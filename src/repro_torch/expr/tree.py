"""Typed columnar expression tree — the analyzable operator-input surface.

An :class:`Expr` describes a per-row computation over a table's columns as an
immutable tree of frozen dataclass nodes: ``col("a") + lit(3)``,
``(col("a") > 3) & (col("b") < 7)``, ``when(cond).then(x).otherwise(y)``,
``col("x").sum()``. Unlike the opaque Python callables the API used to take
(bytecode-fingerprinted and numpy-probed to *guess* which columns they
touch), an expression is a value the engine can inspect exactly:

- :func:`referenced_columns` — the exact column set, for projection pushdown
  and build-time schema validation;
- structural equality/hashing — frozen dataclasses compare and hash by
  shape, so two independently-built identical expressions key the same
  compiled-plan cache entry while different literals never alias;
- dual compilation — :func:`to_torch_fn` lowers to a torch function over the
  (P, capacity) columns of all workers, :func:`to_numpy_fn` to a numpy
  function for host-side filtering (no probe needed: an expression is
  known to evaluate on either backend);
- rewrites — :func:`fold_constants` and :func:`split_conjuncts` normalize
  predicates before pushdown.

Equality note: ``==``/``!=`` on :class:`Expr` are *structural* (dataclass
semantics) so plan nodes and caches stay sound; build elementwise comparison
predicates with :meth:`Expr.eq` / :meth:`Expr.ne`. Using an expression in a
boolean context (``if expr:``) raises ``TypeError`` — combine predicates
with ``&``, ``|``, ``~``.

Types follow the reference (jax with 64-bit mode off), not torch: every
node's result has the dtype jax's promotion lattice gives it
(:mod:`repro_torch.core.promotion`), with Python literals weakly typed,
and integer division, remainder and powers give jax's values, divisors of
zero included.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Mapping

import numpy as np
import torch

from ..core import promotion
from ..core.dataframe import narrow_u32, where_rows, wide

__all__ = [
    "Expr",
    "Col",
    "Lit",
    "BinOp",
    "UnaryOp",
    "Cond",
    "Cast",
    "Agg",
    "Alias",
    "col",
    "lit",
    "when",
    "referenced_columns",
    "fold_constants",
    "split_conjuncts",
    "to_torch_fn",
    "to_numpy_fn",
    "infer_schema_entry",
    "ensure_columns",
    "ensure_row_expr",
    "is_when_builder",
    "prepare_row_expr",
    "host_portable",
    "bind_vocabs",
]

# op key -> (render symbol, python/array implementation)
_BIN_OPS = {
    "add": ("+", operator.add),
    "sub": ("-", operator.sub),
    "mul": ("*", operator.mul),
    "truediv": ("/", operator.truediv),
    "floordiv": ("//", operator.floordiv),
    "mod": ("%", operator.mod),
    "pow": ("**", operator.pow),
    "gt": (">", operator.gt),
    "ge": (">=", operator.ge),
    "lt": ("<", operator.lt),
    "le": ("<=", operator.le),
    "eq": ("==", operator.eq),
    "ne": ("!=", operator.ne),
    "and": ("&", operator.and_),
    "or": ("|", operator.or_),
    "xor": ("^", operator.xor),
}

_UNARY_OPS = {
    "neg": operator.neg,
    "invert": operator.invert,
    "abs": operator.abs,
}

_AGG_OPS = ("sum", "count", "min", "max", "mean")


def _to_expr(v) -> "Expr":
    if isinstance(v, Expr):
        return v
    if isinstance(v, (_When, _WhenThen)):
        raise TypeError(
            "incomplete when(...) expression: finish the builder with "
            ".then(value).otherwise(value)")
    return lit(v)


def _reject_bare_bool(value, op: str) -> None:
    """Catch the ``col("a") == 3`` mistake: ``==``/``!=`` on expressions
    compare *structure* and return a Python bool, which would otherwise
    coerce to a constant literal and silently produce all-True/all-False
    results. Predicate positions reject raw bools with guidance."""
    if isinstance(value, bool):
        raise TypeError(
            f"{op}: got a plain Python bool — `==`/`!=` on expressions "
            "compare structure, not values; use .eq()/.ne() for "
            f"elementwise equality (or lit({value}) for an explicit "
            "constant)")


@dataclasses.dataclass(frozen=True)
class Expr:
    """Base class for expression nodes (immutable, structurally hashable).

    Subclass instances are built via :func:`col` / :func:`lit` /
    :func:`when` and the overloaded operators; users never instantiate node
    classes directly. Arithmetic (``+ - * / // % **``), comparisons
    (``> >= < <=`` plus :meth:`eq`/:meth:`ne`), boolean combinators
    (``& | ^ ~``), ``-``/``abs``, :meth:`cast`, aggregation methods
    (:meth:`sum` ...) and :meth:`alias` all return new trees.
    """

    # -- arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return BinOp("add", self, _to_expr(o))

    def __radd__(self, o):
        return BinOp("add", _to_expr(o), self)

    def __sub__(self, o):
        return BinOp("sub", self, _to_expr(o))

    def __rsub__(self, o):
        return BinOp("sub", _to_expr(o), self)

    def __mul__(self, o):
        return BinOp("mul", self, _to_expr(o))

    def __rmul__(self, o):
        return BinOp("mul", _to_expr(o), self)

    def __truediv__(self, o):
        return BinOp("truediv", self, _to_expr(o))

    def __rtruediv__(self, o):
        return BinOp("truediv", _to_expr(o), self)

    def __floordiv__(self, o):
        return BinOp("floordiv", self, _to_expr(o))

    def __rfloordiv__(self, o):
        return BinOp("floordiv", _to_expr(o), self)

    def __mod__(self, o):
        return BinOp("mod", self, _to_expr(o))

    def __rmod__(self, o):
        return BinOp("mod", _to_expr(o), self)

    def __pow__(self, o):
        return BinOp("pow", self, _to_expr(o))

    def __rpow__(self, o):
        return BinOp("pow", _to_expr(o), self)

    # -- comparisons ----------------------------------------------------------
    # NOTE: == / != keep dataclass *structural* semantics (plan equality and
    # cache keys depend on them); elementwise equality is .eq() / .ne().
    def __gt__(self, o):
        return BinOp("gt", self, _to_expr(o))

    def __ge__(self, o):
        return BinOp("ge", self, _to_expr(o))

    def __lt__(self, o):
        return BinOp("lt", self, _to_expr(o))

    def __le__(self, o):
        return BinOp("le", self, _to_expr(o))

    def eq(self, o) -> "Expr":
        """Elementwise equality predicate (``==`` is structural equality)."""
        return BinOp("eq", self, _to_expr(o))

    def ne(self, o) -> "Expr":
        """Elementwise inequality predicate (``!=`` is structural)."""
        return BinOp("ne", self, _to_expr(o))

    def is_in(self, values) -> "Expr":
        """Membership predicate: ``col("c").is_in(["iad", "sfo"])``.

        Desugars to an OR chain of :meth:`eq` comparisons, so each literal
        binds independently against a dict-encoded column's vocab (absent
        values fold to elementwise false); an empty value list is the
        constant-false predicate."""
        vals = list(values)
        if not vals:
            return lit(False)
        out = self.eq(vals[0])
        for v in vals[1:]:
            out = BinOp("or", out, self.eq(v))
        return out

    # -- boolean / bitwise ----------------------------------------------------
    # A bare Python bool operand here is almost always the `col(x) == v`
    # mistake (structural equality returns a bool); reject it instead of
    # silently folding the predicate to a constant — lit(True) stays
    # available for an intentional constant.
    def __and__(self, o):
        _reject_bare_bool(o, "&")
        return BinOp("and", self, _to_expr(o))

    def __rand__(self, o):
        _reject_bare_bool(o, "&")
        return BinOp("and", _to_expr(o), self)

    def __or__(self, o):
        _reject_bare_bool(o, "|")
        return BinOp("or", self, _to_expr(o))

    def __ror__(self, o):
        _reject_bare_bool(o, "|")
        return BinOp("or", _to_expr(o), self)

    def __xor__(self, o):
        _reject_bare_bool(o, "^")
        return BinOp("xor", self, _to_expr(o))

    def __invert__(self):
        return UnaryOp("invert", self)

    def __neg__(self):
        return UnaryOp("neg", self)

    def __abs__(self):
        return UnaryOp("abs", self)

    def __bool__(self):
        raise TypeError(
            "an expression has no truth value; combine predicates with "
            "& | ~ (not `and`/`or`/`not`) and compare with .eq()/.ne()")

    # -- conversions / naming -------------------------------------------------
    def cast(self, dtype) -> "Expr":
        """Elementwise dtype cast (``astype`` on both backends)."""
        return Cast(self, str(np.dtype(dtype)))

    def alias(self, name: str) -> "Expr":
        """Name this expression's output (groupby aggregation specs)."""
        return Alias(self, str(name))

    # -- aggregations (groupby specs) ----------------------------------------
    def sum(self) -> "Expr":
        """Aggregation spec: per-group sum of this column."""
        return Agg("sum", self)

    def count(self) -> "Expr":
        """Aggregation spec: per-group row count."""
        return Agg("count", self)

    def min(self) -> "Expr":
        """Aggregation spec: per-group minimum."""
        return Agg("min", self)

    def max(self) -> "Expr":
        """Aggregation spec: per-group maximum."""
        return Agg("max", self)

    def mean(self) -> "Expr":
        """Aggregation spec: per-group mean (float32)."""
        return Agg("mean", self)


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    """Reference to a column by name (``col("a")``)."""

    name: str

    def __str__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    """Scalar literal. ``kind`` (bool/int/float/str) is derived from the value so
    ``lit(3)`` and ``lit(3.0)`` never alias structurally (Python's
    ``3 == 3.0`` would otherwise make them cache-equal); ``dtype`` pins a
    concrete dtype (else the literal stays weakly typed, letting the column
    dtype drive promotion exactly like a Python scalar in jax)."""

    value: object
    dtype: str | None = None
    kind: str = dataclasses.field(default="", init=False)

    def __post_init__(self):
        v = self.value
        if isinstance(v, (np.generic,)):
            v = v.item()
            object.__setattr__(self, "value", v)
        if isinstance(v, bool):
            k = "bool"
        elif isinstance(v, int):
            k = "int"
        elif isinstance(v, float):
            k = "float"
        elif isinstance(v, str):
            # string literals only ever compare against dict-encoded
            # columns; prepare_row_expr rewrites them into int32 code
            # space (bind_vocabs) before compilation — an unbound string
            # literal is a typed build-time error, never a device value.
            k = "str"
        else:
            raise TypeError(
                f"lit() takes a Python/numpy scalar (bool/int/float/str), "
                f"got {type(v).__name__}")
        object.__setattr__(self, "kind", k)

    def __str__(self):
        return repr(self.value) if self.dtype is None else \
            f"lit({self.value!r}, {self.dtype})"


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    """Binary operation node; ``op`` is a key of the operator table
    (arithmetic / comparison / boolean)."""

    op: str
    left: Expr
    right: Expr

    def __str__(self):
        sym = _BIN_OPS[self.op][0]
        return f"({self.left} {sym} {self.right})"


@dataclasses.dataclass(frozen=True)
class UnaryOp(Expr):
    """Unary operation node: ``neg`` (-x), ``invert`` (~x), ``abs``."""

    op: str
    child: Expr

    def __str__(self):
        if self.op == "neg":
            return f"(-{self.child})"
        if self.op == "invert":
            return f"(~{self.child})"
        return f"{self.op}({self.child})"


@dataclasses.dataclass(frozen=True)
class Cond(Expr):
    """Conditional select: ``when(pred).then(t).otherwise(f)`` — elementwise
    ``where(pred, t, f)`` on both backends."""

    pred: Expr
    if_true: Expr
    if_false: Expr

    def __str__(self):
        return f"when({self.pred}, {self.if_true}, {self.if_false})"


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    """Elementwise dtype cast node."""

    child: Expr
    dtype: str

    def __str__(self):
        return f"{self.child}.cast({self.dtype})"


@dataclasses.dataclass(frozen=True)
class Agg(Expr):
    """Aggregation spec node (``col("x").sum()``) — only meaningful as a
    groupby aggregation spec, never inside a row-level expression."""

    op: str
    child: Expr

    def __post_init__(self):
        if self.op not in _AGG_OPS:
            raise ValueError(f"unknown aggregation op {self.op!r}; "
                             f"supported: {_AGG_OPS}")

    def __str__(self):
        return f"{self.child}.{self.op}()"


@dataclasses.dataclass(frozen=True)
class Alias(Expr):
    """Output-name wrapper (``.alias("total")``) for aggregation specs."""

    child: Expr
    name: str

    def __str__(self):
        return f"{self.child} as {self.name!r}"


# -- builders -----------------------------------------------------------------

def col(name: str) -> Col:
    """Reference a column by name: ``col("a") > 3`` builds a predicate."""
    return Col(str(name))


def lit(value, dtype=None) -> Lit:
    """Scalar literal. Weakly typed unless ``dtype`` pins one, mirroring how
    a bare Python scalar promotes against column dtypes in jax. String
    literals are build-time-only: they bind against a dict-encoded column's
    vocab (``prepare_row_expr``) and never reach the device."""
    return Lit(value, None if dtype is None else str(np.dtype(dtype)))


class _When:
    """Builder state after ``when(pred)``; call ``.then(value)`` next."""

    def __init__(self, pred):
        self._pred = _to_expr(pred)

    def then(self, value) -> "_WhenThen":
        """Value when the predicate holds; finish with ``.otherwise()``."""
        return _WhenThen(self._pred, _to_expr(value))

    def __repr__(self):
        return f"when({self._pred}).then(...)"


class _WhenThen:
    """Builder state after ``.then(v)``; call ``.otherwise(value)`` to get
    the :class:`Cond` expression."""

    def __init__(self, pred, if_true):
        self._pred = pred
        self._if_true = if_true

    def otherwise(self, value) -> Cond:
        """Value when the predicate does not hold; returns the expression."""
        return Cond(self._pred, self._if_true, _to_expr(value))

    def __repr__(self):
        return f"when({self._pred}).then({self._if_true}).otherwise(...)"


def when(pred) -> _When:
    """Start a conditional: ``when(col("a") > 0).then(1).otherwise(-1)``."""
    _reject_bare_bool(pred, "when")
    return _When(pred)


# -- analysis -----------------------------------------------------------------

def _children(e: Expr) -> tuple:
    if isinstance(e, BinOp):
        return (e.left, e.right)
    if isinstance(e, (UnaryOp, Cast, Agg, Alias)):
        return (e.child,)
    if isinstance(e, Cond):
        return (e.pred, e.if_true, e.if_false)
    return ()


def referenced_columns(e: Expr) -> frozenset:
    """Exact set of column names the expression reads — the introspection
    callables never gave us (``probe_columns`` guesses from a trial run;
    this is definitional)."""
    out: set = set()

    def rec(x: Expr):
        if isinstance(x, Col):
            out.add(x.name)
        for c in _children(x):
            rec(c)

    rec(e)
    return frozenset(out)


def _contains_agg(e: Expr) -> bool:
    if isinstance(e, (Agg, Alias)):
        return True
    return any(_contains_agg(c) for c in _children(e))


def ensure_row_expr(e: Expr, op: str) -> None:
    """Reject aggregation/alias nodes inside row-level expressions
    (select predicates, with_column values) with a actionable error."""
    if _contains_agg(e):
        raise TypeError(
            f"{op}: aggregation expressions (.sum()/.alias()/...) are only "
            "valid as groupby aggregation specs, not in row-level "
            "expressions; compute derived inputs with with_column and "
            "aggregate the result")


def ensure_columns(e: Expr, available, op: str) -> None:
    """Validate referenced columns against a schema, raising ``KeyError``
    with the same wording as the eager path's column checks."""
    have = set(available)
    missing = sorted(n for n in referenced_columns(e) if n not in have)
    if missing:
        raise KeyError(
            f"{op}: unknown column(s) {missing}; "
            f"available schema: {sorted(have)}")


def is_when_builder(value) -> bool:
    """True for an unfinished ``when(...)``/``when(...).then(...)`` builder
    — callers route these to the guidance error instead of the legacy
    callable or literal fallbacks."""
    return isinstance(value, (_When, _WhenThen))


def prepare_row_expr(value, available, op: str, vocabs=None) -> "Expr":
    """The shared normalize-and-validate entry for row-level expression
    inputs (``select`` predicates, ``with_column`` values, scan
    predicates): coerce scalars to literals, reject unfinished ``when``
    builders and aggregation nodes with guidance, constant-fold, rewrite
    string literals into dict-code space against ``vocabs``
    (:func:`bind_vocabs`), and validate referenced columns against
    ``available`` (``KeyError`` with the eager wording). Every layer calls
    this one helper so eager, lazy and scan behavior cannot drift apart.

    Args:
      vocabs: optional mapping ``column name -> DictVocab`` for the
        dict-encoded columns in scope. A string literal that still
        compares against a non-dict column after binding raises a typed
        ``TypeError`` naming the operation.
    """
    if is_when_builder(value):
        raise TypeError(
            f"{op}: incomplete when(...) expression: finish the builder "
            "with .then(value).otherwise(value)")
    _reject_bare_bool(value, op)
    e = value if isinstance(value, Expr) else lit(value)
    e = fold_constants(e)
    if vocabs:
        e = fold_constants(bind_vocabs(e, vocabs))
    _ensure_strings_bound(e, op)
    ensure_row_expr(e, op)
    ensure_columns(e, available, op)
    return e


#: comparison flip table for Lit-op-Col orderings (``"x" < col("c")`` is
#: ``col("c") > "x"``)
_CMP_FLIP = {"gt": "lt", "ge": "le", "lt": "gt", "le": "ge",
             "eq": "eq", "ne": "ne"}


def _ensure_strings_bound(e: Expr, op: str) -> None:
    """Reject string literals that survived vocab binding: they compare
    against a column with no dict vocab in scope (or appear outside a
    comparison), which has no device meaning."""

    def rec(x: Expr) -> None:
        if isinstance(x, Lit) and x.kind == "str":
            raise TypeError(
                f"{op}: string literal {x.value!r} does not compare against "
                "a dict-encoded string column here — string comparisons "
                "require a dict-encoded column (see docs/TYPES.md)")
        for c in _children(x):
            rec(c)

    rec(e)


def bind_vocabs(e: Expr, vocabs: Mapping) -> Expr:
    """Rewrite string-literal comparisons into dict-code space.

    For every comparison between ``col(name)`` (with ``name`` in
    ``vocabs``) and a string literal, emit the equivalent ``int32``
    code-space predicate against the column's sorted vocab:

    - ``eq``/``ne`` with a *present* literal become code equality; with an
      *absent* literal they fold to elementwise false / true
      (``codes < 0`` / ``codes >= 0``) — never an error, matching SQL
      semantics for a value the data cannot contain;
    - ordered comparisons use the ``np.searchsorted`` boundary of the
      literal, which is exact whether or not the literal is present
      (sorted vocab => codes are order-isomorphic with strings);
    - a comparison between two dict *columns* requires identical vocabs
      (join/union unification recodes them first) and raises ``TypeError``
      otherwise.

    ``vocabs`` maps column name -> :class:`repro.core.vocab.DictVocab`
    (anything providing ``code_of``/``bound`` works). Non-string parts of
    the tree pass through untouched.
    """

    def cmp_code(op: str, name: str, s: str) -> Expr:
        v = vocabs[name]
        c = Col(name)
        if op in ("eq", "ne"):
            code = v.code_of(s)
            if code is None:
                # absent from the vocab: no row can match (eq) / every row
                # matches (ne) — fold to a constant-valued elementwise
                # predicate over the codes so shapes stay row-wise
                return BinOp("lt" if op == "eq" else "ge", c, Lit(0))
            return BinOp(op, c, Lit(int(code)))
        side = "left" if op in ("lt", "ge") else "right"
        bound = int(v.bound(s, side))
        return BinOp("lt" if op in ("lt", "le") else "ge", c, Lit(bound))

    def rec(x: Expr) -> Expr:
        if isinstance(x, BinOp):
            if x.op in _CMP_FLIP:
                le, ri = x.left, x.right
                if isinstance(le, Col) and isinstance(ri, Lit) \
                        and ri.kind == "str" and le.name in vocabs:
                    return cmp_code(x.op, le.name, ri.value)
                if isinstance(ri, Col) and isinstance(le, Lit) \
                        and le.kind == "str" and ri.name in vocabs:
                    return cmp_code(_CMP_FLIP[x.op], ri.name, le.value)
                if isinstance(le, Col) and isinstance(ri, Col) \
                        and le.name in vocabs and ri.name in vocabs \
                        and vocabs[le.name] != vocabs[ri.name]:
                    raise TypeError(
                        f"comparison between dict columns {le.name!r} and "
                        f"{ri.name!r} with different vocabularies; join or "
                        "union them first so vocab unification recodes "
                        "both sides")
            left, right = rec(x.left), rec(x.right)
            if left is x.left and right is x.right:
                return x
            return BinOp(x.op, left, right)
        if isinstance(x, UnaryOp):
            child = rec(x.child)
            return x if child is x.child else UnaryOp(x.op, child)
        if isinstance(x, Cond):
            p, t, f = rec(x.pred), rec(x.if_true), rec(x.if_false)
            if p is x.pred and t is x.if_true and f is x.if_false:
                return x
            return Cond(p, t, f)
        if isinstance(x, (Cast, Agg, Alias)):
            child = rec(x.child)
            return x if child is x.child else \
                dataclasses.replace(x, child=child)
        return x

    return rec(e) if vocabs else e


def host_portable(e: Expr, schema) -> bool:
    """True when host (numpy) and device (jax) evaluation of a predicate
    provably agree, so the optimizer may absorb it into a SCAN's host-side
    filter without changing which rows pass.

    Portable: all-integer comparisons (operands are signed-integer/bool
    columns, integer literals, or integer-only computations — unsigned
    columns are excluded, see ``intlike``), float comparisons
    anchored on device-exact float columns/literals, and boolean
    combinations of such; boolean columns/literals. Rejected: float
    *arithmetic* and mixed int-column vs float comparisons (numpy promotes
    through float64 where jax stays float32 — results can flip above
    2^24), ``truediv``/``pow``, float casts, and 64-bit columns/dtype pins
    (jax with x64 disabled truncates them to 32 bits on device, so the
    host sees different values than the device SELECT being replaced
    would). A rejected predicate simply stays a device SELECT."""
    dts = {n: np.dtype(d) for n, d, _ in schema}

    def exact(d) -> bool:
        # the dtype survives device admission unchanged (jax x64 disabled
        # truncates 64-bit ints/floats to 32 bits)
        d = np.dtype(d)
        return d.itemsize < 8 or d.kind not in ("i", "u", "f")

    def intlike(x: Expr) -> bool:
        # the subtree computes exclusively in signed-integer/bool space.
        # Unsigned columns are excluded outright: numpy compares them
        # against out-of-range (e.g. negative) weak literals exactly,
        # while jax wraps the literal into the unsigned dtype — provable
        # agreement would need per-literal range analysis.
        if isinstance(x, Col):
            d = dts.get(x.name)
            return d is not None and d.kind in ("i", "b") and exact(d)
        if isinstance(x, Lit):
            return x.kind in ("bool", "int") and (
                x.dtype is None or (np.dtype(x.dtype).kind in ("i", "b")
                                    and exact(x.dtype)))
        if isinstance(x, BinOp):
            return x.op in ("add", "sub", "mul", "floordiv", "mod",
                            "and", "or", "xor") \
                and intlike(x.left) and intlike(x.right)
        if isinstance(x, UnaryOp):
            return intlike(x.child)
        if isinstance(x, Cast):
            return np.dtype(x.dtype).kind in ("i", "b") \
                and exact(x.dtype) and intlike(x.child)
        if isinstance(x, Cond):
            return pred_ok(x.pred) and intlike(x.if_true) \
                and intlike(x.if_false)
        return False

    def float_atom(x: Expr) -> bool:
        # one side of a float-space comparison: a device-exact float
        # column, a weak literal (promotes to the column dtype on BOTH
        # backends under NEP 50 / jax weak typing), or a device-exact
        # float-pinned literal
        if isinstance(x, Col):
            d = dts.get(x.name)
            return d is not None and d.kind == "f" and exact(d)
        if isinstance(x, Lit):
            return x.dtype is None or (np.dtype(x.dtype).kind == "f"
                                       and exact(x.dtype))
        return False

    def compare_ok(left: Expr, right: Expr) -> bool:
        # both sides must promote identically on numpy and jax: either an
        # all-integer comparison, or a float comparison anchored on float
        # columns/literals. A mixed int-column vs float comparison is
        # float64 on numpy but float32 on jax (flips above 2^24), so it
        # is rejected.
        if intlike(left) and intlike(right):
            return True
        return float_atom(left) and float_atom(right)

    def pred_ok(x: Expr) -> bool:
        if isinstance(x, BinOp):
            if x.op in ("gt", "ge", "lt", "le", "eq", "ne"):
                return compare_ok(x.left, x.right)
            if x.op in ("and", "or", "xor"):
                return pred_ok(x.left) and pred_ok(x.right)
            return False
        if isinstance(x, UnaryOp) and x.op == "invert":
            return pred_ok(x.child)
        if isinstance(x, Col):
            d = dts.get(x.name)
            return d is not None and d.kind == "b"
        if isinstance(x, Lit):
            return x.kind == "bool"
        return False

    return pred_ok(e)


# -- rewrites -----------------------------------------------------------------

def _surely_bool(e: Expr) -> bool:
    """True when the expression produces booleans for *any* input schema
    (comparisons, boolean combinations of such) — the schema-free soundness
    test the fold identities need (``&``/``|`` double as integer bitwise
    ops, where ``x & True`` is ``x & 1``, not ``x``)."""
    if isinstance(e, BinOp):
        if e.op in ("gt", "ge", "lt", "le", "eq", "ne"):
            return True
        if e.op in ("and", "or", "xor"):
            return _surely_bool(e.left) and _surely_bool(e.right)
        return False
    if isinstance(e, UnaryOp) and e.op == "invert":
        return _surely_bool(e.child)
    if isinstance(e, Cond):
        return _surely_bool(e.if_true) and _surely_bool(e.if_false)
    if isinstance(e, Lit):
        return e.kind == "bool"
    return False


def fold_constants(e: Expr) -> Expr:
    """Evaluate literal-only subtrees down to literals and apply boolean
    identities (``x & True -> x``, ``x | False -> x``, literal-predicate
    ``when`` branch selection). Runs at build time so equivalent spellings
    (``col("a") > lit(1) + lit(2)`` vs ``col("a") > 3``) produce the same
    structural hash, and again in the optimizer's predicate normalization.

    Folding is semantics-preserving by construction: dtype-pinned literals
    are never collapsed (the pin drives promotion of the unfolded tree),
    and the boolean identities only apply when the kept side provably
    produces booleans on any schema (``x & True`` over an integer ``x`` is
    bitwise ``x & 1``, not ``x``)."""
    if isinstance(e, BinOp):
        left, right = fold_constants(e.left), fold_constants(e.right)
        if isinstance(left, Lit) and isinstance(right, Lit) \
                and left.dtype is None and right.dtype is None:
            try:
                return lit(_BIN_OPS[e.op][1](left.value, right.value))
            except Exception:
                pass
        if e.op == "and":
            if isinstance(left, Lit) and left.value is True \
                    and _surely_bool(right):
                return right
            if isinstance(right, Lit) and right.value is True \
                    and _surely_bool(left):
                return left
        if e.op == "or":
            if isinstance(left, Lit) and left.value is False \
                    and _surely_bool(right):
                return right
            if isinstance(right, Lit) and right.value is False \
                    and _surely_bool(left):
                return left
        if left is e.left and right is e.right:
            return e
        return BinOp(e.op, left, right)
    if isinstance(e, UnaryOp):
        child = fold_constants(e.child)
        if isinstance(child, Lit) and child.dtype is None:
            try:
                return lit(_UNARY_OPS[e.op](child.value))
            except Exception:
                pass
        return e if child is e.child else UnaryOp(e.op, child)
    if isinstance(e, Cond):
        pred = fold_constants(e.pred)
        t, f = fold_constants(e.if_true), fold_constants(e.if_false)
        if isinstance(pred, Lit) and pred.kind == "bool":
            return t if pred.value else f
        if pred is e.pred and t is e.if_true and f is e.if_false:
            return e
        return Cond(pred, t, f)
    if isinstance(e, Cast):
        child = fold_constants(e.child)
        return e if child is e.child else Cast(child, e.dtype)
    if isinstance(e, (Agg, Alias)):
        child = fold_constants(e.child)
        if child is e.child:
            return e
        return dataclasses.replace(e, child=child)
    return e


def infer_schema_entry(e: Expr, schema) -> tuple:
    """Output ``(dtype string, trailing shape)`` of a row-level expression
    over ``schema`` (((name, dtype, tail), ...)), by evaluating it with
    :func:`to_torch_fn` on a tiny ones-valued table -- the reference's
    promotion rules, so the propagated schema matches what execution will
    produce."""
    cols = {n: torch.ones((2,) + tuple(tail),
                          dtype=promotion.torch_dtype_of(promotion.canonical_name(dt)))
            for n, dt, tail in schema}
    out = to_torch_fn(e)(cols)
    return promotion.dtype_name(out.dtype), tuple(out.shape[1:]) if out.dim() else ()


def _is_bool_expr(e: Expr, schema) -> bool:
    if _surely_bool(e):  # static fast path: no evaluation for the
        return True      # common comparison-built predicates
    refs = referenced_columns(e)
    sub = tuple(x for x in schema if x[0] in refs)
    try:
        dt, _ = infer_schema_entry(e, sub)
    except Exception:
        return False
    return dt == "bool"


def split_conjuncts(e: Expr, schema) -> tuple:
    """Split a predicate into its top-level AND conjuncts, so each can push
    down independently (e.g. to different join sides, or into a SCAN).
    ``&`` is also integer bitwise-AND, so a conjunct split only happens when
    both sides infer to boolean dtype over ``schema``; otherwise the
    expression is returned whole."""
    if isinstance(e, BinOp) and e.op == "and" \
            and _is_bool_expr(e.left, schema) and _is_bool_expr(e.right, schema):
        return split_conjuncts(e.left, schema) + split_conjuncts(e.right, schema)
    return (e,)


# -- compilation --------------------------------------------------------------

def _eval(e: Expr, cols: Mapping, xp):
    if isinstance(e, Col):
        return cols[e.name]
    if isinstance(e, Lit):
        if e.dtype is not None:
            return xp.asarray(e.value, dtype=xp.dtype(e.dtype))
        return e.value  # weakly typed scalar: column dtype drives promotion
    if isinstance(e, BinOp):
        return _BIN_OPS[e.op][1](_eval(e.left, cols, xp),
                                 _eval(e.right, cols, xp))
    if isinstance(e, UnaryOp):
        return _UNARY_OPS[e.op](_eval(e.child, cols, xp))
    if isinstance(e, Cond):
        return xp.where(_eval(e.pred, cols, xp),
                        _eval(e.if_true, cols, xp),
                        _eval(e.if_false, cols, xp))
    if isinstance(e, Cast):
        return xp.asarray(_eval(e.child, cols, xp)).astype(xp.dtype(e.dtype))
    if isinstance(e, (Agg, Alias)):
        raise TypeError(f"aggregation expression {e} cannot be evaluated "
                        "row-wise; it is a groupby aggregation spec")
    raise TypeError(e)


def to_torch_fn(e: Expr):
    """Compile to a torch function ``cols dict -> torch.Tensor`` (select
    masks, with_column values). Columns may have any shape; a literal-only
    expression gives a 0-d tensor, which the caller broadcasts."""

    def fn(cols):
        dev = next((v.device for v in cols.values() if isinstance(v, torch.Tensor)), None)
        return _as(_teval(e, cols, dev), dev)

    return fn


def to_numpy_fn(e: Expr):
    """Compile to a numpy function ``cols dict -> np.ndarray`` for
    host-side SCAN pre-admission filtering. Expressions always lower to
    numpy — unlike user callables, no trial probe is needed."""

    def fn(cols):
        return np.asarray(_eval(e, cols, np))

    return fn


# -- the torch lowering ---------------------------------------------------------

class _V:
    """A value during torch evaluation: a tensor, or a Python scalar for a
    weak literal, with the dtype and weak flag jax gives it. ``pred`` is the
    bool array a cast value was converted from (XLA still sees
    ``convert(pred)`` there), else None."""

    __slots__ = ("v", "dt", "weak", "pred")

    def __init__(self, v, dt: str, weak: bool, pred: torch.Tensor | None = None):
        self.v, self.dt, self.weak, self.pred = v, dt, weak, pred


def _as(x: _V, dev, dt: str | None = None) -> torch.Tensor:
    """``x`` as a tensor of dtype ``dt`` (default: its own)."""
    dt = x.dt if dt is None else dt
    promotion.torch_dtype_of(dt)  # dtypes the port does not hold raise
    if isinstance(x.v, torch.Tensor):
        return promotion.convert(x.v, dt)
    return promotion.scalar_tensor(x.v, dt, dev)


_flush = promotion.flush_denormals


def _promoted(a: _V, b: _V, dev, numeric: bool = False):
    """(a, b, dtype, weak) with both converted to jax's result dtype (and
    float32 denormals flushed); ``numeric`` makes bool int32, as
    ``promote_args_numeric`` does."""
    dt, weak = promotion.result_type((a.dt, a.weak), (b.dt, b.weak))
    if numeric and dt == "bool":
        dt = "int32"
    return _flush(_as(a, dev, dt)), _flush(_as(b, dev, dt)), dt, weak


def _is_bool_array(x: _V) -> bool:
    return x.dt == "bool" and isinstance(x.v, torch.Tensor) and x.v.dim() > 0


def _converted_pred(x: _V, dt: str) -> torch.Tensor | None:
    """The bool array that ``x`` is ``convert(pred)`` of, when it enters an
    op of dtype ``dt`` with no further convert: a bool array promoted to
    ``dt``, or one cast to ``dt`` itself. A cast to another dtype gets a
    second convert on promotion, and XLA's rewrite then does not fire."""
    if _is_bool_array(x):
        return x.v
    return x.pred if x.dt == dt else None


def _exact_reciprocal(b: _V, dev, dt: str):
    """1 / b when b is a literal whose reciprocal is exact in ``dt`` (+-0,
    +-inf, a power of two), else None: XLA divides by such a constant as a
    multiplication by its reciprocal."""
    if isinstance(b.v, torch.Tensor) and b.v.dim() > 0:
        return None
    c = float(_as(b, dev, dt).item())
    m, _ = np.frexp(c)
    if c == 0 or np.isinf(c) or abs(m) == 0.5:
        r = 1 / _as(b, dev, dt)
        return r if r.isfinite() or c == 0 or np.isinf(c) else None
    return None


def _int_sign(x: torch.Tensor) -> torch.Tensor:
    return (x > 0).to(torch.int8) - (x < 0).to(torch.int8)


def _float_sign(x: torch.Tensor) -> torch.Tensor:
    """lax.sign of floats: +-1, and the value itself for +-0 and NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(x.dtype)


def _lax_div_rem(x: torch.Tensor, y: torch.Tensor, unsigned: bool):
    """XLA's integer division and remainder (truncating): x / 0 is all ones
    (-1 signed), x % 0 is x, INT_MIN / -1 wraps to INT_MIN with remainder
    0. Divisors of 0 and -1 never reach the hardware divide."""
    zero = y == 0
    special = zero if unsigned else zero | (y == -1)
    safe = torch.where(special, torch.ones_like(y), y)
    q = torch.div(x, safe, rounding_mode="trunc")
    r = torch.fmod(x, safe)
    if not unsigned:
        q = torch.where(y == -1, -x, q)
        r = torch.where(y == -1, torch.zeros_like(r), r)
    q = torch.where(zero, torch.full_like(q, torch.iinfo(q.dtype).max if unsigned else -1), q)
    r = torch.where(zero, x, r)
    return q, r


def _round_half_away(d: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(d)
    return torch.where((d - t).abs() >= 0.5, t + torch.sign(d), t)


# NaN bits of float32 and float16: the quiet bit, and the NaN x86 makes
# for an invalid operation (sign set)
_NAN_BITS = {torch.float32: (torch.int32, 0x00400000, -0x00400000),
             torch.float16: (torch.int16, 0x0200, -0x0200)}


def _nan_like_reference(r: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        pow_: bool = False) -> torch.Tensor:
    """``r`` with each NaN given the bits XLA's CPU code gives it, where the
    port composes the op itself (float floordiv, mod, pow): the first NaN
    operand, quieted, else the invalid-operation NaN. For pow a NaN base
    under a finite odd integer exponent loses its sign (libm's powf squares
    it and negates), and a signaling NaN under ``x ** 0`` or ``1 ** y``
    gives that NaN quieted, not 1. For floordiv and mod by a constant power
    of two of at least 1, +inf gives a NaN with the sign bit clear. NaNs
    that one torch op makes itself (add, sub, mul, div) keep torch's
    bits."""
    ints, quiet, invalid = _NAN_BITS[r.dtype]
    xb = x.view(ints) | quiet
    yb = y.view(ints) | quiet
    bits = torch.where(x.isnan(), xb, torch.where(y.isnan(), yb, invalid))
    nan = r.isnan()
    if pow_:
        odd = y.isfinite() & (y == torch.trunc(y)) & (torch.fmod(y, 2) != 0)
        bits = torch.where(x.isnan() & odd, bits & torch.iinfo(ints).max, bits)
        if r.dtype == torch.float32:  # float16 widens to float32, quieting first
            # libm returns x + y, not 1, for a signaling NaN under x ** 0 and 1 ** y
            signaling = lambda t: t.isnan() & ((t.view(ints) & quiet) == 0)  # noqa: E731
            nan = nan | ((y == 0) & signaling(x)) | ((x == 1) & signaling(y))
    elif y.dim() == 0:
        m, e = np.frexp(abs(float(y)))
        if m == 0.5 and e >= 1:
            bits = torch.where(x == torch.inf, bits & torch.iinfo(ints).max, bits)
    return torch.where(nan, bits, r.view(ints)).view(r.dtype)


def _float_divmod(x: torch.Tensor, y: torch.Tensor):
    """jnp's float floor division and remainder (CPython's float_divmod)."""
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    ind = (mod != 0) & (_float_sign(y) != _float_sign(mod))
    mod = torch.where(ind, mod + y, mod)
    div = torch.where(ind, div - 1, div)
    return _round_half_away(div), mod


def _shift_right_logical(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.uint8:
        return x >> 1
    return (x >> 1) & torch.iinfo(x.dtype).max


def _pow_int_int(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """jnp's integer power: six rounds of binary exponentiation, the
    exponent shifted logically (so a negative exponent runs its low bits)."""
    one = torch.ones((), dtype=x1.dtype, device=x1.device)
    acc = torch.where((x1 == 0) & (x2 != 0), one - one, one)
    for _ in range(6):
        acc = torch.where((x2 & 1) != 0, acc * x1, acc)
        x1 = x1 * x1
        x2 = _shift_right_logical(x2)
    return acc


def _integer_pow(x: torch.Tensor, y: int, dt: str) -> torch.Tensor:
    """lax.integer_pow: binary exponentiation specialised on a concrete
    exponent, a reciprocal for a negative one (refused for integers)."""
    if y < 0 and not promotion.is_float(dt):
        raise TypeError(f"Integers cannot be raised to negative powers, got "
                        f"integer_pow({dt}, {y})")
    if y == 0:
        return torch.ones_like(x)
    recip, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else _flush(acc * x)
        y >>= 1
        if y > 0:
            x = _flush(x * x)
    return _flush(1 / acc) if recip else acc


def _concrete_int(b: _V):
    """The exponent as a Python int when jnp.power would see a concrete
    integer scalar (a literal-only subtree), else None."""
    v = b.v
    if isinstance(v, (bool, int)):
        return int(v)
    if isinstance(v, torch.Tensor) and v.dim() == 0 and not v.is_floating_point():
        return int(v.item())
    return None


def _tbin_u32(op: str, a: _V, b: _V, dev, weak: bool) -> _V:
    """An op whose operands promote to uint32, on their int64 values (torch
    has no uint32 arithmetic or ordering on the CPU), the result wrapped
    back modulo 2**32 as uint32 arithmetic wraps."""
    x, y = wide(_as(a, dev, "uint32")), wide(_as(b, dev, "uint32"))
    if op in ("gt", "ge", "lt", "le", "eq", "ne"):
        return _V(_BIN_OPS[op][1](x, y), "bool", False)
    if op == "floordiv":
        r, _ = _lax_div_rem(x, y, True)
    elif op == "mod":
        _, r = _lax_div_rem(x, torch.where(y == 0, torch.ones_like(y), y), True)
    else:  # add, sub, mul (the low 32 bits survive int64 wrapping), and, or, xor
        r = _BIN_OPS[op][1](x, y)
    return _V(narrow_u32(r), "uint32", weak)


def _tbin(op: str, a: _V, b: _V, dev) -> _V:
    if op not in ("truediv", "pow"):
        dt, weak = promotion.result_type((a.dt, a.weak), (b.dt, b.weak))
        if dt == "uint32":
            return _tbin_u32(op, a, b, dev, weak)
    if op in ("and", "or", "xor"):
        x, y, dt, weak = _promoted(a, b, dev)
        if promotion.is_float(dt):
            raise TypeError(f"{op} does not accept dtype {dt}; accepted dtypes are "
                            "subtypes of integer and bool")
        f = {"and": torch.bitwise_and, "or": torch.bitwise_or, "xor": torch.bitwise_xor}[op]
        return _V(f(x, y), dt, weak)
    if op in ("gt", "ge", "lt", "le", "eq", "ne"):
        x, y, _, _ = _promoted(a, b, dev)
        return _V(_BIN_OPS[op][1](x, y), "bool", False)
    if op == "pow":
        return _tpow(a, b, dev)
    if op == "truediv":
        dt, weak = promotion.result_type((a.dt, a.weak), (b.dt, b.weak))
        if not promotion.is_float(dt):
            dt = "float32"
        pred = _converted_pred(a, dt)
        r = _exact_reciprocal(b, dev, dt) if pred is not None else None
        if r is not None:  # convert(bool) * (1 / c) is select(bool, 1 / c, 0)
            return _V(torch.where(pred, r, torch.zeros_like(r)), dt, weak)
        x, y = _flush(_as(a, dev, dt)), _flush(_as(b, dev, dt))
        return _V(_flush(x / y), dt, weak)
    if op in ("floordiv", "mod"):
        x, y, dt, weak = _promoted(a, b, dev, numeric=True)
        if promotion.is_float(dt):
            d, m = _float_divmod(x, y)
            return _V(_nan_like_reference(_flush(d if op == "floordiv" else m), x, y),
                      dt, weak)
        unsigned = promotion.is_unsigned(dt)
        if op == "floordiv":
            q, r = _lax_div_rem(x, y, unsigned)
            if not unsigned:
                q = torch.where((_int_sign(x) != _int_sign(y)) & (r != 0), q - 1, q)
            return _V(q, dt, weak)
        y = torch.where(y == 0, torch.ones_like(y), y)
        _, r = _lax_div_rem(x, y, unsigned)
        plus = ((r < 0) != (y < 0)) & (r != 0)
        return _V(torch.where(plus, r + y, r), dt, weak)
    dt, weak = promotion.result_type((a.dt, a.weak), (b.dt, b.weak))
    if op == "mul" and dt != "bool":
        # XLA rewrites convert(bool array) * x into select(bool, x, 0): a
        # False row gives +0 even against inf, NaN or a negative value, and
        # a select flushes nothing
        for p, other in ((a, b), (b, a)):
            pred = _converted_pred(p, dt)
            if pred is not None:
                o = _as(other, dev, dt)
                return _V(torch.where(pred, o, torch.zeros_like(o)), dt, weak)
    x, y, dt, weak = _promoted(a, b, dev)
    if dt == "bool":
        if op == "sub":
            raise TypeError("sub does not accept dtype bool; accepted dtypes are "
                            "subtypes of integer, floating and complex")
        return _V((x | y) if op == "add" else (x & y), dt, weak)
    return _V(_flush(_BIN_OPS[op][1](x, y)), dt, weak)


def _tpow(a: _V, b: _V, dev) -> _V:
    """jnp.power's four cases, in its order."""
    n = _concrete_int(b)
    if n is not None:  # a concrete integer exponent: integer_pow
        dt, weak = promotion.result_type((a.dt, a.weak))
        dt = "int32" if dt == "bool" else dt
        if dt == "uint32":  # on the int64 values, wrapped back
            return _V(narrow_u32(_integer_pow(wide(_as(a, dev, dt)), n, dt)), dt, weak)
        return _V(_integer_pow(_flush(_as(a, dev, dt)), n, dt), dt, weak)
    x, y, dt, weak = _promoted(a, b, dev, numeric=True)
    if dt == "uint32":
        return _V(narrow_u32(_pow_int_int(wide(x), wide(y))), dt, weak)
    if not promotion.is_float(dt):
        return _V(_pow_int_int(x, y), dt, weak)
    if promotion.is_float(a.dt) and promotion.is_int(b.dt):  # float ** int column
        x, y = _flush(_as(a, dev)), _as(b, dev, a.dt)
        r = _nan_like_reference(torch.pow(x, y), x, y, pow_=True)
        return _V(_flush(r), a.dt, a.weak and b.weak)
    if not (isinstance(b.v, torch.Tensor) and b.v.dim() > 0):
        r = _pow_constant(_as(a, dev, dt), float(y))
        if r is not None:
            return _V(r, dt, weak)
    return _V(_nan_like_reference(_flush(torch.pow(x, y)), x, y, pow_=True), dt, weak)


def _pow_constant(x: torch.Tensor, c: float) -> torch.Tensor | None:
    """XLA's rewrites of a float power by a constant exponent (which also
    decide NaN signs and roundings), else None: x ** 1 is x, x ** -1 is
    1 / x, x ** 2 and x ** 3 are products, x ** 0 is 1, and x ** 0.5 is
    |sqrt(x)| with +inf for -inf."""
    if c == 1.0:
        return x
    if c == 0.0:
        return torch.ones_like(x)
    x = _flush(x)
    if c == -1.0:
        return _flush(1 / x)
    if c == 2.0:
        return _flush(x * x)
    if c == 3.0:
        return _flush(_flush(x * x) * x)
    if c == 0.5:
        return torch.where(x == -torch.inf, torch.inf, _flush(torch.sqrt(x)).abs())
    return None


def _tunary(op: str, a: _V, dev) -> _V:
    x = _as(a, dev)
    if a.dt == "uint32" and op in ("neg", "invert"):  # on the int64 values, wrapped back
        return _V(narrow_u32(-wide(x) if op == "neg" else ~wide(x)), a.dt, a.weak)
    if op == "neg":
        if a.dt == "bool":
            raise TypeError("neg does not accept dtype bool; accepted dtypes are "
                            "subtypes of integer, floating and complex")
        return _V(-x, a.dt, a.weak)
    if op == "invert":
        if promotion.is_float(a.dt):
            raise TypeError(f"not does not accept dtype {a.dt}; accepted dtypes are "
                            "subtypes of integer and bool")
        return _V(~x, a.dt, a.weak)
    # abs: bool and unsigned are their own absolute value; INT_MIN wraps
    if promotion.is_float(a.dt):
        return _V(torch.abs(x), a.dt, a.weak)
    if a.dt == "bool" or promotion.is_unsigned(a.dt):
        return _V(x, a.dt, a.weak)
    return _V(torch.where(x < 0, -x, x), a.dt, a.weak)


def _teval(e: Expr, cols: Mapping, dev) -> _V:
    if isinstance(e, Col):
        v = cols[e.name]
        return _V(v, promotion.dtype_name(v.dtype), False)
    if isinstance(e, Lit):
        if e.kind == "str":
            raise TypeError(f"string literal {e.value!r} has no device value; it must "
                            "compare against a dict-encoded column")
        if e.dtype is not None:
            dt = promotion.canonical_name(e.dtype)
            promotion.torch_dtype_of(dt)  # dtypes the port does not hold raise
            return _V(promotion.scalar_tensor(e.value, dt, dev), dt, False)
        if e.kind == "bool":
            return _V(e.value, "bool", False)
        return _V(e.value, "int32" if e.kind == "int" else "float32", True)
    if isinstance(e, BinOp):
        return _tbin(e.op, _teval(e.left, cols, dev), _teval(e.right, cols, dev), dev)
    if isinstance(e, UnaryOp):
        return _tunary(e.op, _teval(e.child, cols, dev), dev)
    if isinstance(e, Cond):
        p = _teval(e.pred, cols, dev)
        pred = _as(p, dev, "bool")
        x, y, dt, weak = _promoted(_teval(e.if_true, cols, dev),
                                   _teval(e.if_false, cols, dev), dev)
        return _V(where_rows(pred, x, y), dt, weak)
    if isinstance(e, Cast):
        x = _teval(e.child, cols, dev)
        dt = promotion.canonical_name(e.dtype)
        # a cast to its own dtype is no convert at all; any other keeps no
        # trace of a bool array under it
        pred = x.v if _is_bool_array(x) else (x.pred if dt == x.dt else None)
        return _V(_as(x, dev, dt), dt, False, pred)
    if isinstance(e, (Agg, Alias)):
        raise TypeError(f"aggregation expression {e} cannot be evaluated "
                        "row-wise; it is a groupby aggregation spec")
    raise TypeError(e)
