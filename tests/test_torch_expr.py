"""The port's expression lowering against the reference's.

``repro_torch.expr.to_torch_fn`` must give what ``repro.expr.to_jax_fn``
gives (jax with 64-bit mode off) on the same numpy columns: the same dtype,
the same values bit for bit (NaN by position), and the same exception type
where the reference raises. The grid runs every binary operator over every
pair of the port's column dtypes and against weak int and float literals
on either side, every unary operator and every cast, with the edge values
that tell the two libraries apart: zero divisors, INT_MIN, negative
exponents, +-0.0, +-inf and NaN.

The DDF runs an expression under jit, where XLA also rewrites across ops
(``convert(bool) * x`` becomes a select even when the convert is the
expression's own cast); those cases, and the NaN bits that the port's
composed float ops (floordiv, mod, pow) must carry, are held against the
jitted reference, every bit compared, NaNs' sign and payload included.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import expr as ref_expr
from repro_torch import expr as pexpr
from repro_torch.core import promotion

DTYPES = ("bool", "int8", "uint8", "int16", "int32", "float16", "float32")
N = 12
_VALUES = {
    "bool": [True, False, True, True, False, False, True, False, True, False, True, True],
    "int8": [-128, 127, -1, 0, 1, 2, 7, -7, 3, -3, 100, -100],
    "uint8": [0, 255, 1, 2, 7, 128, 3, 100, 200, 5, 0, 9],
    "int16": [-32768, 32767, -1, 0, 1, 2, 7, -7, 3, -3, 1000, -1000],
    "int32": [-2**31, 2**31 - 1, -1, 0, 1, 2, 7, -7, 3, -3, 100000, -100000],
    "float16": [0.0, -0.0, 1.5, -2.5, 3.0, -7.0, np.inf, -np.inf, np.nan, 0.1, 65504.0, 2.0],
    "float32": [0.0, -0.0, 1.5, -2.5, 3.0, -7.0, np.inf, -np.inf, np.nan, 0.1, 1e30, 2.0],
}
BIN_OPS = ("add", "sub", "mul", "truediv", "floordiv", "mod", "pow",
           "gt", "ge", "lt", "le", "eq", "ne", "and", "or", "xor")
SYMMETRIC = ("add", "mul", "eq", "ne", "and", "or", "xor")
INT_LITS = (0, -2, 300)
FLOAT_LITS = (0.0, 1.5, -0.5)
# every same-dtype pair, and mixed pairs that cross each edge of the lattice
PAIRS = tuple((d, d) for d in DTYPES) + (
    ("bool", "int8"), ("uint8", "int8"), ("uint8", "int16"), ("int8", "int16"),
    ("int16", "int32"), ("int32", "float16"), ("float16", "float32"), ("bool", "float32"),
    ("uint8", "float16"), ("int8", "float32"), ("int32", "bool"), ("float32", "uint8"))


def column(dtype, shift=0):
    v = _VALUES[dtype]
    return np.asarray(v[shift:] + v[:shift], dtype=np.dtype(dtype))


def _binop(op, a, b):
    return ref_expr.BinOp(op, a if isinstance(a, ref_expr.Expr) else ref_expr.lit(a),
                          b if isinstance(b, ref_expr.Expr) else ref_expr.lit(b))


def _port_expr(e):
    """The same tree built from the port's node classes."""
    if isinstance(e, ref_expr.Col):
        return pexpr.col(e.name)
    if isinstance(e, ref_expr.Lit):
        return pexpr.Lit(e.value, e.dtype)
    if isinstance(e, ref_expr.BinOp):
        return pexpr.BinOp(e.op, _port_expr(e.left), _port_expr(e.right))
    if isinstance(e, ref_expr.UnaryOp):
        return pexpr.UnaryOp(e.op, _port_expr(e.child))
    if isinstance(e, ref_expr.Cond):
        return pexpr.Cond(_port_expr(e.pred), _port_expr(e.if_true), _port_expr(e.if_false))
    if isinstance(e, ref_expr.Cast):
        return pexpr.Cast(_port_expr(e.child), e.dtype)
    raise TypeError(e)


def _same_bits(got: np.ndarray, exp: np.ndarray) -> bool:
    if got.dtype != exp.dtype or got.shape != exp.shape:
        return False
    if got.dtype.kind == "f":
        nan = np.isnan(exp)
        if not np.array_equal(np.isnan(got), nan):
            return False
        ints = {2: np.int16, 4: np.int32}[got.dtype.itemsize]
        return np.array_equal(got[~nan].view(ints), exp[~nan].view(ints))
    return np.array_equal(got, exp)


def check(e, cols):
    """Evaluate ``e`` with both packages on ``cols`` (numpy) and require
    the same dtype and bits, or the same exception type."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            exp = np.asarray(ref_expr.to_jax_fn(e)({k: jnp.asarray(v) for k, v in cols.items()}))
        except (TypeError, OverflowError, ValueError) as err:
            exp = err
        try:
            got = pexpr.to_torch_fn(_port_expr(e))(
                {k: torch.from_numpy(v.copy()) for k, v in cols.items()}).numpy()
        except (TypeError, OverflowError, ValueError) as err:
            got = err
    if isinstance(exp, Exception):
        assert isinstance(got, type(exp)), (str(e), exp, got)
        return
    assert not isinstance(got, Exception), (str(e), got)
    assert _same_bits(got, exp), (str(e), got.dtype, got.tolist(), exp.dtype, exp.tolist())


@pytest.mark.parametrize("op", BIN_OPS)
@pytest.mark.parametrize("left", DTYPES)
def test_binary_op_against_weak_literals(op, left):
    a = ref_expr.col("a")
    for v in INT_LITS + FLOAT_LITS + (True,):
        check(_binop(op, a, v), {"a": column(left)})
        if op not in SYMMETRIC or v == 0:
            check(_binop(op, v, a), {"a": column(left)})


@pytest.mark.parametrize("op", BIN_OPS)
def test_binary_op_over_column_pairs(op):
    for left, right in PAIRS:
        check(_binop(op, ref_expr.col("a"), ref_expr.col("b")),
              {"a": column(left), "b": column(right, 5)})


@pytest.mark.parametrize("op", ("neg", "invert", "abs"))
@pytest.mark.parametrize("dtype", DTYPES)
def test_unary_op(op, dtype):
    check(ref_expr.UnaryOp(op, ref_expr.col("a")), {"a": column(dtype)})


@pytest.mark.parametrize("dtype", DTYPES)
def test_cast_to_every_dtype(dtype):
    vals = {"float16": [300.0, -300.0, np.nan, 2.7, -2.7, 70000.0, -0.0, 1e-8],
            "float32": [1e10, -1e10, np.nan, 3.7, -3.7, 2**31, 1e-39, -129.0]}
    a = np.asarray(vals.get(dtype, _VALUES[dtype][:8]), dtype=np.dtype(dtype))
    for to in DTYPES + ("int64", "float64"):
        check(ref_expr.col("a").cast(to), {"a": a})


def test_edge_values_named_by_the_reference():
    i32 = {"a": np.array([7, -7, 0], np.int32), "z": np.zeros(3, np.int32)}
    check(ref_expr.col("a") // ref_expr.col("z"), i32)  # [-2, -2, -1]
    check(ref_expr.col("a") % ref_expr.col("z"), i32)  # 0
    check(ref_expr.col("a") ** -1, i32)  # TypeError
    check(ref_expr.col("a") ** ref_expr.col("a"), i32)  # negative column exponent
    check(ref_expr.col("a") - ref_expr.col("a"), {"a": column("bool")})  # TypeError
    check(abs(ref_expr.col("a")), {"a": np.array([-2**31], np.int32)})  # wraps
    check(ref_expr.col("a") * 300, {"a": np.array([1, 2, -1], np.int8)})  # 44, 88, -44
    check(ref_expr.col("a") + ref_expr.col("b"),
          {"a": column("uint8"), "b": column("int8")})  # int16
    check(ref_expr.col("a") * 1.5, i32)  # float32
    for dt in DTYPES:  # float32 denormal operands flush to zero, as XLA's do
        check(ref_expr.col("a") * ref_expr.col("d"),
              {"a": column(dt), "d": np.full(12, 1e-39, np.float32)})
    check(ref_expr.col("a") + 2**31, i32)  # OverflowError


def test_weak_results_promote_like_the_reference():
    cols = {"b": column("bool"), "i8": column("int8"), "i32": column("int32", 3),
            "f16": column("float16", 2), "u8": column("uint8")}
    c = ref_expr.col
    for e in ((c("b") + 1) * c("i8"),  # weak int32 meets int8: int8
              (c("i32") * 1.5) + c("f16"),  # weak float32 meets float16: float16
              (2.5 ** c("i8")) + c("f16"),  # float ** int column is strong: float32
              (c("b") / 2) + c("f16"),
              ref_expr.when(c("b")).then(1).otherwise(c("i8")),
              ref_expr.when(c("i8")).then(1.5).otherwise(2),
              ref_expr.when(c("b")).then(c("u8")).otherwise(-1),
              (c("i8") ** 2) + c("u8"),
              (c("b") ** 3) * c("i8"),
              ref_expr.lit(3) + c("u8"),
              -(c("i32") % 3) + c("i8"),
              (c("u8") // 0) + (c("u8") % 0)):
        check(e, cols)


def test_pinned_literals_and_casts_of_literals():
    c = ref_expr.col
    cols = {"i8": column("int8"), "f16": column("float16")}
    for e in (c("i8") + ref_expr.lit(3, "int16"),
              c("f16") * ref_expr.lit(1.5, "float32"),
              c("i8") ** ref_expr.lit(2, "int8"),
              c("f16") ** ref_expr.lit(2, "int32"),
              c("i8") + ref_expr.lit(7).cast("int8"),
              c("i8") < ref_expr.lit(5, "int64")):
        check(e, cols)


def test_unported_dtypes_raise():
    """uint16, which no column of the port holds, raises; uint32, once
    refused too, gives the reference's dtype and bits (a strong uint32
    with int32 is int32 with x64 off)."""
    a = np.array([-7, 0, 5], np.int32)
    x = {"a": torch.from_numpy(a.copy())}
    with pytest.raises(TypeError, match="not ported"):
        pexpr.to_torch_fn(pexpr.col("a").cast("uint16"))(x)
    for e in (lambda m: m.col("a").cast("uint32"), lambda m: m.col("a") + m.lit(1, "uint32"),
              lambda m: m.col("a").cast("uint32") * 3 - 1):
        got = pexpr.to_torch_fn(e(pexpr))(x).numpy()
        exp = np.asarray(jax.jit(ref_expr.to_jax_fn(e(ref_expr)))({"a": jnp.asarray(a)}))
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes(), (got, exp)


@pytest.mark.parametrize("a,b", [(a, b) for a in DTYPES for b in DTYPES] +
                         [(a, w) for a in DTYPES for w in ("i*", "f*")])
def test_promotion_table_matches_jax(a, b):
    """The lattice join of every pair, and against weak literals, as
    ``jnp.result_type`` gives it with 64-bit mode off."""
    args = [np.dtype(a), {"i*": 1, "f*": 1.0}[b] if b in ("i*", "f*") else np.dtype(b)]
    exp = np.dtype(jnp.result_type(*args))
    weak = b in ("i*", "f*")
    bn = ("int32" if b == "i*" else "float32") if weak else b
    got, _ = promotion.result_type((a, False), (bn, weak))
    assert got == str(exp), (a, b, got, exp)


def test_infer_schema_entry_matches_reference():
    schema = (("a", "int8", ()), ("b", "float16", ()), ("c", "bool", ()), ("d", "int64", ()))
    c = ref_expr.col
    for e in (c("a") * 300, c("a") / 2, c("b") + 1, c("c") + 1, (c("a") > 1) & c("c"),
              c("d") * 2, c("a").cast("float64")):
        assert pexpr.infer_schema_entry(_port_expr(e), schema) == \
            ref_expr.infer_schema_entry(e, schema), str(e)


def test_host_side_helpers_match_reference():
    c = ref_expr.col
    schema = (("a", "int32", ()), ("f", "float32", ()), ("u", "uint8", ()))
    exprs = ((c("a") > 3) & (c("f") < 2.5), (c("a") + 1.5) > 2, c("u") < -1,
             ref_expr.when(c("a") > 0).then(True).otherwise(c("f") > 0),
             (c("a") > ref_expr.lit(1) + ref_expr.lit(2)) | ref_expr.lit(False))
    for e in exprs:
        pe = _port_expr(e)
        assert pexpr.host_portable(pe, schema) == ref_expr.host_portable(e, schema), str(e)
        assert str(pexpr.fold_constants(pe)) == str(ref_expr.fold_constants(e))
        assert pexpr.referenced_columns(pe) == ref_expr.referenced_columns(e)
        assert [str(x) for x in pexpr.split_conjuncts(pe, schema)] == \
            [str(x) for x in ref_expr.split_conjuncts(e, schema)]
    cols = {"a": np.array([1, 5, -3], np.int32), "f": np.array([0.5, 3.0, -1.0], np.float32)}
    np.testing.assert_array_equal(pexpr.to_numpy_fn(_port_expr(exprs[0]))(cols),
                                  ref_expr.to_numpy_fn(exprs[0])(cols))


def test_agg_specs_parse_like_reference():
    specs = [ref_expr.col("v").sum(), ref_expr.col("v").mean().alias("avg"),
             ref_expr.col("w").max()]
    pspecs = [pexpr.col("v").sum(), pexpr.col("v").mean().alias("avg"), pexpr.col("w").max()]
    assert pexpr.parse_agg_specs(pspecs) == ref_expr.parse_agg_specs(specs)
    for bad in ([pexpr.col("v") + 1], [], [pexpr.col("v").sum().alias("x"),
                                           pexpr.col("w").sum().alias("x")]):
        with pytest.raises((TypeError, ValueError)):
            pexpr.parse_agg_specs(bad)


def check_jit(e, cols):
    """``e`` as the reference's DDF runs it, under jit, against the port:
    the same dtype and every bit, NaNs' included."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exp = np.asarray(jax.jit(ref_expr.to_jax_fn(e))(
            {k: jnp.asarray(v) for k, v in cols.items()}))
        got = pexpr.to_torch_fn(_port_expr(e))(
            {k: torch.from_numpy(v.copy()) for k, v in cols.items()}).numpy()
    assert got.dtype == exp.dtype, (str(e), got.dtype, exp.dtype)
    if exp.dtype.kind == "f":
        ints = {2: np.uint16, 4: np.uint32}[exp.dtype.itemsize]
        got, exp = got.view(ints), exp.view(ints)
    bad = np.nonzero(got != exp)[0]
    assert not len(bad), (str(e), [(hex(int(got[i])), hex(int(exp[i]))) for i in bad[:6]])


_EDGE = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.0], np.float32)
_GRID = {"a": np.repeat(_EDGE, 8), "b": np.tile(_EDGE, 8),
         "h": np.tile(_EDGE, 8).astype(np.float16), "i": np.tile(np.arange(-3, 5), 8)
         .astype(np.int32), "bo": np.tile(np.arange(8) % 3 == 0, 8)}


@pytest.mark.parametrize("to", ["float32", "float16", "float64", "int32", "int8", "bool"])
@pytest.mark.parametrize("other", ["b", "h", "i"])
def test_cast_bool_times_x_matches_jit(to, other):
    """``cast(bool) * x``, ``x * cast(bool)`` and ``cast(bool) / x``: XLA
    makes the product a select (+0 on a False row, even against NaN, inf
    or a negative x) when the convert meets x with no further convert; a
    predicate of a bool column or of an int comparison alike."""
    c = ref_expr.col
    for p in (c("a") > 0, c("bo"), c("i") > 0):
        check_jit(p.cast(to) * c(other), _GRID)
        check_jit(c(other) * p.cast(to), _GRID)
        check_jit(p.cast(to) / c(other), _GRID)
        check_jit(c(other) / p.cast(to), _GRID)
        for lit in (0.0, -0.0, np.inf, 0.5, 3.0):
            check_jit(p.cast(to) / lit, _GRID)
    # a cast of a cast: XLA sees convert(convert(pred)) and keeps the product
    check_jit((c("a") > 0).cast("int32").cast(to) * c(other), _GRID)


_NAN_EDGE = np.concatenate([_EDGE, np.array([0x7FC00001, 0xFFC12345, 0x7F812345], np.uint32)
                            .view(np.float32), np.array([3.0, -3.0, 1.0, 0.5, -0.5],
                                                        np.float32)])
_NAN_GRID = {"a": np.repeat(_NAN_EDGE, len(_NAN_EDGE)), "b": np.tile(_NAN_EDGE, len(_NAN_EDGE))}
_NAN_GRID.update(h=_NAN_GRID["a"].astype(np.float16), g=_NAN_GRID["b"].astype(np.float16),
                 j=np.nan_to_num(_NAN_GRID["b"], posinf=5, neginf=-5).astype(np.int32))


@pytest.mark.parametrize("op", ["floordiv", "mod", "pow"])
@pytest.mark.parametrize("pair", [("a", "b"), ("h", "g"), ("a", "j"), ("h", "j")])
def test_composed_float_ops_carry_the_reference_nan(op, pair):
    """floordiv, mod and pow are composed of several torch ops in the port;
    their NaNs carry the reference's bits (the first NaN operand, quieted,
    else the invalid-operation NaN; pow's libm and constant-exponent rules),
    so rows hash to the reference's workers."""
    c = ref_expr.col
    x, y = c(pair[0]), c(pair[1])
    check_jit(_binop(op, x, y), _NAN_GRID)
    if pair[1] in ("b", "g"):
        for lit in (0.0, 1.5, -2.0, 1.0, -1.0, 2.0, 3.0, 0.5, -0.5):
            check_jit(_binop(op, x, lit), _NAN_GRID)
