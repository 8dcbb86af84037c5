"""Columnar expressions: the operator-input surface of the dataframe.

Build typed expression trees with :func:`col` / :func:`lit` / :func:`when`
and Python operators, and pass them to ``DDF.select`` / ``DDF.with_column``
/ groupby aggregation specs. The old opaque-callable forms remain as a
deprecated shim. The tree, its analyses and rewrites are the reference's
(``repro.expr``); the lowering is :func:`to_torch_fn`, which follows the
reference's dtypes and values.
"""

import warnings

from .aggs import parse_agg_specs  # noqa: F401
from .tree import (  # noqa: F401
    Agg,
    Alias,
    BinOp,
    Cast,
    Col,
    Cond,
    Expr,
    Lit,
    UnaryOp,
    bind_vocabs,
    col,
    ensure_columns,
    ensure_row_expr,
    fold_constants,
    host_portable,
    infer_schema_entry,
    is_when_builder,
    lit,
    prepare_row_expr,
    referenced_columns,
    split_conjuncts,
    to_torch_fn,
    to_numpy_fn,
    when,
)

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
    "parse_agg_specs",
    "warn_callable_deprecated",
]

# one warning per op name per process: enough signal to migrate without
# drowning a loop that calls the legacy form per batch
_WARNED: set = set()


def warn_callable_deprecated(op: str) -> None:
    """Emit the one-shot ``DeprecationWarning`` for a legacy callable-taking
    operator form (``select``/``map_columns`` with a Python function).
    Behavior of the legacy path is unchanged — bit-identical results through
    the probe-based pipeline — but expressions are the supported surface."""
    if op in _WARNED:
        return
    _WARNED.add(op)
    warnings.warn(
        f"{op} with a Python callable is deprecated; pass a repro_torch.expr "
        "expression instead (e.g. select(col('a') > 3)). The callable form "
        "keeps its behavior but hides column references from the "
        "optimizer.",
        DeprecationWarning, stacklevel=3)
