"""Groupby aggregation specs as expressions.

``groupby(keys, [col("v").sum(), col("v").mean().alias("avg")])`` is parsed
into the engine's canonical ``{value_col: (op, ...)}`` mapping plus the
renames implied by aliases (the distributed groupby kernel emits fixed
``<col>_<op>`` names; aliases are applied as a zero-copy rename on top).
"""

from __future__ import annotations

from .tree import Agg, Alias, Col

__all__ = ["parse_agg_specs"]


def parse_agg_specs(specs) -> tuple:
    """Parse a sequence of aggregation expressions into ``(aggs, renames)``.

    Each spec must be ``col(name).<op>()`` optionally wrapped in
    ``.alias(out_name)``; ``aggs`` is the canonical ``{col: (op, ...)}``
    mapping and ``renames`` is a sorted ``((default_name, alias), ...)``
    tuple for aliases that differ from the default ``<col>_<op>`` output
    name. Duplicate (col, op) pairs with conflicting aliases raise
    ``ValueError``; non-column aggregation inputs raise ``TypeError`` with
    migration guidance (compute derived inputs with ``with_column`` first).
    """
    aggs: dict = {}
    renames: dict = {}
    seen: dict = {}
    for spec in specs:
        alias = None
        e = spec
        if isinstance(e, Alias):
            alias, e = e.name, e.child
        if not isinstance(e, Agg):
            raise TypeError(
                f"groupby aggregation spec must be an aggregation "
                f"expression like col('x').sum() (got {spec!r})")
        if not isinstance(e.child, Col):
            raise TypeError(
                f"groupby aggregates a plain column, got {spec}; compute "
                "derived inputs with with_column first "
                "(e.g. with_column('t', col('a') + col('b')) then "
                "col('t').sum())")
        name, op = e.child.name, e.op
        key = (name, op)
        if key in seen:
            if seen[key] != alias:
                raise ValueError(
                    f"groupby: duplicate aggregation {name}_{op} with "
                    "conflicting aliases")
            continue
        seen[key] = alias
        aggs.setdefault(name, []).append(op)
        default = f"{name}_{op}"
        if alias is not None and alias != default:
            renames[default] = alias
    if not aggs:
        raise ValueError("groupby: empty aggregation spec")
    outs: set = set()
    for (name, op), alias in seen.items():
        out_name = alias if alias is not None else f"{name}_{op}"
        if out_name in outs:
            raise ValueError(
                f"groupby: aggregation specs produce duplicate output "
                f"column {out_name!r}; give conflicting aggregations "
                "distinct .alias() names")
        outs.add(out_name)
    return ({k: tuple(v) for k, v in aggs.items()},
            tuple(sorted(renames.items())))
