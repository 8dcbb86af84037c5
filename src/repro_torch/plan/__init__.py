"""Lazy logical-plan layer: build -> optimize -> run whole pipelines.

The reference's ``repro.plan`` on one card:

- ``logical``  -- immutable plan node types + property propagation
  (schema, capacity, partitioning, row estimates);
- ``optimizer`` -- rewrite passes: predicate/projection pushdown, cost-model
  shuffle planning, shuffle elision (co-partition reuse), EP fusion;
- ``executor`` -- one composed callable per optimized plan, with plan and
  op caches;
- ``frame``    -- the user-facing ``LazyDDF`` handle.

Entry points: ``DDF.lazy()``, ``DDF.from_numpy(..., mode="lazy")``, or flip
the module default with :func:`set_default_mode` ("eager" ships as the
default; "lazy" makes ``DDF.from_numpy`` return ``LazyDDF``).
"""

from . import executor, logical, optimizer  # noqa: F401
from .frame import LazyDDF  # noqa: F401
from .logical import format_plan  # noqa: F401
from .optimizer import optimize  # noqa: F401

__all__ = ["LazyDDF", "optimize", "format_plan", "set_default_mode",
           "get_default_mode"]

_DEFAULT_MODE = "eager"


def set_default_mode(mode: str) -> None:
    """Set the module-wide API default: "lazy" makes ``DDF.from_numpy``
    return a ``LazyDDF`` (plan-building) handle; "eager" keeps the
    immediate-execution semantics."""
    global _DEFAULT_MODE
    if mode not in ("eager", "lazy"):
        raise ValueError(f"mode must be 'eager' or 'lazy', got {mode!r}")
    _DEFAULT_MODE = mode


def get_default_mode() -> str:
    """Current module-wide API default ("eager" or "lazy")."""
    return _DEFAULT_MODE
