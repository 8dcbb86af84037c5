"""Deterministic testing utilities for the streaming engine.

``repro_torch.testing.faults`` is the seeded fault-injection harness, the
reference's ``repro.testing.faults``: named fault sites threaded through
the streaming runner, a :class:`FaultPlan` that fails specific invocations
deterministically from a seed, and the ``fault_scope`` context manager
chaos tests use to install one.
"""

from .faults import (  # noqa: F401
    FAULT_SITES,
    FaultPlan,
    InjectedFault,
    active_plan,
    check,
    fault_scope,
)

__all__ = ["FAULT_SITES", "FaultPlan", "InjectedFault", "active_plan",
           "check", "fault_scope"]
