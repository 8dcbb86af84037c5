"""Deterministic fault-injection harness.

Chaos testing a streaming engine is only useful when every failure is
reproducible: a flaky test that injects faults at *random* points cannot be
re-run, bisected, or minimized. This module makes fault injection a pure
function of a seed and the runtime's call sequence:

- **Fault sites** are named instrumentation points threaded through the
  streaming runner (``FAULT_SITES``): chunk decode, the prefetch thread,
  the per-morsel device op, spill writes, and checkpoint publication. Each
  site calls :func:`check` exactly once per unit of work it performs.
- A :class:`FaultPlan` decides — deterministically, from its seed and the
  per-site invocation ordinal — whether a given ``check`` raises
  :class:`InjectedFault`. Two modes compose:

  * ``rates={site: p}`` — *transient* faults: invocation ``n`` of a site
    fails iff the n-th draw of that site's seeded RNG is below ``p``.
    A retry re-invokes the site with the next ordinal, so transient
    faults exercise the retry path and then pass.
  * ``kill_after={site: n}`` — *persistent* faults: every invocation with
    ordinal >= ``n`` fails, guaranteeing retries exhaust and the query
    dies — the checkpoint/resume path's trigger.

- :func:`fault_scope` activates a plan process-wide (the prefetch thread
  must see it too, so this is intentionally not thread-local).

The contract: given the same seed, the same pipeline, and the same
configuration, the exact same invocations fail, so every chaos test is
reproducible from its seed. The reference's ``repro.testing.faults`` line
for line (numpy only): one seed fires the same sites and ordinals in both
packages.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Mapping

import numpy as np

__all__ = [
    "FAULT_SITES",
    "FaultPlan",
    "InjectedFault",
    "active_plan",
    "check",
    "fault_scope",
]

#: Registry of instrumented fault sites in the streaming runner.
FAULT_SITES = (
    "chunk_decode",        # host-side dataset chunk decode (read_rows)
    "prefetch",            # inside the double-buffering prefetch thread
    "device_op",           # the per-morsel device program (one plan run)
    "spill_write",         # appending a batch to a host-side spill dataset
    "checkpoint_publish",  # atomic tmp-dir-rename checkpoint publication
)


class InjectedFault(RuntimeError):
    """A deterministic injected failure (always classified retryable)."""

    def __init__(self, site: str, ordinal: int):
        super().__init__(
            f"injected fault at site '{site}' (invocation #{ordinal})")
        self.site = site
        self.ordinal = ordinal


class FaultPlan:
    """Seeded, deterministic schedule of failures over the fault sites.

    Args:
      seed: master seed; each site gets an independent RNG derived from
        ``(seed, site index)``, so adding a rate for one site never
        perturbs another site's draw sequence.
      rates: ``{site: probability}`` of a transient fault per invocation.
      kill_after: ``{site: ordinal}`` — every invocation with ordinal >=
        the threshold fails (persistent; exhausts any retry budget).
      max_failures: cap on the total number of *transient* fires (rates
        only), so a high-rate plan still lets the stream finish.

    Thread-safe: the runner's prefetch thread and consumer thread hit
    sites concurrently; ordinals are assigned under a lock per site, and
    the per-site RNG stream makes the outcome a function of the ordinal
    alone.
    """

    def __init__(self, seed: int = 0,
                 rates: Mapping[str, float] | None = None,
                 kill_after: Mapping[str, int] | None = None,
                 max_failures: int | None = None):
        for site in list(rates or ()) + list(kill_after or ()):
            if site not in FAULT_SITES:
                raise ValueError(f"unknown fault site {site!r}; registered "
                                 f"sites: {list(FAULT_SITES)}")
        self.seed = int(seed)
        self.rates = dict(rates or {})
        self.kill_after = dict(kill_after or {})
        self.max_failures = max_failures
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._draws: dict[str, np.random.Generator] = {}
        self.fired: list[tuple[str, int]] = []

    def _rng(self, site: str) -> np.random.Generator:
        if site not in self._draws:
            self._draws[site] = np.random.default_rng(
                np.random.SeedSequence([self.seed, FAULT_SITES.index(site)]))
        return self._draws[site]

    def invocations(self, site: str) -> int:
        """How many times ``site`` has been checked under this plan."""
        with self._lock:
            return self._counts.get(site, 0)

    def reset(self) -> None:
        """Forget all invocation counts and draws (fresh deterministic run)."""
        with self._lock:
            self._counts.clear()
            self._draws.clear()
            self.fired.clear()

    def check(self, site: str) -> None:
        """Record one invocation of ``site``; raise if it is scheduled to
        fail. Deterministic in (seed, site, ordinal)."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            fire = False
            if site in self.kill_after and n >= self.kill_after[site]:
                fire = True
            elif site in self.rates:
                would = float(self._rng(site).random()) < self.rates[site]
                capped = (self.max_failures is not None
                          and len(self.fired) >= self.max_failures)
                fire = would and not capped
            if fire:
                self.fired.append((site, n))
        if fire:
            raise InjectedFault(site, n)


_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


def active_plan() -> FaultPlan | None:
    """The currently-installed :class:`FaultPlan` (None outside chaos tests)."""
    return _ACTIVE


@contextlib.contextmanager
def fault_scope(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Activate ``plan`` for the dynamic extent of the ``with`` block.

    Process-wide on purpose: the runner's prefetch thread must observe the
    plan installed by the test's main thread. Nested scopes restore the
    previous plan on exit.
    """
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev


def check(site: str) -> None:
    """Fault-site hook: no-op unless a :class:`FaultPlan` is active.

    Production code calls this at each registered site; the cost without an
    active plan is one global read, so the hooks stay in the
    host-side hot paths permanently.
    """
    if site not in FAULT_SITES:
        raise ValueError(f"unknown fault site {site!r}; registered sites: "
                         f"{list(FAULT_SITES)}")
    plan = _ACTIVE
    if plan is not None:
        plan.check(site)
