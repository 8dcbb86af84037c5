"""Error classification + bounded-backoff retry for the streaming runner.

A morsel-driven stream fails in two fundamentally different ways:

- **retryable** — transient environment faults: injected chaos faults
  (``repro_torch.testing.InjectedFault``), I/O errors during chunk decode or
  spill write (``OSError``/``EOFError``), and corrupt-archive decode
  errors (``zipfile.BadZipFile`` from a torn ``.npz`` read). Re-executing
  the same unit of work is safe (decode and the per-morsel device op are
  pure; spill appends only mutate state after a successful write), so the
  runner retries in place with bounded exponential backoff.
- **fatal** — deterministic program errors that would recur on every
  attempt: ``strict_overflow`` violations (``RuntimeError``), schema
  mismatches (``ValueError``/``KeyError``), plan bugs. Retrying these only
  delays the failure, so they propagate immediately; recovery is
  checkpoint/restore (fix the query, then ``resume=True``).

The classification is a total function over exceptions (default: fatal),
mirroring the retry-pattern guidance in the resilience literature: never
retry on errors the caller caused.
"""

from __future__ import annotations

import dataclasses
import time
import zipfile
from typing import Callable

from ..testing.faults import InjectedFault

__all__ = ["RETRYABLE_EXCEPTIONS", "RetryPolicy", "call_with_retry",
           "classify_error"]

#: Exception types the runner re-executes in place (transient faults).
RETRYABLE_EXCEPTIONS = (InjectedFault, OSError, EOFError, zipfile.BadZipFile)


def classify_error(exc: BaseException) -> str:
    """``"retryable"`` for transient I/O / injected faults, ``"fatal"``
    for deterministic errors (strict_overflow, schema mismatch, bugs)."""
    return "retryable" if isinstance(exc, RETRYABLE_EXCEPTIONS) else "fatal"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for retryable morsel failures.

    ``max_retries`` bounds re-executions *per unit of work* (a morsel
    decode, one device op, one spill append, one checkpoint publish), not
    per stream; attempt ``k`` sleeps ``backoff_s * backoff_factor**k``
    capped at ``max_backoff_s``."""

    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        return min(self.backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)


def call_with_retry(fn: Callable, policy: RetryPolicy, site: str,
                    on_retry: Callable[[str, int, BaseException], None] | None = None,
                    sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()``; on a retryable failure, back off and re-run, up to
    ``policy.max_retries`` times. Fatal errors and exhausted budgets
    propagate the original exception. ``on_retry(site, attempt, exc)`` is
    invoked before each re-execution (the runner counts retries per site
    into its info dict)."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:
            if classify_error(exc) != "retryable" or attempt >= policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(site, attempt, exc)
            sleep(policy.delay(attempt))
            attempt += 1
