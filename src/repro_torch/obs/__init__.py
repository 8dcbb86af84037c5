"""Unified observability: tracing spans, typed metrics, cost-model checks.

Three cooperating pieces (see docs/OBSERVABILITY.md, the reference's):

- :mod:`repro_torch.obs.trace` — the reference's spans: nestable,
  thread-safe, a process-wide recorder and Chrome/Perfetto
  ``trace_event`` export; each span is also a ``torch.profiler`` range of
  its name while tracing is on; near-zero cost while disabled.
- :mod:`repro_torch.obs.metrics` — a typed registry (counters, gauges)
  unifying the engine's previously ad-hoc counters; per-run
  sub-registries propagate into process totals (except on checkpoint
  restore, which must not double-count).
- :mod:`repro_torch.obs.model_check` — predicted-vs-observed accounting for
  every planned shuffle/groupby/scan, with :func:`model_report`
  summarizing cost-model error per paper pattern.

The wiring lives in the layers themselves: partition, shuffle,
compaction, the local operators and the lazy executor open spans; the
plan executor and the streaming runner also emit model records
(synchronizing the card for honest wall times while tracing is on), and
``LazyDDF.collect(profile=True)`` / ``explain(analyze=True)`` use
:func:`profiled` to scope a per-query profile. The query service reads
them in ``QueryService.stats()["trace"]``.
"""

from __future__ import annotations

from . import metrics, model_check, trace
from .metrics import MetricsRegistry, engine_snapshot, registry
from .model_check import ModelRecord, model_report
from .trace import Trace, get_trace, span, tracing

__all__ = [
    "MetricsRegistry",
    "ModelRecord",
    "Profile",
    "Trace",
    "engine_snapshot",
    "get_trace",
    "metrics",
    "model_check",
    "model_report",
    "profiled",
    "registry",
    "span",
    "trace",
    "tracing",
]


class Profile:
    """The result of one :func:`profiled` block.

    ``records`` are the block's :class:`ModelRecord` samples; ``trace`` is
    the block's :class:`Trace` slice. :meth:`report` returns the
    structured summary, :meth:`render` a human-readable per-node profile
    (what ``LazyDDF.explain(analyze=True)`` appends to the plan)."""

    def __init__(self):
        self.records: list = []
        self.trace: Trace | None = None

    def report(self) -> dict:
        """``{"model": model_report(...), "spans": per-name aggregates}``."""
        return {"model": model_report(self.records),
                "spans": self.trace.summary() if self.trace else {}}

    def render(self) -> str:
        """Human-readable per-operator profile: predicted vs observed wall
        time per planned operator (aggregated across morsel dispatches of
        the same operator), then the per-pattern error summary."""
        agg: dict[tuple, dict] = {}
        for r in self.records:
            d = agg.setdefault((r.op, r.pattern),
                               {"n": 0, "pred": 0.0, "obs": 0.0})
            d["n"] += 1
            d["pred"] += r.predicted_s
            d["obs"] += r.observed_s
        lines = ["-- profile (predicted vs observed) --"]
        for (op, pattern), d in sorted(agg.items()):
            ratio = d["obs"] / max(d["pred"], 1e-9)
            lines.append(
                f"{op:<22} {pattern:<24} x{d['n']:<4d} "
                f"predicted {d['pred'] * 1e3:9.3f} ms  "
                f"observed {d['obs'] * 1e3:9.3f} ms  (x{ratio:.2f})")
        rep = model_report(self.records)
        if rep:
            lines.append("-- per-pattern model error --")
            for pattern, d in sorted(rep.items()):
                lines.append(
                    f"{pattern:<24} n={d['count']:<5d} "
                    f"bias x{d['bias']:.2f}  "
                    f"mean |rel err| {d['mean_abs_rel_err']:.2f}")
        return "\n".join(lines)


class _Profiled:
    __slots__ = ("_prof", "_tracing", "_mark", "_tmark")

    def __enter__(self):
        self._prof = Profile()
        self._mark = model_check.mark()
        self._tmark = trace.mark()
        self._tracing = trace.tracing()
        self._tracing.__enter__()
        return self._prof

    def __exit__(self, *exc):
        self._tracing.__exit__(*exc)
        self._prof.records = model_check.records(since=self._mark)
        self._prof.trace = trace.get_trace(since=self._tmark)
        return False


def profiled() -> _Profiled:
    """Enable tracing for a ``with`` block and scope a :class:`Profile` to
    it::

        with obs.profiled() as prof:
            lz.collect()
        print(prof.render())

    The prior tracing state is restored on exit; the yielded profile is
    filled with the block's model samples and trace slice when the block
    closes."""
    return _Profiled()
