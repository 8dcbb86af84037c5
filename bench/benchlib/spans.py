"""The program's own spans in a window's ``torch.profiler`` trace: how much
of the device's busy time each span, and each layer of spans, holds, and
where the device idled.

While ``repro_torch.obs.trace`` is tracing, every program span is a
``record_function`` range of its name, on the profiler's clock. A span
name's device time is the part of the device's busy time (the union of
its operations' intervals, clipped to the window, as ``trace.summarise``
computes it) spent in operations launched while one of its host ranges
was open: the profiler links each device operation to the host operation
that launched it. (The device range the profiler gives a span covers only
the operations launched directly in it, not in the spans nested inside,
so it is not used.)

The interval arithmetic is the pure functions at the top; :func:`read`
takes them to a profiler's events, and :func:`run_cell` runs one cell's
``--trace 1`` run with the program's spans on around the window
(``bench/trace_spans.py`` is its command line).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

from . import trace

DIGEST = "bench.digest"
LOCAL = ("local.sort", "local.unique", "local.groupby", "local.join", "local.anti_join")
# a layer's device time: busy time inside any of its spans and outside the
# spans it leaves to another layer
LAYERS = {
    "partition": (("partition.hash", "partition.range"), ()),
    "shuffle": (("shuffle",), ()),
    "shuffle_buffers": (("shuffle.buffers",), ()),
    "exchange": (("shuffle",), ("shuffle.buffers", "compact")),
    "compact": (("compact",), ()),
    "local": (LOCAL, ("compact",)),
}


def merge(intervals) -> list[list[float]]:
    """The union of ``(start, end)`` intervals, in any order, as sorted
    disjoint ``[start, end]`` pairs (``trace._union``); empty intervals
    drop out."""
    return trace._union(sorted((s, e) for s, e in intervals if e > s))[1]


def subtract(a, b) -> list[list[float]]:
    """Merged intervals ``a`` less merged intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append([s, b[k][0]])
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Total length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def inside(busy, include, exclude=()) -> float:
    """Length of ``busy`` (merged) inside the union of ``include`` and
    outside the union of ``exclude`` (``(start, end)`` intervals each)."""
    return overlap(busy, subtract(merge(include), merge(exclude)))


def open_at(ranges, points) -> list[list[str]]:
    """For each point, the names of the ``(start, end, name)`` ranges open
    at it (start <= point < end), outermost first: of two ranges with one
    start, the longer encloses the other."""
    rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: list[list[str]] = [[] for _ in points]
    active, i = [], 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        p = points[k]
        while i < len(rs) and rs[i][0] <= p:
            active.append(rs[i])
            i += 1
        active = [r for r in active if r[1] > p]
        out[k] = [r[2] for r in active]
    return out


def idle_by_span(gaps, ranges, outside="outside any program span") -> dict:
    """Idle time summed by the innermost ``(start, end, name)`` range open
    when each ``(start, length)`` gap began."""
    out: dict = defaultdict(float)
    for (_, g), names in zip(gaps, open_at(ranges, [at for at, _ in gaps])):
        out[names[-1] if names else outside] += g
    return dict(out)


def split(busy, ranges: dict, gaps=(), host=()) -> dict:
    """Busy time by span name and by layer (``LAYERS``), the share of the
    busy time outside the harness's digests that falls inside a program
    span (``coverage``), and the idle time by host span. ``busy`` is the
    merged device intervals, ``ranges`` the intervals of each span name,
    ``host`` the host ``(start, end, name)`` ranges of the program's spans."""
    busy_s = sum(e - s for s, e in busy)
    program = [r for name, rs in ranges.items() if name != DIGEST for r in rs]
    digest = ranges.get(DIGEST, ())
    outside_digest = busy_s - inside(busy, digest)
    return {
        "busy": busy_s,
        "by_span": {name: inside(busy, rs) for name, rs in ranges.items()},
        "by_layer": {layer: inside(busy, [r for n in inc for r in ranges.get(n, ())],
                                   [r for n in exc for r in ranges.get(n, ())])
                     for layer, (inc, exc) in LAYERS.items()},
        "coverage": inside(busy, program, digest) / outside_digest if outside_digest > 0 else None,
        "idle_by_span": idle_by_span(gaps, host),
    }


def events(prof) -> list[tuple]:
    """``(name, on_device, start_ns, end_ns, correlation, linked)`` for
    every event of a finished profiler session, from its raw results,
    where each device operation carries the ``correlation`` of the host
    operation that launched it as ``linked`` (0 on host operations); not
    every torch keeps that link on its ``FunctionEvent``."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(), e.correlation_id(),
             e.linked_correlation_id()) for e in prof.profiler.kineto_results.events()]


def read(evs, names) -> dict:
    """The window's split by the program's spans ``names`` (and the
    harness's digests), in seconds, from :func:`events`: each device
    operation belongs to every span open on the host when the host
    operation that launched it began. ``linked_share`` is the share of the
    busy time whose launch the trace holds (the rest counts outside every
    span); ``kernels`` is device time by (innermost span, operation
    name)."""
    names = set(names) | {DIGEST}
    host = [e for e in evs if not e[1]]
    host_names = {e[0] for e in host}
    win = [e for e in host if e[0] == trace.WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {trace.WINDOW!r} range")
    w0, w1 = win[0][2], win[0][3]

    def clip(e):
        return max(e[2], w0), min(e[3], w1)

    hosts = [(*clip(e), e[0]) for e in host if e[0] in names]
    # a device range named like a host range is the host annotation's shadow
    ops = [(*clip(e), e[0], e[5]) for e in evs if e[1] and e[0] not in host_names
           and not e[0].startswith(trace._NOT_DEVICE_WORK)]
    ops = [o for o in ops if o[1] > o[0]]
    busy = merge((s, t) for s, t, _, _ in ops)
    launched = {e[4]: e[2] for e in host if e[5] == 0}
    at = [launched.get(c) for *_, c in ops]
    ranges: dict = defaultdict(list)
    kernels: dict = defaultdict(float)
    for (s, t, name, _), stack in zip(ops, open_at(hosts, [w0 - 1 if a is None else a
                                                          for a in at])):
        for n in set(stack):
            ranges[n].append((s, t))
        kernels[(stack[-1] if stack else "", name[:80])] += t - s
    busy_ns = sum(t - s for s, t in busy)
    linked = overlap(busy, merge((s, t) for (s, t, _, _), a in zip(ops, at) if a is not None))
    gaps = [(s, t - s) for s, t in subtract([[w0, w1]], busy)]
    out = split(busy, ranges, gaps, [h for h in hosts if h[1] > h[0]])
    return {**{k: v if k == "coverage" else _seconds(v) for k, v in out.items()},
            "linked_share": linked / busy_ns if busy_ns else None,
            "kernels": sorted(([sp, k, v / 1e9] for (sp, k), v in kernels.items()),
                              key=lambda x: -x[2])}


def _seconds(v):
    """Nanoseconds (the profiler's raw unit) to seconds, through dicts."""
    return {k: _seconds(x) for k, x in v.items()} if isinstance(v, dict) else v / 1e9


def program_readings(spans, iterations: int, split_s: dict | None) -> dict:
    """What the spans read per iteration of the window: each layer's
    device time (ms; None without a device trace), the shuffles' fill
    (live rows over slots, %), and the mean host time of ``plan.build``
    (ms, lazy plans only)."""
    out: dict = {}
    busy = split_s is not None and split_s["busy"] > 0
    for layer in ("partition", "shuffle", "shuffle_buffers", "compact", "local"):
        out[f"dev_ms.{layer}"] = (split_s["by_layer"][layer] * 1e3 / iterations
                                  if busy and iterations else None)
    shuffles = [s for s in spans if s.name == "shuffle"]
    slots = sum(s.attrs["slots"] for s in shuffles)
    rows = sum(int(s.attrs["rows"]) for s in shuffles)
    out["shuffle_fill_pct"] = 100.0 * rows / slots if slots else None
    builds = [s.duration_s for s in spans if s.name == "plan.build"]
    out["host_ms.plan_build"] = sum(builds) / len(builds) * 1e3 if builds else None
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float, **kw) -> dict:
    """``cell.run_cell`` traced, with the program's spans on around the
    window: the result line, plus under ``"spans"`` the window's split
    (:func:`read`), :func:`program_readings`, and the share of the busy
    time outside the digests that a program span holds."""
    from repro_torch.obs import trace as program

    from . import cell

    got: dict = {}
    base_profiler, base_summarise = trace.profiler, trace.summarise

    @contextlib.contextmanager
    def profiler():
        with program.tracing():
            mark = program.mark()
            with base_profiler() as prof:
                yield prof
            got["spans"] = program.get_trace(mark).spans

    def summarise(prof, top: int = 10):
        got["split"] = read(events(prof), {s.name for s in got["spans"]})
        return base_summarise(prof, top)

    trace.profiler, trace.summarise = profiler, summarise
    try:
        res = cell.run_cell(root, workload, seed, seconds, True, **kw)
    finally:
        trace.profiler, trace.summarise = base_profiler, base_summarise
    sp = got["split"]
    res["spans"] = {**program_readings(got["spans"], res["attempted"], sp),
                    "coverage_pct": None if sp["coverage"] is None else 100 * sp["coverage"],
                    "linked_share": sp["linked_share"], "by_span_s": sp["by_span"],
                    "by_layer_s": sp["by_layer"], "idle_by_span_s": sp["idle_by_span"],
                    "kernels": sp["kernels"][:40]}
    return res
