"""What a ``--trace 1`` run reads: the benchmark's own spans, the shapes of
the dataframe kernels' calls, and ``torch.profiler``'s trace of the window,
summarised in memory (nothing is exported).

From the trace: the device's busy time (the union of the intervals of its
kernels, copies and sets, clipped to the window), each device operation's
time by name, and the longest idle gaps, each named by the innermost host
operation that was running when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

WINDOW = "bench.window"
# CUPTI's own bookkeeping, listed as device events; no work runs in them
_NOT_DEVICE_WORK = ("Command Buffer Full", "Activity Buffer Request")


def untimed(name: str, fn):
    """The span of a ``--trace 0`` run: the call alone, with no wait for the
    device and no annotation."""
    return fn()


class Spans:
    """Host-clock spans around calls into the program, each ending in a wait
    for the device, kept in memory by name (``--trace 1`` runs only)."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = defaultdict(list)

    def __call__(self, name: str, fn):
        with torch.profiler.record_function(f"bench.{name}"):
            t = time.perf_counter()
            out = fn()
            self.sync()
            self.seconds[name].append(time.perf_counter() - t)
        return out


@contextlib.contextmanager
def kernel_calls(calls: dict):
    """Record the shape of every call of the dataframe kernels' launchers,
    ``repro_torch.kernels.ops.hash_partition_cuda`` and
    ``segment_reduce_cuda``, into ``calls``; arguments and results pass
    through unchanged. Only calls that launch (rows, width and segments
    above 0) are recorded."""
    from repro_torch.kernels import ops

    hp, sr = ops.hash_partition_cuda, ops.segment_reduce_cuda

    def hash_rec(keys, num_partitions, with_hist=True):
        n, n_cols = keys.shape[0], 1 if keys.ndim == 1 else keys.shape[1]
        if n:
            calls.setdefault("hash_partition", []).append((n, n_cols, num_partitions, with_hist))
        return hp(keys, num_partitions, with_hist=with_hist)

    def seg_rec(values, seg_ids, num_segments, op="sum"):
        n, width = values.shape[0], (values.shape[1] if values.ndim > 1 else 1)
        if n and width and num_segments:
            calls.setdefault("segment_reduce", []).append(
                (n, width, num_segments, values.element_size()))
        return sr(values, seg_ids, num_segments, op)

    ops.hash_partition_cuda, ops.segment_reduce_cuda = hash_rec, seg_rec
    try:
        yield calls
    finally:
        ops.hash_partition_cuda, ops.segment_reduce_cuda = hp, sr


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals) -> tuple[float, list]:
    """Total length of the union of sorted ``(start, end)`` intervals, and
    the merged intervals."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def summarise(prof, top: int = 10) -> dict:
    """The window's trace in seconds: ``window_s``, ``busy_s``,
    ``kernel_s`` (device time by operation name), and ``breakdown``
    (``device_ops`` and ``idle_gaps``, at most ``top`` each)."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in events:
        (device if e.device_type == cuda else host).append(e)
    host_names = {e.name for e in host}
    win = [e for e in host if e.name == WINDOW]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans = []
    kernel_s = defaultdict(float)
    for e in device:
        # a device range named like a host range is the host annotation's shadow
        if e.name in host_names or e.name.startswith(_NOT_DEVICE_WORK):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            spans.append((s, t))
            kernel_s[e.name] += (t - s) / 1e6
    spans.sort()
    busy_us, merged = _union(spans)
    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((s - prev, prev))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((w1 - prev, prev))
    gaps.sort(reverse=True)
    host_ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                      if e.name != WINDOW)
    starts = [h[0] for h in host_ops]

    def doing(at: float) -> str:
        i = bisect.bisect_right(starts, at)
        for j in range(i - 1, max(i - 4096, -1), -1):  # the latest start that still covers it
            if host_ops[j][1] > at:
                return host_ops[j][2]
        return "host, outside any traced operation"

    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "kernel_s": dict(kernel_s),
            "breakdown": {"device_ops": [[k, v] for k, v in ops[:top]],
                          "idle_gaps": [[doing(at), g / 1e6] for g, at in gaps[:top]]}}
