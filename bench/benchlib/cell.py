"""One run of one cell: set-up, the measured window, the per-layer readings
and the check against the reference.

The cell's configuration names its generator, its traffic mix names its
pipeline and its driver; each is a file found by that name (``spec``).
Set-up draws the tables on the device from the seed and warms every shape
the traffic uses; the driver then offers load for ``seconds`` and reduces
each answer to a digest on the device. After the window, with the peak
read and the program's state freed, the reference works the answer out
again from the same inputs. Spans, the profiler and the kernels' shape
records run in ``--trace 1`` runs only.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch

from . import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is neither)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def use_cache_dirs(root: str) -> None:
    """Keep the harness's kernel cache (Triton's, for the fused digests) at a
    fixed path inside the checkout, so only a checkout's first run builds."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".bench_cache", "triton")


def _sync_of(device):
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float | None = None, overrides: dict | None = None,
             patch=None, control: bool = False) -> dict:
    """Run ``workload`` once and return its result line as a dict.

    ``overrides`` replaces configuration values (tests run the cells at a
    size the CPU holds); ``patch`` is a context manager put around the
    set-up and the window (tests break the program underneath with it);
    ``control=True`` judges the reference's control in the program's place.
    """
    from repro_torch.core import DDF, DDFContext, from_arrays
    from repro_torch.kernels import registry
    from repro_torch.plan import executor

    t0 = time.perf_counter() if t0 is None else t0
    bench = spec.load(root)
    cell = spec.workload(bench, workload)
    cfg = {**spec.config(bench, root, cell["config"]), **(overrides or {})}
    traffic = spec.traffic(cell["traffic"])
    pipe = spec.module("pipelines", traffic["pipeline"]).Pipeline(traffic)
    driver = spec.module("drivers", traffic["driver"])
    on_card = torch.device(device).type == "cuda"
    sync = _sync_of(device)

    ctx = DDFContext(nworkers=cfg["workers"], device=device)
    inputs = spec.module("generators", cfg["generator"]).tables(cfg, seed, device)

    def ddf(cols):
        t = from_arrays(cols, device=device)
        return DDF(t.columns, t.nvalid, ctx)

    frames = {name: ddf(cols) for name, cols in inputs.items()}
    span = trace.Spans(sync) if traced else trace.untimed
    calls, summary = {}, None
    with patch() if patch else contextlib.nullcontext():
        for _ in range(traffic["warmup_iterations"]):
            pipe.digest(pipe.run(frames, trace.untimed))
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        caches = executor.cache_stats()
        with contextlib.ExitStack() as stack:
            if traced:
                stack.enter_context(trace.kernel_calls(calls))
                prof = stack.enter_context(trace.profiler())
            with torch.profiler.record_function(trace.WINDOW):
                win = driver.window(pipe, frames, seconds, span, sync)
        if traced:
            summary = trace.summarise(prof)
            del prof
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    launches = registry.launch_counts()
    values = {**win["values"], "peak_mem_gib": peak / 2**30, "setup_s": win["start"] - t0}
    obs = {"spans": dict(span.seconds) if traced else {}, "trace": summary,
           "kernel_calls": calls, "launches": launches,
           "plan_cache": (caches["plan"], executor.cache_stats()["plan"])}

    # the check: the program's state freed, the reference from the same inputs
    got = pipe.answer(win["last"]) if win["last"] is not None else None
    digests = win["digests"]
    del frames, ctx, win["last"]
    if on_card:
        torch.cuda.empty_cache()
    flat = {name: {c: v.reshape(-1) for c, v in cols.items()} for name, cols in inputs.items()}
    exp = pipe.reference(flat)
    if control:  # the control's answer stands where the program's stood
        got = pipe.reference(flat, control=True)
        digests = [pipe.reference_digest(got)]
    want = pipe.reference_digest(exp).cpu()
    seen = torch.stack(digests).cpu() if digests else want.new_empty((0, want.numel()))
    checks = {"failed": win["failed"], "overflow": win["overflow"],
              "iterations_off": int((seen != want).any(dim=1).sum())}
    if got is None:
        checks["answer_missing"] = 1
    else:
        checks.update(pipe.compare(got, exp))
    correct = all(v <= 0 for v in checks.values())

    res = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"]}
    if traced:
        metrics = {}
        for m in spec.per_layer(bench, workload):
            v = spec.metric_reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end(bench, workload)}
    res["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu", "count": 1,
           "memory_peak_bytes": peak}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        res["breakdown"] = summary["breakdown"]
    res["device"] = dev
    res["launches"] = {k: v for k, v in launches.items() if k in ("hash_partition",
                                                                  "segment_reduce")}
    if traced:  # the harness's own share of the window: the digests' span
        res["spans_ms"] = {k: sum(v) / len(v) * 1e3 for k, v in obs["spans"].items() if v}
    if win["error"]:
        res["error"] = win["error"][:2000]
    res["checks"] = {k: {"value": v, "limit": 0} for k, v in checks.items()}
    return res
