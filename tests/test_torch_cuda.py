"""The port's Hopper kernels on the card.

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (bit for bit; float sums on integer-valued inputs), and the DDF
slice on the card against the same slice on the CPU. Every test needs a
CUDA device and skips without one. This file imports neither jax nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import time
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import DDF, DDFContext
from repro_torch.data import uniform_table
from repro_torch.kernels import ops, registry

AGGS = {"c1": ("sum", "min", "max", "count", "mean")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 100_003])
def test_hash_kernel_matches_plain_on_card(cuda_device, n):
    k = torch.randint(-2**31, 2**31 - 1, (n, 2), dtype=torch.int32, device=cuda_device)
    registry.reset_launch_counts()
    d, h = ops.hash_partition(k, 8)
    assert registry.launch_counts()["hash_partition_hist"] == 1  # the histogram variant
    registry.reset_launch_counts()
    d_only, none = ops.hash_partition(k, 8, with_hist=False)
    assert registry.launch_counts()["hash_partition"] == 1
    assert registry.launch_counts()["hash_partition_hist"] == 0
    assert none is None and torch.equal(d_only, d)
    d_ref, h_ref = ops.hash_partition(k, 8, force="torch")
    assert torch.equal(d, d_ref) and torch.equal(h, h_ref)


SEG_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.bool, torch.int8, torch.uint8,
              torch.int16, torch.float16)
TILE_ROWS = 4096  # rows per block of the kernel: 256 threads x 16 rows


def _seg_layout(name, rng):
    """Sorted int32 ids and the segment count, shaped to stress the kernel."""
    if name == "runs":  # runs crossing thread (16 rows), warp (512) and tile edges
        lens = np.concatenate([rng.integers(1, 40, 6000),
                               [5000, 4096, 4095, 513, 512, 17, 16, 15, 1]])
        rng.shuffle(lens)
        ids = np.repeat(np.arange(len(lens)) * 2, lens)[: 50 * TILE_ROWS + 77]
        return ids, int(ids.max()) + 3
    if name == "one_segment":  # one segment over many tiles
        ids = np.full(300_001, 1)
        ids[:3] = 0
        ids[-7:] = np.arange(2, 9)
        return ids, 12
    if name == "tile_aligned":  # segments that fill whole tiles and end on tile edges
        ids = np.repeat(np.arange(8) * 3, [TILE_ROWS, 2 * TILE_ROWS, 3 * TILE_ROWS, 1,
                                           TILE_ROWS - 1, TILE_ROWS, 5, TILE_ROWS])
        return ids, int(ids.max()) + 2
    if name == "gaps":  # >= 10M empty ids at the start, in the middle and at the end
        a = np.repeat(np.arange(10_000_000, 10_003_000), 3)
        b = 20_003_000 + np.cumsum(rng.integers(1, 3000, 5000))
        ids = np.concatenate([a, b])
        return ids, int(ids.max()) + 10_000_001
    if name == "out_of_range":  # negative ids first, ids >= num_segments last
        ids = np.sort(np.concatenate([rng.integers(-50, 0, 3000), rng.integers(0, 900, 20000),
                                      rng.integers(1000, 3000, 3000)]))
        return ids, 1000
    if name == "n1":
        return np.array([3]), 7
    if name == "ragged":  # about 20 rows per segment, a ragged row count
        return np.sort(rng.integers(0, 5000, 100_003)), 5003
    if name == "distinct":
        return np.arange(2 * TILE_ROWS + 300) + 5, 2 * TILE_ROWS + 305
    raise ValueError(name)


def _seg_values(dtype, op, shape, rng):
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if dtype == torch.uint32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape).astype(np.int32)).view(dtype)
    if not dtype.is_floating_point:
        ii = torch.iinfo(dtype)
        return torch.from_numpy(rng.integers(ii.min, ii.max + 1, shape)).to(dtype)
    # integer-valued, so that sums are exact in any order (float16 sums stay
    # far inside +-2048); +-0, +-inf and NaNs of both signs, some with
    # payloads, sprinkled in
    if dtype == torch.float16 and op == "sum":
        v = (rng.integers(-2, 3, shape) * (rng.random(shape) < 0.05)).astype(np.float32)
    else:
        v = rng.integers(-1000, 1000, shape).astype(np.float32)
    r = rng.random(shape)
    v[r < 0.05] = 0.0
    v[(r >= 0.05) & (r < 0.1)] = -0.0
    v[(r >= 0.101) & (r < 0.102)] = np.inf
    v[(r >= 0.102) & (r < 0.103)] = -np.inf
    t = torch.from_numpy(v).to(dtype)
    ints = {torch.float32: torch.int32, torch.float16: torch.int16}[dtype]
    nans = ([0x7FC00000, -0x00400000, 0x7FC00001, -0x003FFFF9] if dtype == torch.float32
            else [0x7E00, -0x0200, 0x7E01, -0x01F9])
    nan = torch.from_numpy((r >= 0.1) & (r < 0.101))
    pick = torch.tensor(nans, dtype=ints)[torch.from_numpy(rng.integers(0, 4, shape))]
    t.view(ints)[nan] = pick[nan]
    return t


def _same_bits(got, exp, nan_bits: bool = True):
    """Bit for bit, the sign of zero and each NaN's sign and payload
    included; with ``nan_bits`` off (float sums, whose NaNs CUDA arithmetic
    makes) NaNs compare by position."""
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if got.dtype.is_floating_point:
        nan = got.isnan()
        assert torch.equal(nan, exp.isnan())
        ints = {torch.float32: torch.int32, torch.float16: torch.int16}[got.dtype]
        keep = torch.ones_like(nan) if nan_bits else ~nan
        got, exp = got.view(ints)[keep], exp.view(ints)[keep]
    elif got.dtype == torch.uint32:
        got, exp = got.view(torch.int32), exp.view(torch.int32)
    assert torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3])
@pytest.mark.parametrize("layout", ["runs", "one_segment", "tile_aligned", "gaps",
                                    "out_of_range", "n1", "ragged", "distinct"])
@pytest.mark.parametrize("dtype,op", [(d, o) for d in SEG_DTYPES for o in ("sum", "min", "max")
                                      if not (d == torch.bool and o == "sum")])
def test_segment_kernel_matches_plain_on_card(cuda_device, dtype, op, layout, width):
    rng = np.random.default_rng(zlib.crc32(f"{dtype} {op} {layout} {width}".encode()))
    ids, nseg = _seg_layout(layout, rng)
    seg = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    vals = _seg_values(dtype, op, (len(ids), width), rng).to(cuda_device)
    registry.reset_launch_counts()
    got = ops.segment_reduce(vals, seg, nseg, op=op)
    assert registry.launch_counts()["segment_reduce"] == 1
    _same_bits(got, ops.segment_reduce(vals, seg, nseg, op=op, force="torch"),
               nan_bits=op != "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("layout", ["runs", "one_segment", "tile_aligned"])
@pytest.mark.parametrize("signs", ["pos", "neg", "both"])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_segment_nan_rule_on_card(cuda_device, dtype, op, signs, layout, width):
    """The kernel picks the NaN a segment keeps itself (a walk over the
    segment's rows where it stores a NaN result); the plain version does it
    by other means (``resolve_nans``). NaNs of one sign only make the walk
    run to the segment's last NaN; both signs make it stop at the first
    preferred one. Bits must agree, payloads included."""
    rng = np.random.default_rng(zlib.crc32(f"nan {dtype} {op} {signs} {layout} {width}".encode()))
    ids, nseg = _seg_layout(layout, rng)
    seg = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    ints = {torch.float32: torch.int32, torch.float16: torch.int16}[dtype]
    shape = (len(ids), width)
    vals = torch.from_numpy(rng.integers(-1000, 1000, shape).astype(np.float32)).to(dtype)
    pos = [0x7FC00000, 0x7FC00003, 0x7F800001] if dtype == torch.float32 else [0x7E00, 0x7E03,
                                                                                0x7C01]
    neg = [b - (1 << (31 if dtype == torch.float32 else 15)) for b in pos]  # sign bit set
    pool = {"pos": pos, "neg": neg, "both": pos + neg}[signs]
    nan = torch.from_numpy(rng.random(shape) < 0.002)
    pick = torch.tensor(pool, dtype=ints)[torch.from_numpy(rng.integers(0, len(pool), shape))]
    vals.view(ints)[nan] = pick[nan]
    vals, seg = vals.to(cuda_device), seg.to(cuda_device)
    registry.reset_launch_counts()
    got = ops.segment_reduce(vals, seg, nseg, op=op)
    assert registry.launch_counts()["segment_reduce"] == 1
    exp = ops.segment_reduce(vals, seg, nseg, op=op, force="torch")
    assert bool(exp.isnan().any())
    _same_bits(got, exp)


@pytest.mark.cuda
def test_segment_bool_sum_raises_on_card(cuda_device):
    vals = torch.ones((4, 1), dtype=torch.bool, device=cuda_device)
    seg = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    registry.reset_launch_counts()
    for force in ("cuda", "torch"):
        with pytest.raises(TypeError, match="bool"):
            ops.segment_reduce(vals, seg, 1, force=force)
    assert registry.launch_counts()["segment_reduce"] == 0


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    registry.reset_launch_counts()
    d, h = ops.hash_partition(torch.empty((0, 2), dtype=torch.int32, device=cuda_device), 8)
    out = ops.segment_reduce(torch.empty((0, 1), dtype=torch.int32, device=cuda_device),
                             torch.empty(0, dtype=torch.int32, device=cuda_device), 3, op="min")
    assert registry.launch_counts() == {"hash_partition": 0, "hash_partition_hist": 0,
                                        "segment_reduce": 0, "flash_attention": 0,
                                        "ssd_scan": 0}
    assert d.numel() == 0 and h.tolist() == [0] * 8
    assert out[:, 0].tolist() == [2**31 - 1] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.uint8, np.int16, np.float16])
def test_groupby_of_narrow_dtype_on_card(cuda_device, dtype):
    """The card answers a groupby over each narrow column dtype as the CPU
    does, through the kernel; a bool sum raises on both."""
    rng = np.random.default_rng(3)
    if dtype == np.bool_:
        c1, aggs = rng.random(640) < 0.5, {"c1": ("min", "max", "count")}
    elif dtype == np.float16:  # integer-valued: sums exact in any order
        c1, aggs = rng.integers(-8, 9, 640).astype(dtype), AGGS
    else:
        ii = np.iinfo(dtype)
        c1, aggs = rng.integers(ii.min, ii.max + 1, 640).astype(dtype), AGGS
    t = {"c0": (np.arange(640) % 37).astype(np.int32), "c1": c1}
    outs = {}
    for device in ("cuda", "cpu"):
        ctx = DDFContext(nworkers=2, device=device)
        registry.reset_launch_counts()
        G, _ = DDF.from_numpy(t, ctx).groupby(("c0",), aggs, pre_combine=True)
        outs[device] = (G.partitions(), registry.launch_counts()["segment_reduce"])
        if dtype == np.bool_:
            with pytest.raises(TypeError, match="bool"):
                DDF.from_numpy(t, ctx).groupby(("c0",), {"c1": ("sum",)}, pre_combine=True)
    (gpu, launches), (cpu, none) = outs["cuda"], outs["cpu"]
    assert launches > 0 and none == 0
    for g, c in zip(gpu, cpu):
        for k in c:
            np.testing.assert_array_equal(g[k], c[k])


@pytest.mark.cuda
def test_slice_on_card_goes_through_the_kernels(cuda_device):
    outs = {}
    for device in ("cuda", "cpu"):
        ctx = DDFContext(nworkers=4, device=device)
        L = DDF.from_numpy(uniform_table(4000, 0.5, seed=1), ctx)
        R = DDF.from_numpy(uniform_table(4000, 0.5, seed=2), ctx)
        registry.reset_launch_counts()
        J, _ = L.join(R, on=("c0",), strategy="shuffle")
        G, _ = J.groupby(("c0",), AGGS, pre_combine=True)
        U, _ = G.unique(("c0",))
        outs[device] = (U.partitions(), registry.launch_counts())
    (gpu, launches), (cpu, none) = outs["cuda"], outs["cpu"]
    assert launches["hash_partition"] > 0 and launches["segment_reduce"] > 0
    assert launches["hash_partition_hist"] == 0  # the shuffle builds destinations only
    assert none == {"hash_partition": 0, "hash_partition_hist": 0, "segment_reduce": 0,
                    "flash_attention": 0, "ssd_scan": 0}
    for g, c in zip(gpu, cpu):
        for k in c:
            np.testing.assert_array_equal(g[k], c[k])


@pytest.mark.cuda
def test_lazy_plan_on_card_goes_through_the_kernels(cuda_device):
    """The lazy path on the card: the launches its optimized plan implies
    (two hash_partition for the join, one segment_reduce per partial of the
    elided groupby), the same rows as on the CPU and as the eager steps on
    the card, bit for bit, and a second collect that hits the caches."""
    from repro_torch.expr import col, when
    from repro_torch.plan import executor

    aggs = [col("c1").sum(), col("c1").min(), col("c1").max(), col("c1").count(),
            col("c1").mean().alias("avg"), col("c2").sum()]

    def lazy(L, R):
        return (L.lazy().select(col("c1") < 2**30)
                .with_column("c2", when(col("c1") < 2**29).then(1).otherwise(0))
                .project(["c0", "c1", "c2"])
                .join(R.lazy(), on=("c0",), strategy="shuffle").groupby(("c0",), aggs))

    outs = {}
    for device in ("cuda", "cpu"):
        ctx = DDFContext(nworkers=8, device=device)
        L = DDF.from_numpy(uniform_table(40_000, 0.9, seed=1), ctx)
        R = DDF.from_numpy(uniform_table(40_000, 0.9, seed=2), ctx)
        registry.reset_launch_counts()
        lz = lazy(L, R)
        out = lz.collect()
        outs[device] = (out.to_numpy(), registry.launch_counts())
        assert out.counts.device.type == device
        assert all(int(v.sum()) == 0 for v in lz.last_info.values())
        if device == "cuda":
            before = executor.cache_stats()
            lazy(L, R).collect()
            after = executor.cache_stats()
            assert after["op"]["hits"] == before["op"]["hits"] + 1
            E = (L.select(col("c1") < 2**30)
                 .with_column("c2", when(col("c1") < 2**29).then(1).otherwise(0))
                 .project(["c0", "c1", "c2"]))
            EG, _ = E.join(R, on=("c0",), strategy="shuffle")[0].groupby(("c0",), aggs)
            eager = EG.to_numpy()
    (gpu, launches), (cpu, none) = outs["cuda"], outs["cpu"]
    assert launches == {"hash_partition": 2, "hash_partition_hist": 0, "segment_reduce": 5,
                        "flash_attention": 0, "ssd_scan": 0}
    assert not any(none.values())
    for k in cpu:
        bits = (lambda a: a.view(np.int32)) if cpu[k].dtype.kind == "f" else (lambda a: a)
        np.testing.assert_array_equal(bits(gpu[k]), bits(cpu[k]), err_msg=k)
        np.testing.assert_array_equal(bits(gpu[k]), bits(eager[k]), err_msg=k)


@pytest.mark.cuda
def test_stream_on_card_matches_the_cpu_and_resumes(cuda_device, tmp_path):
    """The streamed groupby (the README's lazy example without its join) on
    the card: the same rows as on the CPU by bits, one hash_partition per
    batch and segment_reduce launches, never the histogram variant; killed
    at half its batches and resumed from its checkpoint, the same rows
    again, the store cleared."""
    from repro_torch.data import write_dataset
    from repro_torch.expr import col, when
    from repro_torch.stream import StreamCheckpoint, scan_dataset
    from repro_torch.testing import FaultPlan, InjectedFault, fault_scope

    ds = write_dataset(uniform_table(400_000, 0.9, seed=1), str(tmp_path / "ds"),
                       chunk_rows=30_000, compress=False)
    aggs = [col("c1").sum(), col("c1").min(), col("c1").max(), col("c1").count(),
            col("c1").mean().alias("avg"), col("c2").sum()]

    def query(device):
        return (scan_dataset(ds, DDFContext(nworkers=8, device=device), batch_rows=80_000)
                .select(col("c1") < 2**30)
                .with_column("c2", when(col("c1") < 2**29).then(1).otherwise(0))
                .groupby(("c0",), aggs))

    outs = {}
    for device in ("cuda", "cpu"):
        registry.reset_launch_counts()
        lz = query(device)
        out = lz.collect_stream()
        assert out.counts.device.type == device and lz.last_info["batches"] == 5
        assert all(int(v.sum()) == 0 for k, v in lz.last_info.items() if "overflow" in k)
        outs[device] = (out.to_numpy(), registry.launch_counts())
    (gpu, launches), (cpu, none) = outs["cuda"], outs["cpu"]
    assert launches["hash_partition"] == 5 and launches["segment_reduce"] > 0
    assert launches["hash_partition_hist"] == 0 and not any(none.values())

    def same(a, b):
        for k in b:
            np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)

    same(gpu, cpu)
    ck = str(tmp_path / "ck")
    registry.reset_launch_counts()
    with fault_scope(FaultPlan(kill_after={"device_op": 2})):
        with pytest.raises(InjectedFault):
            query("cuda").collect_stream(checkpoint_dir=ck, checkpoint_every=2)
    assert StreamCheckpoint(ck).steps() == [0]
    resumed = query("cuda").collect_stream(checkpoint_dir=ck, resume=True).to_numpy()
    same(resumed, gpu)
    assert StreamCheckpoint(ck).steps() == []
    assert registry.launch_counts()["hash_partition_hist"] == 0


# -- the query service on the card -----------------------------------------------------

def _service_scan(ds, ctx, **kw):
    from repro_torch.expr import col
    from repro_torch.stream import scan_dataset

    return (scan_dataset(ds, ctx, **kw).select(col("c1") < 2**30)
            .with_column("k", col("c0") % 1000)
            .groupby(("k",), {"c1": ("sum", "count")}))


def _service_lazy(L, R):
    from repro_torch.expr import col

    return (L.lazy().select(col("c1") < 2**30).join(R.lazy(), on=("c0",), strategy="shuffle")
            .groupby(("c0",), {"c1": ("sum", "count"), "c1_r": ("max",)}))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fair", "round_robin"])
def test_service_interleaved_equals_serial_on_card(cuda_device, tmp_path, policy):
    """Two streamed groupbys, two lazy joins, an eager sort and a select
    through one service on the card: each result equal to its serial run
    by bits, every session DONE, the launch counts the serial runs' sum."""
    from repro_torch.data import write_dataset
    from repro_torch.expr import col
    from repro_torch.service import QueryService

    ctx = DDFContext(nworkers=8, device="cuda")
    ds = write_dataset(uniform_table(400_000, 0.9, seed=1), str(tmp_path / "ds"),
                       chunk_rows=30_000, compress=False)
    L = DDF.from_numpy(uniform_table(40_000, 0.9, seed=1), ctx)
    R = DDF.from_numpy(uniform_table(40_000, 0.9, seed=2), ctx)
    queries = [(_service_scan(ds, ctx, batch_rows=80_000), {"carry_capacity": 1024}),
               (_service_lazy(L, R), {}),
               (_service_scan(ds, ctx, batch_rows=80_000), {"carry_capacity": 1024}),
               (_service_lazy(L, R), {}),
               (lambda: L.sort_values("c1")[0], {}),
               (L.lazy().select(col("c1") < 5000), {})]
    serial, want = [], {k: 0 for k in registry.KERNEL_OPS}
    for q, opts in queries:
        registry.reset_launch_counts()
        out = (q.collect_stream(**opts) if opts else q.collect() if hasattr(q, "collect")
               else q())
        serial.append(out.to_numpy())
        for k, v in registry.launch_counts().items():
            want[k] += v
    registry.reset_launch_counts()
    with QueryService(policy=policy, max_running=4, memory_budget_bytes=1e12) as svc:
        handles = [svc.submit(q, **opts) for q, opts in queries]
        outs = [h.result(timeout=300) for h in handles]
    assert registry.launch_counts() == want
    assert want["hash_partition"] > 0 and want["segment_reduce"] > 0
    assert want["hash_partition_hist"] == 0
    assert svc.stats()["sessions"]["DONE"] == len(queries)
    for got, exp in zip(outs, serial):
        assert got.counts.device.type == "cuda"
        got = got.to_numpy()
        for k in exp:
            np.testing.assert_array_equal(got[k].view(np.uint8), exp[k].view(np.uint8),
                                          err_msg=k)


@pytest.mark.cuda
def test_service_charges_a_lazy_querys_card_time_to_it(cuda_device):
    """A scan-free lazy query returns from ``collect()`` before the card has
    done its work; the service waits for the card at the end of the morsel,
    so the query's ``device_s`` is at least its card time, measured with
    CUDA events around the collect the service itself runs."""
    from repro_torch.service import QueryService

    ctx = DDFContext(nworkers=8, device="cuda")
    L = DDF.from_numpy(uniform_table(8_000_000, 0.9, seed=1), ctx)
    R = DDF.from_numpy(uniform_table(8_000_000, 0.9, seed=2), ctx)
    _service_lazy(L, R).collect()  # warm the plan and op caches
    card, host = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        _service_lazy(L, R).collect()
        host.append(time.perf_counter() - t)
        end.record()
        torch.cuda.synchronize()
        card.append(start.elapsed_time(end) / 1e3)
    # the query leaves most of its card time behind when collect() returns
    assert min(card) > 2 * max(host), (card, host)
    query = _service_lazy(L, R)
    collect = query.collect
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_collect(*a, **kw):  # the service's own run, between two events
        start.record()
        out = collect(*a, **kw)
        end.record()
        return out

    query.collect = timed_collect
    with QueryService() as svc:
        h = svc.submit(query)
        h.result(timeout=300)
    end.synchronize()
    service_card = start.elapsed_time(end) / 1e3
    assert h.morsels == 1 and h.device_s >= service_card, (h.device_s, service_card, card, host)


@pytest.mark.cuda
def test_service_cancelled_scan_returns_its_memory(cuda_device, tmp_path):
    """A streamed groupby with its default carry (rows / P slots per worker)
    cancelled mid-stream: CANCELLED, ``QueryCancelled``, and once the
    service has drained, the card's allocated memory is back within 64 MiB
    of what it was before the submit, though the query held more."""
    import gc

    from repro_torch.data import write_dataset
    from repro_torch.service import QueryCancelled, QueryService, QueryState

    ctx = DDFContext(nworkers=8, device="cuda")
    ds = write_dataset(uniform_table(16_000_000, 0.9, seed=1), str(tmp_path / "ds"),
                       chunk_rows=1_000_000, compress=False)
    slack = 64 * 2**20
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    with QueryService() as svc:
        h = svc.submit(_service_scan(ds, ctx, batch_rows=1_000_000))
        deadline = time.monotonic() + 300
        while h.morsels < 3 and not h.done() and time.monotonic() < deadline:
            time.sleep(0.0005)
        held = torch.cuda.memory_allocated()
        assert svc.cancel(h.qid)
    with pytest.raises(QueryCancelled):
        h.result(timeout=1)
    torch.cuda.synchronize()
    assert h.state == QueryState.CANCELLED and 3 <= h.morsels < 16
    assert held - base > slack and torch.cuda.memory_allocated() - base <= slack, (
        base, held, torch.cuda.memory_allocated())


# -- the rest of the eager DDF (expressions, sort, set ops, windows, ...) -------------

WORDS = np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"])


def _pattern_tables():
    rng = np.random.default_rng(7)

    def table(n, words):
        return {"k": rng.integers(0, n // 3, n).astype(np.int32),
                "v": rng.integers(-1000, 1000, n).astype(np.int32),
                "f": (rng.integers(-200, 200, n) / 4).astype(np.float32),
                "s": words[rng.integers(0, len(words), n)]}

    small = {"a": np.arange(32, dtype=np.int32), "b": np.arange(32, dtype=np.float32) / 2,
             "c": np.arange(32) % 3 == 0}
    return table(4000, WORDS[:6]), table(3000, WORDS[2:]), small


def _col(name):
    from repro_torch.expr import col

    return col(name)


# name -> (call on (L, R, M), expected launches on the card: hash_partition,
# segment_reduce)
PATTERN_OPS = {
    "select": (lambda L, R, M: L.select((_col("v") > 0) & _col("s").ne("bee")), (0, 0)),
    "with_column": (lambda L, R, M: L.with_column("w", (_col("v") * 3 - _col("k")) // 7
                                                  + _col("f") / 2), (0, 0)),
    "project_drop_rename": (lambda L, R, M: L.project(["k", "s", "v"]).drop(["k"])
                            .rename({"v": "x"}), (0, 0)),
    "sort": (lambda L, R, M: L.sort_values("v"), (0, 0)),
    "sort_desc": (lambda L, R, M: L.sort_values("f", descending=True), (0, 0)),
    "union": (lambda L, R, M: L.project(["k"]).union(R.project(["k"]), on=("k",)), (1, 0)),
    "union_string": (lambda L, R, M: L.project(["s"]).union(R.project(["s"]), on=("s",)),
                     (1, 0)),
    # R's s_min padding holds the min identity, recoded by the union
    "union_string_min": (lambda L, R, M: R.groupby(("k",), [_col("s").min()])[0]
                         .project(["s_min"]).union(L.project(["s"]).rename({"s": "s_min"}),
                                                   on=("s_min",)), (2, 2)),
    "difference": (lambda L, R, M: L.difference(R, on=("k",)), (2, 0)),
    "join_string": (lambda L, R, M: L.join(R.rename({"v": "v2", "f": "f2", "k": "k2"}),
                                           on=("s",), strategy="shuffle"), (2, 0)),
    "groupby_exprs": (lambda L, R, M: L.groupby(("k",), [_col("v").max(),
                                                         _col("v").mean().alias("avg")],
                                                pre_combine=True), (1, 6)),
    "agg": (lambda L, R, M: tuple(L.agg(c, op) for c in ("v", "f", "s") for op in
                                  ("min", "max", "count")) + (L.agg("v", "sum"),
                                                              L.agg("f", "mean"), L.length()),
            (0, 0)),
    "rolling_sum": (lambda L, R, M: L.rolling_sum("v", 5), (0, 0)),
    "rolling": (lambda L, R, M: tuple(L.rolling("f", 8, op)[0] for op in
                                      ("sum", "mean", "min", "max")), (0, 0)),
    "rebalance": (lambda L, R, M: L.select(_col("v") > 500).rebalance(), (0, 0)),
    "head": (lambda L, R, M: L.head(1234), (0, 0)),
    "transpose": (lambda L, R, M: M.transpose(), (0, 0)),
}


def _host(x):
    """A result as host data: DDF -> (per-worker partitions, vocabularies),
    info dict -> numpy, scalars as they are."""
    from repro_torch.core import DDF as _DDF

    if isinstance(x, _DDF):
        return ([{k: v[w, : int(x.counts[w])].cpu().numpy() for k, v in x.columns.items()}
                 for w in range(x.ctx.nworkers)], {k: v.words for k, v in x.vocabs.items()})
    if isinstance(x, dict):
        return {k: v.cpu().numpy() for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return np.asarray(x)


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PATTERN_OPS))
def test_pattern_op_on_card_matches_cpu(cuda_device, name):
    """Each DDF method of the patterns slice on the card equals the same
    call on the CPU, bit for bit (integer-valued data: float sums exact),
    and launches the kernels it should."""
    fn, (n_hash, n_seg) = PATTERN_OPS[name]
    tables = _pattern_tables()
    outs, launches = {}, {}
    for device in ("cpu", "cuda"):
        ctx = DDFContext(nworkers=8, device=device)
        ddfs = [DDF.from_numpy(t, ctx) for t in tables]
        registry.reset_launch_counts()
        outs[device] = _host(fn(*ddfs))
        launches[device] = registry.launch_counts()
    assert launches["cpu"] == {k: 0 for k in registry.KERNEL_OPS}
    assert launches["cuda"] == {"hash_partition": n_hash, "hash_partition_hist": 0,
                                "segment_reduce": n_seg, "flash_attention": 0,
                                "ssd_scan": 0}, launches["cuda"]
    _assert_same(outs["cpu"], outs["cuda"], name)


@pytest.mark.cuda
def test_expressions_on_card_match_cpu(cuda_device):
    """The expression lowering's integer division, remainder, powers,
    casts and denormal flush give the same bits on the card as on the
    CPU."""
    from repro_torch.expr import col, to_torch_fn

    rng = np.random.default_rng(3)
    cols = {"i": np.concatenate([[-2**31, 2**31 - 1, 0, -1, 7, -7],
                                 rng.integers(-100, 100, 58)]).astype(np.int32),
            "j": np.concatenate([[0, -1, 0, 0, 2, -3],
                                 rng.integers(-5, 5, 58)]).astype(np.int32),
            "u": rng.integers(0, 256, 64).astype(np.uint8),
            "f": np.concatenate([[0.0, -0.0, np.inf, np.nan, 1e-39, -5e-39],
                                 rng.normal(size=58) * 100]).astype(np.float32),
            "h": rng.normal(size=64).astype(np.float16)}
    exprs = [col("i") // col("j"), col("i") % col("j"), col("u") // 0, col("i") ** col("j"),
             col("f") // col("h"), col("f") % 2.5, col("f") * 1e-30, col("f") / col("h"),
             col("f").cast("int8"), col("h").cast("int16"), col("i") * 300 + col("u"),
             abs(col("i")), -col("u"), (col("f") > 0) * col("f"), col("f") ** 2,
             col("h") ** col("j"), col("i").cast("float16") + col("h")]
    for e in exprs:
        fn = to_torch_fn(e)
        cpu = fn({k: torch.from_numpy(v) for k, v in cols.items()})
        gpu = fn({k: torch.from_numpy(v).to(cuda_device) for k, v in cols.items()}).cpu()
        assert cpu.dtype == gpu.dtype, str(e)
        if cpu.is_floating_point():
            nan = cpu.isnan()
            assert torch.equal(nan, gpu.isnan()), str(e)
            ints = {torch.float32: torch.int32, torch.float16: torch.int16}[cpu.dtype]
            assert torch.equal(cpu[~nan].view(ints), gpu[~nan].view(ints)), str(e)
        else:
            assert torch.equal(cpu, gpu), str(e)


# -- model-layer kernels -------------------------------------------------------------

def _normal(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV,S", [(64, 4, 2, 200), (128, 2, 2, 129), (256, 4, 1, 97)])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=37, softcap=30.0)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, hd, H, KV, S, kwargs):
    """Ragged S (no multiple of the 64-row tile) at every head_dim the kernel
    takes. Float32: summation order only (2e-5, the reference's kernel test
    tolerance); bf16: the bf16 roundings of P and of the output (2e-2)."""
    q = _normal((2, S, H, hd), dtype, cuda_device, 0)
    k = _normal((2, S, KV, hd), dtype, cuda_device, 1)
    v = _normal((2, S, KV, hd), dtype, cuda_device, 2)
    registry.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="torch", **kwargs)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,KV", [(64, 4, 2), (128, 4, 1), (256, 2, 1)])
@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=700, softcap=30.0)])
def test_flash_bf16_tensor_core_kernel_on_card(cuda_device, hd, H, KV, S, kwargs):
    """The bf16 wgmma kernel at a multiple of its 128-row query tile (4096)
    and at a ragged S spanning more than 3 K/V stages (1000), every head_dim,
    KV < H: one counted launch, within bf16's 2e-2 of the plain version."""
    q = _normal((1, S, H, hd), torch.bfloat16, cuda_device, 10)
    k = _normal((1, S, KV, hd), torch.bfloat16, cuda_device, 11)
    v = _normal((1, S, KV, hd), torch.bfloat16, cuda_device, 12)
    registry.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="torch", **kwargs)
    torch.testing.assert_close(got.float(), exp.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,ds,H,G,chunk,L", [(64, 64, 4, 1, 256, 700), (64, 128, 4, 2, 64, 300),
                                               (32, 16, 4, 2, 8, 45), (32, 32, 2, 1, 100, 333),
                                               (64, 64, 4, 2, 100, 345), (32, 128, 4, 2, 1024, 3000),
                                               (64, 16, 2, 2, 1024, 2100)])
def test_ssd_kernel_matches_plain_on_card(cuda_device, dh, ds, H, G, chunk, L):
    """Ragged L (no multiple of the chunk), G > 1, every ds the kernel takes,
    at least 3 chunks at chunks 100 and 1024, the final state checked, one
    counted launch for the three passes. Float32 in another summation order
    over up to chunk * (dh + ds) terms: 1e-4."""
    b = 2
    x = _normal((b, L, H, dh), torch.float32, cuda_device, 3)
    dt = torch.rand((b, L, H), generator=torch.Generator().manual_seed(4)).to(cuda_device) * 0.19 + 0.01
    A = -(torch.rand(H, generator=torch.Generator().manual_seed(5)).to(cuda_device) * 1.5 + 0.5)
    B = _normal((b, L, G, ds), torch.float32, cuda_device, 6)
    C = _normal((b, L, G, ds), torch.float32, cuda_device, 7)
    D = _normal((H,), torch.float32, cuda_device, 8)
    registry.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert registry.launch_counts()["ssd_scan"] == 1
    y_ref, st_ref = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk, force="torch")
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, st_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_model_kernels_refuse_what_they_do_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q16 = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_cuda(q16, q16, q16)
    x = torch.zeros((1, 8, 2, 64), device=cuda_device)
    dt = torch.zeros((1, 8, 2), device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    Bm = torch.zeros((1, 8, 1, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan_cuda(x.double(), dt, A, Bm, Bm, A, chunk=4)
    with pytest.raises(ValueError, match="ds"):
        ssd_scan_cuda(x, dt, A, torch.zeros((1, 8, 1, 24), device=cuda_device),
                      torch.zeros((1, 8, 1, 24), device=cuda_device), A, chunk=4)
    registry.reset_launch_counts()
    ops.flash_attention(torch.zeros((1, 0, 2, 64), device=cuda_device),
                        torch.zeros((1, 0, 2, 64), device=cuda_device),
                        torch.zeros((1, 0, 2, 64), device=cuda_device))
    assert registry.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
def test_smoke_prefill_launches_both_kernels(cuda_device):
    """The zamba2 smoke config with head_dim 64 (the kernel takes 64, 128
    and 256; the smoke config's 16 runs only in the plain version): one
    prefill launches ssd_scan once per layer and flash_attention once per
    shared-block call, and equals the plain versions' prefill (float32)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill

    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), head_dim=64, dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 37), device=cuda_device)
    prefill = make_prefill(model)
    registry.reset_launch_counts()
    nxt, state = prefill(params, model.init_decode_state(2, 64), {"tokens": tokens})
    assert registry.launch_counts()["ssd_scan"] == cfg.n_layers
    assert registry.launch_counts()["flash_attention"] == cfg.n_layers // cfg.shared_attn_every
    assert state["length"] == 37 and nxt.shape == (2,)
    h, _ = model.forward(params, {"tokens": tokens})
    with registry.use_backend("torch"):
        h_ref, _ = model.forward(params, {"tokens": tokens})
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [129, 1000])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=37, softcap=30.0)])
def test_flash_head_dim_80_matches_plain_on_card(cuda_device, dtype, S, kwargs):
    """head_dim 80 (stablelm-3b): the wrapper zero-pads q, k, v to 128 and
    keeps 80 output columns, with the scale of the true head_dim. One
    counted launch, within the tolerances of the other head_dims."""
    q = _normal((2, S, 4, 80), dtype, cuda_device, 20)
    k = _normal((2, S, 2, 80), dtype, cuda_device, 21)
    v = _normal((2, S, 2, 80), dtype, cuda_device, 22)
    registry.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    exp = ops.flash_attention(q, k, v, force="torch", **kwargs)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-moe-1b-a400m", "llava-next-mistral-7b",
                                  "whisper-tiny"])
def test_family_prefill_launches_flash_in_every_layer_on_card(cuda_device, arch):
    """Each new family's smoke config with head_dim 64 (the smoke configs'
    16 runs only in the plain version), float32: one prefill launches
    flash_attention once per self-attention layer (whisper's encoder too;
    cross-attention launches none), and the forward equals the plain
    versions' to 1e-4."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill

    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=64, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 37), device=cuda_device,
                                     generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((2, cfg.n_patches, cfg.d_model), device=cuda_device,
                                            generator=gen)
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn((2, cfg.enc_positions, cfg.d_model),
                                          device=cuda_device, generator=gen)
    registry.reset_launch_counts()
    nxt, state = make_prefill(model)(params, model.init_decode_state(2, 64), batch)
    torch.cuda.synchronize()
    enc = cfg.n_enc_layers if cfg.family == "encdec" else 0
    assert registry.launch_counts()["flash_attention"] == cfg.n_layers + enc
    assert registry.launch_counts()["ssd_scan"] == 0
    assert state["length"] == 37 and nxt.shape == (2,)
    h, aux = model.forward(params, batch)
    with registry.use_backend("torch"):
        h_ref, aux_ref = model.forward(params, batch)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux, aux_ref, atol=1e-5, rtol=1e-5)


# -- the model kernels under autograd ----------------------------------------------------

def _grad_close(got, exp, dtype) -> None:
    """Each gradient within 2e-2 (bf16) or 1e-4 (float32) of its largest
    magnitude."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g is not None and g.dtype == e.dtype and g.shape == e.shape, i
        scale = float(e.float().abs().max())
        assert float((g.float() - e.float()).abs().max()) <= tol * scale, (i, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV,S,kwargs", [
    (64, 4, 4, 700, dict(causal=True)),
    (128, 4, 2, 1100, dict(causal=True, window=300)),
    (64, 4, 1, 600, dict(causal=True, softcap=30.0)),
    (256, 2, 1, 333, dict(causal=False)),
    (64, 8, 2, 1536, dict(causal=True, window=700, softcap=20.0)),
])
def test_flash_gradients_on_card_match_plain_autograd(cuda_device, dtype, hd, H, KV, S, kwargs):
    """``ops.flash_attention`` on the card with inputs that require grad: one
    counted kernel launch in the forward (``FlashAttentionFn``), none in the
    backward, and the gradients of q, k, v and of a weight ``w`` on the
    output (the loss ``sum(out * w)``, so that ``w``'s gradient is the
    kernel's output) equal to plain autograd's (``force="torch"``): causal,
    windowed, softcapped, GQA, bidirectional, several query blocks of 512."""
    q = _normal((2, S, H, hd), dtype, cuda_device, 20).requires_grad_()
    k = _normal((2, S, KV, hd), dtype, cuda_device, 21).requires_grad_()
    v = _normal((2, S, KV, hd), dtype, cuda_device, 22).requires_grad_()
    w = _normal((2, S, H, hd), dtype, cuda_device, 23).requires_grad_()
    registry.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kwargs)
    got = torch.autograd.grad((out * w).sum(), (q, k, v, w))
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    out_ref = ops.flash_attention(q, k, v, force="torch", **kwargs)
    exp = torch.autograd.grad((out_ref * w).sum(), (q, k, v, w))
    assert registry.launch_counts()["flash_attention"] == 1
    _grad_close(got, exp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,ds,H,G,chunk,L", [(64, 64, 4, 1, 256, 700), (32, 16, 4, 2, 8, 45),
                                               (64, 128, 4, 2, 64, 300)])
def test_ssd_gradients_on_card_match_plain_autograd(cuda_device, dh, ds, H, G, chunk, L):
    """``ops.ssd_scan`` on the card with all six inputs requiring grad: one
    counted launch (``SsdScanFn``), and the gradients of x, dt, A, B, C and
    D and of weights on y and on the final state (the loss ``sum(y * wy) +
    sum(state * ws)``, so that their gradients are the kernel's outputs)
    equal to plain autograd's (float32, 1e-4 of each gradient's largest
    magnitude)."""
    b = 2
    gen = torch.Generator().manual_seed(24)
    ins = [_normal((b, L, H, dh), torch.float32, cuda_device, 25),
           (torch.rand((b, L, H), generator=gen) * 0.19 + 0.01).to(cuda_device),
           -torch.rand(H, generator=gen).to(cuda_device) - 0.5,
           _normal((b, L, G, ds), torch.float32, cuda_device, 26),
           _normal((b, L, G, ds), torch.float32, cuda_device, 27),
           _normal((H,), torch.float32, cuda_device, 28)]
    ins = [t.requires_grad_() for t in ins]
    wy = _normal((b, L, H, dh), torch.float32, cuda_device, 29).requires_grad_()
    ws = _normal((b, H, dh, ds), torch.float32, cuda_device, 30).requires_grad_()
    registry.reset_launch_counts()
    y, state = ops.ssd_scan(*ins, chunk=chunk)
    got = torch.autograd.grad((y * wy).sum() + (state * ws).sum(), ins + [wy, ws])
    torch.cuda.synchronize()
    assert registry.launch_counts()["ssd_scan"] == 1
    y2, state2 = ops.ssd_scan(*ins, chunk=chunk, force="torch")
    exp = torch.autograd.grad((y2 * wy).sum() + (state2 * ws).sum(), ins + [wy, ws])
    _grad_close(got, exp, torch.float32)


@pytest.mark.cuda
def test_raw_model_kernels_refuse_grad_inputs_on_card(cuda_device):
    """A direct kernel call would return a tensor with no graph: with grad
    mode on and an input requiring grad it raises; under ``no_grad`` it
    launches."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = _normal((1, 64, 2, 64), torch.bfloat16, cuda_device, 31).requires_grad_()
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flash_attention_cuda(q, q, q)
    x = _normal((1, 64, 2, 32), torch.float32, cuda_device, 32)
    dt = torch.full((1, 64, 2), 0.1, device=cuda_device)
    A = torch.full((2,), -1.0, device=cuda_device, requires_grad=True)
    Bm = _normal((1, 64, 1, 16), torch.float32, cuda_device, 33)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        ssd_scan_cuda(x, dt, A, Bm, Bm, A.detach(), chunk=16)
    registry.reset_launch_counts()
    with torch.no_grad():
        flash_attention_cuda(q, q, q)
        ssd_scan_cuda(x, dt, A, Bm, Bm, A, chunk=16)
    assert registry.launch_counts()["flash_attention"] == 1
    assert registry.launch_counts()["ssd_scan"] == 1


@pytest.mark.cuda
def test_train_step_on_card_launches_both_kernels_twice_per_layer(cuda_device):
    """One train step of the zamba2 smoke config at head_dim 64 on the card:
    every layer recomputed in the backward, so ssd_scan launches twice per
    Mamba layer and flash_attention twice per shared-block call; the loss
    and the updated parameters are finite, and the loss equals the plain
    versions' (float32)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train.train_step import (TrainHParams, init_train_state, make_loss_fn,
                                              make_train_step)

    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), head_dim=64, dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "loss_mask": torch.ones((2, 40), device=cuda_device)}
    with torch.no_grad(), registry.use_backend("torch"):
        plain, _ = make_loss_fn(model, TrainHParams())(state["params"], batch)
    registry.reset_launch_counts()
    state, m = make_train_step(model, TrainHParams())(state, batch)
    torch.cuda.synchronize()
    shared = cfg.n_layers // cfg.shared_attn_every
    assert registry.launch_counts()["ssd_scan"] == 2 * cfg.n_layers
    assert registry.launch_counts()["flash_attention"] == 2 * shared
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
    assert abs(float(m["loss"]) - float(plain)) <= 1e-4 * abs(float(plain))
    ssm = state["params"]["layers"]["ssm"]
    assert all(bool(torch.isfinite(t).all()) for t in ssm.values() if isinstance(t, torch.Tensor))


@pytest.mark.cuda
def test_meta_peak_predicts_a_train_step_on_card(cuda_device):
    """The dry run's tracked peak on the meta device against
    ``max_memory_allocated`` of the same train step on the card: olmo-1b at
    full width, 2 layers, 2 x 1024, one microbatch; the step's memory above
    what was resident before it within 15% of the prediction."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell, input_specs
    from repro_torch.models import build_model
    from repro_torch.train.train_step import TrainHParams, init_train_state, make_train_step

    cell = ShapeCell("train_4k", 1024, 2, "train")
    rec = dryrun.run_cell("olmo-1b", "train_4k", cell=cell, microbatches=1,
                          overrides={"n_layers": 2}, save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = dataclasses.replace(get_config("olmo-1b"), n_layers=2)
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    batch = input_specs(cfg, cell, device="cuda")
    batch["tokens"].random_(0, cfg.vocab_size)
    batch["labels"].random_(0, cfg.vocab_size)
    batch["loss_mask"].fill_(1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    registry.reset_launch_counts()
    make_train_step(model, TrainHParams(microbatches=1))(state, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    predicted = rec["memory"]["peak_bytes"] - rec["memory"]["resident_bytes"]
    assert registry.launch_counts()["flash_attention"] == rec["kernels"]["flash_attention"]["calls"]
    assert abs(measured - predicted) <= 0.15 * predicted, (measured, predicted)


@pytest.mark.cuda
def test_dryrun_ddf_on_card_equals_the_cpu(cuda_device):
    """The paper's join at P = 8 and 2000 rows per worker on the card: two
    hash_partition launches, no histogram or segment_reduce, no overflow,
    the CPU run's joined rows, and both hash launches counted by their
    formula."""
    from repro_torch.configs.paper_cylon import smoke_config
    from repro_torch.kernels.hash_partition import hash_work
    from repro_torch.launch import dryrun_ddf

    left, right = dryrun_ddf.paper_tables(dryrun_ddf.WORKERS, smoke_config())
    card = dryrun_ddf.run(left, right, save=False, verbose=False)
    cpu = dryrun_ddf.run(left, right, device="cpu", save=False, verbose=False, iters=1)
    assert {k: card["launches"][k] for k in ("hash_partition", "hash_partition_hist",
                                             "segment_reduce")} == \
        {"hash_partition": 2, "hash_partition_hist": 0, "segment_reduce": 0}
    assert card["join_rows"] == cpu["join_rows"] > 0
    assert not any(card["overflow"].values())
    one = hash_work(dryrun_ddf.WORKERS * card["capacity"], 1, dryrun_ddf.WORKERS, False)[1]
    assert card["kernels"]["hash_partition"] == {"calls": 2, "flops": 0.0, "bytes": 2 * one}
    assert card["join_ms"] > 0 and card["transpose_ms"] > 0
    assert card["memory"]["bytes_per_device"] > 0


@pytest.mark.cuda
def test_rescale_state_on_card_gives_views_with_equal_bits(cuda_device, tmp_path):
    """A zamba2 smoke-config train state saved from the card and rescaled
    onto a (4, 2) mesh on the card: every leaf equal by bits, every
    coordinate's shard a view of its leaf on ``cuda``."""
    from repro_torch import sharding
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint
    from repro_torch.train.elastic import rescale_state
    from repro_torch.train.train_step import init_train_state, train_state_specs
    from repro_torch.tree import flatten, leaves

    model = build_model(get_smoke_config("zamba2-1.2b"))
    state = init_train_state(model, torch.Generator(device="cuda").manual_seed(0))
    checkpoint.save(str(tmp_path), 5, state)
    rs, step = rescale_state(str(tmp_path), 5, train_state_specs(model), MeshLayout.of((4, 2)))
    assert step == 5
    assert all(a.device.type == "cuda" and torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(leaves(rs), leaves(state)))
    flat, specs = flatten(rs), flatten(rs.specs)
    for coord in rs.plan.coords():
        views = flatten(rs.local(coord))
        for key, v in views.items():
            assert v.device.type == "cuda"
            assert v.untyped_storage().data_ptr() == flat[key].untyped_storage().data_ptr()
            assert tuple(v.shape) == sharding.local_shape(flat[key].shape, specs[key], rs.plan)
        assert rs.bytes_per_device() == sum(v.numel() * v.element_size() for v in views.values())


@pytest.mark.cuda
def test_grouped_slice_over_one_nccl_rank_equals_one_card(cuda_device, tmp_path):
    """The slice (joins, groupbys, unique) over a one-rank NCCL group on
    cuda:0, in a spawned process: every worker's rows and counters equal
    by bits to the one-card engine's, with the same kernel launches."""
    import test_torch_dist_cases as cases

    rows = 2000
    out = tmp_path / "rank0.npz"
    cases.spawn(cases.card_rank_main, (str(tmp_path / "store"), str(out), rows), 1, 300.0)
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    registry.reset_launch_counts()
    exp = cases.slice_cases(DDFContext(nworkers=cases.P), cases.uniform_layout(rows))
    exp.update({f"launches|value|{k}": np.array(v)
                for k, v in registry.launch_counts().items()})
    assert int(exp["launches|value|hash_partition"]) > 0
    assert int(exp["launches|value|hash_partition_hist"]) == 0
    assert set(got) == set(exp), sorted(set(got) ^ set(exp))
    for k, v in exp.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


@pytest.mark.cuda
def test_grouped_lazy_and_stream_over_one_nccl_rank_equal_one_card(cuda_device, tmp_path):
    """The README lazy collect and a streamed groupby (4 batches) over a
    one-rank NCCL group on cuda:0, in a spawned process: every worker's rows
    and counters equal by bits to the one-card engine's, with the same
    kernel launches and no histogram launch."""
    import test_torch_dist_cases as cases
    from repro_torch.data import write_dataset

    rows = 2000
    layout = cases.uniform_layout(rows)
    np.savez(tmp_path / "layout.npz", **layout)
    left = {k.split("|")[1]: v for k, v in layout.items()
            if k.startswith("left|") and k != "left|counts"}
    counts = layout["left|counts"]
    cap = len(left["c0"]) // cases.P
    live = np.concatenate([np.arange(w * cap, w * cap + counts[w]) for w in range(cases.P)])
    write_dataset({k: v[live] for k, v in left.items()}, str(tmp_path / "left"),
                  chunk_rows=3000)
    out = tmp_path / "rank0.npz"
    cases.spawn(cases.card_plan_rank_main, (str(tmp_path / "store"), str(out),
                                            str(tmp_path / "layout.npz"), str(tmp_path)),
                1, 300.0)
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    exp = cases.card_plan_cases(DDFContext(nworkers=cases.P), layout, str(tmp_path))
    for what in ("lazy", "stream"):
        assert int(exp[f"launches {what}|value|hash_partition"]) > 0, what
        assert int(exp[f"launches {what}|value|segment_reduce"]) > 0, what
        assert int(exp[f"launches {what}|value|hash_partition_hist"]) == 0, what
    assert int(exp["card stream|value|batches"]) == 4
    assert set(got) == set(exp), sorted(set(got) ^ set(exp))
    for k, v in exp.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k
