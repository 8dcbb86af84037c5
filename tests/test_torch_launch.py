"""The port's launch/ against the reference's, on the CPU.

- ``shapes``: ``SHAPES``, ``cell_applicable`` and ``input_specs`` (meta
  tensors against ``ShapeDtypeStruct``s) for every architecture x shape;
- ``roofline``: ``model_flops`` for every cell, and ``roofline_terms``
  with the reference's ``HW`` set to the port's constants;
- ``op_cost`` against ``hlo_cost``: the reference's two scan cases as
  Python loops, and the olmo-1b smoke train step, whose extra products are
  named and held exactly;
- the kernels' meta stand-ins: each allocates only what its wrapper does on
  the card and counts its formula's work, never zero;
- ``dryrun.run_cell`` for four families x four shapes at B = 2, S = 64,
  and ``dryrun_ddf`` at ``paper_cylon.smoke_config()`` against the numpy
  oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch import hlo_cost
from repro.launch import roofline as ref_roofline
from repro.launch import shapes as ref_shapes
from repro.models.model_zoo import build_model as ref_build_model
from repro.train.train_step import TrainHParams as RefTrainHParams
from repro.train.train_step import make_train_step as ref_make_train_step
from repro.train.train_step import train_state_specs as ref_train_state_specs
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.paper_cylon import CONFIG, CylonWorkload, smoke_config
from repro_torch.kernels import ops, registry
from repro_torch.kernels.flash_attention import flash_work
from repro_torch.kernels.hash_partition import hash_work
from repro_torch.kernels.segment_reduce import segment_work
from repro_torch.kernels.ssd_scan import ssd_work
from repro_torch.launch import dryrun, dryrun_ddf, op_cost, roofline, shapes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.train.train_step import (TrainHParams, init_train_state, make_train_step,
                                         train_state_specs)

CELLS = [(a, s) for a in ARCHS for s in shapes.SHAPES]


def test_shapes_and_cells_equal_the_reference():
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for name, cell in shapes.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref_shapes.SHAPES[name])
    for arch, shape in CELLS:
        got = shapes.cell_applicable(get_config(arch), shape)[0]
        assert got == ref_shapes.cell_applicable(ref_get_config(arch), shape)[0], (arch, shape)
    assert CONFIG.rows_per_worker == 25_000_000 and smoke_config().rows_per_worker == 2000
    assert dataclasses.asdict(CylonWorkload()) == dict(
        rows_per_worker=25_000_000, n_columns=2, dtype="int64", cardinality=0.9,
        key_column="c0")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    for shape in shapes.SHAPES:
        got = shapes.input_specs(get_config(arch), shape)
        exp = ref_shapes.input_specs(ref_get_config(arch), shape)
        assert list(got) == list(exp), (arch, shape)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(exp[k].shape), (arch, shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(exp[k].dtype), (arch, shape, k)


def test_model_flops_equal_the_reference():
    for arch, shape in CELLS:
        got = roofline.model_flops(get_config(arch), shapes.SHAPES[shape])
        assert got == ref_roofline.model_flops(ref_get_config(arch), ref_shapes.SHAPES[shape])


@pytest.mark.parametrize("n_chips", [1, 256])
def test_roofline_terms_equal_the_reference_under_the_same_constants(monkeypatch, n_chips):
    monkeypatch.setattr(ref_roofline, "HW", dict(roofline.HW))
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    cfg, ref_cfg = get_config("olmo-1b"), ref_get_config("olmo-1b")
    dominants = set()
    for shape in shapes.SHAPES:
        for flops in (0.0, 1e12, 1e16):
            for nbytes in (1e9, 1e13):
                for coll in (0.0, 1e6, 1e13):
                    kw = dict(flops=flops, bytes_accessed=nbytes,
                              collective={"total_bytes": coll}, n_chips=n_chips)
                    got = roofline.roofline_terms(cfg, shapes.SHAPES[shape], **kw)
                    exp = ref_roofline.roofline_terms(ref_cfg, ref_shapes.SHAPES[shape], **kw)
                    assert got == exp
                    dominants.add(got["dominant"])
    assert dominants == {"compute", "memory", "collective"}


def _jax_scan_flops(f, *shapes_):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes_]
    return hlo_cost.analyze(jax.jit(f).lower(*args).compile().as_text()).flops


def test_op_cost_counts_every_trip_of_a_loop():
    """tests/test_roofline.py's scan cases as Python loops: 5 trips, and 3 x
    4 nested trips, each equal to hlo_cost's trip-scaled count."""
    def step(c, w):
        return torch.tanh(c @ w)

    def f(x, ws):
        for w in ws:
            x = step(x, w)
        return x.sum()

    def g(x, ws):
        for outer in ws:
            for w in outer:
                x = x @ w
        return x.sum()

    def jf(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0].sum()

    def jg(x, ws):
        def outer(c, wo):
            return jax.lax.scan(lambda c2, w: (c2 @ w, None), c, wo)[0], None
        return jax.lax.scan(outer, x, ws)[0].sum()

    meta = dict(device="meta")
    c1 = op_cost.analyze(f, torch.empty(64, 64, **meta), torch.empty(5, 64, 64, **meta))
    c2 = op_cost.analyze(g, torch.empty(32, 32, **meta), torch.empty(3, 4, 32, 32, **meta))
    assert c1.flops == 2 * 64 * 64 * 64 * 5 == _jax_scan_flops(jf, (64, 64), (5, 64, 64))
    assert c2.flops == 2 * 32 * 32 * 32 * 3 * 4 == _jax_scan_flops(jg, (32, 32), (3, 4, 32, 32))
    assert c1.kernels == {} and c1.bytes > 0 and c1.collective_bytes == 0


def _olmo_smoke_step(cfg, device, B=2, S=64):
    model = build_model(cfg, device=device)
    state = (init_train_state(model, torch.Generator().manual_seed(0)) if device == "cpu"
             else train_state_specs(model))
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device=device),
             "labels": torch.ones((B, S), dtype=torch.int32, device=device),
             "loss_mask": torch.ones((B, S), device=device)}
    return op_cost.analyze(make_train_step(model, TrainHParams(microbatches=1)), state, batch)


def test_op_cost_of_the_train_step_against_hlo_cost():
    """The olmo-1b smoke train step (B 2, S 64, one microbatch) on the CPU
    counts XLA's flops plus two recomputations the reference's step does
    not run: ``FlashAttentionFn.backward`` recomputes each layer's QK^T and
    PV products (XLA's rematerialised layer reuses its own recompute), and
    the chunked loss's ``checkpoint`` recomputes the logits (the
    reference's scan keeps them)."""
    B, S = 2, 64
    ref_cfg = ref_get_smoke_config("olmo-1b")
    ref_model = ref_build_model(ref_cfg)
    specs = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "loss_mask": jax.ShapeDtypeStruct((B, S), jnp.float32)}
    compiled = jax.jit(ref_make_train_step(ref_model, RefTrainHParams(microbatches=1))).lower(
        ref_train_state_specs(ref_model), specs).compile()
    xla = hlo_cost.analyze(compiled.as_text()).flops
    assert xla == 109_051_904

    cfg = get_smoke_config("olmo-1b")
    cost = _olmo_smoke_step(cfg, "cpu", B, S)
    product = 2 * B * cfg.n_heads * S * S * cfg.head_dim  # one QK^T or PV product
    attention_recompute = cfg.n_layers * 2 * product
    logits_recompute = 2 * B * S * cfg.vocab_size * cfg.d_model
    assert attention_recompute == logits_recompute == 4_194_304
    assert cost.flops == xla + attention_recompute + logits_recompute
    roof = roofline.roofline_terms(cfg, shapes.ShapeCell("smoke", S, B, "train"),
                                   flops=cost.flops, bytes_accessed=cost.bytes,
                                   collective={"total_bytes": 0.0}, n_chips=1)
    assert 0.2 < roof["useful_flops_ratio"] <= 1.5


def test_meta_train_step_counts_the_kernel_formula():
    """On the meta device the flash forward is the kernel's stand-in: the
    same step counts the plain version's dense products less the causal
    formula's, four calls (two layers, each recomputed)."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), head_dim=64)  # a kernel head_dim
    B, S = 2, 64
    cpu, meta = _olmo_smoke_step(cfg, "cpu", B, S), _olmo_smoke_step(cfg, "meta", B, S)
    plain = 4 * B * cfg.n_heads * S * S * cfg.head_dim
    formula = flash_work(B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2)[0]
    assert meta.kernels["flash_attention"]["calls"] == 4
    assert meta.kernels["flash_attention"]["flops"] == 4 * formula
    assert meta.flops == cpu.flops - 4 * (plain - formula)
    assert meta.resident_bytes == cpu.resident_bytes


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _stand_in_cases():
    """{kernel: (call(force), inputs, bytes its wrapper allocates on the
    card, its formula's (flops, bytes))}."""
    B, S, H, hd = 1, 65536, 8, 64
    q = _meta(B, S, H, hd, dtype=torch.bfloat16)
    b, L, Hs, dh, G, ds, chunk = 2, 4096, 64, 64, 1, 128, 256
    nc, tiles = L // chunk, chunk // 64
    x, dt, A, Bm = _meta(b, L, Hs, dh), _meta(b, L, Hs), _meta(Hs), _meta(b, L, G, ds)
    n, nseg = 1 << 20, 1000
    keys, vals, ids = _meta(n, 2, dtype=torch.int32), _meta(n, 1, dtype=torch.int32), \
        _meta(n, dtype=torch.int32)
    ssd_bytes = 4 * (x.numel() + b * Hs * dh * ds  # y, the final state
                     + b * Hs * nc * dh * ds + b * Hs * nc * 2 * chunk  # chunk states, cumsums
                     + b * G * nc * tiles * (tiles + 1) // 2 * 64 * 64)  # scores
    return {
        "flash_attention": (lambda f: ops.flash_attention(q, q, q, causal=True, force=f), (q,),
                            B * S * H * hd * 2, flash_work(B, S, H, H, hd, 2)),
        "ssd_scan": (lambda f: ops.ssd_scan(x, dt, A, Bm, Bm, A, chunk=chunk, force=f),
                     (x, dt, A, Bm), ssd_bytes, ssd_work(b, L, Hs, dh, G, ds, chunk)),
        "hash_partition": (lambda f: ops.hash_partition(keys, 8, with_hist=False, force=f),
                           (keys,), 4 * n, hash_work(n, 2, 8, False)),
        "segment_reduce": (lambda f: ops.segment_reduce(vals, ids, nseg, force=f), (vals, ids),
                           4 * nseg, segment_work(n, 1, nseg, 4)),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan", "hash_partition",
                                    "segment_reduce"])
def test_kernel_stand_ins_allocate_the_outputs_and_count_the_formula(kernel):
    """A kernel call on the meta device allocates what its wrapper allocates
    on the card (outputs and scratch), launches nothing and adds its
    formula's flops and bytes; the plain version on the same inputs
    allocates its own temporaries (at S = 65536 the flash scores alone
    are 137 GB)."""
    call, inputs, out_bytes, (flops, nbytes) = _stand_in_cases()[kernel]
    cost = op_cost.analyze(lambda *_: call(None), *inputs)
    assert cost.kernels == {kernel: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert nbytes > 0 and cost.flops == flops and cost.bytes == nbytes
    assert cost.peak_bytes - cost.resident_bytes == out_bytes
    plain = op_cost.analyze(lambda *_: call("torch"), *inputs)
    assert plain.kernels == {}
    assert plain.peak_bytes - plain.resident_bytes > out_bytes
    if kernel == "flash_attention":
        assert plain.peak_bytes - plain.resident_bytes > 1000 * out_bytes


def test_peak_tracks_storages_until_they_are_freed():
    def fn(x):
        a = torch.empty(1000, device="meta")       # 4000 bytes
        b = a.view(10, 100) * 2                     # 4000 more; the view allocates nothing
        del a
        c = torch.empty(250, device="meta")        # reuses a's room
        return b.sum() + c.sum() + x.sum()

    cost = op_cost.analyze(fn, torch.empty(10, device="meta"))
    assert cost.resident_bytes == 40
    assert cost.peak_bytes == 40 + 8000


def test_host_mesh_describes_the_visible_devices():
    mesh = make_host_mesh(device="cpu")
    assert mesh.size == 1 and mesh.shape == {"data": 1} and mesh.kinds == ("cpu",)
    assert make_host_mesh(("data", "model"), device="cpu").shape == {"data": 1, "model": 1}


# full widths, depth cut (zamba2 keeps one shared block), B = 2, S = 64
DRY_RUN_ARCHS = {"olmo-1b": 2, "zamba2-1.2b": 6, "granite-moe-1b-a400m": 2,
                 "llava-next-mistral-7b": 2}
# the cell's 64 positions hold llava's image prefix cut to 16 patches
DRY_RUN_OVERRIDES = {"llava-next-mistral-7b": {"n_patches": 16}}


@pytest.mark.parametrize("arch", list(DRY_RUN_ARCHS))
@pytest.mark.parametrize("shape", list(shapes.SHAPES))
def test_dry_run_cell_on_the_meta_device(arch, shape):
    cell = dataclasses.replace(shapes.SHAPES[shape], seq_len=64, global_batch=2)
    rec = dryrun.run_cell(arch, shape, cell=cell,
                          overrides={"n_layers": DRY_RUN_ARCHS[arch],
                                     **DRY_RUN_OVERRIDES.get(arch, {})},
                          save=False, verbose=False)
    if not shapes.cell_applicable(get_config(arch), shape)[0]:
        assert rec["status"] == "skipped"
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["n_devices"] == 1
    # one card runs no collective: the term stays 0
    assert rec["collectives"] == {"per_op": {}, "total_bytes": 0.0, "total_count": 0}
    assert rec["roofline"]["t_collective_s"] == 0.0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["resident_bytes"] >= mem["param_bytes"] > 0
    assert rec["fits_one_card"] and mem["card_bytes"] == 80e9
    kernels = rec["kernels"]
    if cell.kind == "decode":
        assert kernels == {}  # decode attends and scans in plain PyTorch
    else:
        calls = {"flash_attention": DRY_RUN_ARCHS[arch] if arch != "zamba2-1.2b" else 1,
                 "ssd_scan": DRY_RUN_ARCHS[arch] if arch == "zamba2-1.2b" else 0}
        if cell.kind == "train":  # each layer recomputed in the backward
            calls = {k: 2 * v for k, v in calls.items()}
        assert {k: kernels.get(k, {"calls": 0})["calls"] for k in calls} == calls
    if cell.kind == "train":
        assert 0.2 < rec["roofline"]["useful_flops_ratio"] <= 1.5
        assert rec["microbatches"] == dryrun.MICROBATCHES[get_config(arch).name]


@pytest.mark.parametrize("mesh", [(2, 2), "16x16"], ids=["2x2", "16x16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-tiny"])
def test_dry_run_rank_on_a_mesh(arch, mesh):
    """Rank 0 of a smoke-width train cell cut to 16 x 64 on a dry mesh: the
    census of its FSDP and model-axis collectives, the collective term as
    its bytes over ``ici_bw``, ``n_chips`` the mesh size; on 16x16 its
    resident bytes equal the cell's ``state_bytes_per_device``."""
    cell = shapes.ShapeCell("cut", 64, 16, "train")
    with registry.use_backend("torch"):  # a smoke head_dim has no kernel
        rec = dryrun.run_cell(arch, "train_4k", cell=cell, mesh=mesh, rank=0,
                              config=get_smoke_config(arch), save=False, verbose=False,
                              card=(80e9, "80e9"))
    assert rec["status"] == "ok", rec.get("traceback")
    size = 4 if mesh == (2, 2) else 256
    assert rec["n_devices"] == size and rec["mesh"] == ("2x2" if size == 4 else "16x16")
    coll = rec["collectives"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(coll["per_op"])
    assert coll["total_count"] == sum(v["count"] for v in coll["per_op"].values())
    assert coll["total_bytes"] == sum(v["bytes"] for v in coll["per_op"].values()) > 0
    assert rec["roofline"]["t_collective_s"] == coll["total_bytes"] / roofline.HW["ici_bw"]
    assert rec["roofline"]["model_flops_per_chip"] == \
        rec["roofline"]["model_flops_total"] / size
    if size == 256:
        assert rec["memory"]["resident_bytes"] == rec["state_bytes_per_device"]["16x16"]


def test_dryrun_ddf_rank_counts_its_exchanges():
    """One rank's block of the paper's join on a stand-in group: six
    all-to-alls (two shuffles of two columns and their counts), each the
    rank's (P / world, P, quota) received slabs, and a smaller peak than
    one card's."""
    P, rows = dryrun_ddf.WORKERS, 1000
    workload = CylonWorkload(rows_per_worker=rows)
    one = dryrun_ddf.predict(rows, P)
    for world in (2, 8):
        rec = dryrun_ddf.run_rank(world, world - 1, workload=workload, save=False,
                                  verbose=False)
        slab = 4 * (P // world) * P  # an int32 from every source to each of the rank's workers
        # per shuffle: two columns' (P / world, P, quota) buffers and the counts
        assert rec["collectives"]["per_op"] == {"all-to-all": {
            "count": 6, "bytes": 2 * (2 * slab * rec["quota"] + slab)}}
        assert rec["memory"]["peak_bytes"] < one.peak_bytes
        assert rec["roofline"]["t_collective_s"] == \
            rec["collectives"]["total_bytes"] / roofline.HW["ici_bw"]


def test_dryrun_ddf_joins_the_smoke_workload_on_the_cpu():
    workload = smoke_config()
    left, right = dryrun_ddf.paper_tables(dryrun_ddf.WORKERS, workload)
    rec = dryrun_ddf.run(left, right, device="cpu", save=False, verbose=False, iters=1)
    n = dryrun_ddf.WORKERS * workload.rows_per_worker
    exp = chip_smoke.numpy_oracle(left, right, int(n * workload.cardinality))
    assert rec["join_rows"] == exp["join_rows"] > 0
    assert rec["overflow"] == {"overflow_left": 0, "overflow_right": 0, "overflow_join": 0}
    for k in ("status", "n_devices", "quota", "rows_per_worker", "memory", "flops",
              "bytes_accessed", "collectives", "roofline", "launches", "join_ms",
              "transpose_ms"):
        assert k in rec, k
    ro = rec["roofline"]
    assert ro["hockney_predicted_shuffle_s"] > 0 and ro["t_memory_s"] > 0
    assert rec["rows_per_worker"] == 2000 and rec["n_devices"] == 1
    assert rec["bytes_accessed"] > 0 and rec["flops"] == 0  # no products in a join
