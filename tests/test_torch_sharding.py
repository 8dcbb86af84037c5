"""The port's layout layer against the reference's, on the CPU.

- ``sharding.param_specs`` against the reference's ``param_shardings`` for
  all ten architectures at full width on five meshes in both modes, and
  ``local_shape`` against ``NamedSharding.shard_shape``; the reference's
  plans are built over ``jax.sharding.AbstractMesh``, so no device count is
  forced;
- the per-device train-state bytes on the production meshes;
- ``batch_specs`` and ``decode_state_specs`` for one architecture of each
  family, at decode_32k and (where it applies) long_500k;
- ``elastic.rescale_state`` of an olmo-1b smoke-config checkpoint onto
  three meshes: equal bits, views, bytes;
- ``cost_model.choose_shuffle_algorithm`` on a grid;
- the dry run's ``state_bytes_per_device`` against the reference's plans.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import sharding as ref_sharding
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.core import cost_model as ref_cost_model
from repro.core.comm.communicator import ICI
from repro.launch import shapes as ref_shapes
from repro.models.model_zoo import build_model as ref_build_model
from repro.train.train_step import train_state_specs as ref_train_state_specs
from repro_torch import sharding
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import cost_model
from repro_torch.core.comm.communicator import FabricProfile
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.models import build_model
from repro_torch.train import checkpoint
from repro_torch.train.elastic import ShardedState, rescale_state
from repro_torch.train.train_step import init_train_state, make_train_step, train_state_specs
from repro_torch.tree import leaves

MESHES = {"2x1": ((2, 1), ("data", "model")), "8x1": ((8, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

# Per-device train state (params + mu + nu) in GiB on 16x16 and 2x16x16,
# and the whole state, as the reference's plans give them.
STATE_GIB = {
    "deepseek-67b": (753.5, 2.961, 1.489),
    "gemma2-9b": (103.3, 0.410, 0.208),
    "llava-next-mistral-7b": (81.1, 0.320, 0.161),
    "granite-moe-3b-a800m": (36.9, 0.196, 0.098),
    "stablelm-3b": (31.2, 0.126, 0.065),
    "mamba2-1.3b": (15.0, 0.147, 0.076),
    "granite-moe-1b-a400m": (14.9, 0.092, 0.046),
    "olmo-1b": (13.2, 0.051, 0.026),
    "zamba2-1.2b": (12.2, 0.057, 0.030),
    "whisper-tiny": (0.6, 0.024, 0.012),
}

FAMILY_ARCHS = ["olmo-1b", "granite-moe-1b-a400m", "llava-next-mistral-7b", "mamba2-1.3b",
                "zamba2-1.2b", "whisper-tiny"]


def _layout(name):
    return MeshLayout.of(*MESHES[name])


def _ref_plan(name, mode):
    sizes, axes = MESHES[name]
    return ref_sharding.make_plan(AbstractMesh(sizes, axes), mode=mode)


def _ref_flat(tree):
    """{``/``-joined path: leaf} of a jax pytree (dicts and NamedTuples)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, jax.ShapeDtypeStruct)))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in p): v
            for p, v in flat}


def _port_flat(tree, prefix=""):
    """{``/``-joined path: leaf} of a port tree (dicts and NamedTuples),
    without the leaves that are not there (``None``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {} if tree is None else {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}{k}/"))
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return ref_train_state_specs(ref_build_model(ref_get_config(arch)))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return train_state_specs(build_model(get_config(arch), device="meta"))


def _ref_bytes(shardings, shapes_, drop_scalars=False):
    """The bytes one device holds under the reference's shardings; with
    ``drop_scalars`` without the 0-d leaves (a decode state's ``length``
    and an int8-free cache's scale placeholders, which the port does not
    have)."""
    sh, sp = _ref_flat(shardings), _ref_flat(shapes_)
    return sum(math.prod(sh[k].shard_shape(s.shape)) * np.dtype(s.dtype).itemsize
               for k, s in sp.items() if not (drop_scalars and s.shape == ()))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_local_shapes_equal_the_reference(arch):
    ref, port = _ref_state(arch)["params"], _port_state(arch)["params"]
    ref_shapes_ = _ref_flat(ref)
    for mesh in MESHES:
        for mode in ("train", "serve"):
            plan, ref_plan = sharding.make_plan(_layout(mesh), mode), _ref_plan(mesh, mode)
            assert plan.dp == ref_plan.dp and plan.fsdp == ref_plan.fsdp
            got = _port_flat(sharding.param_specs(port, plan))
            exp = _ref_flat(ref_sharding.param_shardings(ref, ref_plan))
            assert set(got) == set(exp), (arch, mesh, mode)
            for key, sh in exp.items():
                assert got[key] == tuple(sh.spec), (arch, mesh, mode, key)
                shape = ref_shapes_[key].shape
                assert sharding.local_shape(shape, got[key], plan) == sh.shard_shape(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_bytes_per_device_equal_the_reference(arch):
    """params + mu + nu on the production meshes, in the train plan."""
    ref, port = _ref_state(arch), _port_state(arch)
    whole = sum(t.numel() * t.element_size() for k in ("params",)
                for t in leaves(port[k])) * 3
    want = STATE_GIB[get_config(arch).name]
    assert round(whole / 2**30, 1) == want[0]
    for i, multi_pod in enumerate((False, True)):
        name = "2x16x16" if multi_pod else "16x16"
        plan = sharding.make_plan(make_production_mesh(multi_pod=multi_pod))
        assert plan.mesh == _layout(name) and plan.mesh.size == (512 if multi_pod else 256)
        ref_plan = _ref_plan(name, "train")
        specs = sharding.state_specs(port, plan)
        assert specs["opt"]["step"] == ()
        trio = [(port["params"], specs["params"], ref["params"]),
                (port["opt"]["mu"], specs["opt"]["mu"], ref["opt"]["mu"]),
                (port["opt"]["nu"], specs["opt"]["nu"], ref["opt"]["nu"])]
        got = sum(sharding.bytes_per_device(t, s, plan) for t, s, _ in trio)
        exp = sum(_ref_bytes(ref_sharding.param_shardings(r, ref_plan), r) for _, _, r in trio)
        assert got == exp, (arch, name)
        assert round(got / 2**30, 3) == want[1 + i], (arch, name, got / 2**30)
        # the whole state: the replicated int32 step adds its 4 bytes
        assert sharding.bytes_per_device(port, specs, plan) == got + 4


def _decode_cfgs(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if cfg.family in ("dense", "moe", "vlm"):  # the dry run's int8 KV cache at decode
        cfg = dataclasses.replace(cfg, kv_quant_decode=True)
        ref_cfg = dataclasses.replace(ref_cfg, kv_quant_decode=True)
    return cfg, ref_cfg


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_and_decode_state_specs_equal_the_reference(arch):
    cfg, ref_cfg = _decode_cfgs(arch)
    model, ref_model = build_model(cfg, device="meta"), ref_build_model(ref_cfg)
    for shape in shapes.SHAPES:
        if not shapes.cell_applicable(cfg, shape)[0]:
            continue
        cell = shapes.SHAPES[shape]
        batch, ref_batch = shapes.input_specs(cfg, shape), ref_shapes.input_specs(ref_cfg, shape)
        for mesh in MESHES:
            for mode in ("train", "serve"):
                plan, ref_plan = sharding.make_plan(_layout(mesh), mode), _ref_plan(mesh, mode)
                got = _port_flat(sharding.batch_specs(batch, plan))
                exp = _ref_flat(ref_sharding.batch_shardings(ref_batch, ref_plan))
                assert got == {k: tuple(v.spec) for k, v in exp.items()}, (arch, shape, mesh)
        if cell.kind != "decode":
            continue
        long_ctx = cell.global_batch == 1
        state = model.init_decode_state(cell.global_batch, cell.seq_len + dryrun.CACHE_PAD)
        ref_state = ref_model.decode_state_specs(cell.global_batch,
                                                 cell.seq_len + dryrun.CACHE_PAD)
        ref_shapes_ = _ref_flat(ref_state)
        for mesh in MESHES:
            plan, ref_plan = sharding.make_plan(_layout(mesh), "serve"), _ref_plan(mesh, "serve")
            got = _port_flat(sharding.decode_state_specs(state, plan, long_context=long_ctx))
            exp = _ref_flat(ref_sharding.decode_state_shardings(ref_state, ref_plan,
                                                                long_context=long_ctx))
            # the port's length is a host int, an int8-free cache has no scales
            missing = {k for k in exp if k not in got}
            assert all(k == "length" or ref_shapes_[k].shape == () for k in missing), missing
            assert "length" in missing and set(got) <= set(exp)
            for key, spec in got.items():
                assert spec == tuple(exp[key].spec), (arch, shape, mesh, key)
                assert (sharding.local_shape(ref_shapes_[key].shape, spec, plan)
                        == exp[key].shard_shape(ref_shapes_[key].shape))
            if long_ctx and mesh == "16x16" and "kv" in state:
                assert got["kv/k"][2] == ("data", "model")


def test_rescale_state_restores_onto_other_meshes(tmp_path):
    """An olmo-1b smoke-config state saved at step 11 and rescaled onto
    (2, 1), (8, 1) and (4, 2): step 11, leaves equal by bits, every
    coordinate's shard a view of its leaf with ``local_shape``, the bytes
    per device those views' bytes, the reference's specs; one train step
    takes the rescaled state."""
    cfg = get_smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0))
    checkpoint.save(str(tmp_path), 11, state)
    ref_params = ref_train_state_specs(ref_build_model(ref_get_smoke_config("olmo-1b")))["params"]
    for mesh in ("2x1", "8x1", "4x2"):
        rs, step = rescale_state(str(tmp_path), 11, train_state_specs(model), _layout(mesh),
                                 device="cpu")
        assert step == 11 and isinstance(rs, ShardedState)
        plan = rs.plan
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(leaves(rs), leaves(state)))
        exp = _ref_flat(ref_sharding.param_shardings(ref_params, _ref_plan(mesh, "train")))
        assert _port_flat(rs.specs["params"]) == {k: tuple(v.spec) for k, v in exp.items()}
        assert rs.specs["opt"]["mu"] == rs.specs["params"] and rs.specs["opt"]["step"] == ()
        flat, specs = _port_flat(rs), _port_flat(rs.specs)
        assert any(a is not None for s in specs.values() for a in s)  # something is split
        coords = list(plan.coords())
        assert len(coords) == plan.mesh.size
        pieces = {}
        for coord in coords:
            views = _port_flat(rs.local(coord))
            assert list(views) == list(flat)
            for key, v in views.items():
                leaf = flat[key]
                assert v.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr()
                assert tuple(v.shape) == sharding.local_shape(leaf.shape, specs[key], plan)
                pieces.setdefault(key, []).append(v)
            assert rs.bytes_per_device() == sum(v.numel() * v.element_size()
                                                for v in views.values())
        # the shards cover each leaf: distinct offsets, each replicated alike
        for key, vs in pieces.items():
            n_shards = math.prod(plan.axis_size(a) for a in specs[key])
            assert len({v.storage_offset() for v in vs}) == n_shards
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "loss_mask": torch.ones((2, 16))}
    _, m = make_train_step(model)(rs, batch)
    assert bool(torch.isfinite(m["loss"]))


def test_rescale_state_defaults_to_the_card(tmp_path):
    model = build_model(get_smoke_config("olmo-1b"), device="cpu")
    checkpoint.save(str(tmp_path), 3, init_train_state(model, torch.Generator().manual_seed(0)))
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rescale_state(str(tmp_path), 3, train_state_specs(model), _layout("2x1"))


def test_local_shard_splits_axes_first_major():
    """A dim over ("pod", "data") of a 2 x 4 x 1 mesh: coordinate (p, d)
    holds piece p * 4 + d, as jax lays it out."""
    mesh = MeshLayout.of((2, 4, 1), ("pod", "data", "model"))
    plan = sharding.make_plan(mesh)
    t = torch.arange(16 * 3).reshape(16, 3)
    spec = (("pod", "data"), "model")
    for coord in plan.coords():
        v = sharding.local_shard(t, spec, plan, coord)
        k = coord["pod"] * 4 + coord["data"]
        assert v.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
        assert torch.equal(v, t[2 * k:2 * k + 2])
        assert torch.equal(v, sharding.local_shard(t, spec, plan, tuple(coord.values())))
    with pytest.raises(ValueError):
        sharding.local_shape((15, 3), spec, plan)
    assert sharding.gather_spec(("layers", "attn", "wq"), (4, 16, 8, 2), plan) == \
        (None, None, "model", None)


def test_choose_shuffle_algorithm_equals_the_reference():
    ref_params = ref_cost_model.CostParams()
    assert ref_params.fabric.name == "ici" and ref_params.gamma_s_per_row == 2e-9
    params = cost_model.CostParams(FabricProfile("ici", ICI.alpha_s, ICI.beta_s_per_byte),
                                   gamma_s_per_row=2e-9)
    seen = set()
    for P in [2 ** i for i in range(1, 11)]:
        for n_bytes in [10.0 ** e for e in range(2, 11, 2)]:
            got = cost_model.choose_shuffle_algorithm(P, n_bytes, params)
            assert got == ref_cost_model.choose_shuffle_algorithm(P, n_bytes, ref_params), \
                (P, n_bytes)
            seen.add(got)
    assert len(seen) > 1, seen
    assert cost_model.choose_shuffle_algorithm(8, 1e6) in ("isend-irecv", "ring", "pairwise",
                                                          "bruck")


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "decode_32k"), ("zamba2-1.2b", "long_500k")])
def test_dryrun_state_bytes_per_device_equal_the_reference(arch, shape):
    """The dry run's per-device state bytes: bf16 parameters, the decode
    state (long-context layout at batch 1) and the input batch under the
    reference's serve plan on both production meshes; the reference's
    0-d ``length`` (and zamba2's scale placeholders) have no counterpart
    in the port."""
    rec = dryrun.run_cell(arch, shape, save=False, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    _, ref_cfg = _decode_cfgs(arch)
    ref_model = ref_build_model(ref_cfg)
    cell = ref_shapes.SHAPES[shape]
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype), ref_model.param_specs())
    state = ref_model.decode_state_specs(cell.global_batch, cell.seq_len + dryrun.CACHE_PAD)
    batch = ref_shapes.input_specs(ref_cfg, shape)
    for name in ("16x16", "2x16x16"):
        plan = _ref_plan(name, "serve")
        sh = ref_sharding.decode_state_shardings(state, plan,
                                                 long_context=cell.global_batch == 1)
        exp = (_ref_bytes(ref_sharding.param_shardings(params, plan), params)
               + _ref_bytes(sh, state, drop_scalars=True)
               + _ref_bytes(ref_sharding.batch_shardings(batch, plan), batch))
        assert rec["state_bytes_per_device"][name] == exp, (name, exp)
