"""The port's trainer (``repro_torch.train``) against the reference's
(``repro.train``), on the CPU at float32 smoke configs.

Both packages start from the reference's ``init_train_state(model,
jax.random.key(0))``, carried across with ``from_jax_train_state``, and
take the same numpy batches:

- the loss, its metrics (``nll``, ``ntok``, ``moe_aux``) within rtol 1e-5
  and every gradient leaf within 1e-4 of its largest magnitude, against
  ``jax.value_and_grad`` of the reference's ``make_loss_fn``: dense
  (olmo), moe (granite-moe-1b) and hybrid (zamba2) here; ssm, vlm and
  encdec in ``tests/test_torch_train_families.py``;
- ``adamw_update`` on identical numpy gradients and ``schedule`` from step
  0 to past ``total_steps`` within rtol 1e-6;
- a full step at ``lr=1e-2, warmup_steps=1`` and a step with
  ``microbatches=2``, against the reference's; 30 steps of olmo-smoke
  whose loss falls below 0.7 of the first (the reference's own test);
- ``chunked_cross_entropy`` with a mask and a softcap, value and gradient;
- checkpoints written by either package restored by the other, by bits,
  with the same manifest; atomicity and crash debris;
- ``compressed_psum`` at P = 1 against the reference, at P = 4 against a
  numpy transcription of ``src/repro/train/compress.py:45-53``;
- ``StepGuard`` on a fake clock: emergency saves at the reference's steps;
- ``chip_smoke.run_train_path`` at smoke configs on the CPU.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_family_cases import (_jax, check_grads, check_loss_and_grads, train_batch,
                                train_pair, tree_leaves)

from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train.compress import compressed_psum as ref_compressed_psum
from repro.train.elastic import StepGuard as RefStepGuard
from repro.train.loss import chunked_cross_entropy as ref_xent
from repro.train.train_step import TrainHParams as RefHParams
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import to_numpy_tree
from repro_torch.train import checkpoint, compress, optimizer
from repro_torch.train.elastic import StepGuard
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.train_step import (TrainHParams, init_train_state, make_train_step,
                                          train_state_specs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = dict(lr=1e-2, warmup_steps=1)  # step 1 at the full rate: a wrong update shows


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m", "zamba2-1.2b"])
def test_loss_metrics_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)


# -- the optimizer -----------------------------------------------------------------------

def _opt_tree(rng):
    """Parameters with a stacked norm scale (2, 8), a vector and a scalar
    leaf, so both sides of the ``ndim >= 2`` decay rule show."""
    return {"w": rng.normal(size=(8, 6)).astype(np.float32),
            "layers": {"scale": rng.normal(size=(2, 8)).astype(np.float32),
                       "w3": rng.normal(size=(2, 3, 4)).astype(np.float32)},
            "b": rng.normal(size=(6,)).astype(np.float32),
            "s": np.asarray(rng.normal(size=()), np.float32)}


def _close(got: dict, exp: dict, rtol: float = 1e-6) -> None:
    """Each leaf within ``rtol`` of each element and of the leaf's largest
    magnitude: from step 2 on, ``b1 * mu + (1 - b1) * g`` may cancel, and a
    rounding of either term (XLA may fuse them) is then larger than rtol of
    the element."""
    got, exp = tree_leaves(got), tree_leaves(exp)
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k].dtype == exp[k].dtype, k
        np.testing.assert_allclose(got[k], exp[k], rtol=rtol,
                                   atol=rtol * float(np.abs(exp[k]).max()), err_msg=k)


@pytest.mark.parametrize("clip", [1.0, 100.0])  # clipped and not
def test_adamw_update_matches_the_reference(clip):
    cfg = optimizer.AdamWConfig(grad_clip=clip, **FAST)
    ref_cfg = ref_opt.AdamWConfig(grad_clip=clip, **FAST)
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    ref_p, ref_s = jax.tree.map(jnp.asarray, params), ref_opt.adamw_init(params)
    ref_update = jax.jit(lambda p, g, s: ref_opt.adamw_update(ref_cfg, p, g, s))
    # the port's own copy: jax may alias an aligned numpy buffer and read it
    # asynchronously, after the port's in-place update
    p = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    s = optimizer.adamw_init(p)
    for step in range(3):  # identical numpy gradients each step
        grads = jax.tree.map(lambda x: np.asarray(rng.normal(size=x.shape) * 3, np.float32),
                             params)
        ref_p, ref_s, ref_m = ref_update(ref_p, grads, ref_s)
        p, s, m = optimizer.adamw_update(cfg, p, jax.tree.map(torch.from_numpy, grads), s)
        _close(p, ref_p)
        _close({"mu": s["mu"], "nu": s["nu"]}, {"mu": ref_s["mu"], "nu": ref_s["nu"]})
        assert s["step"].dtype == torch.int32 and int(s["step"]) == int(ref_s["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert m[k].dtype == torch.float32
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 12000])
def test_schedule_matches_the_reference(step):
    cfg, ref_cfg = optimizer.AdamWConfig(), ref_opt.AdamWConfig()
    got = optimizer.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    exp = ref_opt.schedule(ref_cfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(exp), rtol=1e-6)


# -- the train step ----------------------------------------------------------------------

def _steps(microbatches: int):
    """olmo-smoke one full step in: (port model, port state, port metrics,
    reference state, reference metrics)."""
    model, state, ref_model, ref_state = train_pair("olmo-1b")
    b = train_batch(model.cfg, B=4)
    hp = TrainHParams(opt=optimizer.AdamWConfig(**FAST), microbatches=microbatches)
    ref_hp = RefHParams(opt=ref_opt.AdamWConfig(**FAST), microbatches=microbatches)
    ref_state, rm = jax.jit(ref_make_train_step(ref_model, ref_hp))(ref_state, _jax(b))
    state, m = make_train_step(model, hp)(state, b)
    return model, state, m, ref_state, rm


@pytest.fixture(scope="module")
def olmo_stepped():
    return _steps(1)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(microbatches, olmo_stepped):
    """One full step at lr 1e-2: the loss and metrics, the first moments
    (0.1 of the clipped gradient: the gradients themselves) within the
    gradient tolerance, and the parameters. After one step, Adam's update is
    about +-lr wherever a gradient is far from 0; where it is near 0 the
    update's size follows the gradient's last digits, so the parameters are
    held to 1e-3 of lr in the mean and 2 lr at most."""
    _, state, m, ref_state, rm = olmo_stepped if microbatches == 1 else _steps(microbatches)
    assert set(m) == set(rm)
    for k in rm:
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5, err_msg=k)
    check_grads(state["opt"]["mu"], ref_state["opt"]["mu"])
    assert int(state["opt"]["step"]) == int(ref_state["opt"]["step"]) == 1
    got, exp = tree_leaves(state["params"]), tree_leaves(ref_state["params"])
    diffs = np.concatenate([np.abs(got[k] - exp[k]).ravel() for k in exp])
    assert diffs.max() <= 2 * FAST["lr"] and diffs.mean() <= 1e-3 * FAST["lr"], \
        (diffs.max(), diffs.mean())


def _port_olmo():
    """olmo-smoke in float32 with the port's own random state."""
    model = build_model(dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32"),
                        device="cpu")
    return model, init_train_state(model, torch.Generator().manual_seed(0))


def test_microbatches_match_one_batch():
    """The same batch as one or as two microbatches: the same update up to
    float32 accumulation (the reference's own check)."""
    model, state = _port_olmo()
    b = train_batch(model.cfg, B=4)
    s1, _ = make_train_step(model, TrainHParams())(
        {"params": jax.tree.map(torch.clone, state["params"]),
         "opt": jax.tree.map(torch.clone, state["opt"])}, b)
    s2, _ = make_train_step(model, TrainHParams(microbatches=2))(state, b)
    a, c = tree_leaves(s1["params"]), tree_leaves(s2["params"])
    for k in a:
        np.testing.assert_allclose(c[k], a[k], atol=5e-3, rtol=5e-3, err_msg=k)


def test_loss_decreases_over_steps():
    """The reference's ``test_loss_decreases_over_steps`` on the port: 30
    steps of olmo-smoke on one batch, the last loss below 0.7 of the first."""
    model, state = _port_olmo()
    hp = TrainHParams(opt=optimizer.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100))
    step = make_train_step(model, hp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, model.cfg.vocab_size, (4, 16)).astype(np.int32)
    b = {"tokens": tokens, "labels": np.roll(tokens, -1, 1),
         "loss_mask": np.ones((4, 16), np.float32)}
    losses = []
    for _ in range(30):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.7, losses[::6]


def test_train_state_specs_and_init():
    model = build_model(get_smoke_config("zamba2-1.2b"), device="cpu")
    specs = train_state_specs(model)
    state = init_train_state(model, torch.Generator().manual_seed(0))
    a, b = checkpoint.flatten(specs), checkpoint.flatten(state)
    assert a.keys() == b.keys() and "opt/step" in a
    for k in a:
        assert a[k].device.type == "meta" and a[k].shape == b[k].shape and \
            a[k].dtype == b[k].dtype, k
    assert not any(float(v.abs().max()) for k, v in b.items() if k.startswith("opt/"))


# -- the loss ----------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 30.0])
def test_chunked_cross_entropy_matches_the_reference(cap):
    rng = np.random.default_rng(0)
    B, S, d, V = 2, 32, 16, 64
    hidden = rng.normal(size=(B, S, d)).astype(np.float32) * 3
    emb = rng.normal(size=(V, d)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = rng.integers(0, 2, (B, S)).astype(np.float32)

    def ref(h, e):
        return ref_xent(h, e, jnp.asarray(labels), jnp.asarray(mask), chunk=8,
                        final_softcap=cap)

    (rnll, rntok), rg = jax.value_and_grad(ref, argnums=(0, 1), has_aux=True)(hidden, emb)
    h, e = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    nll, ntok = chunked_cross_entropy(h, e, torch.from_numpy(labels), torch.from_numpy(mask),
                                      chunk=8, final_softcap=cap)
    grads = torch.autograd.grad(nll, (h, e))
    np.testing.assert_allclose(float(nll), float(rnll), rtol=1e-5)
    assert float(ntok) == float(rntok) == mask.sum()
    check_grads({"h": grads[0], "e": grads[1]}, {"h": rg[0], "e": rg[1]})


# -- checkpoints -------------------------------------------------------------------------

def _bits_equal(got: dict, exp: dict) -> None:
    got, exp = tree_leaves(got), tree_leaves(exp)
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k].dtype == exp[k].dtype and got[k].shape == exp[k].shape, k
        assert got[k].tobytes() == exp[k].tobytes(), k


def test_checkpoints_cross_between_the_packages(tmp_path, olmo_stepped):
    """olmo-smoke one step in (the moments are not zero)."""
    model, state, _, ref_state, _ = olmo_stepped
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    checkpoint.save(port_dir, 7, state)
    ref_ckpt.save(ref_dir, 7, ref_state)
    with open(os.path.join(port_dir, "step_00000007", "manifest.json")) as f:
        port_manifest = json.load(f)
    with open(os.path.join(ref_dir, "step_00000007", "manifest.json")) as f:
        assert json.load(f) == port_manifest  # same keys, order, shapes, dtypes
    assert ref_ckpt.latest_step(port_dir) == checkpoint.latest_step(ref_dir) == 7
    # the port writes, the reference restores
    restored, step = ref_ckpt.restore(port_dir, 7, jax.eval_shape(lambda: ref_state))
    assert step == 7
    _bits_equal(jax.tree.map(np.asarray, restored), state)
    # the reference writes, the port restores (onto meta specs and onto a state)
    for specs in (train_state_specs(model), state):
        got, step = checkpoint.restore(ref_dir, 7, specs, device="cpu")
        assert step == 7
        _bits_equal(got, jax.tree.map(np.asarray, ref_state))
    with pytest.raises(ValueError, match="meta"):
        checkpoint.restore(ref_dir, 7, train_state_specs(model))
    # the reference's writer takes the port's state as a numpy tree
    ref_ckpt.save(ref_dir, 8, to_numpy_tree(state))
    got, _ = checkpoint.restore(ref_dir, 8, state)
    _bits_equal(got, to_numpy_tree(state))


def test_checkpoint_atomicity_and_debris(tmp_path):
    """A second save of a step replaces it; staging dirs of a crashed save
    and step dirs without a manifest are never restorable, and the staging
    dirs are cleaned."""
    model, state, _, _ = train_pair("olmo-1b")
    d = str(tmp_path)
    checkpoint.save(d, 1, state)
    os.makedirs(os.path.join(d, "step_00000002.tmp_0"))
    os.makedirs(os.path.join(d, "step_00000003"))  # no manifest
    os.makedirs(os.path.join(d, "step_00000001.tmp_0"))  # a crashed re-save of step 1
    assert checkpoint.latest_step(d) == ref_ckpt.latest_step(d) == 1
    assert not any(".tmp_" in n for n in os.listdir(d))
    checkpoint.save(d, 1, state)  # overwrite
    assert checkpoint.list_steps(d) == [1]
    with pytest.raises(FileNotFoundError, match="valid steps"):
        checkpoint.restore(d, 3, state)
    bad = dict(state, params={**state["params"], "embed": state["params"]["embed"][:1]})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, 1, bad)


# -- gradient compression ----------------------------------------------------------------

def _grads(rng, P=None):
    lead = () if P is None else (P,)
    return {"w": (rng.normal(size=lead + (32, 32))).astype(np.float32),
            "b": (rng.normal(size=lead + (32,))).astype(np.float32)}


def test_compressed_psum_at_one_worker_matches_the_reference():
    from repro.compat import shard_map

    rng = np.random.default_rng(0)
    grads, err = _grads(rng), _grads(rng)
    mesh = jax.make_mesh((1,), ("data",))
    spec = jax.sharding.PartitionSpec()
    out, new_err = jax.jit(shard_map(lambda g, e: ref_compressed_psum(g, "data", e), mesh=mesh,
                                     in_specs=(spec, spec), out_specs=spec,
                                     check_vma=False))(grads, err)
    t = lambda tree: {k: torch.from_numpy(v[None]) for k, v in tree.items()}  # noqa: E731
    got, got_err = compress.compressed_psum(t(grads), t(err))
    for k in grads:
        assert got[k].numpy().tobytes() == np.asarray(out[k]).tobytes(), k
        # XLA contracts the residual's g - q * scale into one fused
        # multiply-add; the port rounds the product first: one rounding of g
        ulp = np.spacing(np.abs(grads[k] + err[k]).max())
        np.testing.assert_allclose(got_err[k][0].numpy(), np.asarray(new_err[k]), rtol=0,
                                   atol=ulp)


def test_compressed_psum_over_four_workers():
    """A numpy transcription of the reference's per-leaf rule
    (``src/repro/train/compress.py:45-53``) over P = 4 workers, two steps
    with error feedback."""
    rng = np.random.default_rng(1)
    P = 4
    err, np_err = None, None
    for _ in range(2):
        grads = _grads(rng, P)
        got, err = compress.compressed_psum({k: torch.from_numpy(v) for k, v in grads.items()},
                                            err)
        np_err = np_err or {k: np.zeros_like(v) for k, v in grads.items()}
        for k, g in grads.items():
            g32 = g + np_err[k]
            scale = np.float32(max(np.abs(g32).max(), 1e-12)) / np.float32(127.0)
            q = np.clip(np.round(g32 / scale), -127, 127).astype(np.int8)
            np_err[k] = g32 - q.astype(np.float32) * scale
            exp = q.astype(np.int32).sum(0).astype(np.float32) * scale / np.float32(P)
            np.testing.assert_array_equal(got[k].numpy(), exp)
            np.testing.assert_array_equal(err[k].numpy(), np_err[k])
            assert np.abs(got[k].numpy() - g32.mean(0)).max() <= scale  # near the exact mean
    q, s = compress.quantize(torch.from_numpy(grads["w"]))
    assert q.dtype == torch.int8 and \
        float((compress.dequantize(q, s) - torch.from_numpy(grads["w"])).abs().max()) <= float(s)
    assert compress.init_error_feedback({"a": {"b": torch.ones(3)}})["a"]["b"].sum() == 0


# -- the straggler watchdog --------------------------------------------------------------

def test_step_guard_saves_where_the_reference_does(tmp_path):
    durations = [1.0] * 6 + [5.0, 1.0, 2.9, 1.0, 4.0, 3.5, 1.0, 9.0]

    def clock(durs):
        ts = iter(np.cumsum([0.0] + [x for d in durs for x in (0.0, d)])[1:].tolist())
        return lambda: next(ts)

    rg = RefStepGuard(str(tmp_path / "ref"), time_fn=clock(durations))
    pg = StepGuard(str(tmp_path / "port"), time_fn=clock(durations))
    ref_saved, port_saved = [], []
    for i in range(len(durations)):
        rg.step(i, lambda s: ({"w": jnp.full((2,), float(i))}, {"loss": jnp.zeros(())}), None)
        pg.step(i, lambda s: ({"w": torch.full((2,), float(i))}, {"loss": torch.zeros(())}),
                None)
        ref_saved.append(rg.last_emergency_step)
        port_saved.append(pg.last_emergency_step)
    assert port_saved == ref_saved and pg.emergency_saves == rg.emergency_saves >= 2
    assert pg.history == rg.history
    np.testing.assert_allclose(pg.history, durations)
    steps = checkpoint.list_steps(str(tmp_path / "port"))
    assert steps == ref_ckpt.list_steps(str(tmp_path / "ref")) and steps[-1] == ref_saved[-1]
    got, _ = checkpoint.restore(str(tmp_path / "port"), steps[-1], {"w": torch.zeros(2)})
    assert got["w"].tolist() == [float(steps[-1])] * 2


# -- the smoke run's train phase, rehearsed --------------------------------------------

def test_chip_smoke_train_path_runs_on_the_cpu(tmp_path):
    """``chip_smoke.run_train_path`` at smoke configs on the CPU: the
    pipeline, olmo's steps through StepGuard, the falling loss, the
    kernel-path gradients against the plain path (equal here: both are the
    plain versions), the checkpoint round trip, its rescale onto four
    meshes and zamba2's steps."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    res = chip_smoke.run_train_path(
        get_smoke_config("olmo-1b"), get_smoke_config("zamba2-1.2b"), device="cpu",
        n_docs=1200, check_docs=300, workers=2, batch=4, seq=32, microbatches=2, steps=2,
        repeat_steps=5, grad_batch=2, grad_seq=16, grad_layers=(2, 3), hybrid_batch=2,
        hybrid_seq=16, hybrid_steps=1, ckpt_dir=str(tmp_path))
    from repro_torch.kernels import registry

    assert res["pipeline"]["docs"] > 0 and res["pipeline"]["launches"]["hash_partition"] == 0
    assert res["dense"]["repeat_losses"][-1] < res["dense"]["repeat_losses"][0]
    for name in ("olmo-smoke", "zamba2-smoke"):
        assert max(res["grad_check"][name]["max_rel_err"].values()) <= chip_smoke.GRAD_TOL
    assert res["checkpoint"]["restored_equal"] and res["checkpoint"]["loss_equal"]
    assert {k: v["devices"] for k, v in res["rescale"].items()} == \
        {"2x1": 2, "8x1": 8, "4x2": 8, "16x16": 256}
    assert all(v["bytes_per_device"] > 0 for v in res["rescale"].values())
    assert len(res["hybrid"]["ms"]) == 1
    # the launch counts as read, every kernel (all 0 on the CPU)
    for rec in (res["pipeline"], res["dense"], res["hybrid"]):
        assert rec["launches"] == {k: 0 for k in registry.KERNEL_OPS}


def test_chip_smoke_grad_readings_run_on_the_cpu():
    """``chip_smoke.grad_readings`` at smoke configs on the CPU: the kernel
    path is the plain one here (reading 0), the reordered scan moves the
    gradients by float32 noise, and the TF32-operand control by far more,
    so the control separates from the limit; against the float64 scan the
    kernel path and the plain one read the same here."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    res = chip_smoke.grad_readings({get_smoke_config("zamba2-1.2b"): 3}, 2, 2, 16,
                                   device="cpu")["zamba2-smoke"]
    assert res["kernel"]["max"] == 0.0
    assert res["reorder"]["max"] < chip_smoke.SSD_GRAD_TOL < res["control"]["min"]
    assert res["kernel64"] == res["plain64"] and 0 < res["plain64"]["max"] < res["control"]["min"]
    assert res["rule"] in chip_smoke.SSD_GRAD_CHOICES and res["rule"] <= chip_smoke.SSD_GRAD_TOL
