"""The planned train and serve steps over a process group (FSDP over the
data ranks, tensor parallelism over the model ranks) against the
reference's planned steps, on the CPU at float32 smoke configs.

- The reference runs ``make_train_step(model, hp, plan=make_plan(mesh))``
  at meshes (2, 1), (4, 1), (2, 2), (1, 4) and (1, 2), and its planned
  ``make_prefill`` and decode step under ``make_plan(mesh, mode="serve")``
  at (2, 1), (2, 2) and (1, 4), and at one row with the decode state laid
  out by ``decode_state_shardings(..., long_context=True)`` (the KV
  cache's positions over every device, as its dry run lowers a batch-1
  decode) at (2, 2) and (4, 1), over 4 forced host devices, with the
  mesh's axes ``Auto`` (jax 0.9.0's default ``Explicit`` axes refuse
  ``with_sharding_constraint``). The device count needs its flag before
  jax loads, so this file re-runs itself under ``__main__`` for it, once:
  it writes every case's inputs first, and the port's ranks start from
  them while the reference compiles its steps in threads.
- The port: gloo groups of world 2 and 4 spawned as in
  ``tests/test_torch_distributed.py``, running
  ``tests/torch_fsdp_cases.py::rank_main`` (no jax): one
  ``make_train_step(model, hp, plan=make_plan(make_group_mesh(model=M)))``
  from the reference's ``init_train_state(model, jax.random.key(0))`` cut
  to the rank's shards, on its rows of the same batch, at lr 1e-2 and
  warmup 1 (a wrong update shows). The train cases: olmo-1b at
  microbatches 1 and 2, granite-moe-1b (the global Switch aux),
  zamba2-1.2b (the shared block gathered at each use), whisper-tiny (the
  encoder, ``enc_pos``) and llava-next-mistral-7b (``vis_proj``, the image
  prefix) at (2, 1); olmo-1b at (4, 1) and (2, 2); granite-moe-1b at
  (1, 4) (``wq`` split over heads but ``wk``/``wv`` over head_dim, and the
  MoE's groups at the model axis's 4); zamba2-1.2b at (2, 2) (the gated
  norm over split channels, the shared block); olmo-1b with a vocabulary
  of 255 at (1, 2) (the embedding's and the loss's whole-vocabulary
  fallbacks); zamba2-1.2b with 6 attention heads and 2 SSM heads at
  (1, 4), where neither divides the model axis and the layers gather their
  split leaves whole (the gather's backward takes the rank's slice);
  llava-next-mistral-7b at (2, 2) (``vis_proj``'s columns over "model",
  the image prefix in the split stream) and whisper-tiny at (1, 4) (the
  encoder over heads and d_ff on a whole stream, cross-attention over
  heads). Every case with a model axis above 1 splits the residual stream
  over the model ranks between blocks (16 positions, 20 with llava's
  prefix). The serve cases: a prefill of a 6-token prompt, then the prompt
  fed token by token and 3 greedy tokens, olmo-1b at (2, 1), (2, 2) and
  (1, 4), granite-moe-1b at (1, 4), zamba2-1.2b at (2, 2), the 6-head,
  2-SSM-head zamba2-1.2b at (1, 4), llava-next-mistral-7b at (2, 2),
  whisper-tiny at (1, 4) and a 6-head whisper-tiny at (1, 4) (self- and
  cross-attention gathered whole); long-context, one row with the cache's
  16 positions over every rank: olmo-1b at (2, 2), zamba2-1.2b at (4, 1).

What is compared, with the rules of ``tests/test_torch_train.py``:

- ``loss``, ``nll``, ``ntok`` and ``moe_aux`` within rtol 1e-5: they come
  from the forward, before any bf16 gradient. ``grad_norm`` within rtol
  1e-4: it sums gradients that were rounded to bf16.
- The first moments, gathered from the ranks' shards. A leaf that
  ``gather_params`` casts to bf16 (a layer's leaf of two or more dims) has
  a bf16 gradient in both packages: each rank's partial rounds once to
  bf16 (the reference's partitioned dot rounds its partial the same way),
  and the reduce-scatter's sum rounds once more, each rounding within one
  bf16 ulp, 2^-7 of the magnitude's power of two; the first moment is
  0.1 of the clipped gradient, so two ulps at the leaf's largest magnitude
  bound it: 2^-6 of that magnitude. Over the model ranks no bf16 partial
  is summed: a split weight's gradient is its rank's own product, and the
  partial sums that cross the model ranks (*f*'s backward on activations,
  the norm's sum of squares, a whole scale's gradient) are float32; so
  the same two roundings bound every cast leaf at every mesh. Every other
  leaf is float32 end to end and keeps the train tests' 1e-4.
- The parameters: at most 2 lr and at most 1e-3 lr in the mean (Adam's
  first update is about +-lr wherever a gradient is far from 0).
- Each rank's shards have ``sharding.local_shape`` of the plan's spec, and
  ranks that hold the same part of a leaf hold it by bits.
- Serving: the prefill's and the greedy tokens equal the reference's
  planned ones; the decode logits within 1e-5 of the logit scale (the
  reference's own planned against unplanned logits differ by up to
  1.2e-6); the model ranks of one data index give the same logits by bits.

Also: planned checkpoints at (2, 1) and (2, 2) equal one card's save of the
gathered state by bits and restore to each rank's shards; ``StepGuard``
over the group saves at the step rank 0's clock finds slow, on both ranks,
and not at a step only rank 1 finds slow; the ``TokenPipeline`` with the
plan gives each rank its rows of the one-process batch;
``compressed_psum`` over gloo world 4 equals the one-card form at P = 4 by
bits over two steps with error feedback; ``make_group_mesh(model=2)`` and
``(model=4)`` over world 4 build their sub-groups, ``model=3`` raises;
every family builds its train and serve steps at (2, 2); each layer input
that ``torch.utils.checkpoint`` keeps is the rank's block of the stream;
the per-rank dry run (``launch.dryrun.rank_collectives`` on the ``meta``
device over ``launch.mesh.make_dry_mesh``, run in this process while the
ranks run) gives rank 0's and the last rank's ``fsdp.census()`` of every
train step, prefill and first serve step, each kind's count and bytes, and
their state bytes (``sharding.bytes_per_device``); a stand-in collective
refuses a tensor that is not on ``meta``; a plan without a group raises
``RuntimeError``; ``chip_smoke``'s planned phase (its
train steps and serve legs) runs on the CPU at smoke configs over a
one-rank gloo group.

Every spawn and the reference's process have a time limit.
"""

import os
import sys

if __name__ == "__main__":  # the reference's meshes need their devices before jax loads
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dataclasses
import functools
import subprocess
import time

import numpy as np
import pytest
import torch

import torch_fsdp_cases as cases  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MeshLayout, make_dry_mesh  # noqa: E402
from repro_torch.launch.roofline import HW  # noqa: E402
from repro_torch.launch.shapes import ShapeCell  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SPAWN_TIMEOUT_S = 180.0
REFERENCE_TIMEOUT_S = 240
METRIC_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-4
CAST_TOL = 2.0**-6  # two bf16 ulps at a leaf's largest magnitude
F32_TOL = 1e-4
SERVE_TOL = 1e-5  # of the logit scale; the reference's planned vs unplanned: 1.2e-6
ZERO_GRAD_LEAVES = ("xattn/bk",)  # cross-attention's key bias: an exact zero gradient


# -- the reference, in a process of its own -------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_state(arch: str):
    """The reference's model and initial train state of ``arch`` (a
    "<name>@<variant>" built from the smoke config with the variant's
    changes, from the same key 0)."""
    from torch_family_cases import _ref_train_state

    name, kw = cases.arch_variant(arch)
    if not kw:
        return _ref_train_state(name)
    import jax

    from repro.train.train_step import init_train_state as ref_init_train_state
    from torch_family_cases import ref_build_model, ref_smoke_config

    ref_model = ref_build_model(dataclasses.replace(ref_smoke_config(name), dtype="float32",
                                                    **kw))
    return ref_model, jax.jit(lambda key: ref_init_train_state(ref_model, key))(
        jax.random.key(0))


def reference_inputs() -> dict:
    """Every arch's initial train state (the reference's, from key 0) and
    batch, flat: ``"<arch>|state|<path>"`` and ``"<arch>|batch|<name>"``."""
    from concurrent.futures import ThreadPoolExecutor

    from torch_family_cases import train_batch

    with ThreadPoolExecutor(len(cases.ARCHS)) as ex:  # compiles overlap a little
        list(ex.map(_ref_state, cases.ARCHS))
    out = {}
    for arch in cases.ARCHS:
        _, ref_state = _ref_state(arch)
        for k, v in flatten(ref_state).items():
            out[f"{arch}|state|{k}"] = np.asarray(v)
        for k, v in train_batch(cases.smoke_cfg(arch), B=cases.BATCH, S=cases.SEQ).items():
            out[f"{arch}|batch|{k}"] = v
    return out


def _ref_mesh(world: int, model: int):
    import jax
    from jax.sharding import AxisType

    return jax.make_mesh((world // model, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:world])


def write_reference(inputs_path: str, path: str) -> None:
    """The inputs first (the ranks start from them), then the reference's
    planned train steps and serving."""
    import jax
    import jax.numpy as jnp

    from repro.serve.serve_step import make_prefill as ref_make_prefill
    from repro.sharding import decode_state_shardings, make_plan, param_shardings
    from repro.train import optimizer as ref_opt
    from repro.train.train_step import TrainHParams as RefHParams
    from repro.train.train_step import make_train_step as ref_make_train_step

    from concurrent.futures import ThreadPoolExecutor

    assert len(jax.devices()) == max(cases.WORLDS), jax.devices()
    inputs = reference_inputs()
    np.savez(inputs_path + ".tmp.npz", **inputs)
    os.replace(inputs_path + ".tmp.npz", inputs_path)

    def run(arch, mb, world, model):
        ref_model, ref_state = _ref_state(arch)
        _, batch = cases.inputs_of(inputs, arch)
        hp = RefHParams(opt=ref_opt.AdamWConfig(**cases.FAST), microbatches=mb)
        # the plan's shardings name their mesh: no mesh context is needed
        plan = make_plan(_ref_mesh(world, model))
        return jax.jit(ref_make_train_step(ref_model, hp, plan=plan))(ref_state, batch)

    def serve(arch, world, model, long_context=False):
        """The prefill's tokens, then the decode logits over the prompt fed
        token by token and the greedy tokens after it (one row, its state
        laid out for a long context, with ``long_context``)."""
        ref_model, ref_state = _ref_state(arch)
        _, batch = cases.inputs_of(inputs, arch)
        plan = make_plan(_ref_mesh(world, model), mode="serve")
        params = jax.device_put(ref_state["params"],
                                param_shardings(ref_state["params"], plan))
        rows = cases.BATCH if not long_context else 1
        first_batch = {k: jnp.asarray(v) for k, v in cases.prompt_batch(batch, rows).items()}
        prompt = first_batch["tokens"]

        def fresh():
            st = ref_model.init_decode_state(prompt.shape[0], cases.CACHE, dtype=jnp.float32)
            return jax.device_put(st, decode_state_shardings(st, plan, long_context))

        first, _ = jax.jit(ref_make_prefill(ref_model, plan))(params, fresh(), first_batch)
        step = jax.jit(lambda p, st, b: ref_model.decode_step(p, st, b, plan=plan))
        state, logits, toks = fresh(), [], []
        for t in range(cases.PROMPT + cases.GREEDY):
            tok = prompt[:, t:t + 1] if t < cases.PROMPT else toks[-1][:, None]
            lg, state = step(params, state, {"token": tok})
            logits.append(np.asarray(lg))
            if t >= cases.PROMPT - 1:
                toks.append(jnp.argmax(lg, axis=-1).astype(jnp.int32))
        return np.asarray(first), np.stack(logits), np.stack([np.asarray(t) for t in toks])

    out = {}
    serving = ([c + (False,) for c in cases.SERVE_CASES]
               + [c + (True,) for c in cases.LONG_CASES])
    with ThreadPoolExecutor(len(cases.CASES) + len(serving)) as ex:
        done = [ex.submit(run, *c) for c in cases.CASES]
        served = [ex.submit(serve, *c) for c in serving]
        for c, fut in zip(cases.CASES, done):
            state, m = fut.result()
            case = cases.case_name(*c)
            for k, v in m.items():
                out[f"{case}|metric|{k}"] = np.asarray(v)
            for kind, tree in (("mu", state["opt"]["mu"]), ("params", state["params"])):
                for k, v in flatten(tree).items():
                    out[f"{case}|{kind}|{k}"] = np.asarray(v)
        for c, fut in zip(serving, served):
            first, logits, toks = fut.result()
            case = cases.serve_name(*c)
            out[f"{case}|value|prefill"] = first
            out[f"{case}|value|logits"] = logits
            out[f"{case}|value|tokens"] = toks
    np.savez(path, **out)


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _start_world(world: int, inputs_path: str, work):
    """A gloo group of ``world`` spawned ranks running ``cases.rank_main``."""
    import torch.multiprocessing as mp

    out_dir = work / f"world{world}"
    out_dir.mkdir()
    return mp.start_processes(
        cases.rank_main, args=(world, str(out_dir / "store"), inputs_path, str(out_dir)),
        nprocs=world, join=False, start_method="spawn")


def _join(procs: list, deadline: float, work) -> None:
    """Wait for every spawned group; raises when a rank fails or time runs
    out (quoting the stacks that ranks dying on a signal left), and kills
    whatever is left."""
    from test_torch_dist_cases import rank_stacks

    try:
        for pc in procs:
            while not pc.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {SPAWN_TIMEOUT_S} s")
    except Exception as e:
        stacks = "\n".join(rank_stacks(str(work / f"world{w}")) for w in cases.WORLDS)
        if not stacks.strip():
            raise
        raise RuntimeError(f"{e}\n{stacks}") from e
    finally:
        for pc in procs:
            for p in pc.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"reference": flat results, world: [rank results] for each world}."""
    work = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep + ROOT + os.pathsep
                         + env.get("PYTHONPATH", ""))
    ref_path, inputs_path = work / "reference.npz", str(work / "inputs.npz")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), inputs_path,
                             str(ref_path)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    procs = []
    try:
        # the world-1 rank (chip_smoke's phase) needs no inputs: it starts at once
        procs.append(_start_world(1, inputs_path, work))
        deadline = time.monotonic() + REFERENCE_TIMEOUT_S
        while not os.path.exists(inputs_path):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "the reference wrote no inputs"
            time.sleep(0.2)
        procs += [_start_world(w, inputs_path, work) for w in cases.WORLDS if w > 1]
        dry = dry_runs(inputs_path)  # host work on the meta device while the ranks run
        _join(procs, time.monotonic() + SPAWN_TIMEOUT_S, work)
        out, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    res = {"reference": _load(ref_path), "dry": dry}
    for world in cases.WORLDS:
        res[world] = [_load(work / f"world{world}" / f"rank{r}.npz") for r in range(world)]
    return res


def _serve_cells(arch: str, long_context: bool) -> dict:
    """{leg: (shape name, cell)} of a serve case as the dry run takes it: the
    prompt's prefill (after llava's image prefix) and one decode step."""
    cfg = cases.smoke_cfg(arch)
    B = 1 if long_context else cases.BATCH
    S = cases.PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    return {"prefill": ("prefill_32k", ShapeCell("case", S, B, "prefill")),
            "step": ("decode_32k", ShapeCell("case", 0, B, "decode"))}


def dry_runs(inputs_path: str) -> dict:
    """{(case, rank): ``dryrun.rank_collectives``} for rank 0 and the last
    rank of every train case (on the case's batch, as ``meta`` tensors of
    the inputs file's shapes) and of every serve case's two legs
    ("<serve case> prefill", "<serve case> step"), at the case's float32
    smoke config on its mesh; the plain versions stand in for the kernels
    (a smoke head_dim has no kernel), which changes no collective."""
    with np.load(inputs_path) as z:
        shapes = {k: (z[k].shape, z[k].dtype) for k in z.files if "|batch|" in k}
    out = {}
    with registry.use_backend("torch"):
        for arch, mb, world, model in cases.CASES:
            case = cases.case_name(arch, mb, world, model)
            batch = {k.split("|", 2)[2]: torch.empty(shape, device="meta",
                                                     dtype=torch.from_numpy(np.zeros(1, dt)).dtype)
                     for k, (shape, dt) in shapes.items() if k.startswith(f"{arch}|batch|")}
            for r in (0, world - 1):
                out[case, r] = dryrun.rank_collectives(
                    cases.arch_variant(arch)[0], "train_4k",
                    cell=ShapeCell("case", cases.SEQ, cases.BATCH, "train"), microbatches=mb,
                    mesh=(world // model, model), rank=r, config=cases.smoke_cfg(arch),
                    inputs=batch)
        for arch, world, model, lc in ([c + (False,) for c in cases.SERVE_CASES]
                                       + [c + (True,) for c in cases.LONG_CASES]):
            case = cases.serve_name(arch, world, model, lc)
            for leg, (shape, cell) in _serve_cells(arch, lc).items():
                for r in (0, world - 1):
                    out[f"{case} {leg}", r] = dryrun.rank_collectives(
                        cases.arch_variant(arch)[0], shape, cell=cell,
                        mesh=(world // model, model), rank=r, config=cases.smoke_cfg(arch),
                        plan_mode="serve", serve_dtype=torch.float32, cache_len=cases.CACHE,
                        long_context=lc)
    return out


# -- comparisons -------------------------------------------------------------------------

def _kind(flat: dict, case: str, kind: str) -> dict:
    pre = f"{case}|{kind}|"
    return {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}


def _cast_by_gather_params(key: str, ndim: int) -> bool:
    """Whether ``gather_params`` casts the leaf at ``key`` to bf16: a
    float32 leaf of a layer body with two or more dims per layer."""
    top = key.split("/")[0]
    per_layer = ndim - 1 if top in ("layers", "enc_layers") else ndim
    return top in ("layers", "enc_layers", "shared") and per_layer >= 2


def _coords(world: int, model: int) -> list[dict]:
    """Each rank's mesh coordinate, ``divmod(rank, model)``."""
    return [{"data": r // model, "model": r % model} for r in range(world)]


def whole_from_ranks(ranks: list, case: str, kind: str, specs: dict, plan) -> dict:
    """Every leaf whole, from the ranks' shards, each placed where its
    rank's coordinate puts it (ranks that hold the same part of a leaf must
    hold it by bits); each shard must have ``local_shape``."""
    parts = [_kind(r, case, kind) for r in ranks]
    coords = _coords(len(ranks), plan.mesh.shape["model"])
    out = {}
    for k, spec in specs.items():
        shards = [p[k] for p in parts]
        whole = np.zeros([n * plan.axis_size(a) for n, a in
                          zip(shards[0].shape, spec + (None,) * shards[0].ndim)],
                         shards[0].dtype)
        want = sharding.local_shape(whole.shape, spec, plan)
        assert all(s.shape == want for s in shards), (case, kind, k, want)
        held = {}
        for shard, coord in zip(shards, coords):
            block = tuple(coord[a] for a in plan.mesh.axis_names
                          if any(a == x or (isinstance(x, tuple) and a in x) for x in spec))
            if block in held:
                assert shard.tobytes() == held[block].tobytes(), (case, kind, k, coord)
                continue
            held[block] = shard
            sharding.local_shard(torch.from_numpy(whole), spec, plan, coord).copy_(
                torch.from_numpy(shard))
        out[k] = whole
    return out


def readings(runs, arch: str, mb: int, world: int, model: int = 1) -> dict:
    """{"cast": largest |mu - ref| / leaf max over the cast leaves, "f32":
    the same over the others, "params_max"/"params_mean": |param - ref| in
    units of lr}, after checking every leaf."""
    case = cases.case_name(arch, mb, world, model)
    ref = runs["reference"]
    model_ = build_model(cases.smoke_cfg(arch), device="cpu")
    from repro_torch.train.train_step import train_state_specs

    plan = sharding.make_plan(MeshLayout.of((world // model, model)))
    specs = flatten(sharding.param_specs(train_state_specs(model_)["params"], plan))
    got_mu = whole_from_ranks(runs[world], case, "mu", specs, plan)
    exp_mu = _kind(ref, case, "mu")
    assert got_mu.keys() == exp_mu.keys()
    top = max(float(np.abs(v).max()) for v in exp_mu.values())
    worst = {"cast": 0.0, "f32": 0.0}
    for k, e in exp_mu.items():
        g = got_mu[k]
        assert g.shape == e.shape and g.dtype == e.dtype, k
        kind = "cast" if _cast_by_gather_params(k, e.ndim) else "f32"
        tol = CAST_TOL if kind == "cast" else F32_TOL
        if k.endswith(ZERO_GRAD_LEAVES):
            assert max(np.abs(g).max(), np.abs(e).max()) <= tol * 1e-2 * top, k
            continue
        scale = float(np.abs(e).max())
        err = float(np.abs(g - e).max()) / scale
        assert err <= tol, (case, k, kind, err)
        worst[kind] = max(worst[kind], err)
    got_p = whole_from_ranks(runs[world], case, "params", specs, plan)
    exp_p = _kind(ref, case, "params")
    diffs = np.concatenate([np.abs(got_p[k] - exp_p[k]).ravel() for k in exp_p])
    lr = cases.FAST["lr"]
    worst["params_max"] = float(diffs.max()) / lr
    worst["params_mean"] = float(diffs.mean()) / lr
    assert worst["params_max"] <= 2 and worst["params_mean"] <= 1e-3, (case, worst)
    return worst


@pytest.mark.parametrize("arch,mb,world,model", cases.CASES,
                         ids=[cases.case_name(*c) for c in cases.CASES])
def test_planned_step_matches_the_reference(runs, arch, mb, world, model):
    case = cases.case_name(arch, mb, world, model)
    ref = _kind(runs["reference"], case, "metric")
    for rank in runs[world]:
        got = _kind(rank, case, "metric")
        assert set(got) == set(ref) == {"loss", "nll", "ntok", "moe_aux", "grad_norm", "lr"}
        for k, e in ref.items():
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
            np.testing.assert_allclose(float(got[k]), float(e), rtol=rtol, atol=1e-7,
                                       err_msg=f"{case} {k}")
        assert int(rank[f"{case}|value|step"]) == 1
        assert bool(rank[f"{case}|value|specs shapes"])  # train_state_specs(model, plan)
        counts = _kind(rank, case, "count")
        assert int(counts["all_gather"]) > int(counts["reduce_scatter"]) > 0, counts
    if arch == "granite-moe-1b-a400m":
        assert float(ref["moe_aux"]) > 0
    print(case, readings(runs, arch, mb, world, model))  # the largest readings, under -s


def _census(flat: dict, case: str) -> dict:
    return {k: {"count": int(v[0]), "bytes": int(v[1])}
            for k, v in _kind(flat, case, "census").items()}


def _same_census(runs, case: str, world: int) -> None:
    for r in (0, world - 1):
        got, exp = _census(runs[world][r], case), runs["dry"][case, r]["collectives"]
        assert got and got == exp, (case, r, got, exp)


@pytest.mark.parametrize("arch,mb,world,model", cases.CASES,
                         ids=[cases.case_name(*c) for c in cases.CASES])
def test_dry_run_census_equals_the_train_ranks(runs, arch, mb, world, model):
    """The dry run of rank 0 and of the last rank on ``meta``: each kind's
    collectives and bytes equal that gloo rank's ``fsdp.census()`` of its
    train step, and its state bytes equal the rank's shards' and
    ``sharding.bytes_per_device`` of the whole state under the plan."""
    case = cases.case_name(arch, mb, world, model)
    _same_census(runs, case, world)
    whole = cases.train_state_specs(build_model(cases.smoke_cfg(arch), device="meta"))
    plan = sharding.make_plan(MeshLayout.of((world // model, model)))
    want = sharding.bytes_per_device(whole, sharding.state_specs(whole, plan), plan)
    for r in (0, world - 1):
        assert int(runs[world][r][f"{case}|value|state bytes"]) == want
        assert runs["dry"][case, r]["state_bytes"] == want


@pytest.mark.parametrize("arch,world,model,long_context",
                         [c + (False,) for c in cases.SERVE_CASES]
                         + [c + (True,) for c in cases.LONG_CASES],
                         ids=[cases.serve_name(*c) for c in cases.SERVE_CASES]
                         + [cases.serve_name(*c, True) for c in cases.LONG_CASES])
def test_dry_run_census_equals_the_serving_ranks(runs, arch, world, model, long_context):
    """The dry run of each serve leg (the prefill, one serve step) at rank 0
    and the last rank: the gloo rank's census of that leg, kind for kind
    (a leg that runs no collective has none), and the serving weights and
    decode state's bytes, ``sharding.bytes_per_device`` of the whole."""
    from repro_torch.models import transformer

    case = cases.serve_name(arch, world, model, long_context)
    for leg in ("prefill", "step"):
        for r in (0, world - 1):
            got = _census(runs[world][r], f"{case} {leg}")
            assert got == runs["dry"][f"{case} {leg}", r]["collectives"], (case, leg, r)
    cfg = cases.smoke_cfg(arch)
    plan = sharding.make_plan(MeshLayout.of((world // model, model)), mode="serve")
    params = cases.train_state_specs(build_model(cfg, device="meta"))["params"]
    state = transformer.init_decode_state(cfg, 1 if long_context else cases.BATCH, cases.CACHE,
                                          torch.float32, device="meta")
    want = (sharding.bytes_per_device(params, sharding.param_specs(params, plan), plan)
            + sharding.bytes_per_device(state, sharding.decode_state_specs(
                state, plan, long_context=long_context), plan))
    for r in (0, world - 1):
        assert int(runs[world][r][f"{case}|value|state bytes"]) == want
        assert runs["dry"][f"{case} prefill", r]["state_bytes"] == want


def test_dry_run_record_holds_the_census_and_its_collective_term():
    """``run_cell`` on a dry mesh records what ``rank_collectives`` counts
    (the same build, under the flop and byte counters too), its collective
    term is the census bytes over ``HW["ici_bw"]``, and its resident bytes
    are the rank's arguments."""
    kw = dict(cell=ShapeCell("case", cases.SEQ, cases.BATCH, "train"), mesh=(2, 2), rank=3,
              config=cases.smoke_cfg("olmo-1b"))
    with registry.use_backend("torch"):
        rec = dryrun.run_cell("olmo-1b", "train_4k", save=False, verbose=False,
                              card=(80e9, "80e9"), **kw)
        light = dryrun.rank_collectives("olmo-1b", "train_4k", **kw)
    coll = rec["collectives"]
    assert rec["status"] == "ok" and rec["n_devices"] == 4 and rec["rank"] == 3
    assert coll["per_op"] == light["collectives"] and coll["total_count"] > 0
    assert coll["total_bytes"] == sum(v["bytes"] for v in coll["per_op"].values())
    assert rec["roofline"]["t_collective_s"] == coll["total_bytes"] / HW["ici_bw"]
    assert rec["memory"]["resident_bytes"] == light["resident_bytes"]


def test_stand_in_collectives_take_meta_tensors_only():
    """A dry mesh's groups are stand-ins: on ``meta`` a collective returns
    what the real one would and counts it; on the CPU it raises, so that no
    run computes values through one."""
    from repro_torch.core.comm import fsdp

    mesh = make_dry_mesh((2, 2), ("data", "model"), rank=3)
    assert (mesh.coord, mesh.data_group.size, mesh.data_group.rank) == (
        {"data": 1, "model": 1}, 2, 1)
    fsdp.reset_counts()
    out = fsdp.gather(torch.empty(3, 5, device="meta"), 0, mesh.data_group)
    assert out.shape == (6, 5) and out.is_meta
    assert fsdp.census() == {"all-gather": {"count": 1, "bytes": 6 * 5 * 4}}
    for bad in (lambda: fsdp.gather(torch.ones(3, 5), 0, mesh.data_group),
                lambda: fsdp.all_reduce(torch.ones(2), mesh.model_group)):
        with pytest.raises(ValueError, match="meta"):
            bad()
    pod = make_dry_mesh((2, 4, 2), ("pod", "data", "model"), rank=13)
    assert pod.coord == {"pod": 1, "data": 2, "model": 1}
    assert (pod.data_group.size, pod.data_group.rank, pod.model_group.size) == (8, 6, 2)
    assert sharding.batch_rows(16, sharding.make_plan(pod)).tolist() == [12, 13]


def _check_serving(runs, arch: str, world: int, model: int, long_context: bool) -> float:
    """One serve case against the reference (the module's notes); returns
    the largest logit error as a share of the logit scale."""
    case = cases.serve_name(arch, world, model, long_context)
    ref = _kind(runs["reference"], case, "value")
    cfg = cases.smoke_cfg(arch)
    plan = sharding.make_plan(MeshLayout.of((world // model, model)), mode="serve")
    from repro_torch.models import transformer

    B = 1 if long_context else cases.BATCH
    specs = cases.state_flat(sharding.decode_state_specs(
        transformer.init_decode_state(cfg, B, cases.CACHE, torch.float32, device="meta"), plan,
        long_context=long_context))
    k = B if long_context else B // (world // model)  # a long context's row is every rank's
    scale = float(np.abs(ref["logits"]).max())
    worst = 0.0
    for r, (rank, coord) in enumerate(zip(runs[world], _coords(world, model))):
        got = _kind(rank, case, "value")
        lo = 0 if long_context else coord["data"] * k
        rows = slice(lo, lo + k)
        assert got["prefill"].tolist() == ref["prefill"][rows].tolist(), (case, r)
        assert got["tokens"].tolist() == ref["tokens"][:, rows].tolist(), (case, r)
        err = float(np.abs(got["logits"] - ref["logits"][:, rows]).max()) / scale
        assert err <= SERVE_TOL, (case, r, err)
        worst = max(worst, err)
        assert bool(got["served"]) and bool(got["state shapes"]), (case, r)
        assert int(got["prefill length"]) == cases.PROMPT
        if coord["model"]:
            lead = runs[world][r - coord["model"]]
            assert got["logits"].tobytes() == _kind(lead, case, "value")["logits"].tobytes()
            st, lead_st = _kind(rank, case, "state"), _kind(lead, case, "state")
            for key, spec in specs.items():
                if "model" not in str(spec):
                    assert st[key].tobytes() == lead_st[key].tobytes(), (case, r, key)
    counts = _kind(runs[world][0], case, "count")
    assert (int(counts["all_reduce"]) > 0) == (model > 1 or long_context), counts
    return worst


@pytest.mark.parametrize("arch,world,model", cases.SERVE_CASES,
                         ids=[cases.serve_name(*c) for c in cases.SERVE_CASES])
def test_planned_serving_matches_the_reference(runs, arch, world, model):
    """The prefill's tokens and the greedy tokens equal the reference's
    planned ones, the decode logits within ``SERVE_TOL`` of the logit
    scale; the model ranks of one data index agree by bits (logits and the
    leaves of the decode state that the spec does not split over "model"),
    every state leaf has ``local_shape`` of its spec, and ``make_serve_step``
    gives the same tokens."""
    print(cases.serve_name(arch, world, model),
          {"logit_err": _check_serving(runs, arch, world, model, False)})


@pytest.mark.parametrize("arch,world,model", cases.LONG_CASES,
                         ids=[cases.serve_name(*c, True) for c in cases.LONG_CASES])
def test_long_context_serving_matches_the_reference(runs, arch, world, model):
    """One row served from a long-context decode state (the KV cache's
    positions over every rank): the reference's tokens and logits (its
    decode step under ``decode_state_shardings(..., long_context=True)``)
    as the planned serve cases hold them; every rank serves the whole row
    and gives the same logits by bits."""
    case = cases.serve_name(arch, world, model, True)
    print(case, {"logit_err": _check_serving(runs, arch, world, model, True)})
    lead = _kind(runs[world][0], case, "value")["logits"].tobytes()
    assert all(_kind(r, case, "value")["logits"].tobytes() == lead for r in runs[world])


@pytest.mark.parametrize("arch,world,model", cases.LONG_CASES,
                         ids=[cases.serve_name(*c, True) for c in cases.LONG_CASES])
def test_long_context_rank_holds_its_block_of_the_cache(runs, arch, world, model):
    """A long-context rank's KV cache holds T / (D * M) of the T positions,
    and its position blocks, laid side by side in rank order, hold the
    sequence the decode wrote: T / world positions a rank, the written
    ones nonzero and the rest zero."""
    case = cases.serve_name(arch, world, model, True)
    written = cases.PROMPT + cases.GREEDY
    blocks = []
    for rank in runs[world]:
        st = _kind(rank, case, "state")
        kv = {k: v for k, v in st.items() if k.startswith("kv/")}
        assert kv and all(v.shape[2] == cases.CACHE // world for v in kv.values()), \
            {k: v.shape for k, v in kv.items()}
        blocks.append(st["kv/k"])
    keys = np.concatenate(blocks, axis=2)  # (L, 1, T, KV, hd), position blocks in rank order
    used = np.abs(keys).reshape(keys.shape[0], keys.shape[2], -1).max(axis=(0, 2)) > 0
    assert used.tolist() == [t < written for t in range(cases.CACHE)], used


@pytest.mark.parametrize("arch,mb,world,model", cases.CASES,
                         ids=[cases.case_name(*c) for c in cases.CASES])
def test_remat_keeps_the_rank_block_of_the_stream(runs, arch, mb, world, model):
    """Every layer input that ``torch.utils.checkpoint`` keeps for the
    backward is (B/D, S/M, d) where the reference splits the stream (a
    model axis M above 1 dividing the S positions, the image prefix
    included), else (B/D, S, d); whisper's encoder layers keep their whole
    stream (B/D, T, d), as the reference's encoder has no ``act_seq``."""
    cfg = cases.smoke_cfg(arch)
    case = cases.case_name(arch, mb, world, model)
    S = (cfg.n_patches if cfg.family == "vlm" else 0) + cases.SEQ
    rows = cases.BATCH // mb // (world // model)
    stream = (rows, S // model if model > 1 and S % model == 0 else S, cfg.d_model)
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    if cfg.family == "hybrid":  # the shared block after each segment
        layers += cfg.n_layers // cfg.shared_attn_every
    for rank in runs[world]:
        names = _kind(rank, case, "value")["carry layers"].tolist()
        shapes = [tuple(x) for x in _kind(rank, case, "value")["carry shapes"].tolist()]
        assert len(names) == mb * layers, names
        for n, sh in zip(names, shapes):
            want = (rows, cfg.enc_positions, cfg.d_model) if n == "_encoder_layer" else stream
            assert sh == want, (case, n, sh, want)


def test_every_family_builds_its_steps_over_the_model_axis(runs):
    """At (2, 2) over gloo world 4, every family (dense, moe, vlm, ssm,
    hybrid, encdec) builds ``make_train_step``, ``make_prefill`` and
    ``make_serve_step`` without raising."""
    for rank in runs[4]:
        assert rank["families|value|built"].tolist() == [
            "dense", "moe", "vlm", "ssm", "hybrid", "encdec"]


def test_planned_checkpoint_equals_one_card_and_restores_to_the_shards(runs):
    r0, r1 = runs[2]
    assert bool(r0["checkpoint|value|equal"]), r0["checkpoint|value|files"]
    assert sorted(r0["checkpoint|value|files"].tolist()) == ["manifest.json", "shard_0.npz"]
    for rank in (r0, r1):  # checkpoint.restore(plan=) and rescale_state onto the group mesh
        assert bool(rank["checkpoint|value|restored"]) and bool(rank["checkpoint|value|rescaled"])


def test_planned_checkpoint_over_both_axes_equals_one_card(runs):
    """At (2, 2) the save gathers each leaf over "data" and "model": the
    files equal one card's by bits, and the restore and ``rescale_state``
    give each rank its shards."""
    name = "checkpoint 2x2"
    assert bool(runs[4][0][f"{name}|value|equal"]), runs[4][0][f"{name}|value|files"]
    for rank in runs[4]:
        assert bool(rank[f"{name}|value|restored"]) and bool(rank[f"{name}|value|rescaled"])


def test_group_meshes_build_their_sub_groups(runs):
    """Over gloo world 4, ``make_group_mesh(model=2)`` and ``(model=4)``: every
    rank at ``divmod(rank, model)``, in a data group of the ranks of its
    model index and a model group of those of its data index (an
    all-reduce over each sums their global ranks); ``model=3`` raises."""
    for rank in runs[4]:
        for m in (2, 4):
            assert rank[f"mesh {m}|value|got"].tolist() == rank[f"mesh {m}|value|want"].tolist()
        assert bool(rank["mesh 3|value|raised"])


def test_step_guard_takes_rank_zero_decision(runs):
    """Rank 1 alone finds step 6 slow: nobody saves; rank 0 alone finds step
    8 slow: both save at step 8."""
    for rank in runs[2]:
        assert (int(rank["guard|value|saves"]), int(rank["guard|value|last"])) == (1, 8)


def test_token_pipeline_gives_each_rank_its_rows(runs):
    rows = [r["pipeline|value|rows"].tolist() for r in runs[2]]
    assert rows == [[0, 2], [1, 3]]  # 2 microbatches of 2 rows, one row a rank in each
    assert all(bool(r["pipeline|value|equal"]) for r in runs[2])


def test_compressed_psum_over_a_group_equals_one_card(runs):
    assert all(bool(r["compress|value|equal"]) for r in runs[4])


def test_ranks_import_neither_jax_nor_the_reference(runs):
    assert not any(bool(r["modules|value|jax"]) for w in (2, 4) for r in runs[w])


# -- refusals and no-ops, in this process -------------------------------------------------

def _olmo():
    return build_model(cases.smoke_cfg("olmo-1b"), device="cpu")


def test_tensor_parallel_plan_raises():
    """A (2, 2) plan of olmo-1b builds up to its missing process group."""
    from repro_torch.train.train_step import TrainHParams, make_train_step

    with pytest.raises(RuntimeError, match="process group"):
        make_train_step(_olmo(), TrainHParams(), plan=sharding.make_plan(MeshLayout.of((2, 2))))


def test_uneven_heads_variant_gathers_its_layers_whole():
    """At (1, 4) the h6s64 variant's specs give neither the Megatron layout
    of the shared attention block nor the Mamba2 head split, so its train
    and serve cases hold the gather-whole fallback to the reference; the
    smoke config's own specs give the split layouts."""
    from repro_torch.models import attention, ssm, transformer

    plan = sharding.make_plan(MeshLayout.of((1, 4)))
    for arch, split in (("zamba2-1.2b@h6s64", False), ("zamba2-1.2b", True)):
        cfg = cases.smoke_cfg(arch)
        full = transformer.param_shapes(cfg)
        layer = transformer._layer_shapes(full["layers"])
        shared = sharding.ModelAxis(None, 4, 1, sharding.model_dims(full["shared"], plan))
        mixer = sharding.ModelAxis(None, 4, 1, sharding.model_dims(layer, plan)).sub("ssm")
        assert (attention.tp_layout(cfg, shared.sub("attn")) is not None) == split, arch
        assert ssm.heads_split(cfg, mixer) == split, arch


def test_plan_without_a_group_raises_and_no_plan_moves_nothing():
    from repro_torch.train.train_step import TrainHParams, make_train_step

    model = _olmo()
    with pytest.raises(RuntimeError, match="process group"):
        make_train_step(model, TrainHParams(), plan=sharding.make_plan(MeshLayout.of((2, 1))))
    with pytest.raises(ValueError, match="train"):
        make_train_step(model, TrainHParams(),
                        plan=sharding.make_plan(MeshLayout.of((2, 1)), mode="serve"))
    tree = {"w": torch.ones(2, 3)}
    assert sharding.gather_params(tree, None) is tree
    h = torch.ones(1, 2, 3)
    assert sharding.act_seq(h, None) is h and sharding.use_param(h, None, "embed") is h


def test_chip_smoke_planned_phase_runs_on_the_cpu(runs):
    """The smoke run's planned phase (``chip_smoke.run_planned_paths``) at
    smoke configs on the CPU over a one-rank gloo group: the planned steps
    equal the one-device steps by bits (both one-device runs repeat by bits
    on the CPU), their census of collectives equals the world-1 dry run's
    and counts what ``fsdp.counts()`` counts, a planned checkpoint equals
    one card's by bits."""
    (rank,) = runs[1]
    for name in ("dense", "hybrid"):
        v = _kind(rank, f"smoke {name}", "value")
        assert int(v["bits"]) == int(v["repeat"]) == int(v["leaves"]) > 0, v
        assert int(v["metrics_by_bits"]) == int(v["metrics"]) > 0, v
        assert v["planned_losses"].tolist() == v["one_losses"].tolist(), v
        c = _kind(rank, f"smoke {name}", "count")
        assert int(c["all_gather"]) > int(c["reduce_scatter"]) > 0, c
        # the world-1 dry run's census of the same step, kind for kind
        census = _census(rank, f"smoke {name}")
        assert census == _census(rank, f"smoke {name} dry"), name
        assert {k: v["count"] for k, v in census.items()} == {
            k.replace("_", "-"): int(v) for k, v in c.items() if int(v)}
    assert bool(rank["smoke checkpoint|value|equal"])
    assert bool(rank["smoke checkpoint|value|restored"])


def test_chip_smoke_planned_serve_legs_run_on_the_cpu(runs):
    """The smoke run's planned serve legs (``chip_smoke.planned_serve``) at
    smoke configs on the CPU over the one-rank gloo group: a prefill and 3
    greedy decode steps of 2 rows under the serve plan, the tokens equal to
    one device's by bits."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    (rank,) = runs[1]
    for arch, _, _ in chip_smoke.PLANNED_SERVE:
        v = _kind(rank, f"smoke serve {cases.smoke_cfg(arch).name}", "value")
        assert bool(v["tokens_equal"]) and int(v["tokens"]) == 2 * (int(v["steps"]) + 1), v


if __name__ == "__main__":
    write_reference(sys.argv[1], sys.argv[2])
