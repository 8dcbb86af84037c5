"""The planned train step over a gloo group: what each rank runs.

``tests/test_torch_fsdp.py`` writes every case's initial state (the
reference's ``init_train_state(model, jax.random.key(0))``) and batch to an
``.npz``, then spawns gloo groups whose ranks run :func:`rank_main`: each
case whose world is the group's takes one ``make_train_step(model, hp,
plan=make_plan(make_group_mesh()))`` from its rank's shards and rows, and
writes its metrics and its shards of the first moments and the parameters.
World 2 also runs a planned checkpoint, ``StepGuard`` on fake clocks and
the ``TokenPipeline`` over a grouped context; world 4 ``compressed_psum``.
Nothing here imports jax or the reference package. No tests of its own.

Results go to ``<out_dir>/rank<r>.npz`` as ``"<case>|<kind>|<path>"``.
"""

from __future__ import annotations

import dataclasses
import filecmp
import os

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import get_smoke_config
from repro_torch.core.comm import fsdp, group
from repro_torch.launch.mesh import make_group_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_train_state
from repro_torch.train import checkpoint, compress
from repro_torch.train.elastic import StepGuard, rescale_state
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainHParams, make_train_step, shard_batch,
                                          shard_train_state, train_state_specs)
from repro_torch.tree import flatten

# (arch, microbatches, world): each case's name is "<arch> mb<microbatches> w<world>"
CASES = (("olmo-1b", 1, 2), ("olmo-1b", 2, 2), ("granite-moe-1b-a400m", 1, 2),
         ("zamba2-1.2b", 1, 2), ("whisper-tiny", 1, 2), ("llava-next-mistral-7b", 1, 2),
         ("olmo-1b", 1, 4))
ARCHS = tuple(dict.fromkeys(a for a, _, _ in CASES))
WORLDS = (1, 2, 4)  # world 1: chip_smoke's planned phase at smoke configs
FAST = dict(lr=1e-2, warmup_steps=1)  # step 1 at the full rate: a wrong update shows
BATCH = 4
GROUP_TIMEOUT_S = 60.0
PIPE_DOCS = 3000  # tests/test_torch_pipeline.py's corpus


def case_name(arch: str, microbatches: int, world: int) -> str:
    return f"{arch} mb{microbatches} w{world}"


def smoke_cfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _fill(like: dict, flat: dict, prefix: str = "") -> dict:
    return {k: _fill(v, flat, f"{prefix}{k}/") if isinstance(v, dict) else flat[prefix + k]
            for k, v in like.items()}


def inputs_of(z: dict, arch: str) -> tuple[dict, dict]:
    """(the reference's initial train state, the batch) of ``arch`` from
    the inputs file's entries ``"<arch>|state|<path>"`` / ``"|batch|"``,
    the state in the layout of the port's (empty norms included)."""
    flat = {k.split("|", 2)[2]: v for k, v in z.items() if k.startswith(f"{arch}|state|")}
    like = train_state_specs(build_model(smoke_cfg(arch), device="cpu"))
    state = _fill(like, {k: v for k, v in flat.items()})
    batch = {k.split("|", 2)[2]: v for k, v in z.items() if k.startswith(f"{arch}|batch|")}
    return state, batch


def _record(out: dict, case: str, kind: str, tree: dict) -> None:
    for k, v in flatten(tree).items():
        out[f"{case}|{kind}|{k}"] = v.detach().cpu().numpy()


def train_cases(world: int, inputs: dict) -> dict:
    out: dict = {}
    for arch, mb, w in CASES:
        if w != world:
            continue
        case = case_name(arch, mb, w)
        cfg = smoke_cfg(arch)
        model = build_model(cfg, device="cpu")
        plan = sharding.make_plan(make_group_mesh())
        state_np, batch = inputs_of(inputs, arch)
        state = shard_train_state(from_jax_train_state(state_np, cfg, device="cpu"), plan)
        hp = TrainHParams(opt=AdamWConfig(**FAST), microbatches=mb)
        fsdp.reset_counts()
        state, m = make_train_step(model, hp, plan=plan)(state, shard_batch(batch, plan, mb))
        for k, v in m.items():
            out[f"{case}|metric|{k}"] = np.asarray(float(v))
        for k, v in fsdp.counts().items():
            out[f"{case}|count|{k}"] = np.asarray(v)
        _record(out, case, "mu", state["opt"]["mu"])
        _record(out, case, "params", state["params"])
        out[f"{case}|value|step"] = np.asarray(int(state["opt"]["step"]))
        held = {k: tuple(v.shape) for k, v in flatten(train_state_specs(model, plan)).items()}
        out[f"{case}|value|specs shapes"] = np.asarray(
            held == {k: tuple(v.shape) for k, v in flatten(state).items()})
        if arch == "olmo-1b" and mb == 1 and world == 2:
            out.update(checkpoint_case(state, plan, model))
    return out


def checkpoint_case(state: sharding.RankState, plan, model) -> dict:
    """The planned save of ``state`` against one card's save of the whole
    state (gathered to rank 0 here) by bits, then its restore onto the
    plan and ``rescale_state`` onto the group's mesh against the live
    shards by bits."""
    work = os.environ["FSDP_CASE_DIR"]
    planned, one = os.path.join(work, "planned"), os.path.join(work, "one")
    path = checkpoint.save(planned, 1, state)
    g = sharding.data_group(plan)
    specs = flatten(state.specs)
    whole = {k: fsdp.gather_to_root(v, sharding.fsdp_dim(specs[k], plan), g)
             for k, v in flatten(state).items()}
    out = {}
    if plan.mesh.coord["data"] == 0:
        one_path = checkpoint.save(one, 1, unflatten(whole))
        names = sorted(os.listdir(path))
        out["checkpoint|value|files"] = np.asarray(names)
        out["checkpoint|value|equal"] = np.asarray(
            names == sorted(os.listdir(one_path)) and all(
                filecmp.cmp(os.path.join(path, n), os.path.join(one_path, n), shallow=False)
                for n in names))
    fsdp.barrier(g)
    live = flatten(state)
    for what, (back, step) in (
            ("restored", checkpoint.restore(planned, 1, train_state_specs(model), device="cpu",
                                            plan=plan)),
            ("rescaled", rescale_state(planned, 1, train_state_specs(model),
                                       make_group_mesh(), device="cpu"))):
        got = flatten(back)
        out[f"checkpoint|value|{what}"] = np.asarray(
            step == 1 and isinstance(back, sharding.RankState) and list(got) == list(live)
            and all(got[k].dtype == live[k].dtype
                    and got[k].numpy().tobytes() == live[k].numpy().tobytes() for k in live))
    return out


def guard_case(state: sharding.RankState, rank: int) -> dict:
    """``StepGuard`` over the group, each rank on a fake clock of its own:
    a slow step on rank 1 alone (step 6) moves nothing, a slow step on rank
    0 alone (step 8) makes every rank save at step 8."""
    slow_at = {0: 8, 1: 6}[rank]
    ticks = iter(float(t) for i in range(10)
                 for t in (10 * i, 10 * i + (9 if i == slow_at else 1)))
    guard = StepGuard(os.path.join(os.environ["FSDP_CASE_DIR"], "guard"), min_history=5,
                      time_fn=lambda: next(ticks))
    for i in range(10):
        state, _ = guard.step(i, lambda st: (st, {}), state)
    return {"guard|value|saves": np.asarray(guard.emergency_saves),
            "guard|value|last": np.asarray(-1 if guard.last_emergency_step is None
                                           else guard.last_emergency_step)}


def pipeline_case(plan, vocab: int) -> dict:
    """``TokenPipeline`` over a grouped context with the plan: this rank's
    rows of the global batch that one process draws from the same seed."""
    from repro_torch.core import DDFContext
    from repro_torch.data.pipeline import TokenPipeline

    import torch.distributed as dist

    kw = dict(n_docs=PIPE_DOCS, vocab=vocab, seq_len=16, batch=BATCH, seed=3,
              quality_threshold=0.2)
    grouped = TokenPipeline(DDFContext(nworkers=4, device="cpu", group=dist.group.WORLD),
                            plan=plan, microbatches=2, **kw)
    one = TokenPipeline(DDFContext(nworkers=4, device="cpu"), **kw)
    rows = sharding.batch_rows(BATCH, plan, 2)
    same = True
    for _ in range(2):
        got, exp = next(grouped), next(one)
        same = same and all(np.array_equal(got[k], exp[k][rows]) for k in exp)
    return {"pipeline|value|rows": rows, "pipeline|value|equal": np.asarray(same)}


def compress_case(rank: int) -> dict:
    """``compressed_psum`` over the group (rank w holds worker w's
    gradients) against the one-card form at P = world, two steps with error
    feedback, by bits."""
    import torch.distributed as dist

    world = dist.get_world_size()
    rng = np.random.default_rng(7)
    steps = [{"a": torch.from_numpy(rng.normal(size=(world, 5, 3)).astype(np.float32)),
              "b": {"c": torch.from_numpy((rng.normal(size=(world, 7)) * 1e-3)
                                          .astype(np.float32))}} for _ in range(2)]
    g = sharding.data_group(sharding.make_plan(make_group_mesh()))
    err = err_one = None
    same = True
    for grads in steps:
        mean, err = compress.compressed_psum({"a": grads["a"][rank],
                                              "b": {"c": grads["b"]["c"][rank]}}, err, group=g)
        mean_one, err_one = compress.compressed_psum(grads, err_one)
        got, exp = flatten(mean), flatten(mean_one)
        e_got, e_exp = flatten(err), flatten(err_one)
        same = same and all(torch.equal(got[k].view(torch.int32), exp[k].view(torch.int32))
                            and torch.equal(e_got[k].view(torch.int32),
                                            e_exp[k][rank].view(torch.int32)) for k in exp)
    return {"compress|value|equal": np.asarray(same)}


def smoke_case() -> dict:
    """``chip_smoke.run_planned_paths`` at smoke configs on the CPU over this
    one-rank group (the pipeline as ``tests/test_torch_train.py`` runs it)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    res = chip_smoke.run_planned_paths(
        get_smoke_config("olmo-1b"), get_smoke_config("zamba2-1.2b"), device="cpu",
        n_docs=1200, workers=2, batch=4, seq=32, microbatches=2, hybrid_batch=2,
        hybrid_seq=32, ckpt_layers=1)
    out = {}
    for name in ("dense", "hybrid"):
        rec = res[name]
        for k in ("leaves", "repeat", "bits", "metrics", "metrics_by_bits"):
            out[f"smoke {name}|value|{k}"] = np.asarray(rec[k])
        for k in ("planned_losses", "one_losses"):
            out[f"smoke {name}|value|{k}"] = np.asarray(rec[k])
        for k, v in rec["collectives"].items():
            out[f"smoke {name}|count|{k}"] = np.asarray(v)
    for k in ("equal", "restored"):
        out[f"smoke checkpoint|value|{k}"] = np.asarray(res["checkpoint"][k])
    return out


def rank_main(rank: int, world: int, store: str, inputs_path: str, out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case of that world,
    written to ``out_dir/rank<r>.npz``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      FSDP_CASE_DIR=os.path.join(out_dir, "work"))
    torch.set_num_threads(1)
    group.init_from_env(device="cpu", timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        if world == 1:
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **smoke_case())
            return
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        out = train_cases(world, inputs)
        plan = sharding.make_plan(make_group_mesh())
        if world == 2:
            cfg = smoke_cfg("olmo-1b")
            state_np, _ = inputs_of(inputs, "olmo-1b")
            state = shard_train_state(from_jax_train_state(state_np, cfg, device="cpu"), plan)
            out.update(guard_case(state, rank))
            out.update(pipeline_case(plan, cfg.vocab_size))
        else:
            out.update(compress_case(rank))
        import sys

        out["modules|value|jax"] = np.asarray("jax" in sys.modules or "repro" in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        group.close()
