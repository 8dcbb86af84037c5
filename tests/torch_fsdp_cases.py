"""The planned train and serve steps over a gloo group: what each rank runs.

``tests/test_torch_fsdp.py`` writes every case's initial state (the
reference's ``init_train_state(model, jax.random.key(0))``) and batch to an
``.npz``, then spawns gloo groups whose ranks run :func:`rank_main`: each
train case whose world is the group's takes one ``make_train_step(model,
hp, plan=make_plan(make_group_mesh(model=M)))`` from its rank's shards and
rows, and writes its metrics and its shards of the first moments and the
parameters; each serve case runs ``make_prefill`` and the decode step
under ``make_plan(make_group_mesh(model=M), mode="serve")`` on the rank's
shards of the parameters and the decode state: a prefill, the prompt fed
token by token, then greedy tokens, writing the logits and tokens of the
rank's rows; each long-context case the same at one row, its decode state
``init_decode_state(1, T, plan=plan, long_context=True)`` (the KV cache's
positions over every rank). Each train case also records the shape of
every residual-stream input that ``torch.utils.checkpoint`` saves, and
world 4 builds every family's train and serve steps at (2, 2). World 2
also runs a planned checkpoint, ``StepGuard`` on fake
clocks and the ``TokenPipeline`` over a grouped context; world 4
``compressed_psum``, the meshes' sub-groups and a planned checkpoint at
(2, 2). Nothing here imports jax or the reference package. No tests of its
own.

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
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_jax_train_state
from repro_torch.train import checkpoint, compress
from repro_torch.train.elastic import StepGuard, rescale_state
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainHParams, make_train_step, shard_train_state,
                                          train_state_specs)
from repro_torch.tree import flatten

# (arch, microbatches, world, model): the mesh is (world / model, model); an
# arch "<name>@<variant>" is the smoke config changed by VARIANTS[variant]
CASES = (("olmo-1b", 1, 2, 1), ("olmo-1b", 2, 2, 1), ("granite-moe-1b-a400m", 1, 2, 1),
         ("zamba2-1.2b", 1, 2, 1), ("whisper-tiny", 1, 2, 1),
         ("llava-next-mistral-7b", 1, 2, 1), ("olmo-1b", 1, 4, 1), ("olmo-1b", 1, 4, 2),
         ("granite-moe-1b-a400m", 1, 4, 4), ("zamba2-1.2b", 1, 4, 2),
         ("olmo-1b@v255", 1, 2, 2), ("zamba2-1.2b@h6s64", 1, 4, 4),
         ("llava-next-mistral-7b", 1, 4, 2), ("whisper-tiny", 1, 4, 4))
# (arch, world, model): planned serving at float32
SERVE_CASES = (("olmo-1b", 2, 1), ("olmo-1b", 4, 2), ("olmo-1b", 4, 4),
               ("granite-moe-1b-a400m", 4, 4), ("zamba2-1.2b", 4, 2),
               ("zamba2-1.2b@h6s64", 4, 4), ("llava-next-mistral-7b", 4, 2),
               ("whisper-tiny", 4, 4), ("whisper-tiny@h6", 4, 4))
# (arch, world, model): long-context serving, one row, the KV cache's CACHE
# positions over every rank of the mesh
LONG_CASES = (("olmo-1b", 4, 2), ("zamba2-1.2b", 4, 1))
# v255: the embedding's and the loss's whole-vocabulary fallbacks at (1, 2);
# h6s64: 6 attention heads and 2 SSM heads, neither dividing a model axis of
# 4, so the shared attention block (wq and wo split over head_dim) and the
# Mamba2 mixers (w_dt and the head vectors whole, w_x split over channels)
# gather their split leaves whole; h6: whisper's self- and cross-attention
# with 6 heads at a model axis of 4, gathered whole the same way
VARIANTS = {"v255": {"vocab_size": 255},
            "h6s64": {"n_heads": 6, "n_kv_heads": 6, "ssm_head_dim": 64},
            "h6": {"n_heads": 6, "n_kv_heads": 6}}
ARCHS = tuple(dict.fromkeys([c[0] for c in CASES + SERVE_CASES + LONG_CASES]))
# every family, for the steps built at (2, 2)
FAMILY_ARCHS = ("olmo-1b", "granite-moe-1b-a400m", "llava-next-mistral-7b", "mamba2-1.3b",
                "zamba2-1.2b", "whisper-tiny")
WORLDS = (1, 2, 4)  # world 1: chip_smoke's planned phase at smoke configs
PROMPT = 6  # prompt tokens fed one at a time, then GREEDY tokens
GREEDY = 3
CACHE = 16  # the decode state's positions
FAST = dict(lr=1e-2, warmup_steps=1)  # step 1 at the full rate: a wrong update shows
BATCH = 4
SEQ = 16  # the train batches' positions
GROUP_TIMEOUT_S = 60.0
PIPE_DOCS = 3000  # tests/test_torch_pipeline.py's corpus


def case_name(arch: str, microbatches: int, world: int, model: int = 1) -> str:
    if model == 1:
        return f"{arch} mb{microbatches} w{world}"
    return f"{arch} mb{microbatches} {world // model}x{model}"


def serve_name(arch: str, world: int, model: int, long_context: bool = False) -> str:
    return f"serve {arch} {world // model}x{model}" + (" long" if long_context else "")


def arch_variant(arch: str) -> tuple[str, dict]:
    """"<name>@<variant>" -> (name, the config's changes); a plain name ->
    (name, {})."""
    name, _, variant = arch.partition("@")
    return name, dict(VARIANTS[variant]) if variant else {}


def smoke_cfg(arch: str):
    name, kw = arch_variant(arch)
    return dataclasses.replace(get_smoke_config(name), dtype="float32", **kw)


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


def state_flat(state: dict) -> dict:
    """A decode state's tensors (or specs) by ``/``-joined path, a KV
    cache's fields by name (its absent scales and the host ``length`` left
    out)."""
    out = {}
    for k, v in state.items():
        if hasattr(v, "_fields"):
            v = {f: x for f, x in v._asdict().items() if x is not None}
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in state_flat(v).items()})
        elif k != "length" and v is not None:
            out[k] = v
    return out


def _record(out: dict, case: str, kind: str, tree: dict) -> None:
    for k, v in flatten(tree).items():
        out[f"{case}|{kind}|{k}"] = v.detach().cpu().numpy()


def record_census(out: dict, case: str, census: dict) -> None:
    """``fsdp.census()`` (or a difference of two) as ``"<case>|census|<kind>"``
    entries of [count, bytes]."""
    for k, v in census.items():
        out[f"{case}|census|{k}"] = np.asarray([v["count"], v["bytes"]], dtype=np.int64)


def census_since(before: dict) -> dict:
    """``fsdp.census()`` less ``before``: the collectives run since."""
    out = {}
    for k, v in fsdp.census().items():
        b = before.get(k, {"count": 0, "bytes": 0})
        if v["count"] != b["count"]:
            out[k] = {"count": v["count"] - b["count"], "bytes": v["bytes"] - b["bytes"]}
    return out


def tree_nbytes(tree) -> int:
    """Bytes of a state's tensors (:func:`state_flat`'s leaves)."""
    return sum(v.numel() * v.element_size() for v in state_flat(tree).values()
               if isinstance(v, torch.Tensor))


def make_meshes(world: int) -> dict:
    """{model: make_group_mesh(model=model)} for every model axis this
    world's cases use, made once and in the same order on every rank."""
    models = sorted({m for _, _, w, m in CASES if w == world}
                    | {m for _, w, m in SERVE_CASES + LONG_CASES if w == world} | {1})
    return {m: make_group_mesh(model=m) for m in models}


def train_cases(world: int, inputs: dict, meshes: dict) -> dict:
    out: dict = {}
    for arch, mb, w, m in CASES:
        if w != world:
            continue
        case = case_name(arch, mb, w, m)
        cfg = smoke_cfg(arch)
        model = build_model(cfg, device="cpu")
        plan = sharding.make_plan(meshes[m])
        state_np, batch = inputs_of(inputs, arch)
        state = shard_train_state(from_jax_train_state(state_np, cfg, device="cpu"), plan)
        hp = TrainHParams(opt=AdamWConfig(**FAST), microbatches=mb)
        fsdp.reset_counts()
        step = make_train_step(model, hp, plan=plan)
        with saved_streams() as carries:
            state, met = step(state, sharding.shard_batch(batch, plan, mb))
        out[f"{case}|value|carry layers"] = np.asarray([n for n, _ in carries])
        out[f"{case}|value|carry shapes"] = np.asarray([s for _, s in carries])
        for k, v in met.items():
            out[f"{case}|metric|{k}"] = np.asarray(float(v))
        for k, v in fsdp.counts().items():
            out[f"{case}|count|{k}"] = np.asarray(v)
        record_census(out, case, fsdp.census())
        out[f"{case}|value|state bytes"] = np.asarray(tree_nbytes(state))
        _record(out, case, "mu", state["opt"]["mu"])
        _record(out, case, "params", state["params"])
        out[f"{case}|value|step"] = np.asarray(int(state["opt"]["step"]))
        held = {k: tuple(v.shape) for k, v in flatten(train_state_specs(model, plan)).items()}
        out[f"{case}|value|specs shapes"] = np.asarray(
            held == {k: tuple(v.shape) for k, v in flatten(state).items()})
        if arch == "olmo-1b" and mb == 1 and (world, m) in ((2, 1), (4, 2)):
            name = "checkpoint" if m == 1 else f"checkpoint {world // m}x{m}"
            out.update(checkpoint_case(state, plan, model, name))
    return out


class saved_streams:
    """Within it, the name of each function that ``models.transformer``
    hands ``torch.utils.checkpoint`` and the shape of its residual-stream
    input (its second argument), in call order: what a layer keeps for its
    recomputation."""

    def __enter__(self) -> list:
        self.seen, self.orig = [], transformer.checkpoint

        def spy(fn, *args, **kw):
            self.seen.append((fn.__name__, tuple(args[1].shape)))
            return self.orig(fn, *args, **kw)

        transformer.checkpoint = spy
        return self.seen

    def __exit__(self, *exc) -> None:
        transformer.checkpoint = self.orig


def prompt_batch(batch: dict, rows: int) -> dict:
    """The serve cases' prompt: the first ``rows`` rows' first PROMPT
    tokens, with the family's patch embeddings or encoder frames."""
    out = {"tokens": batch["tokens"][:rows, :PROMPT]}
    for k in ("patch_embeds", "enc_frames"):
        if k in batch:
            out[k] = batch[k][:rows]
    return out


def serve_cases(world: int, inputs: dict, meshes: dict) -> dict:
    """Each serve case of this world: ``make_prefill`` on the prompt, then
    the decode step fed the prompt token by token and then its own greedy
    tokens, from the rank's shards; the logits and tokens of the rank's
    rows, and ``make_serve_step``'s tokens over the same steps. A
    long-context case serves one row from a long-context decode state."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step

    out: dict = {}
    for arch, w, m, lc in ([c + (False,) for c in SERVE_CASES]
                           + [c + (True,) for c in LONG_CASES]):
        if w != world:
            continue
        case = serve_name(arch, w, m, lc)
        cfg = smoke_cfg(arch)
        model = build_model(cfg, device="cpu")
        plan = sharding.make_plan(meshes[m], mode="serve")
        state_np, batch = inputs_of(inputs, arch)
        params = sharding.shard_params(
            from_jax_train_state(state_np, cfg, device="cpu")["params"], plan)
        B = 1 if lc else batch["tokens"].shape[0]
        rows = {k: torch.as_tensor(v) for k, v in
                sharding.shard_batch(prompt_batch(batch, B), plan).items()}
        prompt = rows["tokens"]

        def fresh():
            return model.init_decode_state(B, CACHE, torch.float32, plan=plan, long_context=lc)

        fsdp.reset_counts()
        with torch.no_grad():
            prefill_state = fresh()
            out[f"{case}|value|state bytes"] = np.asarray(
                tree_nbytes(params) + tree_nbytes(prefill_state))
            first, st = make_prefill(model, plan)(params, prefill_state, rows)
            record_census(out, f"{case} prefill", fsdp.census())
            state, logits, toks = fresh(), [], []
            step = make_serve_step(model, plan)
            served, sstate = [], fresh()
            for t in range(PROMPT + GREEDY):
                tok = prompt[:, t:t + 1] if t < PROMPT else toks[-1][:, None]
                lg, state = model.decode_step(params, state, {"token": tok}, plan=plan)
                before = fsdp.census()
                nxt, sstate = step(params, sstate, {"token": tok})
                if t == 0:
                    record_census(out, f"{case} step", census_since(before))
                logits.append(lg)
                served.append(nxt)
                if t >= PROMPT - 1:
                    toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
        out[f"{case}|value|prefill"] = first.numpy()
        out[f"{case}|value|prefill length"] = np.asarray(st["length"])
        out[f"{case}|value|logits"] = torch.stack(logits).numpy()
        out[f"{case}|value|tokens"] = torch.stack(toks).numpy()
        out[f"{case}|value|served"] = np.asarray(all(
            torch.equal(a, torch.argmax(lg, dim=-1).to(torch.int32))
            for a, lg in zip(served, logits)))
        whole = transformer.init_decode_state(cfg, B, CACHE, torch.float32, device="meta")
        specs = state_flat(sharding.decode_state_specs(whole, plan, long_context=lc))
        got, full = state_flat(state), state_flat(whole)
        out[f"{case}|value|state shapes"] = np.asarray(got.keys() == full.keys() and all(
            tuple(got[k].shape) == sharding.local_shape(full[k].shape, specs[k], plan)
            for k in got))
        for k, v in got.items():
            out[f"{case}|state|{k}"] = v.numpy()
        for k, v in fsdp.counts().items():
            out[f"{case}|count|{k}"] = np.asarray(v)
    return out


def family_steps_case(meshes: dict) -> dict:
    """Every family's train step, prefill and serve step built at (2, 2);
    a refusal raises, and the rank fails."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step

    built = []
    for arch in FAMILY_ARCHS:
        model = build_model(smoke_cfg(arch), device="cpu")
        make_train_step(model, TrainHParams(), plan=sharding.make_plan(meshes[2]))
        serve = sharding.make_plan(meshes[2], mode="serve")
        make_prefill(model, serve)
        make_serve_step(model, serve)
        built.append(model.cfg.family)
    return {"families|value|built": np.asarray(built)}


def checkpoint_case(state: sharding.RankState, plan, model, name: str) -> dict:
    """The planned save of ``state`` against one card's save of the whole
    state (gathered to rank 0 here) by bits, then its restore onto the
    plan and ``rescale_state`` onto the group's mesh against the live
    shards by bits."""
    work = os.path.join(os.environ["FSDP_CASE_DIR"], name.replace(" ", "_"))
    planned, one = os.path.join(work, "planned"), os.path.join(work, "one")
    path = checkpoint.save(planned, 1, state)
    specs = flatten(state.specs)
    whole = {k: sharding.gather_to_root(v, specs[k], plan) for k, v in flatten(state).items()}
    out = {}
    if all(c == 0 for c in plan.mesh.coord.values()):
        one_path = checkpoint.save(one, 1, unflatten(whole))
        names = sorted(os.listdir(path))
        out[f"{name}|value|files"] = np.asarray(names)
        out[f"{name}|value|equal"] = np.asarray(
            names == sorted(os.listdir(one_path)) and all(
                filecmp.cmp(os.path.join(path, n), os.path.join(one_path, n), shallow=False)
                for n in names))
    fsdp.barrier(sharding.mesh_group(plan))
    live = flatten(state)
    for what, (back, step) in (
            ("restored", checkpoint.restore(planned, 1, train_state_specs(model), device="cpu",
                                            plan=plan)),
            ("rescaled", rescale_state(planned, 1, train_state_specs(model), plan.mesh,
                                       device="cpu"))):
        got = flatten(back)
        out[f"{name}|value|{what}"] = np.asarray(
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
        hybrid_seq=32, ckpt_layers=1,
        serve=[(get_smoke_config(a), 2, 32) for a, _, _ in chip_smoke.PLANNED_SERVE],
        decode_steps=3)
    out = {}
    for name in ("dense", "hybrid"):
        rec = res[name]
        for k in ("leaves", "repeat", "bits", "metrics", "metrics_by_bits"):
            out[f"smoke {name}|value|{k}"] = np.asarray(rec[k])
        for k in ("planned_losses", "one_losses"):
            out[f"smoke {name}|value|{k}"] = np.asarray(rec[k])
        for k, v in rec["collectives"].items():
            out[f"smoke {name}|count|{k}"] = np.asarray(v)
        record_census(out, f"smoke {name}", rec["census"])
        record_census(out, f"smoke {name} dry", rec["dry_census"])
    for k in ("equal", "restored"):
        out[f"smoke checkpoint|value|{k}"] = np.asarray(res["checkpoint"][k])
    for leg in res["serve"]:
        for k in ("tokens", "tokens_equal", "steps"):
            out[f"smoke serve {leg['arch']}|value|{k}"] = np.asarray(leg[k])
    return out


def mesh_case(rank: int, world: int, meshes: dict) -> dict:
    """Each mesh's coordinate, its sub-groups' sizes and ranks, and a sum of
    the global ranks over each sub-group (the data group: the ranks of this
    rank's model index; the model group: those of its data index); a model
    axis that does not divide the world raises."""
    import torch.distributed as dist

    out = {}
    for m, mesh in meshes.items():
        if m == 1:
            continue
        d, j = mesh.coord["data"], mesh.coord["model"]
        sums = [int(fsdp.all_reduce(torch.tensor([rank]), g)[0])
                for g in (mesh.data_group, mesh.model_group)]
        out[f"mesh {m}|value|got"] = np.asarray(
            [d, j, mesh.shape["data"], mesh.shape["model"],
             dist.get_world_size(mesh.data_group), dist.get_rank(mesh.data_group),
             dist.get_world_size(mesh.model_group), dist.get_rank(mesh.model_group)] + sums)
        out[f"mesh {m}|value|want"] = np.asarray(
            [rank // m, rank % m, world // m, m, world // m, rank // m, m, rank % m,
             sum(i * m + j for i in range(world // m)), sum(d * m + i for i in range(m))])
    try:
        make_group_mesh(model=3)
        out["mesh 3|value|raised"] = np.asarray(False)
    except ValueError:
        out["mesh 3|value|raised"] = np.asarray(True)
    return out


def rank_main(rank: int, world: int, store: str, inputs_path: str, out_dir: str) -> None:
    """One rank of a gloo group of ``world``: every case of that world,
    written to ``out_dir/rank<r>.npz``."""
    from test_torch_dist_cases import end_rank, start_rank

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      FSDP_CASE_DIR=os.path.join(out_dir, "work"))
    torch.set_num_threads(1)
    stacks = start_rank(out_dir, rank)
    group.init_from_env(device="cpu", timeout=GROUP_TIMEOUT_S, init_method=f"file://{store}")
    try:
        if world == 1:
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **smoke_case())
            end_rank()
            return
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        meshes = make_meshes(world)
        out = train_cases(world, inputs, meshes)
        out.update(serve_cases(world, inputs, meshes))
        plan = sharding.make_plan(meshes[1])
        if world == 2:
            cfg = smoke_cfg("olmo-1b")
            state_np, _ = inputs_of(inputs, "olmo-1b")
            state = shard_train_state(from_jax_train_state(state_np, cfg, device="cpu"), plan)
            out.update(guard_case(state, rank))
            out.update(pipeline_case(plan, cfg.vocab_size))
        else:
            out.update(compress_case(rank))
            out.update(mesh_case(rank, world, meshes))
            out.update(family_steps_case(meshes))
        import sys

        out["modules|value|jax"] = np.asarray("jax" in sys.modules or "repro" in sys.modules)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        end_rank()
    finally:
        group.close()
        stacks.close()
