"""Sharding plans: where each leaf of a model's state lives on a device mesh.

Train: 2-D sharding, FSDP over the data axes (and "pod"), TP over "model".
Serve: TP-only parameters (each data-parallel replica holds a whole
TP-sharded copy), the batch over the data axes, the KV cache's sequence
over "model" (split-K decode), or over data and model for the batch-1
long-context shape.

Rules are divisibility-aware: each parameter kind carries an ordered list
of candidate specs and the first whose sharded dims divide evenly wins
(granite's 24 heads do not divide a 16-way model axis, so its attention
falls back to head_dim sharding). The rule table is the reference's
(``repro/sharding.py``), value for value.

A spec is a plain tuple, the counterpart of jax's ``PartitionSpec``: one
entry per leading dim, each ``None`` (not split), an axis name, or a tuple
of two or more axis names (split over their product, the first axis
major); trailing dims without an entry are not split and ``()``
replicates. A one-name tuple is written as the name, as ``PartitionSpec``
writes it.

The plans are pure functions of shapes and axis sizes. A mesh is anything
with ``axis_names`` and a ``shape`` mapping (``launch.mesh.HostMesh``, or
the device-less ``launch.mesh.MeshLayout`` of the production meshes), and
the trees may hold ``meta`` tensors: nothing here allocates or touches a
device. One process holds every shard: :func:`local_shard` gives the part
that a mesh coordinate would hold as a view of the whole leaf.

Execution over a process group: a plan over ``launch.mesh.GroupMesh``
(the ranks on ("data", "model"), rank ``r`` at ``divmod(r, model)``) runs
the train and serve steps with every rank holding its :func:`local_shard`
of each leaf (a :class:`RankState` in training). The model-side hooks are
the reference's: :func:`gather_params` casts each float32 leaf of two or
more dims to bf16 and all-gathers it over the data ranks where a layer
uses it, its gradient reduce-scattered back to the shard in bf16
(``core.comm.fsdp``); :func:`use_param` gathers one named leaf without a
cast; both keep the split over "model". :func:`act_seq` is the residual
stream's sequence-parallel layout: where the reference constrains the
stream to ``P(dp, tp, None)`` (:func:`stream_split`), each model rank keeps
its block of the positions between blocks (Megatron's sequence
parallelism), and a layer's model axis says so (``ModelAxis.seq``). The
hooks take the whole leaves' shapes, which a shard does not tell. Over
"model" the layers run Megatron's tensor parallelism on the shards they
hold, each handed the dims its leaves' specs split (:func:`model_axis`;
the collectives are ``core.comm.fsdp``'s *f*, *g* and gathers). A serve
plan gathers nothing over "data" (it has no FSDP axes) and splits the
weights over "model" all the same. A decode state's KV cache holds its
block of the positions over the axes its spec names (:func:`cache_axis`):
"model", or, for a long-context state, every axis of the mesh.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable

import numpy as np
import torch

from .core.comm import fsdp

__all__ = ["ShardingPlan", "make_plan", "param_specs", "gather_spec", "batch_specs",
           "decode_state_specs", "state_specs", "local_shape", "local_shard",
           "local_shards", "bytes_per_device", "data_group", "fsdp_group", "model_group",
           "mesh_group", "ModelAxis", "model_dims", "model_axis", "stream_split",
           "CacheAxis", "cache_axis", "fsdp_dim", "first_holder", "gather_to_root",
           "gather_params", "use_param", "act_seq", "batch_rows", "shard_batch", "shard_params",
           "RankState"]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any
    dp: tuple[str, ...]          # batch axes (e.g. ("pod", "data"))
    tp: str = "model"
    mode: str = "train"          # train | serve

    @property
    def fsdp(self) -> tuple[str, ...]:
        return self.dp if self.mode == "train" else ()

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            return self.mesh.shape[axes]
        return math.prod(self.mesh.shape[a] for a in axes)

    def coords(self):
        """Every mesh coordinate, ``{axis: index}``, the last axis fastest."""
        names = tuple(self.mesh.axis_names)
        for idx in itertools.product(*(range(self.mesh.shape[a]) for a in names)):
            yield dict(zip(names, idx))


def make_plan(mesh, mode: str = "train") -> ShardingPlan:
    dp = tuple(a for a in mesh.axis_names if a != "model")
    return ShardingPlan(mesh=mesh, dp=dp, tp="model", mode=mode)


def _spec(entries) -> tuple:
    """``PartitionSpec``'s canonical form: a one-name tuple is the name, an
    empty one ``None``."""
    out = []
    for axes in entries:
        if isinstance(axes, tuple):
            axes = axes[0] if len(axes) == 1 else (axes or None)
        out.append(axes)
    return tuple(out)


def _tree_map(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest at the same place)`` over the
    tensors of a nested dict / NamedTuple tree (the port's states), keeping
    its structure; anything else (the decode state's host ``length``, a
    KV cache's absent scales) maps to ``None``: it has no spec and no
    bytes on a device."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(r[i] for r in rest), path=path + (f,))
                            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, torch.Tensor):
        return fn(path, tree, *rest)
    return None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _candidates(name: str, plan: ShardingPlan) -> list[tuple]:
    """Ordered spec candidates per (trailing-dims) parameter kind."""
    F: tuple | None = plan.fsdp or None
    T = plan.tp
    rules: dict[str, list[tuple]] = {
        # embeddings (V, d): vocab over TP, d over FSDP
        "embed": [(T, F), (T, None), (None, F), (None, None)],
        "unembed": [(T, F), (T, None), (None, F), (None, None)],
        "pos_embed": [(None, F), (None, None)],
        "enc_pos": [(None, F), (None, None)],
        "vis_proj": [(F, T), (None, None)],
        # attention
        "wq": [(F, T, None), (F, None, T), (F, None, None)],
        "wk": [(F, T, None), (F, None, T), (F, None, None)],
        "wv": [(F, T, None), (F, None, T), (F, None, None)],
        "wo": [(T, None, F), (None, T, F), (None, None, F)],
        "bq": [(T, None), (None, T), (None, None)],
        "bk": [(T, None), (None, T), (None, None)],
        "bv": [(T, None), (None, T), (None, None)],
        # dense mlp
        "w_gate": [(F, T)],
        "w_up": [(F, T)],
        "w_down": [(T, F)],
        # moe (E, d, ff) / (E, ff, d): expert dim unsharded (40/32 don't
        # divide 16); TP inside each expert
        "router": [(F, None), (None, None)],
        "moe/w_gate": [(None, F, T)],
        "moe/w_up": [(None, F, T)],
        "moe/w_down": [(None, T, F)],
        # mamba2
        "w_x": [(F, T)],
        "w_z": [(F, T)],
        "w_b": [(F, None)],
        "w_c": [(F, None)],
        "w_dt": [(F, T), (F, None)],
        "w_out": [(T, F)],
        "conv_x": [(None, T), (None, None)],
        "conv_b": [(None, None)],
        "conv_c": [(None, None)],
        "A_log": [(T,), (None,)],
        "D": [(T,), (None,)],
        "dt_bias": [(T,), (None,)],
    }
    return rules.get(name, [(None,)])


def _fits(spec: tuple, shape: tuple[int, ...], plan: ShardingPlan) -> bool:
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        if dim % plan.axis_size(axes) != 0:
            return False
    return True


def _spec_for(path: tuple, shape: tuple[int, ...], plan: ShardingPlan) -> tuple:
    """The storage spec of the parameter at ``path`` (its dict keys)."""
    keys = [str(k) for k in path]
    name = keys[-1]
    if "moe" in keys and name in ("w_gate", "w_up", "w_down"):
        name = f"moe/{name}"
    # stacked layer dims: rules describe trailing dims; pad leading Nones
    for cand in _candidates(name, plan):
        lead = len(shape) - len(cand)
        if lead < 0:
            continue
        full = (None,) * lead + cand
        if _fits(full, shape, plan):
            return _spec(full)
    return ()  # replicate


def param_specs(tree, plan: ShardingPlan):
    """A tree of parameters (tensors, meta ones too) -> the tree of their
    specs: the counterpart of the reference's ``param_shardings``."""
    return _tree_map(lambda path, t: _spec_for(path, tuple(t.shape), plan), tree)


def gather_spec(path: tuple, shape: tuple[int, ...], plan: ShardingPlan) -> tuple:
    """The storage spec minus the FSDP axes: the ZeRO-3 'gathered at use'
    layout."""
    fs = set(plan.fsdp)
    out = []
    for axes in _spec_for(path, shape, plan):
        if axes is None:
            out.append(None)
        elif isinstance(axes, str):
            out.append(None if axes in fs else axes)
        else:
            kept = tuple(a for a in axes if a not in fs)
            out.append(kept if kept else None)
    return _spec(out)


def state_specs(state, plan: ShardingPlan) -> dict:
    """The specs of a train state {params, opt: {mu, nu, step}}: the
    moments as their parameters, the step replicated."""
    return {"params": param_specs(state["params"], plan),
            "opt": {"mu": param_specs(state["opt"]["mu"], plan),
                    "nu": param_specs(state["opt"]["nu"], plan),
                    "step": ()}}


# ---------------------------------------------------------------------------
# batch / decode-state rules
# ---------------------------------------------------------------------------

def batch_specs(tree, plan: ShardingPlan):
    """tokens / labels / loss_mask (B, S) and frame / patch embeddings
    (B, T, d): the batch over the data axes when it divides."""
    def f(path, t):
        spec = [plan.dp] + [None] * (t.dim() - 1)
        if t.shape[0] % plan.axis_size(plan.dp) != 0:
            spec[0] = None
        return _spec(spec)
    return _tree_map(f, tree)


def decode_state_specs(tree, plan: ShardingPlan, long_context: bool = False):
    """KV caches (L, B, T, KV, hd) and their int8 scales (L, B, T, KV, 1):
    the batch over the data axes, the cache's sequence over TP (split-K
    decode); with ``long_context`` (B = 1) the sequence over data and TP.
    SSM states (L, B, h, dh, ds): the batch over the data axes, heads over
    TP. The host ``length`` has no spec."""
    seq_axes = (plan.dp + (plan.tp,)) if long_context else plan.tp
    batch_axes = None if long_context else plan.dp

    def f(path, t):
        keys = [str(k) for k in path]
        shape = tuple(t.shape)
        if "kv" in keys and len(shape) == 5:
            spec = [None, batch_axes, seq_axes, None, None]
        elif "ssm" in keys and "state" in keys and len(shape) == 5:
            spec = [None, batch_axes, plan.tp, None, None]
            if shape[2] % plan.axis_size(plan.tp) != 0:
                spec[2] = None
        elif "enc_out" in keys:
            spec = [batch_axes, None, None]
        elif len(shape) >= 2 and "conv" in "".join(keys):
            spec = [None, batch_axes] + [None] * (len(shape) - 2)
        elif len(shape) == 0:
            spec = []
        else:
            spec = [None, batch_axes] + [None] * (len(shape) - 2)
        # divisibility guards
        for i, axes in enumerate(spec):
            if axes is not None and shape[i] % plan.axis_size(axes) != 0:
                spec[i] = None
        return _spec(spec)

    return _tree_map(f, tree)


# ---------------------------------------------------------------------------
# layouts on one process (where jax has NamedSharding)
# ---------------------------------------------------------------------------

def local_shape(shape, spec: tuple, plan: ShardingPlan) -> tuple[int, ...]:
    """The shape of one device's shard (``NamedSharding.shard_shape``)."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = list(shape)
    for i, axes in enumerate(spec):
        n = plan.axis_size(axes)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {axes} ({n})")
        out[i] //= n
    return tuple(out)


def _coord(plan: ShardingPlan, coord) -> dict:
    if isinstance(coord, dict):
        return coord
    return dict(zip(plan.mesh.axis_names, coord))


def local_shard(t: torch.Tensor, spec: tuple, plan: ShardingPlan, coord) -> torch.Tensor:
    """The part of ``t`` that mesh coordinate ``coord`` ({axis: index}, or
    the indices in ``axis_names`` order) holds, as a view of ``t``: never a
    copy. A dim split over several axes is cut in their product, the first
    axis major, as jax lays it out."""
    idx = _coord(plan, coord)
    local = local_shape(t.shape, spec, plan)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        k = 0
        for a in (axes,) if isinstance(axes, str) else axes:
            k = k * plan.mesh.shape[a] + idx[a]
        t = t.narrow(dim, k * local[dim], local[dim])
    return t


def local_shards(tree, specs, plan: ShardingPlan, coord):
    """:func:`local_shard` of every leaf of ``tree``."""
    return _tree_map(lambda path, t, s: local_shard(t, s, plan, coord), tree, specs)


def bytes_per_device(tree, specs, plan: ShardingPlan) -> int:
    """The bytes one device holds of ``tree`` laid out by ``specs``
    (every shard has the same shape, so every device holds as many)."""
    sizes = _tree_map(lambda path, t, s: math.prod(local_shape(t.shape, s, plan))
                      * t.element_size(), tree, specs)
    return sum(_leaves(sizes))


# ---------------------------------------------------------------------------
# execution over a process group: FSDP over the data ranks, TP over the model ranks
# ---------------------------------------------------------------------------

def _mesh_of(plan: ShardingPlan):
    mesh = plan.mesh
    if getattr(mesh, "group", None) is None:
        raise RuntimeError(f"a plan over {type(mesh).__name__} has no process group "
                           "to run over: build it on launch.mesh.make_group_mesh()")
    return mesh


def data_group(plan: ShardingPlan | None):
    """The process group of a plan's data axis (the ranks that share this
    rank's model index), or None without a plan. Raises ``RuntimeError``
    for a mesh with no process group behind it."""
    if plan is None:
        return None
    return _mesh_of(plan).data_group


def fsdp_group(plan: ShardingPlan | None):
    """The group a train plan's FSDP axes run over: :func:`data_group`, or
    None when nothing is gathered over "data" (no plan, or a serve plan)."""
    group = data_group(plan)
    return group if plan is not None and plan.fsdp else None


def model_group(plan: ShardingPlan | None):
    """The process group of a plan's model axis (the ranks that share this
    rank's data index), or None without a plan or at model axis 1."""
    if plan is None:
        return None
    mesh = _mesh_of(plan)
    return mesh.model_group if plan.axis_size(plan.tp) > 1 else None


def mesh_group(plan: ShardingPlan | None):
    """The whole group a plan's mesh spans (checkpoints, the gradient norm,
    host decisions), or None without a plan."""
    return None if plan is None else _mesh_of(plan).group


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """What a layer needs to know of the model axis: its ``group``, its
    ``size``, this rank's index ``rank`` on it, ``dims``: for each leaf of
    the parameters it is handed, the dim that the plan's spec splits over
    "model" (None: whole on every model rank), and ``seq``: whether the
    residual stream it takes and gives is split over the model ranks along
    the sequence (:func:`stream_split`; else every model rank holds it
    whole)."""

    group: Any
    size: int
    rank: int
    dims: Any = None
    seq: bool = False

    def sub(self, name: str) -> "ModelAxis":
        """The axis for the parameters' sub-tree (or leaf) ``name``."""
        return dataclasses.replace(self, dims=self.dims[name])


def _model_dim(spec: tuple, plan: ShardingPlan) -> int | None:
    """The dim a spec splits over the model axis (None: not split)."""
    for i, axes in enumerate(spec):
        if plan.tp in ((axes,) if isinstance(axes, str) else (axes or ())):
            return i
    return None


def model_dims(shapes, plan: ShardingPlan):
    """The tree of whole shapes ``shapes`` (a model's parameters, or one
    layer's without its stacking dim) -> the dim of each leaf that its spec
    splits over the model axis (None: whole on every model rank)."""
    def go(s, path):
        if isinstance(s, dict):
            return {k: go(v, path + (k,)) for k, v in s.items()}
        return _model_dim(_spec_for(path, tuple(s), plan), plan)

    return go(shapes, ())


def model_axis(plan: ShardingPlan | None, shapes) -> ModelAxis | None:
    """The plan's model axis for parameters of the whole shapes ``shapes``
    (:func:`model_dims`), or None where the layers run whole (no plan, or a
    model axis of 1)."""
    group = model_group(plan)
    if group is None:
        return None
    return ModelAxis(group, plan.axis_size(plan.tp), plan.mesh.coord[plan.tp],
                     model_dims(shapes, plan))


def stream_split(plan: ShardingPlan | None, seq: int) -> bool:
    """Whether the residual stream of ``seq`` positions is split over the
    model ranks between blocks, where the reference's :func:`act_seq`
    constrains it to ``P(dp, tp, None)``: a model axis larger than 1 that
    divides ``seq``. The reference also asks that the batch divide the data
    axes: a rank's rows here are its block of such a batch
    (:func:`batch_rows`), except a serve batch too small to split, which
    every rank takes whole and whose stream splits all the same (the same
    values)."""
    group = model_group(plan)
    return group is not None and seq % plan.axis_size(plan.tp) == 0


@dataclasses.dataclass(frozen=True)
class CacheAxis:
    """The ranks over which a decode state's KV cache splits its positions:
    their ``group``, its ``size`` and this rank's index ``rank`` in it (the
    block ``[rank * T/size, (rank + 1) * T/size)`` of the T positions)."""

    group: Any
    size: int
    rank: int


def cache_axis(plan: ShardingPlan, spec: tuple) -> CacheAxis | None:
    """The split of a KV cache's positions under ``spec`` (a
    :func:`decode_state_specs` entry, (L, B, T, KV, hd)): over "model" (the
    model group), or over every axis of the mesh (a long-context state: the
    mesh's group, the first axis major); None where the positions are whole
    on every rank."""
    if spec[2] is None:
        return None
    names = (spec[2],) if isinstance(spec[2], str) else tuple(spec[2])
    size = plan.axis_size(names)
    if size == 1:
        return None
    group = model_group(plan) if names == (plan.tp,) else mesh_group(plan)
    rank = 0
    for a in names:
        rank = rank * plan.mesh.shape[a] + plan.mesh.coord[a]
    return CacheAxis(group, size, rank)


def fsdp_dim(spec: tuple, plan: ShardingPlan) -> int | None:
    """The dim a storage spec splits over the FSDP axes (None: not split)."""
    fs = set(plan.fsdp)
    for i, axes in enumerate(spec):
        names = (axes,) if isinstance(axes, str) else (axes or ())
        if fs.intersection(names):
            return i
    return None


def first_holder(spec: tuple, plan: ShardingPlan) -> bool:
    """Whether this rank holds the first copy of its shard of a leaf laid
    out by ``spec``: index 0 on every mesh axis the spec does not split."""
    named = set()
    for axes in spec:
        named.update((axes,) if isinstance(axes, str) else (axes or ()))
    return all(plan.mesh.coord[a] == 0 for a in plan.mesh.axis_names if a not in named)


def gather_to_root(t: torch.Tensor, spec: tuple, plan: ShardingPlan):
    """The whole leaf on rank 0 of the mesh's group from every rank's shard
    ``t`` laid out by ``spec`` (``None`` on the other ranks); every rank
    calls it."""
    shape = [n * plan.axis_size(axes) for n, axes in
             itertools.zip_longest(t.shape, spec[: t.dim()])]
    if list(t.shape) == shape:  # not split: rank 0's own
        return t if plan.mesh.coord == {a: 0 for a in plan.mesh.axis_names} else None
    parts = fsdp.gather_blocks_to_root(t, mesh_group(plan))
    if parts is None:
        return None
    whole = t.new_empty(shape)
    names, sizes = plan.mesh.axis_names, [plan.mesh.shape[a] for a in plan.mesh.axis_names]
    for r, part in enumerate(parts):
        coord = dict(zip(names, np.unravel_index(r, sizes)))
        local_shard(whole, spec, plan, coord).copy_(part)
    return whole


def _gathered(t: torch.Tensor, path: tuple, shape, plan: ShardingPlan, group, cast):
    spec = _spec_for(path, tuple(shape), plan)
    if cast is not None and t.dtype == torch.float32 and t.dim() >= 2:
        t = t.to(cast)  # before the gather: the float32 master stays sharded
    return fsdp.gather(t, fsdp_dim(spec, plan), group)


def gather_params(tree, plan: ShardingPlan | None, shapes=None, cast_dtype=torch.bfloat16):
    """A layer's parameter tree of this rank's shards -> the whole leaves
    (ZeRO-3: gathered at use, inside the layer body that a recomputation
    runs again). Each float32 leaf of two or more dims is cast to
    ``cast_dtype`` before the gather, per use, so its gradient comes back
    in bf16, reduce-scattered, then cast to float32; other leaves are
    gathered as they are; a split over "model" stays. ``shapes`` is the
    tree of the whole leaves' shapes, from which the storage specs follow.
    A no-op without a plan or with no FSDP axes."""
    group = fsdp_group(plan)
    if group is None:
        return tree
    if shapes is None:
        raise ValueError("a planned gather_params needs the whole leaves' shapes")

    def go(t, s, path):
        if isinstance(t, dict):
            return {k: go(v, s[k], path + (k,)) for k, v in t.items()}
        return _gathered(t, path, s, plan, group, cast_dtype)

    return go(tree, shapes, ())


def use_param(leaf: torch.Tensor, plan: ShardingPlan | None, name: str, shape=None):
    """:func:`gather_params` for the one leaf ``name`` (``embed``,
    ``unembed``, ``vis_proj``, the position tables), without a cast;
    ``shape`` is the whole leaf's. ``leaf`` may be rows of the shard (a
    position table's first S rows): only its split dim over "data" is
    gathered."""
    group = fsdp_group(plan)
    if group is None:
        return leaf
    if shape is None:
        raise ValueError(f"a planned use_param of {name!r} needs the whole leaf's shape")
    return _gathered(leaf, (name,), shape, plan, group, None)


def act_seq(h: torch.Tensor, plan: ShardingPlan | None) -> torch.Tensor:
    """The residual stream (B, S, d), whole on every model rank -> the
    reference's sequence-parallel layout between blocks: this rank's block
    of the S positions (B, S/M, d) where :func:`stream_split` says the
    reference splits it (the backward all-gathers), else ``h`` itself."""
    data_group(plan)
    if not stream_split(plan, h.shape[1]):
        return h
    return fsdp.split_seq(h, model_group(plan))


def batch_rows(n: int, plan: ShardingPlan | None, microbatches: int = 1) -> np.ndarray:
    """The rows of an ``n``-row global batch this rank takes (``batch_specs``
    over the data ranks; the model ranks of one data index take the same
    rows), train and serve plans alike: for each of the ``microbatches``
    consecutive microbatches, the rank's block of its rows, so that the
    rank's microbatch ``i`` is its part of the global microbatch ``i``.
    Without a plan, every row. A serve batch whose rows do not split over
    the data ranks (a long-context decode's one row) is every rank's whole,
    as the reference's ``batch_specs`` replicate it; a train batch that does
    not split raises (replicated rows would count twice in the loss)."""
    if data_group(plan) is None:
        return np.arange(n)
    world, rank = plan.axis_size(plan.dp), 0
    for a in plan.dp:  # the rank's index over the data axes, first axis major
        rank = rank * plan.mesh.shape[a] + plan.mesh.coord[a]
    if plan.mode == "serve" and microbatches == 1 and n % world:
        return np.arange(n)
    if n % microbatches or (n // microbatches) % world:
        raise ValueError(f"a batch of {n} rows in {microbatches} microbatches does not "
                         f"split over {world} data ranks")
    m = n // microbatches
    k = m // world
    return np.concatenate([np.arange(i * m + rank * k, i * m + (rank + 1) * k)
                           for i in range(microbatches)])


def shard_batch(batch: dict, plan: ShardingPlan | None, microbatches: int = 1) -> dict:
    """This rank's rows of a global batch (:func:`batch_rows`), numpy
    arrays or tensors. Without a plan, the batch itself."""
    if data_group(plan) is None:
        return batch
    rows = batch_rows(next(iter(batch.values())).shape[0], plan, microbatches)
    return {k: v[torch.as_tensor(rows) if isinstance(v, torch.Tensor) else rows]
            for k, v in batch.items()}


def shard_params(params: dict, plan: ShardingPlan) -> dict:
    """Whole parameters -> this rank's shards under ``plan`` (its
    :func:`param_specs`), each a copy in memory of its own."""
    specs = param_specs(params, plan)
    return _tree_map(lambda path, t, s: local_shard(t, s, plan, plan.mesh.coord).clone(),
                     params, specs)


class RankState(dict):
    """This rank's shards of a train state {params, opt}: the dict itself
    (each leaf in its :func:`local_shape`, its own memory), with ``plan``,
    a plan over a process group, and ``specs``, the whole leaves' storage
    specs (:func:`state_specs`)."""

    def __init__(self, state: dict, plan: ShardingPlan, specs: dict):
        super().__init__(state)
        self.plan = plan
        self.specs = specs
