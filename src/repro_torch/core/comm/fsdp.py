"""The model-side collectives over a process group: ZeRO-3 over the data
ranks, Megatron tensor parallelism over the model ranks.

A train step under a sharding plan holds each parameter as this rank's
shard (``sharding.local_shard``) and gathers it where a layer uses it:

- :func:`gather` all-gathers a leaf along the dim its storage spec splits
  over the data axes; its backward reduce-scatters the cotangent back to
  the shard, in the cotangent's dtype (bf16 for a leaf cast before the
  gather). A leaf the spec does not split (``dim=None``) is read as it is,
  and its backward all-reduces the cotangent: every rank's partial gradient
  of a replicated leaf summed.
- :class:`AllReduceSum` sums a tensor over the ranks with autograd: its
  backward sums the cotangents, so a global mean feeding every rank's loss
  gets the gradient of the sum of the ranks' losses.
- :func:`all_reduce`, :func:`gather_blocks_to_root` and :func:`broadcast_ints`
  move values without autograd (metrics, the gradient norm, checkpoints,
  host decisions).

Over the model ranks, which hold the same rows and split a layer's weights,
a block starts from an input every rank holds whole and ends in a sum of
the ranks' partial outputs:

- :func:`copy_to_model` is the identity whose backward all-reduces
  (Megatron's *f*): a value every rank holds, which each rank uses for its
  own part of the work, gets the sum of the ranks' partial cotangents.
- :func:`reduce_from_model` all-reduces, its backward the identity (*g*):
  the partial outputs summed, after which every rank computes the same.
- :func:`gather_whole` all-gathers along a dim, its backward taking the
  rank's slice: for a value every rank then uses whole, so that each rank's
  cotangent is already the whole one. :func:`gather` is the gather for a
  value each rank uses only in part (its backward reduce-scatters).

Where the residual stream between blocks is split over the model ranks
along the sequence (Megatron's sequence parallelism: each rank holds its
block of the positions), *f* and *g* become a gather and a scatter of the
sequence (dim 1):

- :func:`gather_seq` all-gathers the blocks, its backward reduce-scatters
  (*f*: every rank then uses the whole sequence for its part of the work).
- :func:`scatter_seq` reduce-scatters the ranks' partial outputs, its
  backward all-gathers (*g*: each rank keeps the sum of its block).
- :func:`split_seq` takes the rank's block of a sequence every rank holds
  whole, its backward all-gathers (where the stream is first split, and
  after a block that every rank computed whole).

Every collective is the real one, on NCCL for cards and gloo for the CPU,
whatever the world size: a group of one rank copies. :func:`counts`
tells how many of each kind ran since :func:`reset_counts`, and
:func:`census` how many and how many bytes, under the reference's names
("all-gather", "reduce-scatter", "all-reduce", "gather"): the bytes of
each collective's result on this rank, in the dtype that moved (a leaf
cast to bf16 before its gather counts bf16). Over a
``group.StandInGroup`` (``launch.mesh.make_dry_mesh``) every collective
takes ``meta`` tensors, allocates its result, counts and moves nothing.

This module and ``group.py`` beside it are the modules of the port that
call ``torch.distributed``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .group import Census, StandInGroup, group_rank, group_size, stands_in

__all__ = ["resolve_group", "world_and_rank", "new_group", "gather", "gather_whole",
           "copy_to_model", "reduce_from_model", "gather_seq", "scatter_seq", "split_seq",
           "AllReduceSum", "all_reduce_sum",
           "all_reduce", "gather_blocks_to_root", "broadcast_ints",
           "barrier", "counts", "census", "reset_counts"]

# the single-tensor collectives (torch renamed them; both take the same arguments)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

_COUNTS = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
_CENSUS = Census()
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def counts() -> dict:
    """Collectives run by this module since :func:`reset_counts`."""
    return dict(_COUNTS)


def census() -> dict:
    """``{kind: {"count", "bytes"}}`` of this module's collectives since
    :func:`reset_counts`: the bytes of each result on this rank."""
    return _CENSUS.read()


def reset_counts() -> None:
    """Zero :func:`counts` and :func:`census`."""
    for k in _COUNTS:
        _COUNTS[k] = 0
    _CENSUS.reset()


def _counted(key: str, kind: str, out: torch.Tensor) -> None:
    _COUNTS[key] += 1
    _CENSUS.add(kind, out.numel() * out.element_size())


def resolve_group(group=None):
    """``group``, or the default group; raises when none is initialised."""
    if isinstance(group, StandInGroup):
        return group
    if not dist.is_initialized():
        raise RuntimeError("the process group is not initialised: call "
                           "repro_torch.core.comm.group.init_from_env() first")
    return dist.group.WORLD if group is None else group


def world_and_rank(group) -> tuple[int, int]:
    group = resolve_group(group)
    return group_size(group), group_rank(group)


def new_group(group, ranks: list[int]):
    """A sub-group of ``group`` of its ranks ``ranks`` (ranks of ``group``),
    with the default group's backend and time limit. Collective over the
    default group: every rank calls it, in the same order."""
    import datetime

    from . import group as group_mod

    group = resolve_group(group)
    kw = ({} if group_mod._TIMEOUT_S is None
          else {"timeout": datetime.timedelta(seconds=group_mod._TIMEOUT_S)})
    return dist.new_group([dist.get_global_rank(group, r) for r in ranks], **kw)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    world = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((world * xt.shape[0],) + tuple(xt.shape[1:]))
    if not stands_in(group, xt):
        _all_gather(out, xt, group=group)
    _counted("all_gather", "all-gather", out)
    return out.movedim(0, dim).contiguous()


def _layout(t: torch.Tensor) -> list[int] | None:
    """The order of ``t``'s dims in memory, outermost first (``t.permute``
    of it is contiguous), or None when ``t`` is not dense."""
    perm = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    return perm if t.permute(perm).is_contiguous() else None


def _inverse(perm: list[int]) -> list[int]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


# A gradient comes back from a collective in the layout its cotangent came
# in (a transposed product's cotangent stays transposed), as one device's
# gradient would: a reduction over it (the gradient norm) then adds in the
# same order, and a group of one rank gives one device's bits.

def _reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    world = group_size(group)
    perm = _layout(g) or list(range(g.dim()))
    gp = g.permute(perm).contiguous()  # a view when g is dense
    p = perm.index(dim)
    gt = gp if p == 0 else gp.movedim(p, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // world,) + tuple(gt.shape[1:]))
    if not stands_in(group, gt):
        _reduce_scatter(out, gt, group=group)
    _counted("reduce_scatter", "reduce-scatter", out)
    if p:
        out = out.movedim(0, p).contiguous()
    return out.permute(_inverse(perm))


def _all_reduce_(x: torch.Tensor, op: str, group) -> torch.Tensor:
    if not stands_in(group, x):
        dist.all_reduce(x, op=_OPS[op], group=group)
    _counted("all_reduce", "all-reduce", x)
    return x


def _all_reduced(g: torch.Tensor, group) -> torch.Tensor:
    """A sum of ``g`` over the ranks, in ``g``'s layout."""
    perm = _layout(g)
    if perm is None:
        return _all_reduce_(g.contiguous().clone(), "sum", group)
    out = g.clone()  # keeps a dense layout
    _all_reduce_(out.permute(perm), "sum", group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        if dim is None:
            return x.view_as(x)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is None:
            return _all_reduced(g, ctx.group), None, None
        return _reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def gather(x: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """This rank's shard ``x`` of a leaf split along ``dim`` over the
    ranks of ``group`` -> the whole leaf (contiguous, in ``x``'s dtype);
    the backward reduce-scatters the cotangent to the shard. ``dim=None``:
    ``x`` is the whole leaf on every rank; the backward all-reduces."""
    return _Gather.apply(x, dim, group)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = group_rank(group)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def gather_whole(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' slices ``x`` along ``dim`` -> the whole tensor on every
    rank of ``group``; the backward takes the rank's slice of the cotangent
    (every rank uses the whole value, so its cotangent is the whole one)."""
    return _GatherWhole.apply(x, dim, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduced(g, ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; the backward sums the cotangent over ``group``
    (Megatron's *f*, before the column-split products)."""
    return _CopyToModel.apply(x, group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group``; the backward is
    the identity (Megatron's *g*, after the row-split products)."""
    return _ReduceFromModel.apply(x, group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, 1, ctx.group), None


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of the sequence ``x`` (B, S/M, ...) -> the whole
    (B, S, ...) on every rank of ``group``; the backward reduce-scatters the
    cotangent (sequence-parallel *f*)."""
    return _GatherSeq.apply(x, group)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 1, ctx.group), None


def scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` (B, S, ...) over ``group``, this
    rank's block of the sequence (B, S/M, ...) of it; the backward
    all-gathers (sequence-parallel *g*)."""
    return _ScatterSeq.apply(x, group)


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        world, rank = group_size(group), group_rank(group)
        n = x.shape[1] // world
        return x.narrow(1, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 1, ctx.group), None


def split_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the sequence of ``x`` (B, S, ...), which every
    rank of ``group`` holds whole; the backward all-gathers the blocks'
    cotangents (every rank's whole value then gets the whole one)."""
    return _SplitSeq.apply(x, group)


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the ranks of ``group``; the backward sums the
    cotangents the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.contiguous().clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), "sum", ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return AllReduceSum.apply(x, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``op`` ("sum" or "max") of ``x`` over the ranks of ``group``, a new
    tensor, outside autograd."""
    return _all_reduce_(x.detach().contiguous().clone(), op, group)


def gather_blocks_to_root(x: torch.Tensor, group, root: int = 0):
    """Every rank's ``x`` (all of one shape) on rank ``root`` of ``group``
    as a list in rank order (``None`` elsewhere)."""
    world, rank = world_and_rank(group)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(world)] if rank == root else None
    if not stands_in(group, x):
        dist.gather(x, parts, dst=dist.get_global_rank(group, root), group=group)
    # the result on this rank: every part on the root, nothing elsewhere
    _CENSUS.add("gather", world * x.numel() * x.element_size() if rank == root else 0)
    return parts


def broadcast_ints(values, group, device, root: int = 0) -> list[int]:
    """Rank ``root``'s ``values`` (ints) on every rank of ``group``, moved
    on ``device`` (a card for NCCL, the CPU for gloo)."""
    from .group import WorkerBlock

    world, _ = world_and_rank(group)
    return WorkerBlock(world, device, group).broadcast_ints(values, root=root)


def barrier(group) -> None:
    if not isinstance(group, StandInGroup):
        dist.barrier(group=group)
