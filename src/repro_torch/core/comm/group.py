"""A rank's block of the P workers, over a ``torch.distributed`` group.

The reference spreads a DDF's P workers over a mesh of devices, one worker
per device. The port holds workers as the leading dimension of every
tensor: on one card all P of them, and over a process group of ``world``
ranks ``P / world`` consecutive workers per rank, rank ``r`` owning the
global workers ``[r * P / world, (r + 1) * P / world)``.

:class:`WorkerBlock` is that block with the three exchanges every
collective of the engine is built from:

- ``gather_workers``: every rank receives every worker's slice;
- ``exchange``: the all-to-all of the ``(local, P, quota)`` shuffle
  buffers, laid out ``[dst, src]``;
- ``permute_workers``: global worker ``g`` receives from ``g - offset``.

Besides these, ``broadcast_ints`` shows every rank one rank's host
decision (a fixed-length vector of ints), and ``barrier`` waits for every
rank: the layers above the operators (the lazy plan, the streaming runner,
the query service) take each decision that sets a shape, a batch, a file or
the next morsel either from values gathered over the group or from rank
0's decision sent this way, so that every rank runs the same steps.

Every collective adds one call and the bytes of its result on this rank,
in the dtype that moved, to :func:`census` under the reference's names
("all-gather", "all-to-all", "collective-permute", and "broadcast"). A
:class:`StandInGroup` (``launch.mesh.make_dry_mesh``) is a group that is
not one: its collectives take ``meta`` tensors, allocate what the real
collective returns, add to the census and move nothing, so that one rank's
part of a run over a mesh of any size can be dry-run in one process
(``launch.dryrun``, ``launch.dryrun_ddf``).

Without a group the block is the whole of one card and the exchanges are
the indexings the one-card engine has always done. With a group they are
NCCL collectives on the card and gloo collectives on the CPU, and every
column moves as its bytes: NCCL has no int16 type, gloo's all-to-all
rejects it, and a byte move keeps NaN payloads and signed zeros, on which
the row hashes depend. This module and ``fsdp.py`` beside it (the model's
gathers, reduce-scatters and all-reduces for a train step over the group)
are the only modules of the port that call ``torch.distributed``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ...device import resolve_device

__all__ = ["WorkerBlock", "block_of", "init_from_env", "close", "StandInGroup", "Census",
           "census", "reset_census", "group_size", "group_rank", "stands_in"]

# the backend each device type takes
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# the collective time limit ``init_from_env`` gave the default group, in
# seconds (None: the group was started elsewhere, with torch's default)
_TIMEOUT_S: float | None = None


class StandInGroup:
    """``size`` ranks of which this process is ``rank``: a process group
    that is not one."""

    def __init__(self, size: int, rank: int):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} is not in a group of {size}")
        self.size, self.rank = int(size), int(rank)

    def __repr__(self) -> str:
        return f"StandInGroup(size={self.size}, rank={self.rank})"


def stands_in(group, *tensors: torch.Tensor) -> bool:
    """True for a :class:`StandInGroup`, whose collectives move nothing;
    a tensor given to one that is not on ``meta`` raises, so that no run
    computes values through a stand-in."""
    if not isinstance(group, StandInGroup):
        return False
    for t in tensors:
        if not t.is_meta:
            raise ValueError(f"a stand-in collective takes meta tensors, got one on "
                             f"{t.device}: a dry mesh runs on the meta device only")
    return True


def group_size(group) -> int:
    return group.size if isinstance(group, StandInGroup) else dist.get_world_size(group)


def group_rank(group) -> int:
    return group.rank if isinstance(group, StandInGroup) else dist.get_rank(group)


class Census:
    """Calls and bytes of each kind of collective since the last reset."""

    def __init__(self):
        self._kinds: dict[str, dict] = {}

    def add(self, kind: str, nbytes: int) -> None:
        d = self._kinds.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += int(nbytes)

    def read(self) -> dict:
        return {k: dict(v) for k, v in self._kinds.items()}

    def reset(self) -> None:
        self._kinds.clear()


_CENSUS = Census()


def census() -> dict:
    """``{kind: {"count", "bytes"}}`` of this module's collectives since
    :func:`reset_census`: the bytes of each result on this rank."""
    return _CENSUS.read()


def reset_census() -> None:
    _CENSUS.reset()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def init_from_env(device=None, timeout: float = 600.0,
                  init_method: str = "env://") -> torch.device:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` for
    the default ``env://`` rendezvous; ``init_method`` may name another,
    such as ``file://``). ``device`` defaults to ``cuda:LOCAL_RANK``,
    which becomes the current card before NCCL starts. The backend follows
    from the device: NCCL for a card, gloo for the CPU. ``timeout``
    (seconds) bounds every collective, so a rank that fails makes the
    others raise instead of waiting. Returns the device."""
    dev = resolve_device(device, per_rank=True)
    backend = _BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no process-group backend for device {dev}")
    for var in ("RANK", "WORLD_SIZE"):
        if var not in os.environ:
            raise RuntimeError(f"{var} is not set: start the ranks with torchrun, "
                               "or set RANK and WORLD_SIZE for each")
    kw = {"device_id": dev} if backend == "nccl" else {}
    global _TIMEOUT_S
    _TIMEOUT_S = float(timeout)
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return dev


def close() -> None:
    """Leave the default process group (every rank calls it)."""
    dist.destroy_process_group()


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n, bytes) uint8: each leading slice as its raw bytes."""
    x = x.contiguous()
    return x.reshape(x.shape[0], -1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(shape)


class WorkerBlock:
    """The workers one process holds: all P of one device (``group=None``),
    or rank ``rank``'s ``P / world`` consecutive workers of a process
    group, on this rank's ``device``."""

    def __init__(self, nworkers: int, device=None, group=None):
        self.nworkers = int(nworkers)
        self.device = device
        self.group = group
        stand_in = isinstance(group, StandInGroup)
        if group is None:
            self.world, self.rank = 1, 0
        else:
            if not stand_in and not dist.is_initialized():
                raise RuntimeError("the process group is not initialised: call "
                                   "repro_torch.core.comm.group.init_from_env() first")
            self.world, self.rank = group_size(group), group_rank(group)
            if self.nworkers % self.world:
                raise ValueError(f"{self.nworkers} workers do not split over "
                                 f"{self.world} ranks (P % world must be 0)")
        if group is not None and not stand_in:
            backend = str(dist.get_backend(group))
            dev = torch.device(device) if device is not None else None
            want = _BACKENDS.get(dev.type) if dev is not None else None
            if want is not None and backend != want:
                raise ValueError(f"a {backend} process group cannot move {dev} tensors; "
                                 f"use {want} for {dev.type}")
        self.local = self.nworkers // self.world
        self.lo = self.rank * self.local
        self.hi = self.lo + self.local

    @property
    def timeout_s(self) -> float:
        """Seconds a collective of this group may wait: what
        :func:`init_from_env` was given, else torch's default."""
        if _TIMEOUT_S is not None or isinstance(self.group, StandInGroup):
            return _TIMEOUT_S
        return dist.default_pg_timeout.total_seconds()

    def local_ids(self) -> torch.Tensor:
        """(local,) int32: the global ids of this block's workers."""
        return torch.arange(self.lo, self.hi, dtype=torch.int32, device=self.device)

    def barrier(self) -> None:
        """Wait for every rank of the group (one device: nothing to wait
        for, its workers run in stream order)."""
        if self.group is not None and not isinstance(self.group, StandInGroup):
            dist.barrier(group=self.group)

    def broadcast_ints(self, values, root: int = 0) -> list[int]:
        """Rank ``root``'s ``values`` on every rank: a vector of int64 of a
        length every rank agrees on (the other ranks pass any values of
        that length), moved on this block's device, which NCCL needs, or
        the CPU for gloo. One device: ``values`` itself."""
        vals = [int(v) for v in values]
        if self.group is None or not vals:
            return vals
        _CENSUS.add("broadcast", 8 * len(vals))
        if isinstance(self.group, StandInGroup):  # a dry run keeps its own decision
            return vals
        t = torch.tensor(vals, dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=dist.get_global_rank(self.group, root), group=self.group)
        return t.cpu().tolist()

    def _check(self, x: torch.Tensor, what: str) -> None:
        if x.shape[0] != self.local:
            raise ValueError(f"{what}: leading dimension {x.shape[0]} is not this "
                             f"block's {self.local} workers")

    def gather_workers(self, x: torch.Tensor) -> torch.Tensor:
        """(local, ...) -> (P, ...): every worker's slice, on every rank."""
        if self.group is None:
            return x
        self._check(x, "gather_workers")
        shape = (self.nworkers,) + tuple(x.shape[1:])
        b = _as_bytes(x)
        if b.numel() == 0:
            return x.new_empty(shape)
        out = torch.empty((self.world * b.shape[0], b.shape[1]), dtype=torch.uint8,
                          device=b.device)
        if not stands_in(self.group, b):
            dist.all_gather_into_tensor(out, b, group=self.group)
        _CENSUS.add("all-gather", _nbytes(out))
        return _from_bytes(out, x.dtype, shape)

    def exchange(self, buf: torch.Tensor) -> torch.Tensor:
        """All-to-all of shuffle buffers: (local_src, P_dst, ...) ->
        (local_dst, P_src, ...), worker ``d`` receiving slab ``[s, d]`` of
        every source ``s``."""
        if self.group is None:
            return buf.transpose(0, 1)
        self._check(buf, "exchange")
        L, W, rest = self.local, self.world, tuple(buf.shape[2:])
        # [src_local, dst_rank, dst_local, ...] -> the destination rank first
        send = buf.reshape((L, W, L) + rest).transpose(0, 1)
        b = _as_bytes(send)
        if b.numel() == 0:
            return buf.new_empty((L, self.nworkers) + rest)
        recv = torch.empty_like(b)
        if not stands_in(self.group, b):
            dist.all_to_all_single(recv, b, group=self.group)
        _CENSUS.add("all-to-all", _nbytes(recv))
        # [src_rank, src_local, dst_local, ...] = [src, dst_local, ...]
        got = _from_bytes(recv, buf.dtype, (self.nworkers, L) + rest)
        return got.transpose(0, 1)

    def permute_workers(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        """(local, ...) -> (local, ...): global worker ``g`` receives the
        slice of worker ``g - offset`` (mod P)."""
        if self.group is None:
            return torch.roll(x, offset, dims=0)
        self._check(x, "permute_workers")
        P, L, W = self.nworkers, self.local, self.world
        dst = [(g + offset) % P for g in range(self.lo, self.hi)]
        src = [(g - offset) % P for g in range(self.lo, self.hi)]
        # slabs leave in order of their global destination and arrive, from
        # each source rank, in order of the receiving worker
        send_order = sorted(range(L), key=lambda i: dst[i])
        recv_order = sorted(range(L), key=lambda i: (src[i] // L, i))
        in_splits = [sum(1 for d in dst if d // L == r) for r in range(W)]
        out_splits = [sum(1 for s in src if s // L == r) for r in range(W)]
        b = _as_bytes(x)
        if b.numel() == 0:
            return x.clone()
        dev = b.device
        send = b[torch.tensor(send_order, device=dev)]
        recv = torch.empty_like(b)
        if not stands_in(self.group, b):
            dist.all_to_all_single(recv, send, output_split_sizes=out_splits,
                                   input_split_sizes=in_splits, group=self.group)
        _CENSUS.add("collective-permute", _nbytes(recv))
        out = torch.empty_like(recv)
        out[torch.tensor(recv_order, device=dev)] = recv
        return _from_bytes(out, x.dtype, x.shape)


def block_of(workers: WorkerBlock | None, x: torch.Tensor) -> WorkerBlock:
    """``workers``, or without one the block of one device: all of ``x``'s
    leading workers."""
    return workers if workers is not None else WorkerBlock(x.shape[0], x.device)
