"""The devices a launch runs on, and the layouts it is planned for.

``make_host_mesh`` describes the visible devices: one H100 on the card,
or the CPU when the caller asks for it. ``make_production_mesh`` gives the
reference's production layouts, 16 x 16 on ("data", "model") and
2 x 16 x 16 on ("pod", "data", "model"), as a :class:`MeshLayout`: a
layout of 256 or 512 H100s with no device behind it, which the sharding
plans (``repro_torch.sharding``) read for its axis sizes. Both are
functions, not module-level constants, so that importing this module
touches no device.

``make_group_mesh`` lays the ranks of a process group out on ("data",
"model"); ``make_dry_mesh`` lays out a mesh of any size the same way, for
one rank of it, over ``core.comm.group.StandInGroup``s: collectives that
take ``meta`` tensors, count and move nothing, so that one process can
dry-run any rank's step (``launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["HostMesh", "MeshLayout", "GroupMesh", "make_host_mesh", "make_production_mesh",
           "make_group_mesh", "make_dry_mesh", "parse_mesh"]


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Devices laid out on named axes (``shape`` maps each axis to its
    size); ``kinds`` are the devices' names."""

    axis_names: tuple[str, ...]
    shape: dict
    devices: tuple[torch.device, ...]
    kinds: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_host_mesh(axes: tuple[str, ...] = ("data",), device=None) -> HostMesh:
    """Every visible device of ``device``'s type (default: the cards; a
    machine without one raises) on the given axes: one axis, or two as
    square as the count allows."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i) for i in range(n))
        kinds = tuple(torch.cuda.get_device_name(i) for i in range(n))
    else:
        devices, kinds = (dev,), (dev.type,)
        n = 1
    if len(axes) == 1:
        shape = {axes[0]: n}
    elif len(axes) == 2:
        a = int(math.sqrt(n))
        while n % a:
            a -= 1
        shape = {axes[0]: a, axes[1]: n // a}
    else:
        raise ValueError(f"one or two axes, got {axes}")
    return HostMesh(tuple(axes), shape, devices, kinds)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Devices laid out on named axes (``shape`` maps each axis to its
    size), with no device behind them: what a sharding plan reads of a
    mesh."""

    axis_names: tuple[str, ...]
    shape: dict

    @classmethod
    def of(cls, sizes: tuple[int, ...], axes: tuple[str, ...] = ("data", "model")) -> MeshLayout:
        if len(sizes) != len(axes):
            raise ValueError(f"{len(sizes)} sizes for the axes {axes}")
        return cls(tuple(axes), dict(zip(axes, sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production layout: 16 x 16 = 256 devices, or
    2 x 16 x 16 = 512 across two groups ("pod"). Touches no device."""
    if multi_pod:
        return MeshLayout.of((2, 16, 16), ("pod", "data", "model"))
    return MeshLayout.of((16, 16), ("data", "model"))


@dataclasses.dataclass(frozen=True, eq=False)
class GroupMesh:
    """The ranks of a process group laid out on ("data", "model"), or on
    ("pod", "data", "model") for a dry mesh: ``coord`` is this rank's
    coordinate, ``group`` the whole group, ``data_group`` the ranks that
    share this rank's model index (the data axes' group: "pod" x "data",
    first axis major, as ``sharding.make_plan``'s ``dp``) and
    ``model_group`` those that share its data index (None at model axis 1,
    where nothing moves over "model")."""

    axis_names: tuple[str, ...]
    shape: dict
    coord: dict
    group: Any
    data_group: Any
    model_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _layout(sizes: tuple[int, ...], rank: int):
    """(coordinate, data-group ranks, model-group ranks) of ``rank`` on a
    row-major mesh whose last axis is "model"."""
    coord = [int(c) for c in np.unravel_index(rank, sizes)]
    model = sizes[-1]
    data_ranks = [r for r in range(math.prod(sizes)) if r % model == coord[-1]]
    model_ranks = [r for r in range(math.prod(sizes)) if r // model == rank // model]
    return coord, data_ranks, model_ranks


def parse_mesh(mesh) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(sizes, axes) of "16x16", "2x16x16" or (D, M): ("data", "model"),
    or ("pod", "data", "model") for three sizes."""
    if isinstance(mesh, str):
        mesh = tuple(int(x) for x in mesh.split("x"))
    sizes = tuple(int(x) for x in mesh)
    if len(sizes) == 2:
        return sizes, ("data", "model")
    if len(sizes) == 3:
        return sizes, ("pod", "data", "model")
    raise ValueError(f"a mesh of two or three axes, got {mesh}")


def make_dry_mesh(sizes: tuple[int, ...], axes: tuple[str, ...] | None = None,
                  rank: int = 0) -> GroupMesh:
    """Rank ``rank`` of a mesh of ``sizes`` on ``axes`` (("data", "model"),
    or ("pod", "data", "model")), laid out as :func:`make_group_mesh` lays
    out a group's ranks, over stand-in groups
    (``core.comm.group.StandInGroup``): no process group behind it, and
    its collectives run on ``meta`` tensors only."""
    from ..core.comm.group import StandInGroup

    sizes = tuple(int(x) for x in sizes)
    axes = parse_mesh(sizes)[1] if axes is None else tuple(axes)
    if axes not in (("data", "model"), ("pod", "data", "model")) or len(axes) != len(sizes):
        raise ValueError(f"a dry mesh lies on ('data', 'model') or ('pod', 'data', 'model'), "
                         f"got {axes} for {sizes}")
    world = math.prod(sizes)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not on a mesh of {world}")
    coord, data_ranks, model_ranks = _layout(sizes, rank)
    return GroupMesh(axes, dict(zip(axes, sizes)), dict(zip(axes, coord)),
                     StandInGroup(world, rank),
                     StandInGroup(len(data_ranks), data_ranks.index(rank)),
                     StandInGroup(len(model_ranks), model_ranks.index(rank))
                     if sizes[-1] > 1 else None)


def make_group_mesh(group=None, model: int = 1) -> GroupMesh:
    """A mesh over ``group`` (default: the default group, which must be
    initialised) at (world / ``model``, ``model``) on ("data", "model").
    Rank ``r`` sits at ``divmod(r, model)``, the row-major device order of
    ``jax.make_mesh``, so that it holds what the reference's device ``r``
    holds. At ``model`` 1 the data axis is the group itself. Otherwise every
    rank of the default group must call this, in the same order:
    ``torch.distributed.new_group`` is collective over the default group,
    so each rank creates every sub-group, those it is not in too."""
    from ..core.comm.fsdp import new_group, resolve_group, world_and_rank

    group = resolve_group(group)
    world, rank = world_and_rank(group)
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the group's {world} ranks")
    data = world // model
    (d, m), _, _ = _layout((data, model), rank)
    shape, coord = {"data": data, "model": model}, {"data": d, "model": m}
    if model == 1:
        return GroupMesh(("data", "model"), shape, coord, group, group)
    # every rank creates every sub-group, in the same order
    data_groups = [new_group(group, _layout((data, model), j)[1]) for j in range(model)]
    model_groups = [new_group(group, _layout((data, model), i * model)[2])
                    for i in range(data)]
    return GroupMesh(("data", "model"), shape, coord, group, data_groups[m], model_groups[d])
