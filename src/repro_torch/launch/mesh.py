"""The devices a launch runs on, and the layouts it is planned for.

``make_host_mesh`` describes the visible devices: one H100 on the card,
or the CPU when the caller asks for it. ``make_production_mesh`` gives the
reference's production layouts, 16 x 16 on ("data", "model") and
2 x 16 x 16 on ("pod", "data", "model"), as a :class:`MeshLayout`: a
layout of 256 or 512 H100s with no device behind it, which the sharding
plans (``repro_torch.sharding``) read for its axis sizes. Both are
functions, not module-level constants, so that importing this module
touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..device import resolve_device

__all__ = ["HostMesh", "MeshLayout", "GroupMesh", "make_host_mesh", "make_production_mesh",
           "make_group_mesh"]


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
    """The ranks of a process group laid out on ("data", "model") at
    (world, 1): ``coord`` is this rank's coordinate, ``group`` the data
    axis's process group."""

    axis_names: tuple[str, ...]
    shape: dict
    coord: dict
    group: Any

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_group_mesh(group=None) -> GroupMesh:
    """A mesh over ``group`` (default: the default group, which must be
    initialised): every rank on the data axis, the model axis of size 1."""
    from ..core.comm.fsdp import resolve_group, world_and_rank

    group = resolve_group(group)
    world, rank = world_and_rank(group)
    return GroupMesh(("data", "model"), {"data": world, "model": 1},
                     {"data": rank, "model": 0}, group)
