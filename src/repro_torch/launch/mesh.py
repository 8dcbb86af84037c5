"""The devices a launch runs on.

The reference builds jax meshes: the production 16x16 and 2x16x16 TPU v5e
pods and a host mesh over the visible devices. The port runs on one card,
so only the host mesh has a counterpart: a description of the visible
devices, one H100 on the card or the CPU when the caller asks for it. A
function, not a module-level constant, so that importing this module
touches no device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device

__all__ = ["HostMesh", "make_host_mesh"]


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
