"""Op-level cost of a PyTorch function: FLOPs, bytes moved and peak live
bytes, counted while it runs.

The port's counterpart of the reference's ``launch/hlo_cost.py``. That
module walks XLA's optimized HLO text because ``cost_analysis()`` counts a
``while`` body once, and the reference's layers and microbatches are
``lax.scan`` loops. Here layers and microbatches run as Python loops, so
every trip dispatches its own operators and is counted as it runs: there
is no HLO and no trip count to parse.

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions, attention operators).
- Bytes: a ``TorchDispatchMode`` that adds, for every aten operator, the
  bytes of its tensor inputs (one read each) and outputs (one write each).
  Views move nothing and allocations (``empty``) write nothing, so neither
  counts. This is the roofline convention of the reference's walker (a
  fused region reads its operands and writes its result once), at the
  granularity of eager operators.
- Kernels: work inside a port kernel is invisible to both counters, since
  the kernels are called through ``ctypes``. Each kernel call adds its
  formula's flops and bytes (``kernels.registry.add_work``, the bound of
  the kernel table in PERF.md) at the launch on the card and in the
  wrapper's stand-in on the ``meta`` device, and :func:`analyze` adds them
  here, so no kernel call counts as zero.
- Peak: the storages every operator creates under the mode are live from
  their creation until ``weakref.finalize`` on the storage fires, on top of
  the storages of the arguments (``resident_bytes``). On the ``meta``
  device this predicts what the card would hold: there the kernels'
  wrappers allocate only what they allocate on the card (their outputs and
  scratch), not their plain versions' temporaries, while the plain
  PyTorch that also runs on the card (the attention and SSD backward)
  allocates as it does there. It relies on PyTorch keeping a storage's
  Python object alive as long as the storage (PyTorch 2.x), and it does
  not model the caching allocator's rounding or fragmentation.

- Collectives: the census that ``core.comm.fsdp`` and
  ``core.comm.group`` keep (:func:`~repro_torch.core.comm.fsdp.census`),
  per kind the calls and the bytes of each result on this rank, the
  counterpart of the reference's HLO census (``collective_bytes_from_hlo``).
  It is the census of a real group's rank, or of one rank of a dry mesh
  (``launch.mesh.make_dry_mesh``), whose stand-in collectives allocate their
  results on ``meta`` and move nothing. One card without a group runs no
  collective: the dataframe's all-to-all is then an on-card transpose,
  whose bytes count as memory traffic.

The reference's ``Cost`` fields are kept; ``collective_bytes_tpu``, a TPU
projection, is not.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..core.comm import fsdp
from ..core.comm import group as group_mod
from ..kernels import registry

__all__ = ["Cost", "analyze", "census_of", "tensors"]

_aten = torch.ops.aten
# allocations: they write nothing
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_like.default,
                _aten.empty_strided.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    # per kind of collective: {"count", "bytes"} on this rank
    collective_counts: dict = dataclasses.field(default_factory=dict)
    # per kernel of this run: {"calls", "flops", "bytes"} by its formula
    kernels: dict = dataclasses.field(default_factory=dict)
    resident_bytes: int = 0  # the arguments' storages
    peak_bytes: int = 0      # resident + the most the function held at once


def tensors(tree) -> list:
    """The tensors of a pytree, looking inside dataclasses (``Table``) and
    dict subclasses (``sharding.RankState``)."""
    out = []
    for x in pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            out += tensors([getattr(x, f.name) for f in dataclasses.fields(x)])
        elif isinstance(x, dict):
            out += tensors(dict(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """Bytes in and out of every operator, and the live bytes of the
    storages created under the mode."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}  # id(storage) -> bytes counted live

    def known(self, storage) -> None:
        """Mark a storage that exists before the run (never counted live)."""
        key = id(storage)
        if key not in self._storages:
            self._storages[key] = 0
            weakref.finalize(storage, self._storages.pop, key, None)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key)

    def _created(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._storages:  # a fresh tensor over a storage already seen
            return
        n = s.nbytes()
        self._storages[key] = n
        weakref.finalize(s, self._release, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        returns = func._schema.returns
        fresh = []  # outputs that alias no input
        if len(returns) == len(outs):
            for r, o in zip(returns, outs):
                if r.alias_info is None:
                    fresh += tensors(o)
        elif len(returns) == 1 and returns[0].alias_info is None:
            fresh = tensors(out)
        if not func.is_view and func not in _ALLOCATIONS:
            self.bytes += sum(map(_nbytes, tensors((args, kwargs)))) \
                + sum(map(_nbytes, tensors(out)))
        for t in fresh:
            self._created(t)
        return out


def analyze(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once under the counters and return its
    :class:`Cost`; the result of ``fn`` is dropped. The tensors of the
    arguments count as resident for the peak."""
    traffic = _Traffic()
    resident = 0
    for t in tensors((args, kwargs)):
        s = t.untyped_storage()
        if id(s) not in traffic._storages:
            traffic.known(s)
            resident += s.nbytes()
    before = registry.kernel_work()
    census_before = _census()
    flop_counter = FlopCounterMode(display=False)
    with flop_counter, traffic:
        fn(*args, **kwargs)
    after = registry.kernel_work()
    colls = _census_delta(census_before, _census())
    kernels = {k: {f: after[k][f] - before[k][f] for f in ("calls", "flops", "bytes")}
               for k in after if after[k]["calls"] != before[k]["calls"]}
    return Cost(flops=float(flop_counter.get_total_flops())
                + sum(w["flops"] for w in kernels.values()),
                bytes=float(traffic.bytes) + sum(w["bytes"] for w in kernels.values()),
                kernels=kernels, resident_bytes=resident,
                peak_bytes=resident + traffic.peak,
                collective_counts=colls,
                collective_bytes=float(sum(c["bytes"] for c in colls.values())))


def _census() -> dict:
    """Both communication modules' census, summed by kind."""
    out: dict = {}
    for part in (fsdp.census(), group_mod.census()):
        for k, v in part.items():
            d = out.setdefault(k, {"count": 0, "bytes": 0})
            d["count"] += v["count"]
            d["bytes"] += v["bytes"]
    return out


def _census_delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k, {"count": 0, "bytes": 0})
        if v["count"] != b["count"]:
            out[k] = {"count": v["count"] - b["count"], "bytes": v["bytes"] - b["bytes"]}
    return out


def census_of(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return only the collectives it
    ran (``Cost.collective_counts``), without the flop and byte counters:
    the census of :func:`analyze` at a fraction of its host time."""
    before = _census()
    fn(*args, **kwargs)
    return _census_delta(before, _census())
