"""The port's Hopper kernels on the card.

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (bit for bit; float sums on integer-valued inputs), and the DDF
slice on the card against the same slice on the CPU. Every test needs a
CUDA device and skips without one. This file imports neither jax nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import DDF, DDFContext
from repro_torch.data import uniform_table
from repro_torch.kernels import ops, registry

AGGS = {"c1": ("sum", "min", "max", "count", "mean")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 100_003])
def test_hash_kernel_matches_plain_on_card(cuda_device, n):
    k = torch.randint(-2**31, 2**31 - 1, (n, 2), dtype=torch.int32, device=cuda_device)
    registry.reset_launch_counts()
    d, h = ops.hash_partition(k, 8)
    assert registry.launch_counts()["hash_partition"] == 1
    d_ref, h_ref = ops.hash_partition(k, 8, force="torch")
    assert torch.equal(d, d_ref) and torch.equal(h, h_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32, torch.float32])
def test_segment_kernel_matches_plain_on_card(cuda_device, dtype, op):
    n = 100_003
    seg = torch.sort(torch.randint(0, 5000, (n,), device=cuda_device)).values.to(torch.int32)
    if dtype == torch.float32:
        vals = torch.randint(-1000, 1000, (n, 2), device=cuda_device).to(torch.float32)
    else:
        vals = torch.randint(-2**31, 2**31 - 1, (n, 2), dtype=torch.int32,
                             device=cuda_device).view(dtype)
    got = ops.segment_reduce(vals, seg, 5003, op=op)
    exp = ops.segment_reduce(vals, seg, 5003, op=op, force="torch")
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    registry.reset_launch_counts()
    d, h = ops.hash_partition(torch.empty((0, 2), dtype=torch.int32, device=cuda_device), 8)
    out = ops.segment_reduce(torch.empty((0, 1), dtype=torch.int32, device=cuda_device),
                             torch.empty(0, dtype=torch.int32, device=cuda_device), 3, op="min")
    assert registry.launch_counts() == {"hash_partition": 0, "segment_reduce": 0}
    assert d.numel() == 0 and h.tolist() == [0] * 8
    assert out[:, 0].tolist() == [2**31 - 1] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.float16])
def test_groupby_of_unported_dtype_raises_on_card(cuda_device, dtype):
    vals = torch.from_numpy(np.zeros((4, 1), dtype)).to(cuda_device)
    with pytest.raises(TypeError, match="ROADMAP queue A"):
        ops.segment_reduce(vals, torch.zeros(4, dtype=torch.int32, device=cuda_device), 1)
    ctx = DDFContext(nworkers=2, device="cuda")
    t = {"c0": np.arange(64, dtype=np.int32) % 5, "c1": np.arange(64).astype(dtype)}
    with pytest.raises(TypeError, match="ROADMAP queue A"):
        DDF.from_numpy(t, ctx).groupby(("c0",), {"c1": ("sum",)}, pre_combine=True)


@pytest.mark.cuda
def test_slice_on_card_goes_through_the_kernels(cuda_device):
    outs = {}
    for device in ("cuda", "cpu"):
        ctx = DDFContext(nworkers=4, device=device)
        L = DDF.from_numpy(uniform_table(4000, 0.5, seed=1), ctx)
        R = DDF.from_numpy(uniform_table(4000, 0.5, seed=2), ctx)
        registry.reset_launch_counts()
        J, _ = L.join(R, on=("c0",), strategy="shuffle")
        G, _ = J.groupby(("c0",), AGGS, pre_combine=True)
        U, _ = G.unique(("c0",))
        outs[device] = (U.partitions(), registry.launch_counts())
    (gpu, launches), (cpu, none) = outs["cuda"], outs["cpu"]
    assert launches["hash_partition"] > 0 and launches["segment_reduce"] > 0
    assert none == {"hash_partition": 0, "segment_reduce": 0}
    for g, c in zip(gpu, cpu):
        for k in c:
            np.testing.assert_array_equal(g[k], c[k])
