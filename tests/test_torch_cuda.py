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
    assert registry.launch_counts() == {"hash_partition": 0, "segment_reduce": 0,
                                        "flash_attention": 0, "ssd_scan": 0}
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
    assert none == {"hash_partition": 0, "segment_reduce": 0, "flash_attention": 0,
                    "ssd_scan": 0}
    for g, c in zip(gpu, cpu):
        for k in c:
            np.testing.assert_array_equal(g[k], c[k])


# -- model-layer kernels -------------------------------------------------------------

def _normal(shape, dtype, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,H,KV,S", [(64, 4, 2, 200), (128, 2, 2, 129), (256, 4, 1, 97)])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=37, softcap=30.0)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, hd, H, KV, S, kwargs):
    """Ragged S (no multiple of the 64-row tile) at every head_dim the kernel
    takes. Float32: summation order only (2e-5, the reference's kernel test
    tolerance); bf16: the bf16 roundings of P and of the output (2e-2)."""
    q = _normal((2, S, H, hd), dtype, cuda_device, 0)
    k = _normal((2, S, KV, hd), dtype, cuda_device, 1)
    v = _normal((2, S, KV, hd), dtype, cuda_device, 2)
    registry.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="torch", **kwargs)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,KV", [(64, 4, 2), (128, 4, 1), (256, 2, 1)])
@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=700, softcap=30.0)])
def test_flash_bf16_tensor_core_kernel_on_card(cuda_device, hd, H, KV, S, kwargs):
    """The bf16 wgmma kernel at a multiple of its 128-row query tile (4096)
    and at a ragged S spanning more than 3 K/V stages (1000), every head_dim,
    KV < H: one counted launch, within bf16's 2e-2 of the plain version."""
    q = _normal((1, S, H, hd), torch.bfloat16, cuda_device, 10)
    k = _normal((1, S, KV, hd), torch.bfloat16, cuda_device, 11)
    v = _normal((1, S, KV, hd), torch.bfloat16, cuda_device, 12)
    registry.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kwargs)
    torch.cuda.synchronize()
    assert registry.launch_counts()["flash_attention"] == 1
    exp = ops.flash_attention(q, k, v, force="torch", **kwargs)
    torch.testing.assert_close(got.float(), exp.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,ds,H,G,chunk,L", [(64, 64, 4, 1, 256, 700), (64, 128, 4, 2, 64, 300),
                                               (32, 16, 4, 2, 8, 45), (32, 32, 2, 1, 100, 333),
                                               (64, 64, 4, 2, 100, 345), (32, 128, 4, 2, 1024, 3000),
                                               (64, 16, 2, 2, 1024, 2100)])
def test_ssd_kernel_matches_plain_on_card(cuda_device, dh, ds, H, G, chunk, L):
    """Ragged L (no multiple of the chunk), G > 1, every ds the kernel takes,
    at least 3 chunks at chunks 100 and 1024, the final state checked, one
    counted launch for the three passes. Float32 in another summation order
    over up to chunk * (dh + ds) terms: 1e-4."""
    b = 2
    x = _normal((b, L, H, dh), torch.float32, cuda_device, 3)
    dt = torch.rand((b, L, H), generator=torch.Generator().manual_seed(4)).to(cuda_device) * 0.19 + 0.01
    A = -(torch.rand(H, generator=torch.Generator().manual_seed(5)).to(cuda_device) * 1.5 + 0.5)
    B = _normal((b, L, G, ds), torch.float32, cuda_device, 6)
    C = _normal((b, L, G, ds), torch.float32, cuda_device, 7)
    D = _normal((H,), torch.float32, cuda_device, 8)
    registry.reset_launch_counts()
    y, st = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk)
    torch.cuda.synchronize()
    assert registry.launch_counts()["ssd_scan"] == 1
    y_ref, st_ref = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk, force="torch")
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, st_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_model_kernels_refuse_what_they_do_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(q, q, q)
    q16 = torch.zeros((1, 8, 2, 64), dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention_cuda(q16, q16, q16)
    x = torch.zeros((1, 8, 2, 64), device=cuda_device)
    dt = torch.zeros((1, 8, 2), device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    Bm = torch.zeros((1, 8, 1, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan_cuda(x.double(), dt, A, Bm, Bm, A, chunk=4)
    with pytest.raises(ValueError, match="ds"):
        ssd_scan_cuda(x, dt, A, torch.zeros((1, 8, 1, 24), device=cuda_device),
                      torch.zeros((1, 8, 1, 24), device=cuda_device), A, chunk=4)
    registry.reset_launch_counts()
    ops.flash_attention(torch.zeros((1, 0, 2, 64), device=cuda_device),
                        torch.zeros((1, 0, 2, 64), device=cuda_device),
                        torch.zeros((1, 0, 2, 64), device=cuda_device))
    assert registry.launch_counts()["flash_attention"] == 0


@pytest.mark.cuda
def test_smoke_prefill_launches_both_kernels(cuda_device):
    """The zamba2 smoke config with head_dim 64 (the kernel takes 64, 128
    and 256; the smoke config's 16 runs only in the plain version): one
    prefill launches ssd_scan once per layer and flash_attention once per
    shared-block call, and equals the plain versions' prefill (float32)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill

    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"), head_dim=64, dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 37), device=cuda_device)
    prefill = make_prefill(model)
    registry.reset_launch_counts()
    nxt, state = prefill(params, model.init_decode_state(2, 64), {"tokens": tokens})
    assert registry.launch_counts()["ssd_scan"] == cfg.n_layers
    assert registry.launch_counts()["flash_attention"] == cfg.n_layers // cfg.shared_attn_every
    assert state["length"] == 37 and nxt.shape == (2,)
    h, _ = model.forward(params, {"tokens": tokens})
    with registry.use_backend("torch"):
        h_ref, _ = model.forward(params, {"tokens": tokens})
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)
