"""Flash-attention kernel: the model layer's full-sequence attention.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``,
``flash_attention`` (body ``_kernel``): causal or bidirectional GQA
attention with an online softmax, an optional sliding window (key ``t``
visible to query ``r`` when ``t > r - window``) and an optional logit
softcap ``c * tanh(s / c)``. q is (B, S, H, hd), k and v (B, S, KV, hd);
query head ``h`` reads K/V head ``h // (H // KV)``. Inputs are bf16 or
float32, scores, softmax and sums are float32 inside, the output has q's
dtype.

Bound on the card: operations, ``4 * B * H * S * S * hd`` flops (half when
causal) at 989 TFLOP/s (H100 SXM data sheet, bf16 dense), far above the
bytes moved. The CUDA source (``csrc/flash_attention.cu``) holds two
kernels, picked by dtype. bf16 runs on the tensor cores: a block owns one
(batch, head) and 128 query rows in two consumer warpgroups; a producer
thread keeps K/V tiles in flight through TMA into a ring of shared-memory
stages; ``S = Q K^T`` and ``O += P V`` are ``wgmma`` products (P from
registers in bf16, V read through the transpose bit), and the online
softmax runs in float32 on the accumulators. float32 keeps the CUDA-core
kernel: the products in float32, as the TPU kernel's arithmetic, a block
per (batch, head) and 64 query rows. Both visit only tiles some query can
see and schedule the heaviest query tiles first, and both take head_dim 64,
128 and 256. head_dim 80 (stablelm-3b) runs the hd 128 kernels on q, k and
v zero-padded to 128 columns, with the scale of the true head_dim, and
keeps the first 80 columns of the output: zero columns add nothing to the
scores, and the output's padded columns are zero, so the result is exact,
for 1.6 times the work. Either dtype counts as one ``flash_attention``
launch.

The bf16 kernel rounds the probabilities to bf16 before the PV product, as
the reference model does (``src/repro/models/attention.py:106``); the row
sums come from the float32 probabilities. The TPU kernel, and the float32
kernel here, keep them in float32.

:func:`flash_attention_ref` is the plain PyTorch version: the dense masked
softmax of ``src/repro/kernels/ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import torch

from . import cuda_lib, registry

__all__ = ["flash_attention_ref", "flash_attention_cuda", "HEAD_DIMS"]

HEAD_DIMS = (64, 80, 128, 256)
_PADDED = {80: 128}  # head_dims run by a wider kernel on zero-padded inputs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, softcap):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, S, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of K/V heads {KV}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version: (B, S, H, hd) in q's dtype, dense masked softmax in
    float32."""
    _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    s = torch.einsum("bqhgc,bthc->bhgqt", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqt,bthc->bqhgc", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`flash_attention_ref`, for
    bf16 and float32 and head_dim 64, 80, 128 or 256."""
    _check(q, k, v, window, softcap)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_cuda takes bfloat16 or float32, got {q.dtype}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head_dim {HEAD_DIMS}, got {hd}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if B * H >= 2**31 or -(-S // 64) > 65535:
        raise ValueError(f"B * H = {B * H} or S = {S} exceeds the kernel's grid")
    scale = hd ** -0.5 if scale is None else scale
    kernel_hd = _PADDED.get(hd, hd)
    if kernel_hd != hd:
        q, k, v = (torch.nn.functional.pad(x, (0, kernel_hd - hd)) for x in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out[..., :hd]  # nothing to launch
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2],
        kernel_hd, _DTYPE_CODE[q.dtype], int(bool(causal)), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(scale), stream)
    cuda_lib.check(err, "flash_attention")
    registry.count_launch("flash_attention")
    return out if kernel_hd == hd else out[..., :hd].contiguous()
