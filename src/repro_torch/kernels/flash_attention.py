"""Flash-attention kernel: the model layer's full-sequence attention.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``,
``flash_attention`` (body ``_kernel``): causal or bidirectional GQA
attention with an online softmax, an optional sliding window (key ``t``
visible to query ``r`` when ``t > r - window``) and an optional logit
softcap ``c * tanh(s / c)``. q is (B, S, H, hd), k and v (B, S, KV, hd);
query head ``h`` reads K/V head ``h // (H // KV)``. Inputs are bf16 or
float32, arithmetic is float32 inside, the output has q's dtype.

Bound on the card: operations, ``4 * B * H * S * S * hd`` flops (half when
causal) at 989 TFLOP/s (H100 SXM data sheet, bf16 dense), far above the
bytes moved. The CUDA kernel (``csrc/flash_attention.cu``) gives a block one
(batch, head) and 64 query rows and walks the K/V tiles in a loop in place
of the TPU's sequential kv grid axis, keeping the running max, sum and
output rows in registers and skipping tiles the mask hides completely. Its
products run in float32 on the CUDA cores, as the TPU kernel's arithmetic
does; tensor-core products are later work. It takes head_dim 64, 128 and
256.

The reference model casts the probabilities to the activation dtype before
the PV product (``src/repro/models/attention.py:106``); this kernel, like the
TPU kernel, keeps them in float32.

:func:`flash_attention_ref` is the plain PyTorch version: the dense masked
softmax of ``src/repro/kernels/ref.py::flash_attention_ref``.
"""

from __future__ import annotations

import torch

from . import cuda_lib, registry

__all__ = ["flash_attention_ref", "flash_attention_cuda", "HEAD_DIMS"]

HEAD_DIMS = (64, 128, 256)
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
    bf16 and float32 and head_dim 64, 128 or 256."""
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out  # nothing to launch
    scale = hd ** -0.5 if scale is None else scale
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], hd,
        _DTYPE_CODE[q.dtype], int(bool(causal)), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(scale), stream)
    cuda_lib.check(err, "flash_attention")
    registry.count_launch("flash_attention")
    return out
