"""Flash-attention kernel: the model layer's full-sequence attention.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``,
``flash_attention`` (body ``_kernel``): causal or bidirectional GQA
attention with an online softmax, an optional sliding window (key ``t``
visible to query ``r`` when ``t > r - window``) and an optional logit
softcap ``c * tanh(s / c)``. q is (B, S, H, hd), k and v (B, S, KV, hd);
query head ``h`` reads K/V head ``h // (H // KV)``. Inputs are bf16 or
float32, scores, softmax and sums are float32 inside, the output has q's
dtype.

Bound on the card: operations, ``4 * B * H * hd`` flops for every (query,
key) pair some query sees (``S * S``, about half when causal, fewer in a
window: :func:`flash_work`) at 989 TFLOP/s (H100 SXM data sheet, bf16
dense), far above the bytes moved. The CUDA source
(``csrc/flash_attention.cu``) holds two kernels, picked by dtype. bf16 runs on the tensor cores: a block owns one
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

Training goes through :class:`FlashAttentionFn`. Its forward is the kernel
on the card (the plain version on the CPU); its backward is the gradient of
the reference's training attention (``src/repro/models/attention.py``,
``_chunked_attention``: query blocks of 512 rows, each rematerialised),
recomputed from the saved q, k and v in plain PyTorch, one query block at a
time against the keys the block can see, so the (S, S) scores never exist
whole. The TPU kernel has no backward, and neither has the Hopper kernel:
the kernel's own output carries no autograd graph, so
:func:`flash_attention_cuda` refuses inputs that need one.

On the ``meta`` device the wrapper stands in for the card: it allocates
what it would on the card (the output, and the zero-padded copies at
head_dim 80) and launches nothing, so a shape-only run holds the kernel's
footprint, not the plain version's (B, H, S, S) scores.
"""

from __future__ import annotations

import torch

from . import cuda_lib, registry

__all__ = ["flash_attention_ref", "flash_attention_cuda", "flash_attention_bwd",
           "FlashAttentionFn", "HEAD_DIMS", "Q_BLOCK", "attention_pairs", "flash_work"]

HEAD_DIMS = (64, 80, 128, 256)
_PADDED = {80: 128}  # head_dims run by a wider kernel on zero-padded inputs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30
Q_BLOCK = 512  # query rows per recomputed block, the reference's ``_Q_BLOCK``


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


def attention_pairs(S: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs that some query of an S-long sequence sees: key
    ``t`` is visible to query ``r`` when ``t <= r`` (causal) and ``t > r -
    window``."""
    w = S if window is None else min(window, S)
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return S * S - (S - w) * (S - w + 1) // 2


def flash_work(B: int, S: int, H: int, KV: int, hd: int, itemsize: int, *,
               causal: bool = True, window: int | None = None) -> tuple[float, float]:
    """(flops, bytes) of one call: the QK^T and PV products over the visible
    pairs, ``4 * hd`` flops a pair and query head; q, k and v read and the
    output written once. At head_dim 80 the kernel runs 1.6 times this on
    padded inputs; the count is the work the call needs."""
    flops = 4.0 * B * H * hd * attention_pairs(S, causal, window)
    return flops, float(2 * B * S * (H + KV) * hd * itemsize)


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
    bf16 and float32 and head_dim 64, 80, 128 or 256. Its output has no
    autograd graph, so inputs that require grad under grad mode raise:
    :class:`FlashAttentionFn` (``ops.flash_attention``) is the
    differentiable form."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_cuda's output has no autograd graph; call "
                           "ops.flash_attention (FlashAttentionFn) for gradients")
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)


def _launch(q, k, v, *, causal, window, softcap, scale) -> torch.Tensor:
    _check(q, k, v, window, softcap)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_cuda takes bfloat16 or float32, got {q.dtype}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda takes head_dim {HEAD_DIMS}, got {hd}")
    if not all(t.is_cuda or t.is_meta for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs CUDA tensors (or meta ones for a "
                         "shape-only run)")
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
    work = flash_work(B, S, H, k.shape[2], hd, q.element_size(), causal=causal, window=window)
    if q.is_meta:  # the stand-in: the kernel's output, no launch
        registry.add_work("flash_attention", *work)
        return out if kernel_hd == hd else out[..., :hd].contiguous()
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2],
        kernel_hd, _DTYPE_CODE[q.dtype], int(bool(causal)), 0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), float(scale), stream)
    cuda_lib.check(err, "flash_attention")
    registry.count_launch("flash_attention")
    registry.add_work("flash_attention", *work)
    return out if kernel_hd == hd else out[..., :hd].contiguous()


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, softcap: float | None = None,
                        scale: float | None = None, q_block: int = Q_BLOCK):
    """(dq, dk, dv) of the reference's training attention at (q, k, v) for
    the output gradient ``dout``: per block of ``q_block`` query rows, the
    float32 scaled, softcapped and masked scores against the keys the block
    can see, the softmax rounded to q's dtype before the PV product
    (``src/repro/models/attention.py:106``), and ``torch.autograd.grad``.
    dk and dv sum over the query heads of each K/V group and over the
    blocks in float32."""
    _check(q, k, v, window, softcap)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for s0 in range(0, S, q_block):
        s1 = min(s0 + q_block, S)
        lo = 0 if window is None else max(0, s0 - window + 1)
        hi = s1 if causal else S
        with torch.enable_grad():
            qb = q[:, s0:s1].detach().requires_grad_()
            kb = k[:, lo:hi].detach().requires_grad_()
            vb = v[:, lo:hi].detach().requires_grad_()
            qg = qb.reshape(B, s1 - s0, KV, H // KV, hd)
            s = torch.einsum("bqhgc,bthc->bhgqt", qg, kb).float() * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            qi = torch.arange(s0, s1, device=q.device)[:, None]
            ki = torch.arange(lo, hi, device=q.device)[None, :]
            mask = torch.ones((s1 - s0, hi - lo), dtype=torch.bool, device=q.device)
            if causal:
                mask &= ki <= qi
            if window is not None:
                mask &= ki > qi - window
            p = torch.softmax(torch.where(mask, s, _NEG), dim=-1).to(q.dtype)
            o = torch.einsum("bhgqt,bthc->bqhgc", p, vb).reshape(B, s1 - s0, H, hd)
            gq, gk, gv = torch.autograd.grad(o, (qb, kb, vb), dout[:, s0:s1])
        dq[:, s0:s1] = gq
        dk[:, lo:hi] += gk
        dv[:, lo:hi] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention: the forward launches the kernel
    (``use_kernel``; the plain version otherwise), the backward is
    :func:`flash_attention_bwd` on the saved inputs. The forward counts one
    ``flash_attention`` launch on the kernel, the backward none."""

    @staticmethod
    def forward(ctx, q, k, v, use_kernel: bool, causal: bool, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        out = _launch(q, k, v, **kw) if use_kernel else flash_attention_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.to(q.dtype), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
