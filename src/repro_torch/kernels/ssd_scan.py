"""SSD-scan kernel: the Mamba-2 mixer's chunked state-space scan.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py``, ``ssd_scan``
(body ``_kernel``): ``y = SSD(x) + D * x`` over chunks of ``chunk`` steps,
the (dh, ds) state carried from chunk to chunk, B and C shared by the
``H // G`` heads of a group. Inputs are float32: x (b, L, H, dh), dt
(b, L, H), A and D (H,), B and C (b, L, G, ds). Unlike the TPU kernel, the
port also returns the final state (b, H, dh, ds), which the model's
``ssd_forward`` returns, and takes any L: steps past L act as ``dt = 0``,
``x = 0``, which leave the state unchanged.

Bound on the card: bytes at the model's shapes (x read and y written at
3.35 TB/s, H100 SXM data sheet); the flops, about ``chunk * (dh + ds)`` per
element, sit near the card's balance. The CUDA kernel
(``csrc/ssd_scan.cu``) is chunk-parallel in three launches, the plain
version's own decomposition: per-chunk states, plus the group's scores
``C_I B_J^T`` formed once for the heads that share them; a short
state-passing recurrence over the chunks (one thread per 4 state
elements); then per-chunk outputs (one block per 64-row tile of a chunk),
where the TPU kernel walked the chunks in order. ``exp(acum[i] - acum[j])``
is computed per element only on the diagonal tile, for ``j <= i``; below it
the decay factors into a row and a column part. The products are 3xTF32
(float32 operands split into a TF32 high part and residual): ``wgmma`` for
the outputs' main product, ``mma.sync`` elsewhere, float32-exact to the
reference's tolerance. The three launches count as one ``ssd_scan`` launch.
The wrapper allocates the float32 scratch: the chunk states (b, H,
n_chunks, dh, ds), the in-chunk cumsum of ``A * dt`` and ``dt`` itself
(b, H, n_chunks, 2, chunk) and the scores (b, G, n_chunks, pairs, 64,
64). It takes dh 32 and 64 and ds 16, 32, 64 and 128.

:func:`ssd_scan_ref` is the plain PyTorch version: the model's chunked SSD
algorithm (``models/ssm.py::ssd_scan_ref``) on the chunk-padded sequence,
plus ``D * x``, as ``src/repro/kernels/ref.py::ssd_scan_ref`` computes it.

Training goes through :class:`SsdScanFn`: the kernel forward on the card
(the plain version on the CPU), and as backward the gradient of the plain
chunked scan, recomputed from the saved inputs with autograd, as XLA
derives the reference's (``src/repro/models/ssm.py:74``, jnp). The kernel's
own outputs carry no autograd graph, so :func:`ssd_scan_cuda` refuses
inputs that need one.

On the ``meta`` device the wrapper stands in for the card: it allocates the
outputs and the three scratch tensors it would on the card and launches
nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib, registry

__all__ = ["ssd_scan_ref", "ssd_scan_cuda", "SsdScanFn", "HEAD_DIMS", "STATE_DIMS", "ssd_work"]

HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 1024


def _check(x, dt, A, B, C, D, chunk: int):
    if x.ndim != 4:
        raise ValueError(f"x must be (b, L, H, dh), got {tuple(x.shape)}")
    b, L, H, _ = x.shape
    if dt.shape != (b, L, H):
        raise ValueError(f"dt {tuple(dt.shape)} must be {(b, L, H)}")
    if A.shape != (H,) or D.shape != (H,):
        raise ValueError(f"A {tuple(A.shape)} and D {tuple(D.shape)} must be {(H,)}")
    if B.ndim != 4 or B.shape[:2] != (b, L) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be (b, L, G, ds)")
    if B.shape[2] == 0 or H % B.shape[2]:
        raise ValueError(f"heads {H} must be a multiple of groups {B.shape[2]}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def ssd_work(b: int, L: int, H: int, dh: int, G: int, ds: int, chunk: int) -> tuple[float, float]:
    """(flops, bytes) of one call: per chunk and head the in-chunk scores and
    products, ``chunk * (chunk + 1) * (ds + dh)``, and the chunk-state
    products, ``4 * chunk * dh * ds``; x and dt read, y and the final state
    written, B and C read once, A and D once (float32)."""
    nc = -(-L // chunk)
    flops = float(b * H * nc * (chunk * (chunk + 1) * (ds + dh) + 4 * chunk * dh * ds))
    nbytes = 4.0 * (2 * b * L * H * dh + b * L * H + 2 * b * L * G * ds + 2 * H
                    + b * H * dh * ds)
    return flops, nbytes


def ssd_scan_ref(x, dt, A, B, C, D, *, chunk: int, compute: torch.dtype = torch.float32):
    """Plain version: (y (b, L, H, dh) in x's dtype, final state
    (b, H, dh, ds) float32), computed in ``compute`` (float64 for the
    readings behind ``chip_smoke.py``'s SSD gradient limit)."""
    from ..models.ssm import ssd_scan_ref as chunked_scan

    _check(x, dt, A, B, C, D, chunk)
    L = x.shape[1]
    pad = -L % chunk

    def padded(t):
        t = t.to(compute)
        return F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad]) if pad else t

    y, state = chunked_scan(padded(x), padded(dt), A.to(compute), padded(B), padded(C), chunk)
    y = y[:, :L] + x.to(compute) * D.to(compute)[None, None, :, None]
    return y.to(x.dtype), state.float()


def ssd_scan_cuda(x, dt, A, B, C, D, *, chunk: int):
    """The CUDA kernel: same contract as :func:`ssd_scan_ref`, for float32
    inputs, dh in :data:`HEAD_DIMS` and ds in :data:`STATE_DIMS`. Its
    outputs have no autograd graph, so inputs that require grad under grad
    mode raise: :class:`SsdScanFn` (``ops.ssd_scan``) is the differentiable
    form."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        raise RuntimeError("ssd_scan_cuda's outputs have no autograd graph; call "
                           "ops.ssd_scan (SsdScanFn) for gradients")
    return _launch(x, dt, A, B, C, D, chunk=chunk)


def _launch(x, dt, A, B, C, D, *, chunk: int):
    _check(x, dt, A, B, C, D, chunk)
    tensors = (x, dt, A, B, C, D)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_scan_cuda takes float32 inputs, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    b, L, H, dh = x.shape
    G, ds = B.shape[2], B.shape[3]
    if dh not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"ssd_scan_cuda takes dh {HEAD_DIMS} and ds {STATE_DIMS}, "
                         f"got dh {dh}, ds {ds}")
    if not all(t.is_cuda or t.is_meta for t in tensors):
        raise ValueError("ssd_scan_cuda needs CUDA tensors (or meta ones for a shape-only run)")
    x, dt, A, B, C, D = (t.contiguous() for t in tensors)
    y = torch.empty_like(x)
    if y.numel() == 0:  # nothing to launch
        return y, torch.zeros((b, H, dh, ds), dtype=torch.float32, device=x.device)
    state = torch.empty((b, H, dh, ds), dtype=torch.float32, device=x.device)
    n_chunks, n_tiles = -(-L // chunk), -(-chunk // 64)
    states = torch.empty((b, H, n_chunks, dh, ds), dtype=torch.float32, device=x.device)
    acum = torch.empty((b, H, n_chunks, 2, chunk), dtype=torch.float32, device=x.device)
    scores = torch.empty((b, G, n_chunks, n_tiles * (n_tiles + 1) // 2, 64, 64),
                         dtype=torch.float32, device=x.device)
    work = ssd_work(b, L, H, dh, G, ds, chunk)
    if x.is_meta:  # the stand-in: outputs and scratch, no launch
        registry.add_work("ssd_scan", *work)
        return y, state
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
        y.data_ptr(), state.data_ptr(), states.data_ptr(), acum.data_ptr(), scores.data_ptr(),
        b, L, H, G, dh, ds, chunk, stream)
    cuda_lib.check(err, "ssd_scan")
    registry.count_launch("ssd_scan")  # one count for the three launches
    registry.add_work("ssd_scan", *work)
    return y, state


class SsdScanFn(torch.autograd.Function):
    """Differentiable SSD scan: the forward launches the kernel
    (``use_kernel``; the plain version otherwise) and counts one
    ``ssd_scan`` launch on the kernel; the backward recomputes
    :func:`ssd_scan_ref` from the saved inputs with autograd and launches
    nothing. Returns (y, final state), both differentiable."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, use_kernel: bool, chunk: int):
        run = _launch if use_kernel else ssd_scan_ref
        y, state = run(x, dt, A, B, C, D, chunk=chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ssd_scan_ref(*inputs, chunk=ctx.chunk)
            grads = torch.autograd.grad((y, state), inputs, (dy, dstate), allow_unused=True)
        return (*grads, None, None)
