"""Mamba2 (state-space duality, arXiv:2405.21060): the mixer block and its
one-token recurrent step.

``ssd_forward`` runs the SSD core plus ``D * x`` through ``ops.ssd_scan``
(the Hopper kernel on the card) on the chunk-padded sequence.
``ssd_scan_ref`` is the chunked SSD algorithm in plain PyTorch (the
reference's ``src/repro/models/ssm.py:74``), the core of the kernel's plain
version. The decode step is the selective-SSM recurrence on a
(B, H, dh, ds) state, in plain PyTorch.

Over a plan's model axis (``tp``) the heads are split: ``w_x``, ``w_z``,
``w_dt``, ``conv_x``, ``A_log``, ``D`` and ``dt_bias`` hold the rank's
heads (``d_inner``'s channels are head-major), ``w_out`` their rows, and
``w_b``/``w_c``/``conv_b``/``conv_c`` and the norm's scale are whole. Each
rank runs ``ops.ssd_scan`` on its heads with the B/C groups they read
(f on B and C: every rank computes them whole and reads a part), the gated
RMS norm over all of ``d_inner`` all-reduces its sum of squares, and the
row-split ``w_out`` product is summed over the ranks (*g*). The decode
state holds the rank's heads and whole conv buffers: the step's new
``conv_x`` inputs are gathered over the ranks. Any other layout gathers the
split leaves whole. On a sequence-split stream (``models.tp``) the causal
convolution needs every position: *f* gathers the sequence before the
mixer (B and C from the whole stream, gathered as well) and *g* keeps the
rank's block of the summed output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.comm import fsdp
from ..kernels import ops
from . import tp as tp_mod
from .common import dense_init, norm_apply
from .config import ModelConfig

__all__ = ["ssm_init", "ssd_forward", "ssd_scan_ref", "ssd_decode_step", "init_ssm_state"]


def ssm_init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, s, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    cw = cfg.ssm_conv_width

    def w(*shape):
        return dense_init(gen, shape, device=device)

    return {
        "w_x": w(d, di),
        "w_z": w(d, di),
        "w_b": w(d, g * s),
        "w_c": w(d, g * s),
        "w_dt": w(d, h),
        "dt_bias": torch.zeros(h, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "D": torch.ones(h, device=device),
        "conv_x": w(cw, di),
        "conv_b": w(cw, g * s),
        "conv_c": w(cw, g * s),
        "norm": {"scale": torch.ones(di, device=device)},
        "w_out": w(di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence. x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):  # K is 4: unrolled taps, as the reference
        out = out + pad[:, i: i + S, :] * w[i]
    return out


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} a[..., k]; -inf above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_scan_ref(x, dt, A, B, C, chunk: int):
    """SSD chunked algorithm (Mamba2 paper, listing 1).

    x (b, l, h, dh), dt (b, l, h), A (h,), B and C (b, l, g, ds); l a
    multiple of ``chunk``. Returns (y (b, l, h, dh), final state
    (b, h, dh, ds)).
    """
    b, l, h, dh = x.shape
    g, ds = B.shape[2], B.shape[3]
    nc = l // chunk
    rep = h // g

    xb = x * dt[..., None]
    a = A[None, None, :] * dt
    xc = xb.reshape(b, nc, chunk, h, dh)
    ac = a.reshape(b, nc, chunk, h)
    Bc = torch.repeat_interleave(B.reshape(b, nc, chunk, g, ds), rep, dim=3)
    Cc = torch.repeat_interleave(C.reshape(b, nc, chunk, g, ds), rep, dim=3)

    ac_t = ac.permute(0, 1, 3, 2)                         # (b, nc, h, q)
    Lmat = torch.exp(_segsum(ac_t))                       # (b, nc, h, q, q)
    scores = torch.einsum("bnqhs,bnths->bnhqt", Cc, Bc)
    y_diag = torch.einsum("bnhqt,bnthp->bnqhp", scores * Lmat, xc)

    acum = torch.cumsum(ac_t, dim=-1)                     # (b, nc, h, q)
    decay_states = torch.exp(acum[..., -1:] - acum)
    states = torch.einsum("bnqhs,bnqhp->bnhps",
                          Bc * decay_states.permute(0, 1, 3, 2)[..., None], xc)

    chunk_decay = torch.exp(acum[..., -1])                # (b, nc, h)
    st = torch.zeros((b, h, dh, ds), dtype=x.dtype, device=x.device)
    prev = []
    for n in range(nc):  # the state entering each chunk
        prev.append(st)
        st = st * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                # (b, nc, h, dh, ds)

    state_decay = torch.exp(acum).permute(0, 1, 3, 2)     # (b, nc, q, h)
    y_off = torch.einsum("bnqhs,bnhps->bnqhp", Cc, prev_states) * state_decay[..., None]
    return (y_diag + y_off).reshape(b, l, h, dh), st


_HEAD_SPLIT = {"w_x": 1, "w_z": 1, "w_dt": 1, "dt_bias": 0, "A_log": 0, "D": 0, "conv_x": 1,
               "w_out": 0}


def _groups_of(cfg: ModelConfig, tp) -> tuple[int, int] | None:
    """[lo, hi) of the B/C groups this rank's heads read; None when its
    heads straddle groups unevenly."""
    rep = cfg.ssm_heads // cfg.ssm_groups
    lo, hi = tp_mod.rank_block(cfg.ssm_heads, tp)
    if (hi - lo) % rep and rep % (hi - lo):
        return None
    return lo // rep, (hi - 1) // rep + 1


def heads_split(cfg: ModelConfig, tp, groups: bool = True) -> bool:
    """Whether ``tp.dims`` split the mixer over its heads as the module's
    notes lay them out (else the split leaves are gathered whole); with
    ``groups``, also whether the rank's heads read whole B/C groups (the
    scan's layout)."""
    if any(tp.dims[k] != _HEAD_SPLIT.get(k) for k in tp.dims if k != "norm"):
        return False
    return not groups or _groups_of(cfg, tp) is not None


def ssd_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, plan=None, tp=None):
    """Mamba2 mixer: proj -> conv -> SSD -> gated norm -> out.

    x (B, S, d) -> (out (B, S, d), final SSM state (B, h, dh, ds) float32;
    with ``tp``, the rank's heads; x and out the rank's block of the
    sequence where ``tp.seq``). ``plan``: the reference lays the
    scan's operands out with their batch over the data axes and their heads
    over the model axis; over a process group each rank's ``x`` is already
    its rows. With ``tp``, ``p`` holds this rank's shards over the model
    axis (the module's notes).
    """
    split = False
    if tp is not None:
        split = heads_split(cfg, tp)
        if not split:
            p = tp_mod.gather_split(p, tp)
    xh = tp_mod.enter(x, tp) if split else tp_mod.whole(x, tp)
    x = tp_mod.whole(x, tp) if split else xh  # B and C read x whole on every rank
    B_, S, _ = x.shape
    h, dh, g, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    dt_ = x.dtype

    xs = xh @ p["w_x"].to(dt_)
    z = xh @ p["w_z"].to(dt_)
    Bp = x @ p["w_b"].to(dt_)
    Cp = x @ p["w_c"].to(dt_)
    dt = F.softplus((xh @ p["w_dt"].to(dt_)).float() + p["dt_bias"])

    xs = F.silu(_causal_conv(xs, p["conv_x"].to(dt_)))
    Bp = F.silu(_causal_conv(Bp, p["conv_b"].to(dt_)))
    Cp = F.silu(_causal_conv(Cp, p["conv_c"].to(dt_)))
    if split:  # the rank's heads and the groups they read
        h = p["A_log"].shape[0]
        g_lo, g_hi = _groups_of(cfg, tp)
        Bp = fsdp.copy_to_model(Bp, tp.group)[..., g_lo * ds: g_hi * ds]
        Cp = fsdp.copy_to_model(Cp, tp.group)[..., g_lo * ds: g_hi * ds]
        g = g_hi - g_lo

    A = -torch.exp(p["A_log"].float())  # the kernel takes float32, bf16 weights too
    # pad to a chunk multiple: padded steps have dt = 0 (decay 1, no input),
    # so they leave the carried state as it is
    pad = -S % cfg.ssm_chunk

    def padded(t):
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    xs_p, dt_p, B_p, C_p = padded(xs), padded(dt), padded(Bp), padded(Cp)
    Sp = S + pad
    y, state = ops.ssd_scan(
        xs_p.reshape(B_, Sp, h, dh).float(), dt_p, A,
        B_p.reshape(B_, Sp, g, ds).float(), C_p.reshape(B_, Sp, g, ds).float(),
        p["D"].float(), chunk=cfg.ssm_chunk)
    y = y[:, :S].reshape(B_, S, h * dh).to(dt_)
    y = y * F.silu(z)
    if not split:
        y = norm_apply(p["norm"], y, "rmsnorm")
        return tp_mod.own(y @ p["w_out"].to(dt_), tp), state
    y = tp_mod.rms_scale(y, p["norm"]["scale"], tp)
    return tp_mod.leave(y @ p["w_out"].to(dt_), tp), state


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, dtype=torch.float32, *,
                   device) -> dict:
    cw, gs = cfg.ssm_conv_width, cfg.ssm_groups * cfg.ssm_state

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "state": zeros(n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv_x": zeros(n_layers, batch, cw - 1, cfg.d_inner),
        "conv_b": zeros(n_layers, batch, cw - 1, gs),
        "conv_c": zeros(n_layers, batch, cw - 1, gs),
    }


def ssd_decode_step(p: dict, x: torch.Tensor, layer_state: dict, cfg: ModelConfig, tp=None):
    """One-token recurrent step. x (B, 1, d); layer_state {state
    (B, h, dh, ds), conv_x/b/c rolling buffers (B, K-1, C)}. Returns
    (out (B, 1, d), new layer state). With ``tp``, ``p`` holds this rank's
    shards over the model axis and the state its heads (the module's
    notes)."""
    B_ = x.shape[0]
    h, dh, g, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    split = False
    if tp is not None:
        split = heads_split(cfg, tp, groups=False)
        if split != (layer_state["state"].shape[1] != h):
            raise ValueError(f"a decode state of {layer_state['state'].shape[1]} heads for "
                             f"mixer weights {'split' if split else 'whole'} over the model "
                             "axis")
        if not split:
            p = tp_mod.gather_split(p, tp)
    dt_ = x.dtype
    xt = x[:, 0]
    h_lo, h_hi = tp_mod.rank_block(h, tp) if split else (0, h)
    cols = slice(h_lo * dh, h_hi * dh)  # the rank's channels of d_inner

    xs = xt @ p["w_x"].to(dt_)
    z = xt @ p["w_z"].to(dt_)
    Bp = xt @ p["w_b"].to(dt_)
    Cp = xt @ p["w_c"].to(dt_)
    dt = F.softplus((xt @ p["w_dt"].to(dt_)).float() + p["dt_bias"])  # (B, h)

    def conv_step(buf, new, w, cols=slice(None)):
        seq = torch.cat([buf, new[:, None, :].to(buf.dtype)], dim=1)  # (B, K, C)
        out = torch.einsum("bkc,kc->bc", seq[..., cols].float(), w.float())
        return F.silu(out).to(dt_), seq[:, 1:]

    if split:  # the conv buffer is whole on every rank
        xs, new_cx = conv_step(layer_state["conv_x"], fsdp.gather_whole(xs, 1, tp.group),
                               p["conv_x"], cols)
    else:
        xs, new_cx = conv_step(layer_state["conv_x"], xs, p["conv_x"])
    Bp, new_cb = conv_step(layer_state["conv_b"], Bp, p["conv_b"])
    Cp, new_cc = conv_step(layer_state["conv_c"], Cp, p["conv_c"])

    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B_, h_hi - h_lo, dh).float()
    if split:  # the groups of the rank's heads
        heads = torch.arange(h_lo, h_hi, device=x.device) // (h // g)
        Bh = Bp.reshape(B_, g, ds)[:, heads].float()
        Ch = Cp.reshape(B_, g, ds)[:, heads].float()
    else:
        Bh = torch.repeat_interleave(Bp.reshape(B_, g, ds), h // g, dim=1).float()
        Ch = torch.repeat_interleave(Cp.reshape(B_, g, ds), h // g, dim=1).float()
    decay = torch.exp(dt * A[None, :])
    st = layer_state["state"].float()
    st = st * decay[:, :, None, None] + torch.einsum("bh,bhs,bhp->bhps", dt, Bh, xh)
    y = torch.einsum("bhs,bhps->bhp", Ch, st)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B_, cols.stop - cols.start).to(dt_)
    y = y * F.silu(z)
    if split:
        y = tp_mod.rms_scale(y, p["norm"]["scale"], tp)
        out = fsdp.reduce_from_model(y @ p["w_out"].to(dt_), tp.group)[:, None, :]
    else:
        y = norm_apply(p["norm"], y, "rmsnorm")
        out = (y @ p["w_out"].to(dt_))[:, None, :]
    new_state = {"state": st.to(layer_state["state"].dtype),
                 "conv_x": new_cx, "conv_b": new_cb, "conv_c": new_cc}
    return out, new_state
