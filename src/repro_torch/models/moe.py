"""Top-k MoE with capacity-based dispatch (granite-moe).

The dispatch is the reference's (``src/repro/models/moe.py``): tokens are
split into ``moe_groups`` groups along the sequence; in each group a float32
router softmax picks the top-k experts of every token, the k weights are
renormalised, and the flattened ``(token, k)`` pairs (token-major, k-minor)
are sorted stably by expert. A pair's rank within its expert decides where
it goes: ranks below the capacity C fill the expert's buffer, the rest are
dropped (weight 0). The expert FFNs run as batched products over the
``(E, C, d)`` buffers, in the activation dtype.

The combine sums each token's k contributions in the order the reference's
scatter-add meets them, expert-sorted, starting from zero: a gather and a
sum over k in that order, with no atomics, so bf16 results repeat from run
to run on the card.

Top-k ties: ``jax.lax.top_k`` breaks ties toward the lower index;
``torch.topk`` promises no order, so the router takes the first k of a
stable descending sort, which breaks them the same way.

Under a sharding plan the groups follow the plan, as the reference's do:
``n_seq`` is the model axis's size when it divides the sequence (at model
axis 1, one group per row). Over a process group each rank routes its own
rows, and the Switch aux takes its means over every rank's tokens: an
all-reduce of the router's mean probabilities (with autograd) and of the
top-1 fractions.

Over a plan's model axis (``tp``) every expert's FFN is split over d_ff
(``w_gate``/``w_up`` columns, ``w_down`` rows) and the router is whole on
every rank: each rank routes and dispatches the same, runs its part of
every expert on f(buffer), combines its partial outputs with the weights
(whose gradient is summed over the ranks: f), and the combined outputs are
summed over the ranks (*g*). On a sequence-split stream every rank first
gathers the whole sequence of its rows (``models.tp.whole``), so the
groups are the model axis's on the gathered tokens, and *g* keeps the
rank's block of the sum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import sharding as shard_mod
from ..core.comm import fsdp
from . import tp as tp_mod
from .common import dense_init
from .config import ModelConfig

__all__ = ["moe_init", "moe_forward", "expert_capacity", "route"]


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, device) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, E), device=device),
        "w_gate": dense_init(gen, (E, d, ff), device=device),
        "w_up": dense_init(gen, (E, d, ff), device=device),
        "w_down": dense_init(gen, (E, ff, d), device=device),
    }


def _groups(cfg: ModelConfig, S: int) -> int:
    n_seq = max(1, min(cfg.moe_groups, S))
    while S % n_seq:
        n_seq -= 1
    return n_seq


def route(p: dict, xt: torch.Tensor, cfg: ModelConfig):
    """Router of grouped tokens xt (B, G, n, d): (probs (B, G, n, E) float32,
    top_p (B, G, n, K) renormalised, top_e (B, G, n, K) int64)."""
    logits = torch.einsum("bgnd,de->bgne", xt, p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., : cfg.top_k], top_e[..., : cfg.top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _slots(top_e: torch.Tensor, C: int):
    """Rank of every (token, k) pair within its expert, in the order of a
    stable sort of the token-major, k-minor flattening by expert; (rank
    (B, G, n, K), keep = rank < C)."""
    B, G, n, K = top_e.shape
    flat_e = top_e.reshape(B, G, n * K)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    start = torch.searchsorted(se, se, side="left")
    rank_sorted = torch.arange(n * K, device=top_e.device) - start
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    rank = rank.reshape(B, G, n, K)
    return rank, rank < C


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                plan=None, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, Switch aux loss, a float32
    scalar). With ``plan``, ``x`` is this rank's rows, the groups follow the
    model axis and the aux is over every rank's tokens. With ``tp`` (a
    ``sharding.ModelAxis`` for ``p``), ``p`` holds this rank's shards over
    the model axis, and ``x`` and the output are the rank's block of the
    sequence where ``tp.seq``."""
    x = tp_mod.whole(x, tp)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    if plan is not None and S % plan.axis_size(plan.tp) == 0:
        n_seq = plan.axis_size(plan.tp)
    else:
        n_seq = _groups(cfg, S)
    n = S // n_seq
    C = expert_capacity(cfg, n)
    xt = x.reshape(B, n_seq, n, d)

    probs, top_p, top_e = route(p, xt, cfg)
    # load-balance aux (Switch): E * sum_e f_e * p_e, over all tokens
    me = probs.mean(dim=(0, 1, 2))
    ce = F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1, 2))
    group = shard_mod.data_group(plan)
    if group is not None:  # every rank holds as many tokens: the mean of the means
        world = plan.axis_size(plan.dp)
        me = fsdp.all_reduce_sum(me, group) / world
        ce = fsdp.all_reduce(ce, group) / world
    aux = E * torch.sum(me * ce)

    rank, keep = _slots(top_e, C)
    # dispatch: buf[b, g, e, r] = the token of the pair ranked r at expert e
    slot = torch.where(keep, top_e * C + rank, E * C)  # E * C: the drop slot
    tok = torch.arange(n, device=x.device)[:, None].expand(n, K)
    buf = xt.new_zeros((B, n_seq, E * C + 1, d))
    buf.scatter_(2, slot.reshape(B, n_seq, n * K, 1).expand(-1, -1, -1, d),
                 torch.gather(xt, 2, tok.reshape(1, 1, n * K, 1).expand(B, n_seq, -1, d)))
    buf = buf[:, :, : E * C].reshape(B, n_seq, E, C, d)
    split = tp is not None and tp.dims["w_up"] is not None
    if split:
        buf = fsdp.copy_to_model(buf, tp.group)

    g = torch.einsum("bgecd,edf->bgecf", buf, p["w_gate"].to(dt))
    u = torch.einsum("bgecd,edf->bgecf", buf, p["w_up"].to(dt))
    eo = torch.einsum("bgecf,efd->bgecd", F.silu(g) * u, p["w_down"].to(dt))

    # combine: each token's k contributions in expert order, summed from zero
    k_order = torch.argsort(top_e, dim=-1)  # a token's k experts are distinct
    flat = (top_e * C + rank.clamp(max=C - 1)).gather(-1, k_order)
    w = (top_p * keep).gather(-1, k_order).to(dt)
    if split:
        w = fsdp.copy_to_model(w, tp.group)
    contrib = torch.gather(eo.reshape(B, n_seq, E * C, d), 2,
                           flat.reshape(B, n_seq, n * K, 1).expand(-1, -1, -1, d))
    contrib = contrib.reshape(B, n_seq, n, K, d) * w[..., None]
    out = contrib[..., 0, :]
    for k in range(1, K):
        out = out + contrib[..., k, :]
    out = out.reshape(B, S, d)
    return (tp_mod.leave(out, tp) if split else tp_mod.own(out, tp)), aux
