"""Roofline terms of a launch cell on one NVIDIA H100.

Three terms per (arch x shape), the reference's formulas
(``launch/roofline.py``) with the H100's constants:

  compute    = FLOPs            / peak_flops
  memory     = bytes            / hbm_bw
  collective = collective_bytes / ici_bw

``HW`` holds the NVIDIA H100 SXM data sheet's figures under the
reference's keys: 989e12 FLOP/s (bf16 dense, no sparsity), 3.35e12 B/s of
HBM3, and in ``ici_bw``, which keeps the reference's key name, NVLink 4's
450e9 B/s per GPU in each direction (900 GB/s both ways). They assume the
card's full 700 W power limit. FLOPs, bytes and the collectives' census
come from :mod:`~repro_torch.launch.op_cost`: the census counts, per rank,
each collective's result bytes (the reference's ``collective_bytes_from_hlo``
convention), from a real group's rank or from one rank of a dry mesh
(``launch.mesh.make_dry_mesh``). On one card without a group nothing
crosses a link, and the collective term is 0.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); the ratio
MODEL_FLOPS / FLOPs exposes recomputation and other redundant work.
"""

from __future__ import annotations

from typing import Mapping

__all__ = ["HW", "model_flops", "roofline_terms"]

HW = {
    "peak_flops": 989e12,     # bf16 dense, FLOP/s per card
    "hbm_bw": 3.35e12,        # HBM3, B/s per card
    "ici_bw": 450e9,          # NVLink 4, B/s per card and direction
}


def model_flops(cfg, cell) -> float:
    """6*N*D with N = active params (excluding embeddings' lookup side) and
    D = trained tokens. For decode cells D = global_batch (one token each)."""
    n_active = cfg.num_active_params()
    if cell.kind == "train":
        d_tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * d_tokens
    if cell.kind == "prefill":
        d_tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * d_tokens  # forward only
    return 2.0 * n_active * cell.global_batch  # decode: fwd, 1 token/seq


def roofline_terms(cfg, cell, *, flops: float, bytes_accessed: float,
                   collective: Mapping, n_chips: int) -> dict:
    """The three terms, the dominant one, the model flops and their share
    of the counted flops (``useful_flops_ratio``), and the model flops' time
    at peak over the dominant term (``roofline_fraction``). ``flops``,
    ``bytes_accessed`` and ``collective["total_bytes"]`` are per card."""
    t_compute = flops / HW["peak_flops"]
    t_memory = bytes_accessed / HW["hbm_bw"]
    t_coll = float(collective["total_bytes"]) / HW["ici_bw"]
    mf = model_flops(cfg, cell)
    mf_per_chip = mf / n_chips
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1])[0]
    useful_ratio = mf_per_chip / flops if flops else 0.0
    t_dom = max(t_compute, t_memory, t_coll)
    t_model = mf_per_chip / HW["peak_flops"]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": (t_model / t_dom) if t_dom > 0 else 0.0,
    }
