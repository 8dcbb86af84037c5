"""The port's moe family (granite-moe-1b-a400m, granite-moe-3b-a800m) and its
MoE layer against the reference on the CPU, in float32: forward logits and
the Switch aux loss, decode, the int8 KV cache, the engine's tokens, the
prefill's next token, the layout; and ``moe_forward`` itself where capacity
drops tokens (the same dropped (token, k) pairs), on router ties, and in
bf16 (run to run)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, moe

from torch_family_cases import (TOL, check_decode, check_engine, check_forward,
                                check_int8_decode, check_layout, check_prefill, make_pair)

MOE = ["granite-moe-1b-a400m", "granite-moe-3b-a800m"]


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return make_pair(request.param)


def test_forward_logits_and_aux_match_reference(pair):
    check_forward(pair)


def test_decode_logits_match_reference(pair):
    """Decode only against the reference's decode: at S = 12 the forward's
    capacity (8 slots per expert) can drop tokens, and decode (n = 1) never
    does, so the two legitimately differ; see the next test."""
    check_decode(pair, forward_too=False)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_where_nothing_drops(arch):
    """With capacity_factor = E / K, C = n: no expert can overflow in the
    forward, and decode never drops, so the two agree."""
    cfg = get_smoke_config(arch)
    check_decode(make_pair(arch, capacity_factor=cfg.n_experts / cfg.top_k))


def test_engine_tokens_equal_reference(pair):
    check_engine(pair)


def test_prefill_next_token_equals_reference(pair):
    check_prefill(pair)


@pytest.mark.parametrize("arch", MOE)
def test_init_params_has_the_reference_layout(arch):
    check_layout(arch)


def test_int8_kv_cache_decode_matches_reference():
    """granite-moe-1b's smoke config with the int8 cache, as the reference's
    ``tests/test_serve.py::test_int8_kv_cache_close_to_bf16``."""
    check_int8_decode(make_pair("granite-moe-1b-a400m", seed=2))


# -- the MoE layer ----------------------------------------------------------------------

def _layer(capacity_factor=0.5, moe_groups=1, seed=0, n=64):
    arch = "granite-moe-3b-a800m"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              capacity_factor=capacity_factor, moe_groups=moe_groups)
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32",
                                  capacity_factor=capacity_factor, moe_groups=moe_groups)
    ref_p = ref_moe.moe_init(jax.random.key(seed), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(seed + 1).normal(size=(2, n, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, p, ref_p, x


@pytest.mark.parametrize("groups", [1, 4])
def test_moe_drops_the_reference_pairs(groups):
    """capacity_factor 0.5: C = 8 slots per expert for 128 (token, k) pairs
    over 8 experts in each group of 64 tokens, so many pairs drop. The
    dropped pairs, the output and the aux loss equal the reference's."""
    cfg, ref_cfg, p, ref_p, x = _layer(moe_groups=groups, n=64 * groups)
    n_seq = groups
    n = x.shape[1] // n_seq
    C = moe.expert_capacity(cfg, n)
    assert C == ref_moe.expert_capacity(ref_cfg, n)
    xt = torch.from_numpy(x).reshape(2, n_seq, n, cfg.d_model)
    _, top_p, top_e = moe.route(p, xt, cfg)
    _, keep = moe._slots(top_e, C)
    dropped = {(b, g, t, int(top_e[b, g, t, k]))
               for b, g, t, k in zip(*np.nonzero(~keep.numpy()))}

    logits = jnp.einsum("bgnd,de->bgne", jnp.asarray(xt.numpy()), ref_p["router"])
    ref_tp, ref_te = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_te))
    ref_tp = ref_tp / ref_tp.sum(-1, keepdims=True)
    ref_dropped = set()
    for b in range(2):
        for g in range(n_seq):
            _, slot_e, _, stok, _ = ref_moe._dispatch_one_group(
                jnp.asarray(xt[b, g].numpy()), ref_te[b, g], ref_tp[b, g], cfg.n_experts, C)
            se = np.sort(np.asarray(ref_te[b, g]).reshape(-1), kind="stable")
            ref_dropped |= {(b, g, int(t), int(e)) for t, e, s in
                            zip(np.asarray(stok), se, np.asarray(slot_e)) if s == cfg.n_experts}
    assert dropped == ref_dropped and len(dropped) > 0

    out, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    ref_out, ref_aux = ref_moe.moe_forward(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=TOL, rtol=TOL)


def test_router_ties_break_toward_the_lower_index():
    """A zero router gives every expert the same probability. jax.lax.top_k
    breaks ties toward the lower index; torch.topk promises no order, so the
    port's router takes a stable descending sort instead, which picks the
    same experts."""
    cfg, ref_cfg, p, ref_p, x = _layer(capacity_factor=4.0)
    p = dict(p, router=torch.zeros_like(p["router"]))
    ref_p = dict(ref_p, router=jnp.zeros_like(ref_p["router"]))
    xt = torch.from_numpy(x).reshape(2, 1, -1, cfg.d_model)
    _, top_p, top_e = moe.route(p, xt, cfg)
    ref_tp, ref_te = jax.lax.top_k(jnp.full((3, cfg.n_experts), 1.0 / cfg.n_experts), cfg.top_k)
    assert np.asarray(ref_te).tolist() == [list(range(cfg.top_k))] * 3
    assert (top_e == torch.arange(cfg.top_k)).all()
    out, aux = moe.moe_forward(p, torch.from_numpy(x), cfg)
    ref_out, ref_aux = ref_moe.moe_forward(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), atol=TOL, rtol=TOL)


def test_moe_bf16_repeats_and_is_near_reference():
    """bf16 activations: the combine is a gather and a sum over k in the
    reference's (expert) order, so two runs give the same bits; against the
    reference's bf16 layer, bf16 rounding of the products."""
    cfg, ref_cfg, p, ref_p, x = _layer(capacity_factor=1.25)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    a, _ = moe.moe_forward(p, x16, cfg16)
    b, _ = moe.moe_forward(p, x16, cfg16)
    assert a.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16), b.view(torch.int16))
    ref, _ = ref_moe.moe_forward(ref_p, jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16),
                                 dataclasses.replace(ref_cfg, dtype="bfloat16"))
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(a.float().numpy() / scale, ref / scale, atol=2e-2)


def test_capacity_and_groups_follow_the_reference():
    cfg = get_smoke_config("granite-moe-3b-a800m")
    ref_cfg = ref_smoke_config("granite-moe-3b-a800m")
    for n in (1, 7, 64, 4096):
        assert moe.expert_capacity(cfg, n) == ref_moe.expert_capacity(ref_cfg, n)
    for groups, S, want in ((1, 12, 1), (4, 12, 4), (5, 12, 4), (8, 3, 3)):
        assert moe._groups(dataclasses.replace(cfg, moe_groups=groups), S) == want
    model = build_model(cfg, device="cpu")
    assert model.cfg.family == "moe"
