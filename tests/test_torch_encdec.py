"""The port's encdec (whisper-tiny) and vlm (llava-next-mistral-7b) families
against the reference on the CPU, in float32: forward logits (whisper's
encoder over random frames; llava's projected patch prefix), decode
(whisper against its encoder's output; llava on the tokens alone, as the
reference's decode ignores the prefix), the engine's tokens (whisper with
the reference engine's zero encoder output), the prefill's next token and
the layout; cross-attention and the int8 quantiser on their own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, transformer

from torch_family_cases import (TOL, batch_np, check_decode, check_engine, check_forward,
                                check_layout, check_prefill, make_pair)

FAMILIES = ["whisper-tiny", "llava-next-mistral-7b"]


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    return make_pair(request.param)


def test_forward_logits_match_reference(pair):
    check_forward(pair)


def test_decode_logits_match_reference_and_forward(pair):
    check_decode(pair)


def test_engine_tokens_equal_reference(pair):
    check_engine(pair)


def test_prefill_next_token_equals_reference(pair):
    check_prefill(pair)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_layout(arch):
    check_layout(arch)


def test_encoder_output_matches_reference():
    model, params, ref_model, ref_params = make_pair("whisper-tiny")
    frames = batch_np(model.cfg)["enc_frames"]
    got = transformer._encoder_forward(params, torch.from_numpy(frames), model.cfg)
    exp = ref_transformer._encoder_forward(ref_params, jnp.asarray(frames), ref_model.cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=TOL, rtol=TOL)


def test_decode_state_holds_a_zero_bf16_encoder_output():
    model, _, _, _ = make_pair("whisper-tiny")
    state = model.init_decode_state(2, 16)
    assert state["enc_out"].shape == (2, model.cfg.enc_positions, model.cfg.d_model)
    assert state["enc_out"].dtype == torch.bfloat16 and not state["enc_out"].any()


@pytest.mark.parametrize("kv_heads,softcap,bias", [(4, None, True), (2, 20.0, False)])
def test_cross_attention_matches_reference(kv_heads, softcap, bias):
    """K/V from another sequence (length 11 against 7 queries): no rope, no
    mask, GQA, the softcap and the biases."""
    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), n_kv_heads=kv_heads,
                              attn_logit_softcap=softcap, qkv_bias=bias)
    ref_cfg = dataclasses.replace(ref_smoke_config("whisper-tiny"), n_kv_heads=kv_heads,
                                  attn_logit_softcap=softcap, qkv_bias=bias)
    ref_p = ref_attention.attn_init(jax.random.key(4), ref_cfg)
    rng = np.random.default_rng(5)
    if bias:  # the init's biases are zero: give them values
        ref_p = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32) if k.startswith("b")
                     else v) for k, v in ref_p.items()}
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    got = attention.attention(p, torch.from_numpy(x), cfg, kv_x=torch.from_numpy(kv))
    exp = ref_attention.attention(ref_p, jnp.asarray(x), ref_cfg, kv_x=jnp.asarray(kv))
    assert got.shape == (2, 7, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=TOL, rtol=TOL)


def test_quantize_kv_matches_reference():
    """Symmetric int8 per (token, head): the same codes (round half to even,
    clipped to +-127) and scales, an all-zero head kept at the 1e-8 floor."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    x[0, 0, 1] = 0.0
    x[1, 0, 2, :4] = [127.0, 0.5, 1.5, -2.5]  # the scale is 1: exact halves
    x[1, 0, 2, 4:] = 0.0
    q, s = attention.quantize_kv(torch.from_numpy(x))
    rq, rs = ref_attention.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 1, 4, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q[1, 0, 2, :4].tolist() == [127, 0, 2, -2]
