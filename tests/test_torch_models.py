"""The port's model layer against the reference's, on the CPU.

The reference's parameters (numpy, through ``from_jax_params``) and the same
numpy tokens go through both packages. In float32 the two agree to about
1e-6; the tolerances below are 1e-4, which leaves room for the two
frameworks' different summation orders (einsum paths, the flash kernel's
online softmax against the reference's dense softmax, the chunked SSD
against the reference's chunked SSD) and nothing more.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, build_model, common, mlp, ssm
from repro_torch.models.convert import from_jax_params

TOL = 1e-4
ARCHS = ["zamba2-1.2b", "mamba2-1.3b"]


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(port model, port params, reference model, reference params) for a
    smoke config in float32, with the reference's random parameters."""
    arch = request.param
    cfg = _f32(get_smoke_config(arch))
    ref_cfg = _f32(ref_smoke_config(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = jax.jit(ref_model.init_params)(jax.random.key(1))
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return build_model(cfg, device="cpu"), params, ref_model, ref_params


def _tokens(cfg, B=2, S=20, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_logits_match_reference(pair):
    model, params, ref_model, ref_params = pair
    toks = _tokens(model.cfg)
    h, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    got = model.unembed(params, h).numpy()
    rh, _ = jax.jit(ref_model.forward)(ref_params, {"tokens": jnp.asarray(toks)})
    exp = np.asarray(ref_model.unembed(ref_params, rh))
    assert got.shape == exp.shape == (2, 20, model.cfg.vocab_size)
    np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)


def test_decode_logits_match_reference_and_forward(pair):
    """Token-by-token decode against the reference's decode and against the
    port's own forward (what ``tests/test_models.py`` checks in the
    reference, here also for the hybrid family)."""
    model, params, ref_model, ref_params = pair
    toks = _tokens(model.cfg, S=12)
    state = model.init_decode_state(2, 32, dtype=torch.float32)
    ref_state = ref_model.init_decode_state(2, 32, dtype=jnp.float32)
    ref_step = jax.jit(ref_model.decode_step)
    got, exp = [], []
    for t in range(toks.shape[1]):
        logits, state = model.decode_step(params, state, {"token": torch.from_numpy(toks[:, t:t + 1])})
        got.append(logits.numpy())
        ref_logits, ref_state = ref_step(ref_params, ref_state, {"token": jnp.asarray(toks[:, t:t + 1])})
        exp.append(np.asarray(ref_logits))
    got, exp = np.stack(got, 1), np.stack(exp, 1)
    np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)
    assert state["length"] == toks.shape[1]
    h, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got, model.unembed(params, h).numpy(), atol=2e-3, rtol=2e-3)


def test_bf16_forward_near_reference(pair):
    """bf16 activations: the flash kernel keeps the probabilities in float32
    where the reference rounds them to bf16 before the PV product, and the
    two frameworks round other intermediates at other places, so the logits
    differ by bf16 rounding (0.016 and 0.025 of the logits' largest
    magnitude on the two smoke configs); 0.1 of it catches a wrong layer,
    not rounding."""
    model, params, ref_model, ref_params = pair
    cfg = dataclasses.replace(model.cfg, dtype="bfloat16")
    model16 = build_model(cfg, device="cpu")
    ref16 = ref_build_model(dataclasses.replace(ref_model.cfg, dtype="bfloat16"))
    toks = _tokens(cfg)
    h, _ = model16.forward(params, {"tokens": torch.from_numpy(toks)})
    assert h.dtype == torch.bfloat16
    got = model16.unembed(params, h).float().numpy()
    rh, _ = jax.jit(ref16.forward)(ref_params, {"tokens": jnp.asarray(toks)})
    exp = np.asarray(ref16.unembed(ref_params, rh), np.float32)
    scale = float(np.abs(exp).max())
    np.testing.assert_allclose(got / scale, exp / scale, atol=0.1)


# -- modules ------------------------------------------------------------------------

def _zamba():
    return _f32(get_smoke_config("zamba2-1.2b")), _f32(ref_smoke_config("zamba2-1.2b"))


def test_ssd_forward_output_and_state_match_reference():
    """S = 21 is no multiple of the chunk (8): both pad to 24."""
    cfg, ref_cfg = _zamba()
    ref_p = ref_ssm.ssm_init(jax.random.key(2), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(4).normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    out, state = ssm.ssd_forward(p, torch.from_numpy(x), cfg)
    ref_out, ref_state = jax.jit(ref_ssm.ssd_forward, static_argnums=2)(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(ref_state), atol=TOL, rtol=TOL)
    assert state.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def test_attention_matches_reference():
    cfg, ref_cfg = _zamba()
    ref_p = ref_attention.attn_init(jax.random.key(5), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(6).normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    for window in (None, 5):
        got = attention.attention(p, torch.from_numpy(x), cfg, window=window).numpy()
        exp = np.asarray(ref_attention.attention(ref_p, jnp.asarray(x), ref_cfg, window=window))
        np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    cfg, ref_cfg = (dataclasses.replace(c, mlp=kind) for c in _zamba())
    ref_p = ref_mlp.mlp_init(jax.random.key(7), ref_cfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), ref_p)
    x = np.random.default_rng(8).normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(mlp.mlp_forward(p, torch.from_numpy(x), cfg).numpy(),
                               np.asarray(ref_mlp.mlp_forward(ref_p, jnp.asarray(x), ref_cfg)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric"])
def test_norms_rope_softcap_match_reference(kind):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    p = {k: rng.normal(size=16).astype(np.float32)
         for k in ref_common.norm_init(kind, 16)}
    got = common.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    exp = ref_common.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-6, rtol=1e-5)
    pos = np.arange(7, dtype=np.int32)[None] + 3
    cos, sin = common.rope(torch.from_numpy(pos), 16, 10000.0)
    rcos, rsin = ref_common.rope(jnp.asarray(pos), 16, 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(rcos), atol=1e-6)
    got = common.apply_rope(torch.from_numpy(x), cos, sin).numpy()
    exp = ref_common.apply_rope(jnp.asarray(x), rcos, rsin)
    np.testing.assert_allclose(got, np.asarray(exp), atol=1e-5)
    np.testing.assert_allclose(common.softcap(torch.from_numpy(x), 2.0).numpy(),
                               np.asarray(ref_common.softcap(jnp.asarray(x), 2.0)), atol=1e-6)


def test_dense_init_is_truncated_fan_in():
    gen = torch.Generator().manual_seed(0)
    w = common.dense_init(gen, (400, 300), device="cpu")
    assert w.dtype == torch.float32
    std = 1 / 400 ** 0.5
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.03  # std of N(0, 1) cut at +-2


def test_init_params_has_the_reference_layout():
    cfg = get_smoke_config("zamba2-1.2b")
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(ref_build_model(ref_smoke_config("zamba2-1.2b")).init_params,
                         jax.random.key(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes


# -- what the port takes ---------------------------------------------------------------

def test_unported_configs_and_options_raise():
    """Every architecture of the reference is ported: its full and smoke
    configs equal the reference's field by field, an unknown name or family
    raises, and cross-attention and the int8 cache run."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import get_config as ref_config
    from repro_torch.configs import ARCHS

    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(ref_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(ref_smoke_config(arch))
        build_model(get_smoke_config(arch), device="cpu")
    assert get_config("gemma2-9b").d_model == 3584
    assert get_config("granite-moe-3b-a800m").n_experts == 40
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("llama-70b")
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(get_smoke_config("olmo-1b"), family="rnn"), device="cpu")
    cfg, _ = _zamba()
    p = attention.attn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    assert attention.attention(p, x, cfg, kv_x=torch.zeros((1, 6, cfg.d_model))).shape == x.shape
    assert attention.init_kv_cache(cfg, 1, 8, 1, quantized=True, device="cpu").quantized


def test_from_jax_params_checks_the_tree(pair):
    model, params, _, ref_params = pair
    pn = jax.tree.map(np.asarray, ref_params)
    with pytest.raises(ValueError, match="keys"):
        from_jax_params({k: v for k, v in pn.items() if k != "embed"}, model.cfg, device="cpu")
    other = dataclasses.replace(model.cfg, n_layers=model.cfg.n_layers + 1)
    with pytest.raises(ValueError, match="leading"):
        from_jax_params(pn, other, device="cpu")
    assert params["layers"]["ssm"]["w_x"].shape[0] == model.cfg.n_layers


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("mamba2-1.3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({}, cfg)
