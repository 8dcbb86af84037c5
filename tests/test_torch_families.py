"""The port's dense family (gemma2-9b, olmo-1b, stablelm-3b, deepseek-67b)
against the reference on the CPU, at the smoke configs in float32: forward
logits, token-by-token decode, the int8 KV cache, the serving engine's
tokens, the prefill's next token and the parameter layout. Also the
padded head_dim-80 route of the flash wrapper, rehearsed with the plain
version, and the smoke run's family path on the CPU."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.models.transformer import layer_windows as ref_layer_windows
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import transformer
from repro_torch.models.convert import expected_keys, from_jax_params

from torch_family_cases import (check_decode, check_engine, check_forward, check_int8_decode,
                                check_layout, check_prefill, make_pair)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DENSE = ["gemma2-9b", "olmo-1b", "stablelm-3b", "deepseek-67b"]


@pytest.fixture(scope="module", params=DENSE)
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


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_has_the_reference_layout(arch):
    check_layout(arch)


def test_int8_kv_cache_decode_matches_reference():
    """olmo-1b's smoke config with the int8 cache, as the reference's
    ``tests/test_serve.py::test_int8_kv_cache_close_to_bf16``."""
    check_int8_decode(make_pair("olmo-1b", seed=2))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_windows_and_keys_match_reference(arch):
    """Per-layer windows (gemma2: the window on even layers) and the
    top-level parameter names, at full width and at the smoke config."""
    for cfg in (get_config(arch), get_smoke_config(arch)):
        assert transformer.layer_windows(cfg, cfg.n_layers) == \
            ref_layer_windows(cfg, cfg.n_layers).tolist()
    cfg = get_smoke_config(arch)
    ref = jax.eval_shape(ref_build_model(ref_smoke_config(arch)).init_params, jax.random.key(0))
    assert expected_keys(cfg) == set(ref)


@pytest.mark.parametrize("arch", ["stablelm-3b", "whisper-tiny"])
def test_from_jax_params_checks_every_key(arch):
    """A missing top-level key or a wrong stacked depth (``layers``, and
    ``enc_layers`` for encdec) raises."""
    model, _, _, ref_params = make_pair(arch)
    pn = jax.tree.map(np.asarray, ref_params)
    cfg = model.cfg
    for key in expected_keys(cfg):
        with pytest.raises(ValueError, match="keys"):
            from_jax_params({k: v for k, v in pn.items() if k != key}, cfg, device="cpu")
    with pytest.raises(ValueError, match="leading"):
        from_jax_params(pn, dataclasses.replace(cfg, n_layers=cfg.n_layers + 1), device="cpu")
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="enc_layers"):
            from_jax_params(pn, dataclasses.replace(cfg, n_enc_layers=cfg.n_enc_layers + 1),
                            device="cpu")


@pytest.mark.parametrize("kwargs", [dict(causal=True), dict(causal=False),
                                    dict(causal=True, window=9, softcap=30.0)])
def test_head_dim_80_padding_is_exact(kwargs):
    """The flash wrapper runs head_dim 80 (stablelm-3b) as 128 on zero-padded
    q, k, v with the true head_dim's scale and keeps 80 output columns;
    rehearsed here with the plain version: the same result to float32
    rounding."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 37, n, 80), generator=g) for n in (4, 2, 2))
    exp = flash_attention_ref(q, k, v, **kwargs)
    pad = [torch.nn.functional.pad(x, (0, 48)) for x in (q, k, v)]
    got = flash_attention_ref(*pad, scale=80 ** -0.5, **kwargs)
    assert float(got[..., 80:].abs().max()) == 0.0
    torch.testing.assert_close(got[..., :80], exp, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-tiny"])
def test_chip_smoke_family_path_runs_on_the_cpu(arch, monkeypatch):
    """The smoke run's family phase (prefills, the finite-logits sweep in
    chunks, generate, the kernel path against the plain versions) at a
    smoke config on the CPU, where nothing launches; its launch expectation
    equals the flash-attention calls of one prefill here."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill

    # room for the smoke run's prompts and new tokens in whisper's learned positions
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16",
                              max_seq=chip_smoke.ENGINE_MAX_LEN)
    res = chip_smoke.run_family_path(cfg, 2, 24, 1, 16, device="cpu",
                                     gen=torch.Generator().manual_seed(0))
    assert res["arch"] == cfg.name and not any(res["prefill_launches"].values())
    assert res["consistency"]["kernel_vs_plain_max_abs_err"] == 0.0
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    assert res["consistency"]["routing_tokens"] == moe_layers * 16  # replayed, 1 x 16 tokens
    assert res["consistency"]["routing_flips"] == 0
    assert res["decode_steps"] == max(chip_smoke.PROMPT_LENS) + chip_smoke.MAX_NEW - 1
    assert res["prefill_peak_bytes"] is None

    calls = []
    flash = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: calls.append(1) or flash(*a, **k))
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params = model.init_params(gen)
    make_prefill(model)(params, model.init_decode_state(2, 32),
                        chip_smoke.model_batch(cfg, 2, 24, gen, "cpu"))
    want = chip_smoke.expected_launches(cfg)
    assert len(calls) == want["flash_attention"] == \
        cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)
    assert want["ssd_scan"] == 0


def test_families_import_neither_jax_nor_reference():
    """Every config module and a smoke forward and decode step of every
    family, in a fresh process: no jax and no reference module loads."""
    import subprocess

    code = ("import sys, torch\n"
            "from repro_torch.configs import ARCHS, get_config, get_smoke_config\n"
            "from repro_torch.models import build_model\n"
            "for a in ARCHS:\n"
            "    get_config(a); cfg = get_smoke_config(a)\n"
            "    m = build_model(cfg, device='cpu')\n"
            "    p = m.init_params(torch.Generator().manual_seed(0))\n"
            "    b = {'tokens': torch.zeros((1, 4), dtype=torch.long)}\n"
            "    if cfg.family == 'vlm': b['patch_embeds'] = torch.zeros((1, cfg.n_patches, cfg.d_model))\n"
            "    if cfg.family == 'encdec': b['enc_frames'] = torch.zeros((1, cfg.enc_positions, cfg.d_model))\n"
            "    m.forward(p, b)\n"
            "    m.decode_step(p, m.init_decode_state(1, 8), {'token': b['tokens'][:, :1]})\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
