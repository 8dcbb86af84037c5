"""The port's training gradients for the ssm, vlm and encdec families, and
the model kernels' autograd Functions, against the reference on the CPU.

- ``make_loss_fn``'s loss, metrics and every gradient leaf against
  ``jax.value_and_grad`` of the reference's (mamba2, llava, whisper; the
  dense, moe and hybrid families are in ``tests/test_torch_train.py``).
- ``FlashAttentionFn`` (through ``models.attention.attention``) and
  ``SsdScanFn`` (through ``models.ssm.ssd_forward``) on the CPU, where their
  forward is the plain version and their backward the blockwise
  recomputation: every gradient of the layer's inputs and parameters within
  1e-4 of its largest magnitude against ``jax.grad`` of the reference's
  ``attention`` and ``ssd_forward``, causal, windowed, softcapped, GQA and
  bidirectional, and at S = 3072, where the reference takes its chunked
  path (query blocks of 512; it needs whole 1024-key blocks, so 2560
  fails there). The layer's output has the Function in its
  graph, and a direct call of a raw kernel with grad-requiring inputs
  raises on every device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_family_cases import check_grads, check_loss_and_grads

from repro.models import attention as ref_attention
from repro.models import ssm as ref_ssm
from repro.models.config import ModelConfig as RefConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_cuda
from repro_torch.kernels.ssd_scan import SsdScanFn, ssd_scan_cuda
from repro_torch.models import attention, ssm
from repro_torch.models.config import ModelConfig


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "llava-next-mistral-7b", "whisper-tiny"])
def test_loss_metrics_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)


def _counted(monkeypatch, cls):
    calls = []
    apply = cls.apply
    monkeypatch.setattr(cls, "apply", lambda *a: calls.append(1) or apply(*a))
    return calls


def _params(init, cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    p = init(gen, cfg, device="cpu")
    rng = np.random.default_rng(seed)
    # nonzero biases and SSM constants, so their gradients are not trivial
    return {k: (v + torch.from_numpy(rng.normal(size=v.shape).astype(np.float32) * 0.1)
                if k in ("bq", "bv", "dt_bias", "D") else v)
            if not isinstance(v, dict) else v for k, v in p.items()}


def _grads_both(port_fn, ref_fn, p: dict, x: np.ndarray, ct: np.ndarray):
    """Gradients of sum(out * ct) w.r.t. (x, every parameter) in both packages."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()
              if not isinstance(v, dict)}
    xt = torch.from_numpy(x).requires_grad_()
    out = port_fn({**p, **leaves}, xt)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), [xt, *leaves.values()])
    got = {"x": grads[0], **dict(zip(leaves, grads[1:]))}
    ref_p = {k: v.detach().numpy() if not isinstance(v, dict)
             else {kk: vv.detach().numpy() for kk, vv in v.items()} for k, v in p.items()}
    names = list(leaves)
    exp = jax.jit(jax.grad(lambda xx, pp: jnp.sum(ref_fn({**ref_p, **pp}, xx) * ct),
                           argnums=(0, 1)))(x, {k: ref_p[k] for k in names})
    return got, {"x": exp[0], **exp[1]}


ATTN_CASES = {
    "causal": (dict(), 96, {}),
    "window": (dict(), 96, {"window": 40}),
    "softcap_gqa": (dict(attn_logit_softcap=5.0, n_kv_heads=1), 96, {}),
    "bias_bidirectional": (dict(qkv_bias=True), 64, {"causal": False}),
    # the reference's chunked path (S * S > 2048 ** 2) takes S in whole
    # 1024-key blocks: 2560 fails inside the reference, 3072 is the first
    "chunked_3072_window": (dict(n_kv_heads=2), 3072, {"window": 700}),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_fn_grads_match_the_reference(case, monkeypatch):
    changes, S, kw = ATTN_CASES[case]
    fields = {**dict(name="attn", family="dense", n_layers=1, d_model=32, n_heads=4,
                     n_kv_heads=4, head_dim=16, d_ff=64, vocab_size=64, dtype="float32"),
              **changes}
    cfg, ref_cfg = ModelConfig(**fields), RefConfig(**fields)
    p = _params(attention.attn_init, cfg, 0)
    rng = np.random.default_rng(1)
    B = 1 if S > 512 else 2
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    calls = _counted(monkeypatch, FlashAttentionFn)
    got, exp = _grads_both(lambda pp, xx: attention.attention(pp, xx, cfg, **kw),
                           lambda pp, xx: ref_attention.attention(pp, xx, ref_cfg, **kw),
                           p, x, ct)
    assert len(calls) == 1
    check_grads(got, exp)


@pytest.mark.parametrize("S", [40, 64])  # a padded and a whole last chunk
def test_ssd_scan_fn_grads_match_the_reference(S, monkeypatch):
    fields = dict(name="ssm", family="ssm", n_layers=1, d_model=32, vocab_size=64,
                  ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16, ssm_groups=2,
                  dtype="float32")
    cfg, ref_cfg = ModelConfig(**fields), RefConfig(**fields)
    p = _params(ssm.ssm_init, cfg, 2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    calls = _counted(monkeypatch, SsdScanFn)
    got, exp = _grads_both(lambda pp, xx: ssm.ssd_forward(pp, xx, cfg)[0],
                           lambda pp, xx: ref_ssm.ssd_forward(pp, xx, ref_cfg)[0], p, x, ct)
    assert len(calls) == 1
    assert {"A_log", "D", "dt_bias", "w_x", "x"} <= set(got)
    check_grads(got, exp)


def test_raw_kernels_refuse_inputs_that_need_a_graph():
    """Called directly with grad-requiring inputs under grad mode, a raw
    kernel raises before any device check: its output would carry no
    graph. Without grad mode (or through ``ops``) the same call proceeds."""
    q = torch.zeros((1, 8, 2, 64), requires_grad=True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        flash_attention_cuda(q, q, q)
    x = torch.zeros((1, 8, 2, 32), requires_grad=True)
    dt, A, D = torch.zeros((1, 8, 2)), torch.zeros(2), torch.zeros(2)
    Bm = torch.zeros((1, 8, 1, 16))
    with pytest.raises(RuntimeError, match="no autograd graph"):
        ssd_scan_cuda(x, dt, A, Bm, Bm, D, chunk=4)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    out = ops.flash_attention(q, q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    y, st = ops.ssd_scan(x, dt, A, Bm, Bm, D, chunk=4)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None


def test_remat_changes_no_value_or_gradient():
    """``forward(..., remat=True)`` (the train step's setting) gives the
    hidden states and gradients of ``remat=False`` exactly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    for arch in ("zamba2-1.2b", "whisper-tiny"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        leaves = {k: v for k, v in params.items() if not isinstance(v, dict)}
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))}
        if cfg.family == "encdec":
            batch["enc_frames"] = torch.from_numpy(
                rng.normal(size=(2, cfg.enc_positions, cfg.d_model)).astype(np.float32))
        outs = []
        for remat in (False, True):
            lv = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
            h, _ = model.forward({**params, **lv}, batch, remat=remat)
            outs.append((h.detach(), torch.autograd.grad(h.square().sum(), list(lv.values()))))
        assert torch.equal(outs[0][0], outs[1][0])
        for a, b in zip(outs[0][1], outs[1][1]):
            assert torch.equal(a, b)
