"""Checks shared by the port's family tests (``tests/test_torch_families.py``,
``test_torch_moe.py``, ``test_torch_encdec.py``): a smoke config in float32
with the reference's random parameters (numpy, through ``from_jax_params``),
the same numpy batch through both packages, and the reference's outputs as
the expectation at ``TOL``."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import make_prefill as ref_make_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import ServeEngine, make_prefill

# float32 on both sides: the frameworks' summation orders (einsum paths, the
# flash kernel's online softmax against the reference's dense softmax) and
# nothing more
TOL = 1e-4
# the port's own forward against its token-by-token decode: the reference's
# tolerance for the same check (tests/test_models.py)
DECODE_TOL = 2e-3
PROMPTS = [[5], [1, 2, 3], [9, 8, 7, 6, 5, 4]]


def make_pair(arch: str, seed: int = 1, **changes):
    """(port model, port params, reference model, reference params) for the
    smoke config of ``arch`` in float32, with ``changes`` applied to both."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **changes)
    ref_cfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32", **changes)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = jax.jit(ref_model.init_params)(jax.random.key(seed))
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return build_model(cfg, device="cpu"), params, ref_model, ref_params


def batch_np(cfg, B: int = 2, S: int = 12, seed: int = 3) -> dict:
    """Tokens, plus patch embeddings (vlm) or encoder frames (encdec)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["enc_frames"] = rng.normal(size=(B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return b


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def check_forward(pair) -> None:
    """Logits at every position and the MoE aux loss, against the
    reference's."""
    model, params, ref_model, ref_params = pair
    cfg = model.cfg
    b = batch_np(cfg)
    h, aux = model.forward(params, _torch(b))
    got = model.unembed(params, h).numpy()
    rh, raux = jax.jit(ref_model.forward)(ref_params, _jax(b))
    exp = np.asarray(ref_model.unembed(ref_params, rh))
    S = b["tokens"].shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    assert got.shape == exp.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(raux), atol=TOL, rtol=TOL)
    if cfg.family == "moe":
        assert float(aux) > 0


def _decode_both(pair, b: dict, enc_out: np.ndarray | None = None):
    model, params, ref_model, ref_params = pair
    toks = b["tokens"]
    B, S = toks.shape
    state = model.init_decode_state(B, 32, dtype=torch.float32)
    ref_state = ref_model.init_decode_state(B, 32, dtype=jnp.float32)
    if enc_out is not None:
        state["enc_out"] = torch.from_numpy(enc_out)
        ref_state["enc_out"] = jnp.asarray(enc_out)
    step = jax.jit(ref_model.decode_step)
    got, exp = [], []
    for t in range(S):
        logits, state = model.decode_step(params, state, {"token": torch.from_numpy(toks[:, t:t + 1])})
        got.append(logits.numpy())
        ref_logits, ref_state = step(ref_params, ref_state, {"token": jnp.asarray(toks[:, t:t + 1])})
        exp.append(np.asarray(ref_logits))
    assert state["length"] == S == int(ref_state["length"])
    return np.stack(got, 1), np.stack(exp, 1), state


def check_decode(pair, forward_too: bool = True) -> None:
    """Token-by-token decode (float32 cache) against the reference's decode;
    with ``forward_too``, also against the port's own forward. vlm decodes
    the tokens alone (both packages' decode ignores the image prefix);
    encdec decodes against the port's encoder output of the frames."""
    model, params, _, _ = pair
    cfg = model.cfg
    b = batch_np(cfg)
    enc = None
    if cfg.family == "encdec":
        enc = transformer._encoder_forward(params, torch.from_numpy(b["enc_frames"]), cfg).numpy()
    got, exp, _ = _decode_both(pair, b, enc_out=enc)
    np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)
    if forward_too and cfg.family != "vlm":
        h, _ = model.forward(params, _torch(b))
        np.testing.assert_allclose(got, model.unembed(params, h).numpy(),
                                   atol=DECODE_TOL, rtol=DECODE_TOL)


def check_int8_decode(pair) -> None:
    """The int8 KV cache: logits equal to the reference's int8 decode, and
    within the reference's own 5% of the float cache's."""
    model, params, ref_model, ref_params = pair
    cfg = dataclasses.replace(model.cfg, kv_quant_decode=True)
    qpair = (build_model(cfg, device="cpu"), params,
             ref_build_model(dataclasses.replace(ref_model.cfg, kv_quant_decode=True)), ref_params)
    b = batch_np(cfg, S=10, seed=0)
    got, exp, state = _decode_both(qpair, b)
    assert state["kv"].quantized and state["kv"].k.dtype == torch.int8
    assert state["kv"].k_scale.dtype == torch.float32
    np.testing.assert_allclose(got, exp, atol=TOL, rtol=TOL)
    flt, _, _ = _decode_both(pair, b)
    for t in range(got.shape[1]):
        scale = float(np.abs(flt[:, t]).max()) + 1e-6
        assert float(np.abs(flt[:, t] - got[:, t]).max()) / scale < 0.05


def check_engine(pair) -> None:
    """Greedy tokens equal to the reference engine's, prompts of uneven
    length in one batch."""
    model, params, ref_model, ref_params = pair
    got = ServeEngine(model, params, max_len=64).generate(PROMPTS, max_new=6)
    exp = RefServeEngine(ref_model, ref_params, max_len=64).generate(PROMPTS, max_new=6)
    assert got == exp
    assert [len(o) for o in got] == [len(p) + 6 for p in PROMPTS]


def check_prefill(pair) -> None:
    """The prefill's next token (the port unembeds the last position only)
    against the reference's, and its ``length``."""
    model, params, ref_model, ref_params = pair
    b = batch_np(model.cfg, B=3, S=9, seed=7)
    nxt, state = make_prefill(model)(params, model.init_decode_state(3, 32), _torch(b))
    ref_nxt, ref_state = ref_make_prefill(ref_model)(
        ref_params, ref_model.init_decode_state(3, 32), _jax(b))
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_nxt))
    assert state["length"] == int(ref_state["length"]) == 9


def check_layout(arch: str) -> None:
    """The port's random parameters have the reference's tree of shapes."""
    cfg = get_smoke_config(arch)
    params = build_model(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(ref_build_model(ref_smoke_config(arch)).init_params, jax.random.key(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(params))


# -- training (tests/test_torch_train*.py) -----------------------------------------------

# gradients: each leaf within GRAD_TOL of its own largest magnitude, float32
# on both sides (summation order only)
GRAD_TOL = 1e-4
# cross-attention's key bias has an exact gradient of zero (no rope there, so
# it shifts a query's scores by one constant, which a softmax ignores); both
# packages leave float32 noise in it, held against the model's largest
# gradient instead
ZERO_GRAD_LEAVES = ("xattn/bk",)


@functools.lru_cache(maxsize=None)
def _ref_train_state(arch: str):
    """The reference's model and ``init_train_state(model,
    jax.random.key(0))`` for the float32 smoke config of ``arch``, made once
    per process (its arrays are immutable)."""
    from repro.train.train_step import init_train_state as ref_init_train_state

    ref_model = ref_build_model(dataclasses.replace(ref_smoke_config(arch), dtype="float32"))
    return ref_model, jax.jit(lambda key: ref_init_train_state(ref_model, key))(
        jax.random.key(0))


def train_pair(arch: str):
    """(port model, port train state, reference model, reference train
    state) for the smoke config of ``arch`` in float32, both from the
    reference's ``init_train_state(model, jax.random.key(0))``; the port's
    state is a fresh copy."""
    from repro_torch.models.convert import from_jax_train_state

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    ref_model, ref_state = _ref_train_state(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_model.cfg)
    state = from_jax_train_state(jax.tree.map(np.asarray, ref_state), cfg, device="cpu")
    return build_model(cfg, device="cpu"), state, ref_model, ref_state


def train_batch(cfg, B: int = 4, S: int = 16, seed: int = 0) -> dict:
    """A numpy train batch: tokens, next-token labels, a loss mask with about
    a fifth of the positions off, plus the family's inputs."""
    b = batch_np(cfg, B, S, seed)
    rng = np.random.default_rng(seed + 1)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    b["loss_mask"] = (rng.random((B, S)) < 0.8).astype(np.float32)
    return b


def tree_leaves(tree: dict, prefix: str = "") -> dict:
    """{"/"-joined path: leaf as numpy} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def check_grads(got: dict, exp: dict, tol: float = GRAD_TOL) -> None:
    """Every gradient leaf of ``got`` (port) against ``exp`` (reference)."""
    got, exp = tree_leaves(got), tree_leaves(exp)
    assert got.keys() == exp.keys()
    top = max(float(np.abs(v).max()) for v in exp.values())
    for k, e in exp.items():
        g = got[k]
        assert g.shape == e.shape and g.dtype == e.dtype, k
        if k.endswith(ZERO_GRAD_LEAVES):
            assert max(np.abs(g).max(), np.abs(e).max()) <= tol * 1e-2 * top, k
            continue
        scale = float(np.abs(e).max())
        assert float(np.abs(g - e).max()) <= tol * scale, (k, float(np.abs(g - e).max()), scale)


def check_loss_and_grads(arch: str) -> None:
    """The port's ``make_loss_fn`` value, metrics and gradients against
    ``jax.value_and_grad`` of the reference's, on the same state and batch."""
    from repro.train.train_step import TrainHParams as RefHParams
    from repro.train.train_step import make_loss_fn as ref_make_loss_fn
    from repro_torch.train.train_step import TrainHParams, make_loss_fn, value_and_grad

    model, state, ref_model, ref_state = train_pair(arch)
    b = train_batch(model.cfg)
    ref_fn = jax.value_and_grad(ref_make_loss_fn(ref_model, RefHParams()), has_aux=True)
    (rloss, raux), rgrads = jax.jit(ref_fn)(ref_state["params"], _jax(b))
    (loss, aux), grads = value_and_grad(make_loss_fn(model, TrainHParams()), state["params"], b)
    assert loss.dtype == torch.float32 and set(aux) == set(raux) == {"nll", "ntok", "moe_aux"}
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for k in raux:
        np.testing.assert_allclose(float(aux[k]), float(raux[k]), rtol=1e-5, atol=1e-7)
    if model.cfg.family == "moe":
        assert float(aux["moe_aux"]) > 0
    check_grads(grads, rgrads)
