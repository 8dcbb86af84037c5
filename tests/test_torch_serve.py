"""The port's serving path against the reference's, on the CPU: greedy
generation must give the reference engine's tokens exactly (float32 smoke
configs, the reference's parameters), and prefill the reference's next
token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import make_prefill as ref_make_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import ServeEngine, make_prefill, make_serve_step

PROMPTS = [[5], [1, 2, 3], [9, 8, 7, 6, 5, 4]]


@pytest.fixture(scope="module", params=["zamba2-1.2b", "mamba2-1.3b"])
def pair(request):
    cfg = dataclasses.replace(get_smoke_config(request.param), dtype="float32")
    ref_model = ref_build_model(dataclasses.replace(ref_smoke_config(request.param),
                                                    dtype="float32"))
    ref_params = jax.jit(ref_model.init_params)(jax.random.key(3))
    params = from_jax_params(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return build_model(cfg, device="cpu"), params, ref_model, ref_params


def test_engine_tokens_equal_reference(pair):
    model, params, ref_model, ref_params = pair
    got = ServeEngine(model, params, max_len=64).generate(PROMPTS, max_new=6)
    exp = RefServeEngine(ref_model, ref_params, max_len=64).generate(PROMPTS, max_new=6)
    assert got == exp
    assert [len(o) for o in got] == [len(p) + 6 for p in PROMPTS]


def test_engine_uneven_prompts_match_solo(pair):
    model, params, _, _ = pair
    eng = ServeEngine(model, params, max_len=64)
    batched = eng.generate(PROMPTS, max_new=4)
    for p, got in zip(PROMPTS, batched):
        assert eng.generate([p], max_new=4)[0] == got


def test_engine_rejects_empty_prompt(pair):
    model, params, _, _ = pair
    with pytest.raises(ValueError, match="at least one token"):
        ServeEngine(model, params, max_len=64).generate([[1, 2], []], max_new=2)


def test_engine_cache_is_bf16_as_in_the_reference(pair):
    """The engine asks for the decode state with no dtype: the KV cache is
    bf16 even for a float32 config, as in the reference."""
    model, _, _, _ = pair
    state = model.init_decode_state(2, 16)
    if model.cfg.family == "hybrid":
        assert state["kv"].k.dtype == torch.bfloat16
    assert state["ssm"]["state"].dtype == torch.float32 and state["length"] == 0


def test_prefill_next_token_equals_reference(pair):
    model, params, ref_model, ref_params = pair
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab_size, (3, 17)).astype(np.int32)
    nxt, state = make_prefill(model)(params, model.init_decode_state(3, 32),
                                     {"tokens": torch.from_numpy(toks)})
    ref_nxt, ref_state = ref_make_prefill(ref_model)(
        ref_params, ref_model.init_decode_state(3, 32), {"tokens": jnp.asarray(toks)})
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_nxt))
    assert state["length"] == int(ref_state["length"]) == 17


def test_serve_step_is_greedy(pair):
    model, params, _, _ = pair
    state = model.init_decode_state(2, 8)
    batch = {"token": torch.tensor([[3], [4]])}
    logits, _ = model.decode_step(params, model.init_decode_state(2, 8), batch)
    nxt, state = make_serve_step(model)(params, state, batch)
    assert nxt.tolist() == torch.argmax(logits, dim=-1).tolist() and state["length"] == 1
