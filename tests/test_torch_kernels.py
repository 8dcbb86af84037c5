"""The port's dataframe kernels against the reference's.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; they
are held bit for bit against the reference's Pallas kernels run in
interpret mode and against its plain jnp versions (``kernels/ref.py``):

- hash destinations and histograms for int32, uint32 (near 2**32 - 1),
  float32 and bool keys, 1-3 key columns, N in {1, 1023, 1025, 3000};
- segment sums, mins and maxes in int32, uint32 and integer-valued float32
  (exact in any summation order), with uneven runs, int32 wrap-around and
  empty segments, which hold the identity (0 or the min/max sentinel); in
  bool, int8, uint8, int16 and float16; and the reference's float
  semantics: min(-0.0, +0.0) = -0.0 and max = +0.0 in either order, NaN in
  a segment gives NaN, -0.0 rows sum to +0.0, and a bool sum raises;
- flash attention and the SSD scan within the reference's own kernel-test
  tolerances (``tests/test_kernels.py``): float32 2e-5 and bf16 2e-2 for
  attention, 3e-5 of the output's scale for the scan;
- the card kernels' own arithmetic, rehearsed in plain torch within the
  same tolerances: bf16 attention with P rounded to bf16 before the PV
  product, and the three-pass SSD scan with 3xTF32 products.

The Hopper kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import u32_normalize as ref_u32_normalize
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.partition import u32_normalize
from repro_torch.kernels import ops, registry
from repro.models.ssm import ssd_scan_ref as ref_model_ssd
from repro_torch.kernels.hash_partition import hash_partition_cuda
from repro_torch.kernels.segment_reduce import segment_reduce_cuda


# the reference's interpret-mode kernels, jitted so that each shape is
# interpreted once
_ref_hash_interpret = jax.jit(functools.partial(ref_ops.hash_partition, force="interpret"),
                              static_argnames=("num_partitions",))
_ref_segment_interpret = jax.jit(functools.partial(ref_ops.segment_reduce, force="interpret"),
                                 static_argnames=("num_segments", "op"))
_ref_segment_forced = {
    "interpret": _ref_segment_interpret,
    "jnp": jax.jit(functools.partial(ref_ops.segment_reduce, force="jnp"),
                   static_argnames=("num_segments", "op")),
}


@pytest.fixture(autouse=True)
def _restore_backend():
    prev = registry.get_backend()
    yield
    registry.set_backend(prev)


def _keys(dtype, n, n_cols, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint32:
        k = rng.integers(2**32 - 4096, 2**32, size=(n, n_cols), dtype=np.uint64)
        k[0] = 2**32 - 1
        return k.astype(np.uint32)
    if dtype == np.bool_:
        return rng.integers(0, 2, size=(n, n_cols)).astype(bool)
    if dtype == np.float32:
        k = rng.standard_normal((n, n_cols)).astype(np.float32) * 1e3
        k[0] = -0.0
        return k
    return rng.integers(-2**31, 2**31, size=(n, n_cols), dtype=np.int64).astype(np.int32)


def _port_keys(k):
    return torch.stack([u32_normalize(torch.from_numpy(np.ascontiguousarray(k[:, c])))
                        for c in range(k.shape[1])], dim=1)


def _ref_keys(k):
    return jnp.stack([ref_u32_normalize(jnp.asarray(k[:, c])) for c in range(k.shape[1])],
                     axis=1)


@pytest.mark.parametrize("n", [1, 1023, 1025, 3000])
@pytest.mark.parametrize("n_cols", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.bool_])
def test_hash_partition_parity(dtype, n_cols, n):
    P = 7
    k = _keys(dtype, n, n_cols, seed=n * 10 + n_cols)
    dest, hist = ops.hash_partition(_port_keys(k), P)
    assert dest.dtype == torch.int32 and hist.dtype == torch.int32
    ref_dest, ref_hist = _ref_hash_interpret(_ref_keys(k), num_partitions=P)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref_dest))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref_hist))
    jnp_dest, jnp_hist = ref_ref.hash_partition_ref(_ref_keys(k), P)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jnp_dest))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jnp_hist))
    dest_only, none = ops.hash_partition(_port_keys(k), P, with_hist=False)
    assert none is None
    assert torch.equal(dest_only, dest)
    assert torch.equal(ops.partition_histogram(_port_keys(k), P), hist)


def test_hash_chain_pinned_near_uint32_max():
    """The int64 chain's wrapping multiplies give the uint32 products."""
    k = np.array([[2**32 - 1], [2**32 - 2], [2**31], [0], [1]], np.uint32)
    dest, _ = ops.hash_partition(_port_keys(k), 65521, with_hist=False)
    ref_dest, _ = ref_ref.hash_partition_ref(_ref_keys(k), 65521)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref_dest))


def _ref_segment(values, seg, nseg, op, force="interpret"):
    return np.asarray(_ref_segment_forced[force](jnp.asarray(values), jnp.asarray(seg),
                                                 num_segments=nseg, op=op))


def _port_segment(values, seg, nseg, op):
    if values.dtype == np.uint32:
        v = torch.from_numpy(values.view(np.int32)).view(torch.uint32)
        out = ops.segment_reduce(v, torch.from_numpy(seg), nseg, op=op)
        assert out.dtype == torch.uint32
        return out.view(torch.int32).numpy().view(np.uint32)
    return ops.segment_reduce(torch.from_numpy(values), torch.from_numpy(seg), nseg,
                              op=op).numpy()


def _values(dtype, n, width, rng):
    if dtype == np.uint32:
        return rng.integers(2**32 - 2**24, 2**32, size=(n, width), dtype=np.uint64).astype(np.uint32)
    if dtype == np.float32:  # integer-valued: sums are exact in any order
        return rng.integers(-1000, 1000, size=(n, width)).astype(np.float32)
    return rng.integers(-2**31, 2**31, size=(n, width), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
@pytest.mark.parametrize("n,nseg", [(1, 1), (300, 7), (1300, 40)])
def test_segment_reduce_parity(n, nseg, dtype, op):
    """Uneven runs, every id sorted; three empty segments past the last id
    and empty segments in between hold the identity on both sides."""
    rng = np.random.default_rng(n + nseg)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int32)
    if nseg > 2:  # leave a segment in the middle empty
        seg[seg == nseg // 2] += 1
    vals = _values(dtype, n, 2, rng)
    got = _port_segment(vals, seg, nseg + 3, op)
    exp = _ref_segment(vals, seg, nseg + 3, op)
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_int32_wraps_and_empty_sentinels(op):
    rng = np.random.default_rng(13)
    vals = rng.integers(1 << 30, (1 << 31) - 1, size=(512, 1)).astype(np.int32)
    seg = np.sort(rng.integers(0, 4, 512)).astype(np.int32) * 2  # odd ids empty
    got = _port_segment(vals, seg, 9, op)
    np.testing.assert_array_equal(got, _ref_segment(vals, seg, 9, op))
    empty = {"sum": 0, "min": np.iinfo(np.int32).max, "max": np.iinfo(np.int32).min}[op]
    assert (got[1::2] == empty).all()


def test_segment_reduce_float_sentinels():
    vals = np.array([[1.5], [2.5]], np.float32)
    seg = np.array([0, 0], np.int32)
    assert _port_segment(vals, seg, 2, "min")[1, 0] == np.inf
    assert _port_segment(vals, seg, 2, "max")[1, 0] == -np.inf
    np.testing.assert_array_equal(_port_segment(vals, seg, 2, "max"),
                                  _ref_segment(vals, seg, 2, "max"))


def test_segment_reduce_drops_out_of_range_ids():
    vals = np.arange(6, dtype=np.int32)[:, None]
    seg = np.array([0, 0, 1, 2, 5, 5], np.int32)
    got = _port_segment(vals, seg, 2, "sum")
    np.testing.assert_array_equal(got, [[1], [2]])


_FLOAT_BITS = {np.dtype(np.float32): np.int32, np.dtype(np.float16): np.int16}


def _same_bits(got, exp):
    """Bitwise equality, sign of zero included; NaNs compare by position."""
    assert got.dtype == exp.dtype and got.shape == exp.shape
    if got.dtype in _FLOAT_BITS:
        nan = np.isnan(got)
        np.testing.assert_array_equal(nan, np.isnan(exp))
        got, exp = got.view(_FLOAT_BITS[got.dtype])[~nan], exp.view(_FLOAT_BITS[got.dtype])[~nan]
    np.testing.assert_array_equal(got, exp)


FORCES = ["interpret", "jnp"]


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("rows", [(0.0, -0.0), (-0.0, 0.0)])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_minmax_signed_zeros_follow_reference(dtype, op, rows, force):
    """min(-0.0, +0.0) is -0.0 and max is +0.0, whichever row comes first."""
    vals = np.array([[rows[0]], [rows[1]], [1.5]], dtype)
    seg = np.array([0, 0, 1], np.int32)
    got = _port_segment(vals, seg, 3, op)
    exp = _ref_segment(vals, seg, 3, op, force)
    _same_bits(got, exp)
    assert np.signbit(got[0, 0]) == (op == "min")


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("where", ["first", "last"])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_minmax_nan_propagates_like_reference(dtype, op, where, force):
    """A NaN anywhere in a segment gives NaN; other segments are untouched."""
    run = [np.nan, 3.0, -2.0, 5.0] if where == "first" else [3.0, -2.0, 5.0, np.nan]
    vals = np.array(run + [4.0, -7.0, 0.0], dtype)[:, None]
    seg = np.array([0, 0, 0, 0, 1, 1, 3], np.int32)
    got = _port_segment(vals, seg, 4, op)
    _same_bits(got, _ref_segment(vals, seg, 4, op, force))
    assert np.isnan(got[0, 0]) and not np.isnan(got[1:]).any()


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_segment_sum_of_negative_zeros_like_reference(dtype, force):
    """The reference adds into zeros, so rows of -0.0 sum to +0.0."""
    vals = np.array([[-0.0], [-0.0], [-0.0], [2.0], [-0.0]], dtype)
    seg = np.array([0, 0, 0, 1, 2], np.int32)
    got = _port_segment(vals, seg, 4, "sum")
    _same_bits(got, _ref_segment(vals, seg, 4, "sum", force))
    assert not np.signbit(got).any()


@pytest.mark.parametrize("force", FORCES)
def test_segment_bool_sum_raises_like_reference(force):
    vals = np.ones((4, 1), np.bool_)
    seg = np.zeros(4, np.int32)
    with pytest.raises(TypeError):
        _ref_segment(vals, seg, 1, "sum", force)
    with pytest.raises(TypeError, match="bool"):
        _port_segment(vals, seg, 1, "sum")


def _narrow_values(dtype, n, rng):
    if dtype == np.bool_:
        return rng.random((n, 2)) < 0.5
    if dtype == np.float16:  # integer-valued, partial sums far inside +-2048
        v = rng.integers(-8, 9, (n, 2)).astype(np.float16)
        v[rng.random((n, 2)) < 0.1] = -0.0
        return v
    ii = np.iinfo(dtype)
    return rng.integers(ii.min, ii.max + 1, (n, 2)).astype(dtype)


# bool has no sum; the reference's Pallas path takes no bool either (its
# dispatch sends bool to the jnp path), so bool is held against jnp only
@pytest.mark.parametrize("dtype,op,force", [
    (d, o, f) for d in (np.bool_, np.int8, np.uint8, np.int16, np.float16)
    for o in ("sum", "min", "max") for f in FORCES
    if not (d == np.bool_ and (o == "sum" or f == "interpret"))])
def test_segment_reduce_narrow_dtypes_parity(dtype, op, force):
    """The dtypes the port's tables hold besides int32, uint32 and float32:
    integer sums wrap in the value dtype, bool min / max are AND / OR, empty
    segments hold the identity."""
    rng = np.random.default_rng(7)
    seg = np.sort(rng.integers(0, 9, 300)).astype(np.int32)
    seg[seg == 4] = 5  # an empty segment in the middle
    vals = _narrow_values(dtype, 300, rng)
    got = _port_segment(vals, seg, 11, op)
    _same_bits(got, _ref_segment(vals, seg, 11, op, force))


def test_segment_reduce_partials_fused_form():
    vals = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    seg = torch.tensor([0, 0, 2], dtype=torch.int32)
    out, ids = ops.segment_reduce_partials(vals, seg, op="sum")
    assert out[:, 0].tolist() == [3, 0, 3] and ids.tolist() == [0, 1, 2]


# -- registry ------------------------------------------------------------------

def test_set_backend_validates_and_restores():
    with pytest.raises(ValueError):
        registry.set_backend("pallas")
    prev = registry.set_backend("torch")
    assert registry.get_backend() == "torch" and registry.dispatch_signature() == ("torch",)
    with registry.use_backend("auto"):
        assert registry.get_backend() == "auto"
    assert registry.get_backend() == "torch"
    registry.set_backend(prev)


def test_resolve_decides_by_device_and_dtype():
    # the device decides; every dtype of a CPU tensor runs the plain version
    for dtype in (torch.int32, torch.int8, torch.float16):
        x = torch.zeros(4, dtype=dtype)
        assert registry.resolve("hash_partition", x) == "torch"
        assert registry.resolve("segment_reduce", x) == "torch"
    with registry.use_backend("cuda"):
        with pytest.raises(RuntimeError):
            registry.resolve("segment_reduce", x)
    for kernel in ("flash_attention", "ssd_scan"):
        assert registry.resolve(kernel, x) == "torch"
    with pytest.raises(ValueError):
        registry.resolve("conv1d", x)


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64, torch.bfloat16, torch.complex64])
def test_segment_kernel_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="segment_reduce_cuda takes"):
        segment_reduce_cuda(torch.zeros((4, 1), dtype=dtype),
                            torch.zeros(4, dtype=torch.int32), 1)


def test_plain_versions_count_no_launches():
    registry.reset_launch_counts()
    ops.hash_partition(torch.arange(10, dtype=torch.int32), 3)
    ops.segment_reduce(torch.ones((4, 1), dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), 1)
    ops.flash_attention(torch.zeros((1, 4, 2, 64)), torch.zeros((1, 4, 2, 64)),
                        torch.zeros((1, 4, 2, 64)))
    ops.ssd_scan(torch.zeros((1, 4, 2, 32)), torch.ones((1, 4, 2)), -torch.ones(2),
                 torch.zeros((1, 4, 1, 16)), torch.zeros((1, 4, 1, 16)), torch.ones(2), chunk=4)
    assert registry.launch_counts() == {"hash_partition": 0, "segment_reduce": 0,
                                        "flash_attention": 0, "ssd_scan": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        hash_partition_cuda(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_reduce_cuda(torch.zeros((4, 1), dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ops.hash_partition(torch.zeros(4, dtype=torch.int32), 2, force="cuda")


# -- model-layer kernels ------------------------------------------------------------

_ref_flash_interpret = jax.jit(functools.partial(ref_ops.flash_attention, force="interpret"),
                               static_argnames=("causal", "window", "softcap"))
_ref_ssd_interpret = jax.jit(functools.partial(ref_ops.ssd_scan, force="interpret"),
                             static_argnames=("chunk",))


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _port(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,KV,hd", [(256, 4, 2, 64), (128, 2, 2, 128), (256, 8, 1, 64)])
def test_flash_attention_parity(S, H, KV, hd, dtype):
    """The same causal GQA sweep as the reference's kernel test; bf16 inputs
    are the bf16 roundings of the same float32 draws on both sides."""
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (2, S, n, hd)) for n in (H, KV, KV))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = ops.flash_attention(_port(q, td), _port(k, td), _port(v, td), causal=True)
    assert got.dtype == td
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for exp in (_ref_flash_interpret(jq, jk, jv, causal=True),
                ref_ref.flash_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("kwargs", [
    dict(causal=True, window=64),
    dict(causal=True, softcap=50.0),
    dict(causal=False),
    dict(causal=True, window=32, softcap=30.0),
    dict(causal=True, window=2**30),
])
def test_flash_attention_variants_parity(kwargs):
    rng = np.random.default_rng(1)
    q, k, v = _normal(rng, (1, 256, 4, 64)), _normal(rng, (1, 256, 2, 64)), _normal(rng, (1, 256, 2, 64))
    got = ops.flash_attention(_port(q), _port(k), _port(v), **kwargs).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(got, np.asarray(_ref_flash_interpret(jq, jk, jv, **kwargs)),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref_ref.flash_attention_ref(jq, jk, jv, **kwargs)),
                               atol=2e-5, rtol=2e-5)


def _ssd_inputs(rng, b, L, H, dh, G, ds):
    return (_normal(rng, (b, L, H, dh)), rng.uniform(0.01, 0.2, (b, L, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (H,)).astype(np.float32), _normal(rng, (b, L, G, ds)),
            _normal(rng, (b, L, G, ds)), _normal(rng, (H,)))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("H,dh,G,ds", [(4, 32, 2, 16), (2, 64, 1, 32)])
def test_ssd_scan_parity(chunk, H, dh, G, ds):
    """y against the reference's interpret-mode kernel and its jnp version;
    the final state, which the TPU kernel does not return, against the
    reference model's chunked scan."""
    rng = np.random.default_rng(2)
    arrs = _ssd_inputs(rng, 2, 128, H, dh, G, ds)
    y, state = ops.ssd_scan(*map(_port, arrs), chunk=chunk)
    y = y.numpy()
    jarrs = [jnp.asarray(a) for a in arrs]
    for exp in (_ref_ssd_interpret(*jarrs, chunk=chunk), ref_ref.ssd_scan_ref(*jarrs, chunk=chunk)):
        exp = np.asarray(exp)
        scale = float(np.abs(exp).max()) + 1e-6
        np.testing.assert_allclose(y / scale, exp / scale, atol=3e-5)
    x, dt, A, B, C, _ = jarrs
    _, exp_state = ref_model_ssd(x, dt, A, B, C, chunk)
    exp_state = np.asarray(exp_state)
    scale = float(np.abs(exp_state).max()) + 1e-6
    np.testing.assert_allclose(state.numpy() / scale, exp_state / scale, atol=3e-5)


def test_ssd_scan_ragged_length_equals_padded():
    """L need not be a multiple of the chunk: the result equals the
    reference's kernel on the zero-padded sequence, cut back to L."""
    rng = np.random.default_rng(5)
    L, chunk = 100, 32
    arrs = _ssd_inputs(rng, 1, L, 4, 32, 2, 16)
    y, _ = ops.ssd_scan(*map(_port, arrs), chunk=chunk)
    pad = [np.pad(a, [(0, 0), (0, 28)] + [(0, 0)] * (a.ndim - 2)) if a.ndim > 1 else a
           for a in arrs]
    exp = np.asarray(_ref_ssd_interpret(*map(jnp.asarray, pad), chunk=chunk))[:, :L]
    scale = float(np.abs(exp).max())
    np.testing.assert_allclose(y.numpy() / scale, exp / scale, atol=3e-5)


# -- the card kernels' arithmetic, rehearsed in plain torch ---------------------------

_LOG2E = 1.4426950408889634


def _flash_bf16_emulated(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    """The bf16 tensor-core kernel's arithmetic: bf16 Q, K, V; float32 scores
    and an online softmax in base 2 over K/V tiles (128 keys, 64 at hd 256);
    P rounded to bf16 for the PV product, the row sums from the float32 P;
    the output divided in float32 and rounded to bf16."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    bk = 64 if hd == 256 else 128
    scale = hd ** -0.5 if scale is None else scale
    qf = q.float().permute(0, 2, 1, 3)                                  # (B, H, S, hd)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
    m = torch.full((B, H, S), -torch.inf)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        keys = torch.arange(k0, min(k0 + bk, S))[None, :]
        x = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = x * _LOG2E
        mask = torch.ones((S, keys.shape[1]), dtype=torch.bool)
        if causal:
            mask &= keys <= rows
        if window is not None:
            mask &= keys > rows - window
        x = torch.where(mask, x, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,KV,hd,kwargs", [
    (2, 256, 4, 2, 64, dict(causal=True)),                           # GQA
    (1, 256, 4, 2, 64, dict(causal=True, window=32, softcap=30.0)),  # window + softcap
    (1, 256, 2, 1, 128, dict(causal=False)),                         # non-causal
    (1, 200, 4, 2, 64, dict(causal=True)),                           # ragged S
    (1, 128, 2, 1, 256, dict(causal=True, window=50, softcap=50.0)),
])
def test_flash_bf16_kernel_arithmetic_meets_reference(B, S, H, KV, hd, kwargs):
    """Rounding P to bf16 before the PV product (the bf16 card kernel's
    arithmetic, as the reference model rounds it) stays within the bf16
    tolerance, 2e-2, of the reference's dense version and, where S is a
    multiple of its 128-row blocks, of its interpret-mode kernel."""
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, (B, S, n, hd)) for n in (H, KV, KV))
    got = _flash_bf16_emulated(*(_port(a, torch.bfloat16) for a in (q, k, v)), **kwargs)
    got = got.float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    exps = [ref_ref.flash_attention_ref(jq, jk, jv, **kwargs)]
    if S % 128 == 0:
        exps.append(_ref_flash_interpret(jq, jk, jv, **kwargs))
    for exp in exps:
        np.testing.assert_allclose(got, np.asarray(exp, np.float32), atol=2e-2, rtol=2e-2)


def _tf32(x):
    """Round to TF32 as the kernel does: clear the 13 low mantissa bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """a . b as three TF32 products, lo * hi + hi * lo + hi * hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _ssd_3xtf32_emulated(x, dt, A, B, C, D, chunk):
    """The card kernel's three passes with 3xTF32 products: per-chunk states,
    the state-passing recurrence, per-chunk outputs. Steps past L are dt = 0,
    x = B = C = 0."""
    b, L, H, dh = x.shape
    G, ds = B.shape[2], B.shape[3]
    pad = -L % chunk

    def padded(t):
        return torch.nn.functional.pad(t, [0, 0] * (t.ndim - 2) + [0, pad]) if pad else t

    nc = (L + pad) // chunk
    xc = padded(x).reshape(b, nc, chunk, H, dh)
    dtc = padded(dt).reshape(b, nc, chunk, H)
    Bc = padded(B).reshape(b, nc, chunk, G, ds).repeat_interleave(H // G, dim=3)
    Cc = padded(C).reshape(b, nc, chunk, G, ds).repeat_interleave(H // G, dim=3)
    acum = torch.cumsum(A * dtc, dim=2)                                    # (b, nc, Q, H)
    # 1. each chunk's own state
    w = dtc * torch.exp(acum[:, :, -1:] - acum)
    own = _einsum_3xtf32("bnqhp,bnqhs->bnhps", xc * w[..., None], Bc)
    # 2. the state entering each chunk
    decay = torch.exp(acum[:, :, -1])                                      # (b, nc, H)
    run = torch.zeros((b, H, dh, ds))
    entering = []
    for n in range(nc):
        entering.append(run)
        run = decay[:, n, :, None, None] * run + own[:, n]
    entering = torch.stack(entering, dim=1)
    # 3. outputs
    y = _einsum_3xtf32("bnqhs,bnhps->bnqhp", Cc, entering) * torch.exp(acum)[..., None]
    a_t = acum.permute(0, 1, 3, 2)                                         # (b, nc, H, Q)
    below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = torch.where(below, a_t[..., :, None] - a_t[..., None, :], 0.0)
    scores = _einsum_3xtf32("bnqhs,bnths->bnhqt", Cc, Bc) * torch.where(below, torch.exp(diff), 0.0)
    y = y + _einsum_3xtf32("bnhqt,bnthp->bnqhp", scores, xc * dtc[..., None])
    y = y.reshape(b, L + pad, H, dh)[:, :L] + x * D[None, None, :, None]
    return y, run


@pytest.mark.parametrize("L,chunk,H,dh,G,ds", [
    (128, 32, 4, 32, 2, 16),
    (250, 100, 4, 32, 2, 32),   # ragged L, chunk 100
    (300, 64, 2, 64, 1, 64),    # ragged L
])
def test_ssd_3xtf32_arithmetic_meets_reference(L, chunk, H, dh, G, ds):
    """3xTF32 products inside the three-pass decomposition (the card
    kernel's arithmetic) stay within 3e-5 of scale of the reference's
    interpret-mode kernel and its jnp version on the zero-padded sequence,
    and of its model's final state."""
    rng = np.random.default_rng(9)
    arrs = _ssd_inputs(rng, 2, L, H, dh, G, ds)
    y, state = _ssd_3xtf32_emulated(*map(_port, arrs), chunk)
    pad = -L % chunk
    jarrs = [jnp.asarray(np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
                         if a.ndim > 1 else a) for a in arrs]
    for exp in (_ref_ssd_interpret(*jarrs, chunk=chunk), ref_ref.ssd_scan_ref(*jarrs, chunk=chunk)):
        exp = np.asarray(exp)[:, :L]
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(y.numpy() / scale, exp / scale, atol=3e-5)
    x, dt, A, B, C, _ = jarrs
    _, exp_state = ref_model_ssd(x, dt, A, B, C, chunk)
    exp_state = np.asarray(exp_state)
    scale = float(np.abs(exp_state).max())
    np.testing.assert_allclose(state.numpy() / scale, exp_state / scale, atol=3e-5)


def test_model_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, force="cuda")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(torch.zeros((1, 4, 3, 64)), q, q)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=0)
    x, dt, A, B = torch.zeros((1, 4, 2, 32)), torch.zeros((1, 4, 2)), torch.zeros(2), torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, B, B, A, chunk=4)
    with pytest.raises(ValueError, match="dt"):
        ops.ssd_scan(x, dt[..., :1], A, B, B, A, chunk=4)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, B, B, A, chunk=0)
