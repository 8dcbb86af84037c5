"""The port's dataframe kernels against the reference's.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; they
are held bit for bit against the reference's Pallas kernels run in
interpret mode and against its plain jnp versions (``kernels/ref.py``):

- hash destinations and histograms for int32, uint32 (near 2**32 - 1),
  float32 and bool keys, 1-3 key columns, N in {1, 1023, 1025, 3000};
- segment sums, mins and maxes in int32, uint32 and integer-valued float32
  (exact in any summation order), with uneven runs, int32 wrap-around and
  empty segments, which hold the identity (0 or the min/max sentinel).

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
from repro_torch.kernels.hash_partition import hash_partition_cuda
from repro_torch.kernels.segment_reduce import segment_reduce_cuda


# the reference's interpret-mode kernels, jitted so that each shape is
# interpreted once
_ref_hash_interpret = jax.jit(functools.partial(ref_ops.hash_partition, force="interpret"),
                              static_argnames=("num_partitions",))
_ref_segment_interpret = jax.jit(functools.partial(ref_ops.segment_reduce, force="interpret"),
                                 static_argnames=("num_segments", "op"))


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


def _ref_segment(values, seg, nseg, op):
    return np.asarray(_ref_segment_interpret(jnp.asarray(values), jnp.asarray(seg),
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
    with pytest.raises(ValueError):
        registry.resolve("flash_attention", x)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.int16, torch.float16])
def test_segment_kernel_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="ROADMAP queue A"):
        segment_reduce_cuda(torch.zeros((4, 1), dtype=dtype),
                            torch.zeros(4, dtype=torch.int32), 1)


def test_plain_versions_count_no_launches():
    registry.reset_launch_counts()
    ops.hash_partition(torch.arange(10, dtype=torch.int32), 3)
    ops.segment_reduce(torch.ones((4, 1), dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), 1)
    assert registry.launch_counts() == {"hash_partition": 0, "segment_reduce": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        hash_partition_cuda(torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_reduce_cuda(torch.zeros((4, 1), dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        ops.hash_partition(torch.zeros(4, dtype=torch.int32), 2, force="cuda")
