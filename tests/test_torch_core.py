"""The port's core layer against the reference, worker by worker.

The port holds all P workers in one batched ``Table`` of (P, capacity)
columns; the reference runs one ``Table`` per device. Each test builds both
from the same numpy data (from a seed) and requires, for every worker, the
reference's answer bit for bit: whole columns for the table helpers and the
shuffle buffers, live rows, ``nvalid`` and overflow counters for the
shuffles and the local operators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as ref_cost_model
from repro.core import dataframe as ref_df
from repro.core import local_ops as ref_local
from repro.core import partition as ref_partition
from repro.core import patterns as ref_patterns
from repro.core.comm.communicator import FabricProfile as RefFabric
from repro_torch.core import cost_model, dataframe, local_ops, partition, patterns
from repro_torch.core.comm import collectives
from repro_torch.core.comm.communicator import FabricProfile
from repro_torch.core.dataframe import Table


CAP = 24  # one capacity throughout, so the reference compiles each op once


def _data(P, cap, seed, key_range=None, with_float=True):
    rng = np.random.default_rng(seed)
    key_range = key_range or max(cap // 2, 1)
    cols = {
        "k": rng.integers(0, key_range, size=(P, cap)).astype(np.int32),
        "v": rng.integers(-2**31, 2**31, size=(P, cap), dtype=np.int64).astype(np.int32),
    }
    if with_float:
        cols["f"] = rng.integers(-50, 50, size=(P, cap)).astype(np.float32)
    nvalid = rng.integers(0, cap + 1, size=P).astype(np.int32)
    nvalid[0] = cap
    return cols, nvalid


def _port(cols, nvalid):
    return Table({k: torch.from_numpy(v.copy()) for k, v in cols.items()},
                 torch.from_numpy(nvalid.copy()))


def _refs(cols, nvalid):
    return [ref_df.Table({k: jnp.asarray(v[w]) for k, v in cols.items()},
                         jnp.asarray(nvalid[w], jnp.int32)) for w in range(len(nvalid))]


def _same_live(port: Table, refs, what, full=False):
    assert set(port.columns) == set(refs[0].columns), what
    nv = port.nvalid.numpy()
    assert port.nvalid.dtype == torch.int32
    for w, r in enumerate(refs):
        assert nv[w] == int(r.nvalid), (what, w)
        n = port.capacity if full else nv[w]
        for k, v in port.columns.items():
            got, exp = v[w].numpy()[:n], np.asarray(r.columns[k])[:n]
            assert got.dtype == exp.dtype, (what, k)
            np.testing.assert_array_equal(got, exp, err_msg=f"{what} worker {w} col {k}")


# -- dataframe -------------------------------------------------------------------

def test_canonical_dtypes_follow_jax_without_x64():
    v = np.array([2**40 + 5, -1, 2**31], np.int64)
    np.testing.assert_array_equal(dataframe.canonical_numpy(v), np.asarray(jnp.asarray(v)))
    u = np.array([2**63 + 7, 5], np.uint64)
    np.testing.assert_array_equal(dataframe.canonical_numpy(u), np.asarray(jnp.asarray(u)))
    f = np.array([1.1, 1e300], np.float64)
    np.testing.assert_array_equal(dataframe.canonical_numpy(f), np.asarray(jnp.asarray(f)))
    for dt in (np.int32, np.float32, np.bool_, np.int16):
        assert dataframe.canonical_dtype(dt) == np.dtype(dt)


@pytest.mark.parametrize("cap_out", [None, 5, 40])
@pytest.mark.parametrize("P", [1, 3])
def test_compact_matches_reference(P, cap_out):
    cols, nvalid = _data(P, CAP, seed=P)
    keep = np.random.default_rng(1).random((P, CAP)) < 0.6
    got = dataframe.compact(_port(cols, nvalid), torch.from_numpy(keep), capacity=cap_out)
    exp = [ref_df.compact(r, jnp.asarray(keep[w]), capacity=cap_out)
           for w, r in enumerate(_refs(cols, nvalid))]
    _same_live(got, exp, "compact", full=True)


@pytest.mark.parametrize("cap_out", [None, 9])
def test_concat_and_head_match_reference(cap_out):
    a, na = _data(3, CAP, seed=4)
    b, nb = _data(3, CAP, seed=5)
    got = dataframe.concat(_port(a, na), _port(b, nb), capacity=cap_out)
    exp = [ref_df.concat(x, y, capacity=cap_out) for x, y in zip(_refs(a, na), _refs(b, nb))]
    _same_live(got, exp, "concat", full=True)
    _same_live(dataframe.head(_port(a, na), 4), [ref_df.head(r, 4) for r in _refs(a, na)],
               "head", full=True)


def test_sentinels_match_reference():
    for t, j in ((torch.int32, jnp.int32), (torch.float32, jnp.float32),
                 (torch.int16, jnp.int16)):
        assert dataframe.max_sentinel(t) == ref_df.max_sentinel(j).item()
        assert dataframe.min_sentinel(t) == ref_df.min_sentinel(j).item()


# -- partition -------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 3, 8])
def test_hash_columns_and_destinations_match_reference(P):
    cols, nvalid = _data(P, CAP, seed=P + 10)
    cols["b"] = (cols["v"] % 2 == 0)
    t = _port(cols, nvalid)
    keys = ["k", "f", "b"]
    h = partition.hash_columns(t, keys)
    dest = partition.hash_partition_ids(t, keys, P)
    assert dest.dtype == torch.int32 and h.dtype == torch.int64
    for w, r in enumerate(_refs(cols, nvalid)):
        np.testing.assert_array_equal(h[w].numpy(), np.asarray(ref_partition.hash_columns(r, keys)))
        np.testing.assert_array_equal(dest[w].numpy(),
                                      np.asarray(ref_partition.hash_partition_ids(r, keys, P)))


@pytest.mark.parametrize("quota", [3, 16])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_build_shuffle_buffers_match_reference(P, quota):
    cols, nvalid = _data(P, CAP, seed=P * 7 + quota)
    t = _port(cols, nvalid)
    dest = partition.hash_partition_ids(t, ["k"], P)
    bufs = partition.build_shuffle_buffers(t, dest, P, quota)
    for w, r in enumerate(_refs(cols, nvalid)):
        rb = ref_partition.build_shuffle_buffers(
            r, ref_partition.hash_partition_ids(r, ["k"], P), P, quota)
        np.testing.assert_array_equal(bufs.counts[w].numpy(), np.asarray(rb.counts))
        assert int(bufs.overflow[w]) == int(rb.overflow)
        for k in cols:
            np.testing.assert_array_equal(bufs.columns[k][w].numpy(), np.asarray(rb.columns[k]))


def _all_to_all_model(cols, nvalid, P, quota):
    """Per destination: the live rows the reference's per-worker buffers
    send it, source-major and in buffer order."""
    rbs = [ref_partition.build_shuffle_buffers(
        r, ref_partition.hash_partition_ids(r, ["k"], P), P, quota)
        for r in _refs(cols, nvalid)]
    out = []
    for d in range(P):
        out.append({k: np.concatenate([np.asarray(rb.columns[k][d])[: int(rb.counts[d])]
                                       for rb in rbs]) for k in cols})
    return out, [int(rb.overflow) for rb in rbs]


@pytest.mark.parametrize("quota", [4, 20])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_shuffles_match_all_to_all_model(P, quota):
    cols, nvalid = _data(P, CAP, seed=P * 3 + quota)
    t = _port(cols, nvalid)
    dest = partition.hash_partition_ids(t, ["k"], P)
    expected, ov = _all_to_all_model(cols, nvalid, P, quota)
    results = [collectives.shuffle_table(t, dest, quota)]
    results += [collectives.shuffle_table_pipelined(t, dest, quota, K) for K in (1, 3)]
    for out, overflow in results:
        assert out.capacity == P * quota
        assert overflow.tolist() == ov
        for d in range(P):
            n = int(out.nvalid[d])
            for k in cols:
                np.testing.assert_array_equal(out.columns[k][d].numpy()[:n], expected[d][k])


def test_shuffle_capacity_clips_like_reference():
    cols, nvalid = _data(3, CAP, seed=2)
    t = _port(cols, nvalid)
    dest = partition.hash_partition_ids(t, ["k"], 3)
    a, _ = collectives.shuffle_table(t, dest, 20, capacity=12)
    b, _ = collectives.shuffle_table_pipelined(t, dest, 20, 3, capacity=12)
    assert a.capacity == b.capacity == 12
    assert torch.equal(a.nvalid, b.nvalid)
    for d in range(3):
        n = int(a.nvalid[d])
        assert torch.equal(a.columns["v"][d, :n], b.columns["v"][d, :n])


def test_allgather_gives_every_worker_all_rows():
    cols, nvalid = _data(3, CAP, seed=8)
    out = collectives.allgather_table(_port(cols, nvalid))
    live = np.concatenate([cols["v"][w, : nvalid[w]] for w in range(3)])
    for w in range(3):
        assert int(out.nvalid[w]) == len(live)
        np.testing.assert_array_equal(out.columns["v"][w].numpy()[: len(live)], live)


# -- local operators ---------------------------------------------------------------

@pytest.mark.parametrize("capacity", [10, 80])
@pytest.mark.parametrize("P", [1, 3])
def test_local_join_matches_reference(P, capacity):
    lc, ln = _data(P, CAP, seed=P, key_range=8)
    rc, rn = _data(P, CAP, seed=P + 50, key_range=8)
    rc = {"k": rc["k"], "w": rc["v"], "f": rc["f"]}
    got, ov = local_ops.local_join(_port(lc, ln), _port(rc, rn), ["k"], capacity)
    assert ov.dtype == torch.int32
    exp = []
    for w, (lt, rt) in enumerate(zip(_refs(lc, ln), _refs(rc, rn))):
        e, eov = ref_local.local_join(lt, rt, ["k"], capacity)
        assert int(ov[w]) == int(eov)
        exp.append(e)
    _same_live(got, exp, "local_join")


def test_local_join_two_keys_matches_reference():
    lc, ln = _data(3, CAP, seed=3, key_range=4)
    lc["k2"] = lc["v"] % 3
    rc = {"k": lc["k"][:, ::-1].copy(), "k2": lc["k2"][:, ::-1].copy(), "w": lc["v"]}
    got, _ = local_ops.local_join(_port(lc, ln), _port(rc, ln), ["k", "k2"], 100)
    exp = [ref_local.local_join(lt, rt, ["k", "k2"], 100)[0]
           for lt, rt in zip(_refs(lc, ln), _refs(rc, ln))]
    _same_live(got, exp, "local_join 2 keys")


AGGS = {"v": ("sum", "min", "max", "count", "mean"), "f": ("sum", "min", "max")}


@pytest.mark.parametrize("capacity", [None, 3])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_local_groupby_both_legs_match_reference(P, capacity):
    cols, nvalid = _data(P, CAP, seed=P + 20, key_range=9)
    got, ov = local_ops.local_groupby(_port(cols, nvalid), ["k"], AGGS, capacity=capacity,
                                      with_overflow=True)
    merged, mov = local_ops.local_groupby(got, ["k"], AGGS, merge=True, with_overflow=True)
    exp, exp_m = [], []
    for w, r in enumerate(_refs(cols, nvalid)):
        e, eov = ref_local.local_groupby(r, ["k"], AGGS, capacity=capacity, with_overflow=True)
        m, emov = ref_local.local_groupby(e, ["k"], AGGS, merge=True, with_overflow=True)
        assert int(ov[w]) == int(eov) and int(mov[w]) == int(emov)
        exp.append(e)
        exp_m.append(m)
    _same_live(got, exp, "groupby combine")
    _same_live(merged, exp_m, "groupby merge")
    _same_live(local_ops.finalize_groupby(merged, AGGS),
               [ref_local.finalize_groupby(m, AGGS) for m in exp_m], "finalize")


@pytest.mark.parametrize("capacity", [None, 4])
@pytest.mark.parametrize("P", [1, 3, 8])
def test_local_unique_matches_reference(P, capacity):
    cols, nvalid = _data(P, CAP, seed=P + 30, key_range=7)
    cols["k2"] = (cols["v"] % 2).astype(np.int32)
    got, ov = local_ops.local_unique(_port(cols, nvalid), ["k", "k2"], capacity=capacity,
                                     with_overflow=True)
    exp = []
    for w, r in enumerate(_refs(cols, nvalid)):
        e, eov = ref_local.local_unique(r, ["k", "k2"], capacity=capacity, with_overflow=True)
        assert int(ov[w]) == int(eov)
        exp.append(e)
    _same_live(got, exp, "local_unique")


def test_agg_schema_rejects_unknown_ops():
    assert local_ops.agg_schema({"v": ("sum",)}) == ref_local.agg_schema({"v": ("sum",)})
    with pytest.raises(ValueError):
        local_ops.agg_schema({"v": ("median",)})


# -- planner -----------------------------------------------------------------------

def test_segment_ids_past_int32_raise():
    vals = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        local_ops._seg_reduce_dispatch(vals, torch.zeros((2, 1), dtype=torch.int32),
                                       2**30, "sum")


def test_quota_helpers_match_reference():
    hist = np.array([3, 90, 12, 0])
    assert patterns.quota_from_histogram(hist, 200, 4) == ref_patterns.quota_from_histogram(hist, 200, 4)
    assert patterns.quota_from_histogram(np.zeros(4), 200, 4) == \
        ref_patterns.quota_from_histogram(np.zeros(4), 200, 4)
    sample = np.random.default_rng(0).integers(0, 4, 50)
    assert patterns.sampled_quota(sample, 300, 4, 0.25) == ref_patterns.sampled_quota(sample, 300, 4, 0.25)
    assert patterns.sampled_cardinality(sample) == ref_patterns.sampled_cardinality(sample)
    for cap, P in ((1000, 8), (7, 3), (1, 1)):
        assert partition.default_quota(cap, P) == ref_partition.default_quota(cap, P)


@pytest.mark.parametrize("n_bytes", [1e3, 1e6, 1e9])
def test_cost_formulas_match_reference_on_equal_fabrics(n_bytes):
    p = cost_model.CostParams(fabric=FabricProfile("f", 1e-6, 1 / 50e9))
    rp = ref_cost_model.CostParams(fabric=RefFabric("f", 1e-6, 1 / 50e9))
    for alg in ("isend-irecv", "ring", "pairwise", "bruck"):
        assert cost_model.t_shuffle(8, n_bytes, p, alg) == ref_cost_model.t_shuffle(8, n_bytes, rp, alg)
    assert cost_model.choose_join_strategy(1e5, n_bytes, 8, 16.0, p) == \
        ref_cost_model.choose_join_strategy(1e5, n_bytes, 8, 16.0, rp)
    # the port always plans the monolithic shuffle (one card overlaps no
    # compute), so only the pattern and the sizes are held to the reference
    pj = patterns.plan_join(10**5, int(n_bytes), 8, 20000, params=p)
    rj = ref_patterns.plan_join(10**5, int(n_bytes), 8, 20000, params=rp)
    assert (pj.strategy, pj.quota, pj.capacity) == (rj.strategy, rj.quota, rj.capacity)
    assert not hasattr(pj, "num_chunks")
    pg = patterns.plan_groupby(0.1, 8, 20000)
    rg = ref_patterns.plan_groupby(0.1, 8, 20000, n_rows=int(n_bytes), params=rp)
    assert (pg.strategy, pg.quota, pg.capacity) == (rg.strategy, rg.quota, rg.capacity)
