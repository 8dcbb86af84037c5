"""The frozen pieces of the yardstick: the reference against brute-force
loops at tiny sizes, the tables' generator, the digests and the kernels'
byte formulas."""

import random

import pytest
import torch

import reference as ref
from benchlib import roofline, spec

INT32_MAX = 2**31 - 1


def _wrap(x):
    return (x + 2**31) % 2**32 - 2**31


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _brute_join_groupby(lk, lv, rk, keep=None, flag=None):
    """The join's rows one by one (the left rows with ``c1 < keep``), then
    the groupby's aggregates (and the count of left values below
    ``flag``)."""
    rows = [(k, v) for k, v in zip(lk, lv) if keep is None or v < keep
            for r in rk if r == k]
    out = {}
    for k, v in rows:
        g = out.setdefault(k, {"sum": 0, "min": INT32_MAX, "max": -(2**31), "count": 0,
                               "flag": 0})
        g["flag"] += int(flag is not None and v < flag)
        g["sum"] += v
        g["min"], g["max"] = min(g["min"], v), max(g["max"], v)
        g["count"] += 1
    return rows, dict(sorted(out.items()))


def _tiny(seed, n=300, keys=40, hi=INT32_MAX):
    r = random.Random(seed)
    return ([r.randrange(keys) for _ in range(n)], [r.randrange(hi) for _ in range(n)],
            [r.randrange(keys) for _ in range(n)])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_join_groupby_equals_brute_force(seed):
    lk, lv, rk = _tiny(seed)
    rows, want = _brute_join_groupby(lk, lv, rk)
    t = [torch.tensor(x, dtype=torch.int32) for x in (lk, lv, rk)]
    got = ref.join_groupby(*t)
    assert got["join_rows"] == len(rows)
    assert got["c0"].tolist() == list(want)
    for k, g in zip(got["c0"].tolist(), range(len(want))):
        w = want[k]
        s = _wrap(w["sum"])
        assert got["c1_sum"][g] == s and got["c1_count"][g] == w["count"]
        assert got["c1_min"][g] == w["min"] and got["c1_max"][g] == w["max"]
        assert got["c1_mean"][g].view(torch.int32) == (_f32(s) / _f32(w["count"])).view(
            torch.int32)


@pytest.mark.parametrize("seed", [4, 5])
def test_readme_lazy_equals_brute_force(seed):
    lk, lv, rk = _tiny(seed)
    sel, flag = 2**30, 2**29
    _, want = _brute_join_groupby(lk, lv, rk, keep=sel, flag=flag)
    got = ref.readme_lazy(*[torch.tensor(x, dtype=torch.int32) for x in (lk, lv, rk)], sel, flag)
    assert got["c0"].tolist() == list(want)
    assert got["c1_sum"].tolist() == [_wrap(w["sum"]) for w in want.values()]
    assert got["c1_count"].tolist() == [w["count"] for w in want.values()]
    assert got["c1_min"].tolist() == [w["min"] for w in want.values()]
    assert got["c1_max"].tolist() == [w["max"] for w in want.values()]
    assert got["c2_sum"].tolist() == [w["flag"] for w in want.values()]


def test_sort_and_its_control():
    k, v, _ = _tiny(7, n=200_000)
    k, v = torch.tensor(k, dtype=torch.int32), torch.tensor(v, dtype=torch.int32)
    got = ref.sort_rows(k, v)
    assert got["c1"].tolist() == sorted(v.tolist())
    assert ref.seq_off(ref.sorted_pairs(got["c0"], got["c1"]), ref.sorted_pairs(k, v)) == 0
    ctl = ref.sort_rows(k, v, control=True)  # float32 keys tie where int32 ones do not
    assert ref.seq_off(ctl["c1"], got["c1"]) > 0
    assert ref.seq_off(ref.sorted_pairs(ctl["c0"], ctl["c1"]), ref.sorted_pairs(k, v)) == 0


def test_control_sums_differ():
    lk, lv, rk = _tiny(8, n=2000, keys=300)
    t = [torch.tensor(x, dtype=torch.int32) for x in (lk, lv, rk)]
    a, b = ref.join_groupby(*t), ref.join_groupby(*t, control=True)
    assert ref.rows_off({k: b[k] for k in a if k != "join_rows"},
                        {k: a[k] for k in a if k != "join_rows"}, "c0") > 0


def test_wrap32():
    x = torch.tensor([0, 2**31, 2**32 + 5, -1, 3 * 2**31], dtype=torch.int64)
    assert ref.dataframe.wrap32(x).tolist() == [_wrap(int(v)) for v in x]


def test_digests():
    g = torch.Generator().manual_seed(3)
    cols = {"a": torch.randint(0, 100, (1000,), generator=g, dtype=torch.int32),
            "b": torch.rand(1000, generator=g)}
    perm = torch.randperm(1000, generator=g)
    d = ref.row_digest(cols)
    assert d[0] == 1000 and torch.equal(d, ref.row_digest({k: v[perm] for k, v in cols.items()}))
    changed = dict(cols, a=cols["a"].clone())
    changed["a"][5] += 1
    assert not torch.equal(ref.row_digest(changed), d)
    swapped = dict(cols, b=cols["b"].clone())  # two rows trade a value
    swapped["b"][[0, 1]] = swapped["b"][[1, 0]]
    assert not torch.equal(ref.row_digest(swapped), d)
    assert ref.rows_off(cols, {k: v[cols["a"].argsort(stable=True)] for k, v in cols.items()},
                        "a") >= 0


def test_digests_of_padded_workers_equal_the_flat_columns():
    """Three workers' rows in padded buffers (the padding garbage, one
    worker empty) digest as the same rows flat, in any order."""
    g = torch.Generator().manual_seed(4)
    counts = torch.tensor([5, 0, 3])
    pad = {c: torch.randint(-2**31, 2**31 - 1, (3, 7), generator=g, dtype=torch.int32)
           for c in ("c0", "c1")}
    valid = torch.arange(7)[None, :] < counts[:, None]
    flat = {c: v[valid] for c, v in pad.items()}
    assert torch.equal(ref.row_digest(pad, counts), ref.row_digest(flat))
    ordered = torch.sort(flat["c1"]).values
    assert ref.order_violations(ordered).item() == 0
    assert ref.order_violations(flat["c1"][torch.randperm(8, generator=g)]).item() > 0
    pad["c1"][0, :5], pad["c1"][2, :3] = ordered[:5], ordered[5:]
    assert ref.order_violations(pad["c1"], counts).item() == 0
    pad["c1"][0, :5], pad["c1"][2, :3] = ordered[3:], ordered[:3]  # sorted within, not across
    assert ref.order_violations(pad["c1"], counts).item() == 1


def test_unique_rows_and_its_control():
    k = torch.tensor([5, 3, 5, 2**24 + 1, 2**24, 3], dtype=torch.int32)
    v = torch.tensor([10, 11, 12, 13, 14, 15], dtype=torch.int32)
    got = ref.unique_rows(k, v)
    assert got["c0"].tolist() == [3, 5, 2**24, 2**24 + 1]
    assert got["c1"].tolist() == [11, 10, 14, 13]
    table = ref.sorted_pairs(k, v)
    assert ref.rows_not_in(got, table) == 0
    assert ref.rows_not_in({"c0": got["c0"], "c1": got["c1"] + 1}, table) == 4
    ctl = ref.unique_rows(k, v, control=True)  # 2**24 + 1 rounds onto 2**24 in float32
    assert ctl["c0"].tolist() == [3, 5, 2**24]
    assert ref.rows_off({"c0": ctl["c0"]}, {"c0": got["c0"]}, "c0") > 0


def test_tables_repeat_for_a_seed_and_differ_across_seeds():
    cfg = {"rows_per_worker": 1000, "workers": 4, "cardinality": 0.9, "columns": 2}
    uniform = spec.module("generators", "uniform")
    a, b, c = (uniform.tables(cfg, s, "cpu") for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert list(a) == ["left", "right"]
    a, b, c = (tuple(t.values()) for t in (a, b, c))
    for x, y, z in zip(a, b, c):
        assert all(torch.equal(x[k], y[k]) for k in x)
        assert not torch.equal(x["c1"], z["c1"])
    left, right = a
    assert not torch.equal(left["c0"], right["c0"])
    assert left["c0"].shape == (4, 1000) and left["c0"].dtype == torch.int32
    assert 0 <= int(left["c0"].min()) and int(left["c0"].max()) < 3600
    assert int(left["c1"].max()) < INT32_MAX


def test_byte_formulas_give_the_kernel_tables_bounds():
    hp = roofline.least_ms(roofline.hash_partition_bytes(200_000_000, 1, 8, False))
    sr = roofline.least_ms(roofline.segment_reduce_bytes(400_000_512, 1, 400_000_512, 4))
    assert round(hp, 4) == 0.4776 and round(sr, 4) == 1.4328
    assert roofline.HBM_BYTES_PER_S == 3.35e12 and roofline.BF16_FLOPS_PER_S == 989e12


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [1, 2, 6, 7, 8, 9])
def test_fused_digests_equal_the_plain_ones(n_cols):
    """The Triton digests the card runs give the plain definitions' numbers:
    padded workers (one empty, one full, a capacity off the block size),
    float bits among the columns, and flat columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from conftest import ROOT

    from benchlib import cell, digest

    cell.use_cache_dirs(ROOT)
    g = torch.Generator(device="cuda").manual_seed(n_cols)
    P, cap = 5, 3 * digest.BLOCK + 77
    counts = torch.tensor([cap, 0, 17, cap - 1, 2 * digest.BLOCK], dtype=torch.int32,
                          device="cuda")
    cols = {f"c{i}": torch.randint(-2**31, 2**31 - 1, (P, cap), generator=g, device="cuda",
                                   dtype=torch.int32) for i in range(n_cols)}
    cols["c0"] = cols["c0"].view(torch.float32)
    assert torch.equal(digest.row_digest(cols, counts), ref.row_digest(cols, counts))
    flat = {k: v[1:].reshape(-1) for k, v in cols.items()}
    assert torch.equal(digest.row_digest(flat), ref.row_digest(flat))
    v = torch.sort(cols["c1" if n_cols > 1 else "c0"].view(torch.int32), dim=1).values
    v[3, 100:140] = 0  # a few out of order
    for c in (counts, None):
        assert torch.equal(digest.order_violations(v, c), ref.order_violations(v, c))
    assert torch.equal(digest.order_violations(v[1:].reshape(-1)),
                       ref.order_violations(v[1:].reshape(-1)))
