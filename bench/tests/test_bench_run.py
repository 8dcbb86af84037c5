"""Every cell driven end to end on the CPU at a size a test run holds: the
program's runs come out correct, the reference's control and each planted
fault come out not correct, and the traced run reads its per-layer
metrics."""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT
from faults import FAULTS

from benchlib import cell, spec

CELLS = [w["name"] for w in spec.load(ROOT)["workloads"]]
SMALL = {"rows_per_worker": 20_000}  # the CPU's size; the card runs the configuration's
SEED = 2**31 + 17  # past 32 signed bits, as large seeds are


def _run(name, **kw):
    kw.setdefault("overrides", SMALL)
    return cell.run_cell(ROOT, name, kw.pop("seed", SEED), kw.pop("seconds", 0.3),
                         kw.pop("traced", False), device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in spec.end_to_end(spec.load(ROOT), name)}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"  # the numbers compared come last


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = _run(name, overrides={"rows_per_worker": 125_000}, control=True)
    assert not res["correct"]
    off = {k: c["value"] for k, c in res["checks"].items() if c["value"] > c["limit"]}
    assert off and "iterations_off" in off, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res = _run(name, patch=FAULTS[fault])
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(name):
    res = _run(name, traced=True)
    assert res["correct"]
    got = set(res["metrics"])
    ops = {m["name"] for m in spec.per_layer(spec.load(ROOT), name)
           if m["name"].startswith("op_ms.")}
    assert ops and ops <= got  # the CPU has no device trace: no roofline, idle share 100%
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_unique_is_held_to_its_own_answer(monkeypatch):
    """A unique that hands back its input fails the unique's own number,
    with the join and groupby left sound."""
    from repro_torch.core import DDF

    monkeypatch.setattr(DDF, "unique", lambda self, *a, **k: (self, {}))
    res = _run("uniform.join-groupby-unique")
    off = {k: c["value"] for k, c in res["checks"].items() if c["value"]}
    assert set(off) == {"iterations_off", "unique_off"}, res["checks"]


def test_a_failed_iteration_is_not_correct(monkeypatch):
    """The warm-up passes and the window's first iteration raises: the run
    reports the failure, and is not correct."""
    from repro_torch.core import DDF

    calls = []
    sort = DDF.sort_values

    def flaky(self, *a, **k):
        calls.append(1)
        if len(calls) > 2:  # the sort cell warms up twice
            raise RuntimeError("out of memory")
        return sort(self, *a, **k)

    monkeypatch.setattr(DDF, "sort_values", flaky)
    res = _run("uniform.sort")
    assert not res["correct"] and res["failed"] == 1 and res["attempted"] == 1
    assert res["checks"]["answer_missing"]["value"] == 1 and "out of memory" in res["error"]


def test_untraced_run_times_no_span():
    res = _run(CELLS[0])
    assert "spans_ms" not in res and "busy_s" not in res["device"]
    traced = _run(CELLS[0], traced=True)
    assert {"join", "groupby", "unique", "digest"} <= set(traced["spans_ms"])


def test_same_seed_same_answer_digests():
    a = _run(CELLS[0], seconds=0.0)
    b = _run(CELLS[0], seconds=0.0)
    assert a["checks"] == b["checks"]


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert cell.forbidden_modules() == ["repro"]


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload", "uniform.sort",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert res["launches"] == {"hash_partition": 0, "segment_reduce": 0}
