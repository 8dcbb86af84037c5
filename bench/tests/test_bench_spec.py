"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
imports: every name and unit well formed, every configuration, traffic mix
and per-layer metric found by its name, nothing under ``bench/`` importing
JAX or the JAX package (``repro``, compared as a whole top-level name),
the reference importing nothing of the program, and nothing reading the
JAX package's ``benchmarks/`` or the smoke script."""

import ast
import json
import os

import pytest
from conftest import BENCH, ROOT

from benchlib import spec

B = spec.load(ROOT)
NAMES = ([c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
         + [m["name"] for m in B["end_to_end"] + B["per_layer"]]
         + [w["traffic"] for w in B["workloads"]] + [w["config"] for w in B["workloads"]]
         + [k for c in B["configs"] for k in c["reduced"]])


def _py_files(*parts):
    top = os.path.join(BENCH, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"] and B["paths"] == ["bench"]
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("name", NAMES)
def test_names(name):
    assert spec.NAME.fullmatch(name), name


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(m):
    assert spec.UNIT.fullmatch(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source"}
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) - {"workloads"} == keys | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) - {"workloads"} == keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        assert os.path.isfile(spec.metric_path(m["name"]))
        assert callable(spec.metric_reader(m["name"]))
    for w in m.get("workloads", ()):
        assert w in {c["name"] for c in B["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in B["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(B, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(B, w["name"])
        for m in spec.per_layer(B, w["name"]):
            assert m["moves"] in e2e


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(w):
    assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert w["config"] in {c["name"] for c in B["configs"]}
    tr = spec.traffic(w["traffic"])
    assert callable(spec.module("pipelines", tr["pipeline"]).Pipeline)
    assert callable(spec.module("drivers", tr["driver"]).window)
    cfg = spec.config(B, ROOT, w["config"])
    assert callable(spec.module("generators", cfg["generator"]).tables)
    assert cfg["rows_per_worker"] > 0 and cfg["workers"] > 0


@pytest.mark.parametrize("kind", ["pipelines", "drivers", "generators", "metrics"])
def test_a_new_file_is_found_by_its_name(kind, tmp_path, monkeypatch):
    """A later change adds a pipeline, a driver, a generator or a metric as
    a file: the harness finds it by name with no edit to a file here."""
    (tmp_path / kind).mkdir()
    (tmp_path / kind / "added-1.py").write_text("def read(obs):\n    return 7.0\n")
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    assert spec.module(kind, "added-1").read(None) == 7.0
    with pytest.raises(FileNotFoundError):
        spec.module(kind, "not-there")


def test_every_per_layer_metric_lists_its_cells():
    for m in B["per_layer"]:
        assert m["workloads"], m["name"]


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    for k in c["reduced"]:  # each cut names the published value and why
        assert k in cfg["published"] and k in cfg["reduced_why"]
    assert len(c["reduced"]) <= 16 and 1 <= len(c["source"]) <= 200


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_pair_of_config_and_traffic_appears_once():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}, path


@pytest.mark.parametrize("path", sorted(_py_files("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & {"repro_torch", "benchlib"}, path


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, BENCH))
def test_nothing_reads_the_jax_benchmarks_or_the_smoke_script(path):
    if os.path.basename(path) == "test_bench_spec.py":
        return
    src = open(path).read()
    assert "benchmarks/" not in src and "chip_smoke" not in src, path
    assert "chip_smoke" not in set(_imports(path)) and "benchmarks" not in set(_imports(path))
