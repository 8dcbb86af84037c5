"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one kind
of load or one per-layer metric is a file of its own, found here by the
name the benchmark or a data file gives it:

- a configuration: the ``file`` of its ``configs`` entry (JSON), whose
  ``generator`` names ``bench/generators/<name>.py`` (``tables(cfg, seed,
  device)``: the named input tables);
- a traffic mix: ``bench/traffic/<traffic>.json``, whose ``pipeline``
  names ``bench/pipelines/<name>.py`` (a ``Pipeline`` class: the operations
  an iteration runs and their reference) and whose ``driver`` names
  ``bench/drivers/<name>.py`` (``window(...)``: how load is offered, and
  the end-to-end values it measures);
- a per-layer metric: ``bench/metrics/<name>.py``, a module with
  ``read(obs) -> float | None``.

So a later change adds a cell, a configuration, an operation mix, a key
distribution, a driver or a metric by adding files and entries, without
editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, root: str, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_path(name: str) -> str:
    return os.path.join(BENCH_DIR, "traffic", f"{name}.json")


def traffic(name: str) -> dict:
    with open(traffic_path(name)) as f:
        return json.load(f)


def module_path(kind: str, name: str) -> str:
    return os.path.join(BENCH_DIR, kind, f"{name}.py")


def module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module; its directory goes on the
    path, for the helpers its files share."""
    path = module_path(kind, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if os.path.dirname(path) not in sys.path:
        sys.path.insert(0, os.path.dirname(path))
    mod = importlib.util.module_from_spec(importlib.util.spec_from_file_location(mod_name, path))
    sys.modules[mod_name] = mod
    mod.__spec__.loader.exec_module(mod)
    return mod


def metric_path(name: str) -> str:
    return module_path("metrics", name)


def metric_reader(name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return module("metrics", name).read


def end_to_end(spec: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports (its ``--trace 0`` line):
    those without a ``workloads`` list, and those that list it."""
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", (cell,))]


def per_layer(spec: dict, cell: str) -> list[dict]:
    """The per-layer metrics the cell reports (its ``--trace 1`` line):
    those whose ``workloads`` list it. Every per-layer entry has the list."""
    return [m for m in spec["per_layer"] if cell in m["workloads"]]
