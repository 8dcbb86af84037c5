"""``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

Runs one cell once on the card and prints its result as the last line of
standard output (one JSON object), with every number compared against the
reference beside its limit as the last lines of standard error. Refuses to
run without a CUDA device (exit 3), and prints no result when JAX or the
JAX package was loaded (exit 4). The program keeps its one build cache,
the kernel library, inside the checkout (``src/repro_torch/_build``), and
the harness its Triton cache (``.bench_cache/triton``), so only a cell's
first run in a checkout builds them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _args(argv):
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float, root: str) -> int:
    args = _args(argv)
    import torch

    from . import cell, spec

    chips = spec.workload(spec.load(root), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(root, "src"))
    cell.use_cache_dirs(root)
    res = cell.run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                        device="cuda", t0=t0)
    found = cell.forbidden_modules()
    if found:
        print(f"bench: the run loaded {found}; the benchmark measures the PyTorch port only",
              file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
