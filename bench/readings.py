"""The readings that the limits of ``correct`` are set from, in one process:
the program's numbers compared on many seeds (the lower readings) and the
reference's control in the program's place on a few (the upper readings),
each run at the cell's own size with a short window.

    python3 bench/readings.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 --seconds 2 [--out readings.json]
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    sys.path.insert(0, BENCH)
    import torch

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from benchlib import cell

    cell.use_cache_dirs(ROOT)
    rows = []
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            res = cell.run_cell(ROOT, a.workload, seed, a.seconds, False, device="cuda",
                                control=kind == "control")
            rows.append({"kind": kind, "seed": seed, "correct": res["correct"],
                         "attempted": res["attempted"],
                         "checks": {k: c["value"] for k, c in res["checks"].items()},
                         "seconds": time.perf_counter() - t})
            print(json.dumps(rows[-1]), flush=True)
    out = {"workload": a.workload, "device": torch.cuda.get_device_name(0), "rows": rows}
    for kind in ("program", "control"):
        got = [r["checks"] for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        out[kind] = {k: pick(g[k] for g in got) for k in got[0]} if got else {}
    print(json.dumps({"lower": out["program"], "upper": out["control"]}), flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
