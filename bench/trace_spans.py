"""``python3 bench/trace_spans.py --workload <cell> --seed <n> --seconds <s>``

One ``--trace 1`` run of a cell, as ``bench/run.py --trace 1`` makes it,
with the program's own spans on around the window
(``repro_torch.obs.trace.tracing()``). Prints the result line with one key
more, ``spans``: the window's device time split by program span and by
layer (``benchlib.spans``), per iteration (``dev_ms.*``), the shuffles'
fill, ``plan.build``'s host time, the share of the busy time outside the
digests that a program span holds, the idle time by host span, and the
device operations by innermost span. Needs a CUDA device (exit 3).
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()  # set-up counts from here, as in bench/run.py
BENCH = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="bench/trace_spans.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()
    sys.path.insert(0, BENCH)
    import torch

    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA device", file=sys.stderr)
        sys.exit(3)
    root = os.path.dirname(BENCH)
    sys.path.insert(0, os.path.join(root, "src"))
    from benchlib import cell, spans

    cell.use_cache_dirs(root)
    res = spans.run_cell(root, args.workload, args.seed, args.seconds, device="cuda", t0=T0)
    print(json.dumps(res), flush=True)
