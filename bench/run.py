"""Run one cell of the benchmark once; see ``benchlib/cli.py``."""

import os
import sys
import time

T0 = time.perf_counter()  # set-up counts from here
BENCH = os.path.dirname(os.path.abspath(__file__))

if __name__ == "__main__":
    sys.path.insert(0, BENCH)
    from benchlib import cli

    sys.exit(cli.main(sys.argv[1:], T0, os.path.dirname(BENCH)))
