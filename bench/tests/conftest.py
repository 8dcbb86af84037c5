"""The harness's own tests: ``python -m pytest bench/tests`` from the root
of the repository. They drive the cells on the CPU at a size a test run
holds; the ``cuda`` tests run a cell on the card and skip without one."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
