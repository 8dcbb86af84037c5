"""The driver ``closed_loop``: one client that starts each iteration when
the last has returned. The window ends with the iteration that crosses
``seconds``, so ``rows_per_s`` counts the input rows of whole iterations
over their whole time, the final wait for the device included.

Inside the window each iteration's answer is reduced to its digest on the
device, with no read on the host; the last iteration's answer is kept
whole for the full comparison after the window.
"""

from __future__ import annotations

import time


def window(pipe, tables: dict, seconds: float, span, sync) -> dict:
    rows = pipe.rows(tables)
    digests, last, failed, error, overflow = [], None, 0, None, 0
    t0 = time.perf_counter()
    while True:
        try:
            out = pipe.run(tables, span)
        except Exception as e:  # a failed iteration ends the window and the run is not correct
            failed, error = 1, f"{type(e).__name__}: {e}"
            break
        overflow = overflow + out["overflow"]
        digests.append(span("digest", lambda: pipe.digest(out)))
        if time.perf_counter() - t0 >= seconds:
            last = out
            break
        del out
    sync()
    window_s = time.perf_counter() - t0
    return {"start": t0, "window_s": window_s, "digests": digests, "last": last,
            "attempted": len(digests) + failed, "failed": failed, "error": error,
            "overflow": int(overflow), "values": {"rows_per_s": len(digests) * rows / window_s}}
