"""Helpers the per-layer readers share. Each reader returns None where
its run has nothing to read, and the harness then leaves its metric out."""

from __future__ import annotations

from benchlib import roofline


def span_ms(obs: dict, name: str):
    s = obs["spans"].get(name)
    return sum(s) / len(s) * 1e3 if s else None


def idle_pct(obs: dict):
    tr = obs["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(obs: dict, kernel: str, device_names: tuple, nbytes):
    """The kernel's least time (its calls' bytes at the card's bandwidth)
    as a share of its device time, summed over the device operations whose
    names contain one of ``device_names``."""
    tr, calls = obs["trace"], obs["kernel_calls"].get(kernel)
    if tr is None or not calls:
        return None
    dev_s = sum(s for k, s in tr["kernel_s"].items() if any(n in k for n in device_names))
    if dev_s <= 0:
        return None
    least_s = sum(nbytes(*c) for c in calls) / roofline.HBM_BYTES_PER_S
    return 100.0 * least_s / dev_s
