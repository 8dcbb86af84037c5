"""The card's idle share of the traced window of the eager and lazy
cells: 1 - (union of its kernels', copies' and sets' intervals) / window."""

from _reads import idle_pct


def read(obs):
    return idle_pct(obs)
