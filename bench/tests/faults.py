"""Faults planted underneath the timed path, one context manager each; the
harness must judge a run with any of them not correct."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _half(ddf):
    from repro_torch.core import DDF

    return DDF(ddf.columns, ddf.counts // 2, ddf.ctx, ddf.vocabs)


def _half_table(table):
    from repro_torch.core import Table

    return Table(table.columns, table.nvalid // 2)


def state_unchanged():
    """The keyed step hands back its input: groupby, unique and sort return
    the table they were given, a lazy query its left source."""
    from repro_torch.core import DDF
    from repro_torch.plan.frame import LazyDDF

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(LazyDDF, "collect", lambda f: lambda self, *a, **k: next(
        iter(self._sources.values()))))
    stack.enter_context(_patched(DDF, "groupby", lambda f: lambda self, *a, **k: (self, {})))
    stack.enter_context(_patched(DDF, "unique", lambda f: lambda self, *a, **k: (self, {})))
    stack.enter_context(_patched(
        DDF, "sort_values",
        lambda f: lambda self, *a, **k: (self, {"overflow_shuffle": self.counts * 0})))
    return stack


def half_left_out():
    """Half of each worker's left rows left out of the shuffle join (eager
    and planned), of the unique and of the sort."""
    from repro_torch.core import DDF, operators

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(operators, "dist_join_shuffle",
                                 lambda f: lambda comm, left, *a, **k: f(
                                     comm, _half_table(left), *a, **k)))
    for name in ("sort_values", "unique"):
        stack.enter_context(_patched(DDF, name, lambda f: lambda self, *a, **k: f(
            _half(self), *a, **k)))
    return stack


def exchange_left_out():
    """The all-to-all between the workers skipped: every worker keeps the
    buffers it built for the others."""
    from repro_torch.core.comm.group import WorkerBlock

    return _patched(WorkerBlock, "exchange", lambda f: lambda self, buf: buf)


def answer_altered():
    """One value altered where it is produced: the first row of every
    segment reduction, of every local sort and of every local unique."""
    from repro_torch.core import operators
    from repro_torch.kernels import ops

    def seg(f):
        def g(values, *a, **k):
            out = f(values, *a, **k).clone()
            out.view(-1)[0] += 1
            return out
        return g

    def first_row(f):
        def g(table, *a, **k):
            out = f(table, *a, **k)
            t = out[0] if isinstance(out, tuple) else out
            for v in t.columns.values():
                v[0, 0] += 1
            return out
        return g

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(ops, "segment_reduce", seg))
    stack.enter_context(_patched(operators, "local_sort", first_row))
    stack.enter_context(_patched(operators, "local_unique", first_row))
    return stack


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "exchange_left_out": exchange_left_out, "answer_altered": answer_altered}
