"""LM serving front door: batched greedy decoding (:class:`ServeEngine`) and
the prefill / decode steps it is built from."""

from .engine import ServeEngine  # noqa: F401
from .serve_step import make_prefill, make_serve_step  # noqa: F401

__all__ = ["ServeEngine", "make_prefill", "make_serve_step"]
