"""Synthetic tables for tests and the chip smoke run."""

from .synthetic import uniform_table  # noqa: F401
