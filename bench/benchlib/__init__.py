"""The benchmark's harness: it drives the PyTorch port (``repro_torch``)
cell by cell, as ``BENCHMARK.json`` names them, and holds what the timed
path produced to the plain reference in ``bench/reference``."""
