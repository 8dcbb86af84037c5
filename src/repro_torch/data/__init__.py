"""Data: synthetic tables, partitioned CSV I/O, the chunked on-disk
dataset format the streaming engine scans, and the trainer's
``TokenPipeline`` (``data.pipeline``; the reference's ``repro.data``)."""

from .synthetic import uniform_table, zipf_table, synthetic_token_corpus  # noqa: F401
from .pipeline import TokenPipeline  # noqa: F401
from .io import read_csv_dist, write_csv_dist  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetManifest,
    DatasetWriter,
    csv_to_dataset,
    open_dataset,
    read_rows,
    write_dataset,
)
