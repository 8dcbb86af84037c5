"""Data: synthetic tables, partitioned CSV I/O and the chunked on-disk
dataset format the streaming engine scans (the reference's ``repro.data``,
without the trainer's ``TokenPipeline``)."""

from .synthetic import uniform_table, zipf_table, synthetic_token_corpus  # noqa: F401
from .io import read_csv_dist, write_csv_dist  # noqa: F401
from .dataset import (  # noqa: F401
    DatasetManifest,
    DatasetWriter,
    csv_to_dataset,
    open_dataset,
    read_rows,
    write_dataset,
)
