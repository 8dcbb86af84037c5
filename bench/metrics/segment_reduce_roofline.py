"""segment_reduce's share of its roofline: the bytes of every call the
traced window made (ids and values read, one row per segment written) at
3.35 TB/s, over the device time of its two launches (``segment_tiles``
and ``segment_finish``) in the trace."""

from _reads import roofline_pct

from benchlib.roofline import segment_reduce_bytes


def read(obs):
    return roofline_pct(obs, "segment_reduce", ("segment_tiles", "segment_finish"),
                        segment_reduce_bytes)
