"""hash_partition's share of its roofline: the bytes of every call the
traced window made (keys read, destinations written) at 3.35 TB/s, over
the device time of its kernels (``hash_dest*``) in the trace."""

from _reads import roofline_pct

from benchlib.roofline import hash_partition_bytes


def read(obs):
    return roofline_pct(obs, "hash_partition", ("hash_dest",), hash_partition_bytes)
