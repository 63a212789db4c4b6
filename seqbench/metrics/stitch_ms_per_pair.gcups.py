"""The stitch of ``PartitionedAligner.align``, ms a pair: its
``last_phases`` ``stitch_ms`` (host clock: the segments' chains joined,
the joined chain scored and its rows rendered) summed over the window's
pairs."""


def read(r):
    s = r.spans.get("stitch_ms")
    return None if s is None else s / r.pairs
