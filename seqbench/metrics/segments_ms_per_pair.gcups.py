"""The segment solves of ``PartitionedAligner.align``, ms a pair: its
``last_phases`` ``segments_ms`` (host clock: the one mixed-type
``align_batch`` of the p segments, K1 and K2, replay) summed over the
window's pairs."""


def read(r):
    s = r.spans.get("segments_ms")
    return None if s is None else s / r.pairs
