"""The crossing search of ``PartitionedAligner.align``, ms a pair: its
``last_phases`` ``crossing_ms`` (host clock: the bisection's K6 fills,
one a level, and their combines, each level's results on the host)
summed over the window's pairs."""


def read(r):
    s = r.spans.get("crossing_ms")
    return None if s is None else s / r.pairs
