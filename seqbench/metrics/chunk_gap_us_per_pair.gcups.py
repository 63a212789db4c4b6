"""The card's gap between chunks, us a pair: ``BatchAligner.last_phases``
``gap_ms`` (CUDA events: from a chunk's copies to the host to the next
chunk's fill, i.e. its uploads and the card's wait for the host) summed
over the window's calls."""


def read(r):
    s = r.spans.get("gap_ms")
    return None if s is None else 1e3 * s / r.pairs
