"""Fill and walk on the card, us a pair: ``BatchAligner.last_phases``
``fill_walk_ms`` (CUDA events) summed over the window's calls."""


def read(r):
    s = r.spans.get("fill_walk_ms")
    return None if s is None else 1e3 * s / r.pairs
