"""The host's wait for each chunk, us a pair: ``BatchAligner.last_phases``
``wait_ms`` (host clock around the wait for a chunk's copies to the host
and any overflow fetch) summed over the window's calls."""


def read(r):
    s = r.spans.get("wait_ms")
    return None if s is None else 1e3 * s / r.pairs
