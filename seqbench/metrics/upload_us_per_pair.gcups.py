"""The chunks' uploads, us a pair: ``BatchAligner.last_phases``
``upload_ms`` (host clock around each chunk's host-to-device copies)
summed over the window's calls."""


def read(r):
    s = r.spans.get("upload_ms")
    return None if s is None else 1e3 * s / r.pairs
