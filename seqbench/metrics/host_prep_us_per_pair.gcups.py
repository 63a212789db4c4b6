"""Host prep of ``align_batch``, us a pair: ``BatchAligner.last_phases``
``prep_ms`` (host clock: encode, parity swap, buckets, then each chunk's
padded arrays and types) summed over the window's calls."""


def read(r):
    s = r.spans.get("prep_ms")
    return None if s is None else 1e3 * s / r.pairs
