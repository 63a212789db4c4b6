"""The share of the card's SMs that K1's launches give work, in %: the
program's counters ``fill_ctas`` (B x k CTAs a ``csrc/rowfill.cu``
launch) over ``fill_sm_slots`` (the card's SMs a launch), summed over the
window's calls. Past one CTA an SM it reads above 100."""


def read(r):
    ctas, slots = r.spans.get("fill_ctas"), r.spans.get("fill_sm_slots")
    if ctas is None or not slots:
        return None
    return 100.0 * ctas / slots
