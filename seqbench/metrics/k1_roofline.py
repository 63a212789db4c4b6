"""K1's share of its roofline over the traced passes: the least time of
these inputs' work (``roofline.py``) over the kernel's time on the card,
in %. K1 is ``csrc/rowfill.cu`` ``fill_kernel<C, false, CLUSTER>``, the
dirs16+runs fill: 29 operations a cell, a uint16 dirs word a cell."""

import roofline

PATTERN = r"fill_kernel<\d+,false,"


def read(r):
    return roofline.share_pct(r, PATTERN, 29, 2)
