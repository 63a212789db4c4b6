"""A kernel's least time on the card, from the work of these inputs.

The rule of the port's kernel table: operations a DP cell read from the
kernel's source, bytes = inputs read once + outputs written once (the
codes, the three int32 vectors, the (B, 3) finals, and any dirs word for
each of the (la + 1)(lb + 1) cells). Peaks: one NVIDIA H100 SXM at its
700 W limit, NVIDIA's data sheet, float32 outside the tensor cores and
HBM3. A ``metrics/<kernel>_roofline.py`` reader gives its kernel's name
pattern and counts.
"""

from __future__ import annotations

import re

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def least_seconds(ops_cell, dirs_bytes, la, lb):
    """(seconds, bound) of a kernel's work on pairs of oriented lengths
    ``la``, ``lb`` (int64 arrays); bound is "operations" or "bytes"."""
    ops = ops_cell * float((la * lb).sum())
    nbytes = float((la + lb + 12 + 12).sum()
                   + dirs_bytes * ((la + 1) * (lb + 1)).sum())
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def share_pct(readings, pattern, ops_cell, dirs_bytes):
    """100 x least time / measured time of the kernels whose names (spaces
    removed) match ``pattern``, over the traced passes, or None where the
    trace holds no launch of them."""
    dev = readings.device
    if dev is None:
        return None
    spent = sum(s for name, s in dev.kernels.items()
                if re.search(pattern, name.replace(" ", "")))
    if spent <= 0:
        return None
    la, lb = readings.passage.oriented_lengths(readings.swap)
    least, _ = least_seconds(ops_cell, dirs_bytes, la, lb)
    return 100.0 * least * dev.passes / spent
