"""The crossing search's share of its roofline over the traced passes:
the least time of its work over the time on the card of K6
(``csrc/longrow.cu`` ``strip_kernel``, every instance), in %.

The work is reckoned from the pass and the configuration's
``partitions`` p, as ``PartitionedAligner.align`` fills it: every level
of the bisection fills each of its sub-rectangles once, forward to the
middle row and back, (2 - 2/p) m n cells of an m x n pair, and the first
level fills its reverse half once more with the end forced to T1 (the
free end's tie order), m n / 2; 17 operations a cell. Bytes: each
level's sequences read once and its rows of three float32 tables
written, (m + 2n) + 24 n a level. The cell is named by the run's
``--workload``."""

import argparse
import math
import re
import sys

import manifest
import roofline

PATTERN = r"strip_kernel"
OPS_CELL = 17


def least_seconds(la, lb, p):
    """Least seconds of the crossing search of pairs ``la`` x ``lb`` at
    ``p`` segments."""
    cells = (2.5 - 2.0 / p) * float((la * lb).sum())
    levels = math.ceil(math.log2(p))
    nbytes = (levels + 0.5) * float((la + 26 * lb).sum())
    return max(OPS_CELL * cells / roofline.PEAK_FLOPS,
               nbytes / roofline.PEAK_BYTES)


def partitions():
    """The ``partitions`` of the configuration of the run's cell, or None
    where the command line names no cell."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    name = ap.parse_known_args(sys.argv[1:])[0].workload
    if name is None:
        return None
    return int(manifest.Cell(manifest.load(), name).config["partitions"])


def read(r):
    dev = r.device
    if dev is None:
        return None
    spent = sum(s for name, s in dev.kernels.items()
                if re.search(PATTERN, name.replace(" ", "")))
    p = partitions()
    if spent <= 0 or p is None or p < 2:
        return None
    la, lb = r.passage.oriented_lengths(r.swap)
    return 100.0 * least_seconds(la, lb, p) * dev.passes / spent
