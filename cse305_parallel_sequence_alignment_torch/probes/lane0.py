"""P-lane0: column 0's T3 in the forms A to E, beside K3', in one
process.

The H100 counterpart of the TPU probe scripts/kern_scalar.py: 256 pairs,
2,048 rows of the K3' row step over a 2,176-column b_ext (codes 60-69 in
every column, seed 7) through ``lane0_fill`` at unroll 4 for A (T3(i, 0)
= -h - g*i), B (the constant -5), C (a carried column, less g each row),
D (no select) and E (A, with A's character read from b_ext's column i -
1), and at unroll 8 for B and C (:125-129); A-D fix A's character at 65.
In interleaved rounds with K3' (``rowscan_score_fill``, A all 65). Each
line says whether the kernel equals its plain twin on the first 16 pairs
(``exact``), and for A, C and D, which compute K3''s rows at g = 1, h =
2, whether each pair's last-row max3 at column 2,175 is the max of K3''s
finals there (``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.lane0
"""

from __future__ import annotations

import functools

import torch

from cse305_parallel_sequence_alignment_torch.ops import rowprobe
from cse305_parallel_sequence_alignment_torch.probes._common import (
    REDUCED,
    Variant,
    emit_device,
    ext_codes,
    k3p_rows,
    parse,
    run_attribution,
)

GRID = (("A", 4), ("B", 4), ("C", 4), ("D", 4), ("E", 4), ("B", 8),
        ("C", 8))
K3P_FORMS = "ACD"
ROWS, NL = rowprobe.ROWS, 2176


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    B, rows, W = (8, 32, 256) if small else (256, ROWS, NL)
    b_ext = ext_codes(dev, B, W)
    rext = b_ext[:REDUCED].contiguous()
    call, want = k3p_rows(b_ext, rows)
    cells = B * rows * (W - 1)
    variants, twins = {}, {}
    for mode, u in GRID:
        run = functools.partial(rowprobe.lane0_fill, b_ext, mode, u, rows)
        variants[f"{mode}_u{u}"] = Variant(
            run=run,
            plain=functools.partial(rowprobe.lane0_fill_plain, b_ext, mode,
                                    rows),
            reduced=functools.partial(rowprobe.lane0_fill, rext, mode, u,
                                      rows),
            twin=mode, full="A_u4", pin="K3'", cells=cells,
            nbytes=5 * B * W,
            k3p=(lambda run=run: torch.equal(run()[:, -1], want))
            if mode in K3P_FORMS else None)
        twins[mode] = functools.partial(rowprobe.lane0_fill_plain, rext,
                                        mode, rows)
    return rows, {"K3'": (call, cells)}, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
