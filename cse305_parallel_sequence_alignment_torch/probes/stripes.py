"""P-stripes: 1 to 8 pairs interleaved in one CTA's row loop, beside K3',
in one process.

The H100 counterpart of the TPU probe scripts/kern_stripes.py: the K3'
row step with A's character fixed at 65 over 2,048 rows of a 2,176-column
b_ext (codes 60-69 in every column, seed 7) for the probe's eight cases
(:121-128): 256 pairs at 1, 2, 4 and 8 stripes (pairs a CTA), 128 pairs
at 2 and 4, and 256 pairs at 4 stripes with unroll 2 and 8; one stripe of
128 pairs is added as the full step those two are held against. In
interleaved rounds with K3' (``rowscan_score_fill``, A all 65) at each
batch. Each line says whether the kernel equals its plain twin on the
first 16 pairs (``exact``) and whether each pair's last-row max3 at
column 2,175 is the max of K3''s finals there (``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.stripes
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

# (pairs, stripes, unroll); the probe's total_b 256 and 128
GRID = ((256, 1, 4), (256, 2, 4), (256, 4, 4), (256, 8, 4), (128, 1, 4),
        (128, 2, 4), (128, 4, 4), (256, 4, 2), (256, 4, 8))
ROWS, NL = rowprobe.ROWS, 2176


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    rows, W, scale = (32, 256, 16) if small else (ROWS, NL, 1)
    full_ext = ext_codes(dev, GRID[0][0] // scale, W)
    rext = full_ext[:REDUCED].contiguous()
    pins, want = {}, {}
    for B in sorted({g[0] // scale for g in GRID}):
        call, want[B] = k3p_rows(full_ext[:B].contiguous(), rows)
        pins[f"K3' B{B}"] = (call, B * rows * (W - 1))
    variants = {}
    for B, s, u in GRID:
        B //= scale
        b_ext = full_ext[:B].contiguous()
        run = functools.partial(rowprobe.stripes_fill, b_ext, s, u, rows)
        variants[f"B{B}_S{s}_u{u}"] = Variant(
            run=run,
            plain=functools.partial(rowprobe.stripes_fill_plain, b_ext,
                                    rows),
            reduced=functools.partial(rowprobe.stripes_fill, rext, s, u,
                                      rows),
            twin="A", full=f"B{B}_S1_u4", pin=f"K3' B{B}",
            cells=B * rows * (W - 1), nbytes=5 * B * W,
            k3p=lambda run=run, B=B: torch.equal(run()[:, -1], want[B]))
    twins = {"A": functools.partial(rowprobe.stripes_fill_plain, rext, rows)}
    return rows, pins, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
