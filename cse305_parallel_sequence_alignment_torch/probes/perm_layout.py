"""P-perm: K3''s finals in the contiguous and the strided thread layout,
beside K3', in one process.

The H100 counterpart of the TPU probe scripts/probes/attrib3_r5.py: 256
pairs of 2048 x 2048 (codes 65-68, seed 11, start type -1, every la = m)
through ``perm_finals`` in each layout at unroll 4 and 8, in interleaved
rounds with K3' (``rowscan_score_fill``). The TPU probe permuted the
columns so that each lane owned a run of them; on the card that is the
contiguous layout every row sweep of csrc/ already has, and the TPU's
plain layout is the strided one (column j on thread j mod T, the prefix
max by log2(W) shift-max sweeps over shared memory). Each line says
whether the kernel equals its plain twin on the first 16 pairs
(``exact``) and whether its finals equal K3''s (``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.perm_layout
"""

from __future__ import annotations

import functools

import torch

from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowprobe
from cse305_parallel_sequence_alignment_torch.probes._common import (
    REDUCED,
    Variant,
    bucket,
    emit_device,
    parse,
    run_attribution,
)

GRID = (("contiguous", 4), ("contiguous", 8), ("strided", 4),
        ("strided", 8))


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    B, m, n = (4, 32, 300) if small else (256, 2048, 2048)
    (a, b, la, lb), _ = bucket(dev, B, m, n, seed=11)
    ra, rb, rlb = (x[:REDUCED].contiguous() for x in (a, b, lb))
    st = torch.full_like(la, -1)
    params = rowprobe.PROBE_PARAMS
    k3p = functools.partial(rowcb.rowscan_score_fill, a, b, la, lb, st,
                            params)
    want = k3p()
    cells = B * m * n
    variants = {}
    for layout, u in GRID:
        run = functools.partial(rowprobe.perm_finals, a, b, lb, params,
                                layout, u)
        variants[f"{layout}_u{u}"] = Variant(
            run=run,
            plain=functools.partial(rowprobe.perm_finals_plain, a, b, lb),
            reduced=functools.partial(rowprobe.perm_finals, ra, rb, rlb,
                                      params, layout, u),
            twin="K3'", full="contiguous_u4", pin="K3'", cells=cells,
            nbytes=B * (m + n + 4 + 12),
            k3p=lambda run=run: torch.equal(run(), want))
    twins = {"K3'": functools.partial(rowprobe.perm_finals_plain, ra, rb,
                                      rlb)}
    return m, {"K3'": (k3p, cells)}, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
