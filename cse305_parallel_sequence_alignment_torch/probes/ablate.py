"""P-ablate: the K3' row step with one per-row part ablated at a time,
and the raw max-chain floors, beside K3', in one process.

The H100 counterpart of the TPU probe scripts/probes/attrib_r5.py: 256
pairs of 2048 x 2048 (codes 65-68, seed 11, start type -1, every la = m)
through ``ablate_finals`` under each mode of ``rowprobe.ABLATE`` (the
full step; A's character as 65 + (i & 3); no shifts; both; fb = 1 + 0 *
P1(i-1, 0), NaN from row 2 on; no prefix max; T3 = P3 - g; no column-0
selects) and the floors ``chain`` (K dependent x = max(x + 0.5, P2) a
row, K = 4, 8, 16, 34) and ``indep`` (K/4 rounds of four independent
additions, K = 8, 16, 32), in interleaved rounds with K3'
(``rowscan_score_fill``). Each line says whether the kernel equals its
plain twin on the first 16 pairs, NaN equal to NaN (``exact``), and for
the steps that compute K3''s function (``full``, and ``noboundary``,
whose -inf fills do the selects' work) whether the finals equal K3''s
(``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.ablate
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

GRID = tuple((mode, 0) for mode in rowprobe.ABLATE) + tuple(
    (mode, K) for mode, Ks in rowprobe.FLOORS.items() for K in Ks)
K3P_MODES = ("full", "noboundary")


def name_of(mode, K):
    return f"{mode}_K{K}" if K else mode


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    B, m, n = (4, 32, 300) if small else (256, 2048, 2048)
    (a, b, la, lb), _ = bucket(dev, B, m, n, seed=11)
    ra, rb, rlb = (x[:REDUCED].contiguous() for x in (a, b, lb))
    st = torch.full_like(la, -1)
    k3p = functools.partial(rowcb.rowscan_score_fill, a, b, la, lb, st,
                            rowprobe.PROBE_PARAMS)
    want = k3p()
    cells = B * m * n
    variants, twins = {}, {}
    for mode, K in GRID:
        name = name_of(mode, K)
        run = functools.partial(rowprobe.ablate_finals, a, b, lb, mode, K)
        variants[name] = Variant(
            run=run,
            plain=functools.partial(rowprobe.ablate_finals_plain, a, b, lb,
                                    mode, K),
            reduced=functools.partial(rowprobe.ablate_finals, ra, rb, rlb,
                                      mode, K),
            twin=name, full="full", pin="K3'", cells=cells,
            nbytes=(4 + 12) * B if K else B * (m + n + 4 + 12),
            k3p=(lambda run=run: torch.equal(run(), want))
            if mode in K3P_MODES else None)
        twins[name] = functools.partial(rowprobe.ablate_finals_plain, ra, rb,
                                        rlb, mode, K)
    return m, {"K3'": (k3p, cells)}, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
