"""K3'' (the two-carry row sweep) against K3' (the three-table sweep), in
one process, interleaved so that the card's state cancels.

The H100 counterpart of the TPU probes scripts/probes/ab_rowscan2_r4.py
(three interleaved rounds at 256 x 2048 x 2048, seed 7, start type -1,
and a block_b sweep), ab_unroll_r4.py (an unroll sweep) and rowscan2k.py
(the warm rate). On the card a CTA's shape is set by the columns each
thread keeps in registers, so the TPU's block_b and unroll sweeps become
one sweep of columns a thread (4, 8, 16, 32) with the threads a CTA that
follow, each against K3' timed right after it. Every line says whether
its finals equal those of K3' (``cells_equal``).

    python -m cse305_parallel_sequence_alignment_torch.probes.ab_rowscan2
"""

from __future__ import annotations

import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowscan2
from cse305_parallel_sequence_alignment_torch.probes._common import (
    bucket,
    emit,
    emit_device,
    parse,
    rate,
    timed,
)


def main(argv=None):
    args = parse(argv, __doc__)
    dev = args.dev
    emit_device(dev)
    B, m, n = (8, 64, 64) if args.small else (256, 2048, 2048)
    (a, b, la, lb), _ = bucket(dev, B, m, n)
    st = torch.full_like(la, -1)
    params = ScoringParams()
    cells = B * m * n
    variants = {
        "rowscan (K3')": lambda: rowcb.rowscan_score_fill(
            a, b, la, lb, st, params),
        "rowscan2 (K3'')": lambda: rowscan2.rowscan2_score_fill(
            a, b, la, lb, st, params),
    }
    want = variants["rowscan (K3')"]()
    for name, fn in variants.items():
        emit(kind="check", kernel=name,
             cells_equal=bool(torch.equal(fn(), want)))
    for rnd in range(args.rounds):
        for name, fn in variants.items():
            emit(kind="round", round=rnd, kernel=name, B=B, m=m, n=n,
                 **rate(cells, timed(fn, dev, args.reps)))
    for columns in rowscan2.COLUMNS:
        try:
            c, threads = rowscan2.geometry(n, columns)
        except ValueError:
            continue  # too many threads a CTA at this width
        fn = lambda: rowscan2.rowscan2_score_fill(  # noqa: E731
            a, b, la, lb, st, params, columns=c)
        ok = bool(torch.equal(fn(), want))
        t = rate(cells, timed(fn, dev, args.reps))
        pin = rate(cells, timed(variants["rowscan (K3')"], dev, args.reps))
        emit(kind="columns", columns=c, threads=threads, cells_equal=ok,
             **t, **{f"pin_{k}": v for k, v in pin.items()})


if __name__ == "__main__":
    main()
