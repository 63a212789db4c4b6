"""K3' against P-trim (K3' at uniform la, finals read after row m, omega
in the free modes' order), in one process.

The H100 counterpart of the TPU probe scripts/kern_rowscan2.py: 256 pairs
of 2048 x lb, lb drawn from [1848, 2048] (seed 7), start type -1, every
la = m; each line says whether its finals equal those of K3'
(``exact``). The
TPU probe's block_b x unroll grid has no counterpart here: both sweeps
take the geometry of csrc/rowcb.cu, so the rounds are interleaved
instead.

    python -m cse305_parallel_sequence_alignment_torch.probes.trim_rowscan
"""

from __future__ import annotations

import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import rowcb
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
    B, M, N, spread = (8, 64, 64, 8) if args.small else (256, 2048, 2048,
                                                         200)
    (a, b, la, _), rng = bucket(dev, B, M, N)
    lb = torch.from_numpy(rng.integers(N - spread, N + 1, size=B).astype(
        "int32")).to(dev)
    st = torch.full_like(la, -1)
    params = ScoringParams()
    cells = int(lb.sum()) * M
    variants = {
        "production (K3')": lambda: rowcb.rowscan_score_fill(
            a, b, la, lb, st, params),
        "trimmed (P-trim)": lambda: rowcb.trim_rowscan_fill(
            a, b, lb, params),
    }
    want = variants["production (K3')"]()
    for rnd in range(args.rounds):
        for name, fn in variants.items():
            emit(kind="round", round=rnd, kernel=name, B=B, m=M,
                 lb_min=int(lb.min()), lb_max=int(lb.max()),
                 exact=bool(torch.equal(fn(), want)),
                 **rate(cells, timed(fn, dev, args.reps)))


if __name__ == "__main__":
    main()
