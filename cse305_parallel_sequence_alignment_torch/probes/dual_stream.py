"""(a) P-dual, two pairs a CTA, against K3'', one pair a CTA; (b) K8
through the long-pair pipeline on one card, each timed beside K3''.

The H100 counterpart of the TPU probe scripts/probes/dual_halostair_r4.py.
(a) runs 256 pairs of 2048 x 2048 (seed 7, start type -1) through
``dual_rowscan2_fill`` at several columns a thread, each against
``rowscan2_score_fill`` timed right after it, with ``cells_equal`` (the
finals in pair order equal those of K3''). (b), the TPU probe's op-cut halostair
re-measure, is ``longseq_score`` of one random pair of L x L on a mesh of
the one card through the K8 kernel route, at (L, R) = (8,192, 512),
(16,384, 512), (32,768, 1,024) and (65,536, 1,024), with R rows a step.

    python -m cse305_parallel_sequence_alignment_torch.probes.dual_stream
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import rowscan2
from cse305_parallel_sequence_alignment_torch.parallel import longseq
from cse305_parallel_sequence_alignment_torch.parallel.mesh import Mesh
from cse305_parallel_sequence_alignment_torch.probes._common import (
    bucket,
    emit,
    emit_device,
    parse,
    rate,
    timed,
)

PIPELINE = ((8192, 512), (16384, 512), (32768, 1024), (65536, 1024))
PIPELINE_SMALL = ((256, 64), (512, 128))


def main(argv=None):
    args = parse(argv, __doc__)
    dev = args.dev
    emit_device(dev)
    B, m, n = (8, 64, 64) if args.small else (256, 2048, 2048)
    (a, b, la, lb), rng = bucket(dev, B, m, n)
    st = torch.full_like(la, -1)
    params = ScoringParams()
    cells = B * m * n
    pin = lambda: rowscan2.rowscan2_score_fill(  # noqa: E731
        a, b, la, lb, st, params)
    want = pin()
    for rnd in range(args.rounds):
        for columns in (4, 8, 16):
            c, threads = rowscan2.geometry(n, columns)
            fn = lambda: rowscan2.dual_rowscan2_fill(  # noqa: E731
                a, b, lb, params, columns=c)
            ok = bool(torch.equal(fn(), want))
            t = rate(cells, timed(fn, dev, args.reps))
            p = rate(cells, timed(pin, dev, args.reps))
            emit(kind="dual", round=rnd, columns=c, threads=threads,
                 cells_equal=ok, **t,
                 **{f"pin_{k}": v for k, v in p.items()})

    mesh = Mesh([dev])
    for L, R in PIPELINE_SMALL if args.small else PIPELINE:
        x = rng.integers(65, 69, size=L).astype(np.uint8)
        y = rng.integers(65, 69, size=L).astype(np.uint8)

        def run():
            return longseq.longseq_score(x, y, params, mesh=mesh,
                                         row_chunk=R, backend="kernel")
        t0 = time.perf_counter()
        fin = run()
        first = time.perf_counter() - t0
        iters = max(1, args.reps // 2)
        t0 = time.perf_counter()
        for _ in range(iters):
            run()  # returns host arrays: the card has finished
        wall = (time.perf_counter() - t0) / iters
        row = dict(kind="halostair_d1", L=L, R=R, calls=-(-L // R),
                   first_s=first, wall_s=wall,
                   finite=bool(np.isfinite(fin).all()))
        if dev.type == "cuda":
            row["gcups"] = L * L / wall / 1e9
        p = rate(cells, timed(pin, dev, args.reps))
        emit(**row, **{f"pin_{k}": v for k, v in p.items()})


if __name__ == "__main__":
    main()
