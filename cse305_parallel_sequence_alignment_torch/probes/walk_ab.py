"""K2' (one thread walking G pairs interleaved) against K2 (one thread a
pair) on K1's dirs, then the fused ``BatchAligner`` it would serve.

The H100 counterpart of the TPU probe scripts/probes/pallas_walk_r4.py:
a K1 dirs16+runs fill of 128 pairs of 2048 x 2048 (seed 7), end tables
from its finals, then each walk on those dirs. For every G in 1, 2, 4, 8:
equality with K2 (``mismatched_pairs``: pairs whose K2' stream is not
K2's nonzero entries; ``rounds_mean``) and both times. Last, the fused
``BatchAligner`` (K1 + K2): its device/host split (``last_phases``) on
the 128 pairs and ``align_batch`` pairs/s on 256 and 512 of them (the
128 repeated), mean of 3 timed runs after a warm-up, with the spread.

    python -m cse305_parallel_sequence_alignment_torch.probes.walk_ab
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
    _end_choice,
)
from cse305_parallel_sequence_alignment_torch.ops import device_walk, rowcb
from cse305_parallel_sequence_alignment_torch.probes._common import (
    bucket,
    emit,
    emit_device,
    parse,
    rate,
    timed,
)


def mismatched_pairs(k2, k2g, used):
    """Pairs whose K2' entries up to ``used`` are not the nonzero
    entries of K2's column."""
    k2 = (k2.view(torch.int16).to(torch.int32) & 0xFFFF).cpu().numpy()
    k2g, used = k2g.cpu().numpy(), used.cpu().numpy()
    return sum(not np.array_equal(k2[:, k][k2[:, k] != 0],
                                  k2g[k, : used[k]])
               for k in range(k2g.shape[0]))


def main(argv=None):
    args = parse(argv, __doc__)
    dev = args.dev
    emit_device(dev)
    B, m, n = (8, 64, 64) if args.small else (128, 2048, 2048)
    (a, b, la, lb), _ = bucket(dev, B, m, n)
    st = torch.full_like(la, -1)
    params = ScoringParams()
    fill = lambda: rowcb.rowcb_fill(a, b, la, lb, st, params)  # noqa: E731
    dirs, fin = fill()
    emit(kind="fill_dirs16", B=B, m=m, n=n,
         **rate(B * m * n, timed(fill, dev, args.reps)))
    tables, _ = _end_choice(fin, torch.full_like(la, -1), params.h)
    steps = m + n + 1
    k2 = lambda: device_walk.rle_walk(  # noqa: E731
        dirs, la, lb, tables, steps)
    k2_ent, _ = k2()
    for G in device_walk.GROUPS:
        k2g = lambda: device_walk.group_walk_rle(  # noqa: E731
            dirs, la, lb, tables, steps, G=G)
        ent, used = k2g()
        bad = mismatched_pairs(k2_ent, ent, used)
        t_g = timed(k2g, dev, args.reps)
        t_1 = timed(k2, dev, args.reps)
        emit(kind="walk", G=G, mismatched_pairs=bad,
             rounds_mean=float(used.float().mean()),
             **t_g, **{f"k2_{k}": v for k, v in t_1.items()})
    del dirs

    pairs = [(x.tobytes().decode(), y.tobytes().decode())
             for x, y in zip(a.cpu().numpy(), b.cpu().numpy())]
    al = BatchAligner(params=params, device=str(dev))
    al.align_batch(pairs)
    res = al.align_batch(pairs)
    emit(kind="fused_phases", pairs=B, chain0=len(res[0].chain),
         **{k: v for k, v in al.last_phases.items()})
    for total in ((16, 32) if args.small else (256, 512)):
        ps = (pairs * (total // B + 1))[:total]
        al.align_batch(ps)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = al.align_batch(ps)
            walls.append(time.perf_counter() - t0)
        assert all(r.aligned_a for r in res)
        mean = sum(walls) / len(walls)
        emit(kind="align_batch", total=total, pairs_per_s=total / mean,
             spread_pct=100 * (max(walls) - min(walls)) / mean,
             clock="host")


if __name__ == "__main__":
    main()
