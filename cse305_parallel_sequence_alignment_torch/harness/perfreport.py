"""Performance report: GCUPS of the port's kernels across problem sizes,
batch sizes and modes, one JSON line a row.

The port of the JAX package's ``harness/perfreport.py`` ``run_report``
with the same ``mode`` names and fields:

- for every length L and batch B: ``global_score`` (K3 anti-diagonal
  score fill), ``global_score_rowscan_kernel`` (K3' row sweep; the JAX
  report emits it on the TPU only, the port on every device) and
  ``local_score`` (K9s);
- at the largest L and smallest B: ``global_dirs`` (K1', uint8 codes),
  ``semiglobal_dirs`` (K10d) and ``overlap_dirs`` (K11d), and
  ``banded_score_W129``/``W513`` (K12s) and ``banded_dirs_W129``/``W513``
  (K12d), whose GCUPS count band cells;
- ``longrow_score`` (K6) on 8 pairs of 8 L, and ``global_align_e2e``
  (``BatchAligner.align_batch``: fill, walk, replay and render);
- unless ``include_longseq`` is false: ``longseq_score`` (the
  column-sharded pipeline, ``parallel/longseq.py``) of one pair of 4 L
  over every device of ``device``, with the ``pipeline_*`` accounting of
  ``longseq_pipeline_stats``, ``longseq_score_1dev`` on a one-device mesh
  and, on a card, ``longseq_score_1dev_kernel`` (K8) at 12,288, 32,768
  and 97,408 (the JAX report gates these on the TPU).

The semi-global, overlap and banded dirs rows time the uint16 dirs16+runs
kernels that the port's aligners launch (``"dirs": "u16+runs"``); the JAX
report times uint8 variants of them that no aligner runs. Each timed call
uploads its inputs and returns finished results (on a card it ends in a
synchronise), as the JAX rows time the whole harness call. A failing row
fails the report. Left out: the JAX report's TPU roofline constants, its
device-resident and iteration-scaling rows (workarounds for the TPU's
host link).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.local_oracle import (
    LOCAL_PARAMS,
)
from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
    FREE_END_PARAMS,
)
from cse305_parallel_sequence_alignment_torch.ops import (
    banded,
    diag,
    local,
    longrow,
    rowcb,
)
from cse305_parallel_sequence_alignment_torch.parallel.longseq import (
    longseq_pipeline_stats,
    longseq_score,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    make_seq_mesh,
)
from cse305_parallel_sequence_alignment_torch.utils.observability import (
    gcups,
)

METHOD = "harness-call (upload+sync)"


def _rand_batch(rng, batch, m, n):
    a = rng.integers(65, 69, size=(batch, m)).astype(np.uint8)
    b = rng.integers(65, 69, size=(batch, n)).astype(np.uint8)
    la = np.full((batch,), m, np.int32)
    lb = np.full((batch,), n, np.int32)
    return a, b, la, lb


def _time_call(fn, iters=3):
    fn()  # warm-up (and the kernels' build at first use)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def run_report(lengths=(512, 2048), batches=(64, 256), iters=3,
               include_longseq=True, stream=None, device="cuda"):
    """Run the sweep on ``device``; prints one JSON line per row and
    returns the rows."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"perf on {device!r} needs a CUDA card and none "
                           "is available; pass --device cpu to time the "
                           "plain PyTorch kernels")
    out = stream or sys.stdout
    rng = np.random.default_rng(17)
    rows = []

    def emit(row):
        row["backend"] = dev.type
        row.setdefault("method", METHOD)
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)

    def call(fn, *arrays):
        """A timed call: upload, run, and wait for the results."""
        def run():
            res = fn(*(torch.from_numpy(x).to(dev) for x in arrays))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return res
        return run

    def timed_row(mode, fn, arrays, cells, key="gcups", reps=iters, **extra):
        dt, _ = _time_call(call(fn, *arrays), reps)
        emit({"mode": mode, "len": L, "batch": B, **extra,
              "seconds": round(dt, 4), key: round(gcups(cells, dt), 3)})

    params = ScoringParams()
    for L in lengths:
        for B in batches:
            a, b, la, lb = _rand_batch(rng, B, L, L)
            st = np.full((B,), -1, np.int32)
            for mode, fill in (("global_score", diag.score_fill),
                               ("global_score_rowscan_kernel",
                                rowcb.rowscan_score_fill)):
                timed_row(mode, lambda *t, f=fill: f(*t, params),
                          (a, b, la, lb, st), B * L * L)
            timed_row("local_score",
                      lambda *t: local.sw_score(*t, LOCAL_PARAMS),
                      (a, b, la, lb), B * L * L)

    # dirs fills for every mode at the largest length and smallest batch
    L, B = max(lengths), min(batches)
    a, b, la, lb = _rand_batch(rng, B, L, L)
    st = np.full((B,), -1, np.int32)
    timed_row("global_dirs", lambda *t: rowcb.rowdirs_fill(*t, params),
              (a, b, la, lb, st), B * L * L, dirs="u8")
    for mode, fill in (("semiglobal_dirs", rowcb.semiglobal_dirs),
                       ("overlap_dirs", rowcb.overlap_dirs)):
        timed_row(mode, lambda *t, f=fill: f(*t, FREE_END_PARAMS),
                  (a, b, la, lb), B * L * L, dirs="u16+runs")
    for w in (64, 256):  # bands of W = 129 and 513 lanes
        W = 2 * w + 1
        timed_row(f"banded_score_W{W}",
                  lambda *t, w=w: banded.banded_score(*t, w, w, params),
                  (a, b, la, lb, st), B * L * W, key="gcups_band_cells")
        timed_row(f"banded_dirs_W{W}",
                  lambda *t, w=w: banded.banded_dirs(*t, w, w, params),
                  (a, b, la, lb, st), B * L * W, key="gcups_band_cells",
                  dirs="u16+runs")

    # the column-strip long fill on pairs of 8 L
    L, B = max(lengths) * 8, 8
    a, b, la, lb = _rand_batch(rng, B, L, L)
    timed_row("longrow_score", lambda *t: longrow.long_fill(*t, params),
              (a, b, la, lb, np.full((B,), -1, np.int32)), B * L * L,
              reps=max(1, iters - 1))

    # full alignment end to end: fill, device walk, replay and render
    L, B = max(lengths), min(batches)
    a, b, _, _ = _rand_batch(rng, B, L, L)
    pairs = [(x.tobytes().decode(), y.tobytes().decode())
             for x, y in zip(a, b)]
    aligner = BatchAligner(device=device)
    dt, res = _time_call(lambda: aligner.align_batch(pairs), iters)
    if not all(r.aligned_a for r in res):
        raise RuntimeError("global_align_e2e returned an empty row")
    emit({"mode": "global_align_e2e", "len": L, "batch": B,
          "seconds": round(dt, 4), "pairs_per_s": round(B / dt, 1),
          "gcups": round(gcups(B * L * L, dt), 3)})

    if include_longseq:
        def longseq_row(mode, L, mesh, row_chunk, reps, **extra):
            x = rng.integers(65, 69, size=(L,)).astype(np.uint8)
            y = rng.integers(65, 69, size=(L,)).astype(np.uint8)
            dt, _ = _time_call(lambda: longseq_score(
                x, y, params, mesh=mesh, row_chunk=row_chunk), reps)
            emit({"mode": mode, "len": L, "devices": mesh.size,
                  "seconds": round(dt, 4),
                  "gcups": round(gcups(L * L, dt), 3), **extra})

        mesh = make_seq_mesh(device=device)
        L = max(lengths) * 4
        longseq_row("longseq_score", L, mesh, 256, max(1, iters - 1),
                    **{"pipeline_" + k: v for k, v in longseq_pipeline_stats(
                        L, L, mesh.size, row_chunk=256).items()
                       if k != "devices"})
        mesh1 = make_seq_mesh(1, device=device)
        longseq_row("longseq_score_1dev", L, mesh1, 256, 1)
        if dev.type == "cuda":
            # K8 on one card at the per-device share of a 97 kb pair on an
            # eight-device mesh, and at 32 kb and the whole 97 kb pair
            for Lw in (12288, 32768, 97408):
                longseq_row("longseq_score_1dev_kernel", Lw, mesh1, 1024, 1)
    return rows
