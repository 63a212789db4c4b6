"""Bucketed batched semi-global aligner (A end-to-end, B's flanks free).

The port of the JAX package's ``models/semiglobal.py``: "fit A into B",
as when reads are placed into reference windows. Pairs are bucketed by a
quantum on both axes (no parity swap) and padded. ``align_batch`` runs,
per chunk of a bucket whose dirs fit ``dirs_budget``: the K10d fill
(ops/rowcb.py ``semiglobal_dirs``) with its row dirs16+runs and best
cells, the K2 run-length walk (ops/device_walk.py ``rle_walk``) from each
best cell, and a copy of the walk's used rounds and the bests to pinned
host memory; the dirs never leave the card. The host then builds chains,
spans and CIGARs in the native library (native/walker.py
``free_end_build``, one thread per core) while the device fills and walks
the next chunk. ``score_batch`` runs the K10s score fill only
(ops/diag.py ``semiglobal_score``).

``FreeEndAligner`` holds the dispatch and build that the overlap aligner
(models/overlap.py) shares; the chunking is models/chunked.py's. The
aligner's ``device`` is explicit ("cuda" by default, or "cpu" for the
plain PyTorch versions of the kernels); it is never switched.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    LazyChain,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.chunked import (
    ChunkedAligner,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops.device_walk import rle_walk
from cse305_parallel_sequence_alignment_torch.ops.diag import (
    semiglobal_score,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    semiglobal_dirs,
)
from cse305_parallel_sequence_alignment_torch.utils.observability import Marks

FREE_END_PARAMS = ScoringParams(g=1.0, h=2.0, match=1.0, mismatch=-1.0)


@dataclasses.dataclass
class SemiGlobalResult:
    score: float
    chain: list
    cigar: str
    cigar_extended: str
    target_span: tuple  # (first, last) 1-based B columns aligned
    end_table: int


class FreeEndAligner(ChunkedAligner):
    """Shared body of the semi-global and overlap aligners: the dispatch
    and build of one chunk on the driver of models/chunked.py.

    A subclass names its ``mode`` ("semiglobal" or "overlap"), its
    ``_dirs_fill`` and ``_score_fill`` kernels and its ``_result``.
    ``backend`` "auto" and "pallas" run the row-sweep dirs fill;
    "wavefront" runs ``score_batch`` (its fill is the port of the XLA
    wavefront on every backend) and refuses ``align_batch``, whose JAX
    route is the anti-diagonal dirs fill, not ported (ROADMAP queue 1
    item 15)."""

    mode = ""
    wavefront_dirs = False

    @staticmethod
    def _dirs_bytes(bm, bn):
        return 2 * (bm + 1) * (bn + 1)  # uint16 row dirs

    def _dispatch(self, a, b, la, lb):
        """Queue fill, walk and the device-to-host copies of one chunk on
        the current stream; returns the handles without waiting."""
        max_steps = int(la.max(initial=0)) + int(lb.max(initial=0)) + 1
        marks = Marks(self._dev)
        t_a, t_b, t_la, t_lb = self._to_dev(a, b, la, lb)
        marks.mark()
        dirs, best = self._dirs_fill(t_a, t_b, t_la, t_lb, self.params)
        marks.mark()
        et = best[:, 1].to(torch.int32)
        ei = best[:, 2].to(torch.int32)
        ej = best[:, 3].to(torch.int32)
        entries, used = rle_walk(dirs, ei, ej, et, max_steps)
        del dirs
        marks.mark()
        # the capped prefix of the entries ships with the bests; the whole
        # buffer stays on the device for the rare overflow
        cap = min(max_steps, max(256, max_steps // 16))
        pin = self._dev.type == "cuda"
        host = []
        for x in (entries[:cap], used, best):
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            buf.copy_(x, non_blocking=pin)
            host.append(buf)
        marks.mark()
        return entries, host, marks

    def _emit(self, item, results):
        """Wait for a dispatched chunk and build its results."""
        chunk, a, b, (entries_d, (ent_h, used_h, best_h), marks) = item
        marks.wait()
        for k, name in enumerate(("fill_ms", "walk_ms", "d2h_ms")):
            self.last_phases[name] += marks.ms(k)
        t0 = time.perf_counter()
        used = int(used_h[0])
        ent = ent_h.numpy()
        if used > ent.shape[0]:
            ent = entries_d[:used].cpu().numpy()
        best = best_h.numpy()
        tt, ii, jj, lens, spans, cigars, extended = walker.free_end_build(
            ent[:used].T, best[:, 2].astype(np.int64),
            best[:, 3].astype(np.int64), best[:, 1].astype(np.int32), a, b,
            self.mode)
        # plain Python rows: one conversion a chunk, not a numpy scalar
        # read per field and pair
        best_l, spans_l = best.tolist(), spans.tolist()
        for r, (k, L) in enumerate(zip(chunk, lens.tolist())):
            chain = LazyChain(tt[r, :L].copy(), ii[r, :L].copy(),
                              jj[r, :L].copy())
            results[k] = self._result(best_l[r], chain, spans_l[r],
                                      cigars[r], extended[r])
        self.last_phases["build_ms"] += (time.perf_counter() - t0) * 1e3


@dataclasses.dataclass
class SemiGlobalBatchAligner(FreeEndAligner):
    """Aligns many (query, target) pairs semi-globally, length-bucketed.

    ``max_batch`` caps pairs per launch and ``dirs_budget`` the bytes of
    one chunk's dirs. ``backend``: see ``FreeEndAligner``. ``device`` is
    where the kernels run."""

    params: ScoringParams = FREE_END_PARAMS
    bucket_quantum: int = 128
    max_batch: int = 512
    backend: str = "auto"
    dirs_budget: int = 2 << 30  # align_batch chunk cap (bytes of dirs)
    device: str = "cuda"

    mode = "semiglobal"

    @staticmethod
    def _dirs_fill(a, b, la, lb, params):
        return semiglobal_dirs(a, b, la, lb, params)

    @staticmethod
    def _score_fill(a, b, la, lb, params):
        return semiglobal_score(a, b, la, lb, params)

    @staticmethod
    def _result(best, chain, span, cigar, extended):
        return SemiGlobalResult(
            score=best[0], chain=chain, cigar=cigar,
            cigar_extended=extended, target_span=(span[2], span[3]),
            end_table=int(best[1]))

    def score_batch(self, pairs):
        """(scores, end_tables, end_js) for all pairs (K10s)."""
        out = self._scores(pairs)
        return (out[:, 0].copy(), out[:, 1].astype(np.int32),
                out[:, 3].astype(np.int32))
