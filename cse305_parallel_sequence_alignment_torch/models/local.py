"""Bucketed batched Smith-Waterman local aligner (affine gaps) + CIGARs.

The port of the JAX package's ``models/local.py`` (BASELINE config 3:
batch SW with verified traceback CIGARs). Pairs are bucketed by a
quantum on both axes (no parity swap: local mode has no reference
quirks) and padded, and chunked and pipelined by models/chunked.py.
``align_batch`` runs, per chunk of a bucket whose dirs fit
``dirs_budget``: the K9d fill (ops/local.py) with its skew dirs and best
cells, the K9w walk (ops/device_walk.py) from each best cell, and a copy
of only the walk's table streams and the best values to pinned host
memory; the dirs never leave the card. The host then builds chains,
spans and CIGARs in the native library (native/walker.py
``local_build``, one thread per core), while the device fills and walks
the next chunk. ``score_batch`` runs the K9s score fill only.

The aligner's ``device`` is explicit ("cuda" by default, or "cpu" for
the plain PyTorch versions of the kernels); it is never switched.
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
from cse305_parallel_sequence_alignment_torch.models.local_oracle import (
    LOCAL_PARAMS,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
    local_walk,
)
from cse305_parallel_sequence_alignment_torch.ops.local import (
    sw_dirs,
    sw_score,
)
from cse305_parallel_sequence_alignment_torch.utils.observability import Marks


@dataclasses.dataclass
class LocalAlignmentResult:
    """One local alignment: score, end/start cells (1-based, inclusive),
    chain, CIGAR of the aligned segment."""

    score: float
    start_a: int
    start_b: int
    end_a: int
    end_b: int
    chain: list
    cigar: str
    cigar_extended: str


@dataclasses.dataclass
class LocalBatchAligner(ChunkedAligner):
    """Aligns many pairs locally, length-bucketed like BatchAligner.

    ``max_batch`` caps pairs per launch and ``dirs_budget`` the bytes of
    one chunk's dirs. ``backend`` takes the JAX package's values ("auto",
    "pallas", "wavefront"); all three run the K9 kernels, since the two
    JAX routes agree. ``device`` is where the kernels run.
    ``last_phases`` holds the phase times (ms) of the latest
    ``align_batch``: prep and the chain and CIGAR build on the host's
    clock, fill, walk and device-to-host on the device's; ``last_chunks``
    its number of chunks.
    """

    params: ScoringParams = LOCAL_PARAMS
    bucket_quantum: int = 128
    max_batch: int = 512
    backend: str = "auto"
    dirs_budget: int = 2 << 30  # align_batch chunk cap (bytes of dirs)
    device: str = "cuda"

    score_width = 3

    @staticmethod
    def _dirs_bytes(bm, bn):
        return (bm + bn + 1) * (bn + 1)  # uint8 skew dirs

    @staticmethod
    def _score_fill(a, b, la, lb, params):
        return sw_score(a, b, la, lb, params)

    def score_batch(self, pairs):
        """(scores, end_i, end_j) arrays for all pairs."""
        out = self._scores(pairs)
        return (out[:, 0].copy(), out[:, 1].astype(np.int32),
                out[:, 2].astype(np.int32))

    def _dispatch(self, a, b, la, lb):
        """Queue fill, walk and the device-to-host copies of one chunk on
        the current stream; returns the handles without waiting."""
        max_steps = max(1, int(la.max(initial=0)) + int(lb.max(initial=0)))
        marks = Marks(self._dev)
        t_a, t_b, t_la, t_lb = self._to_dev(a, b, la, lb)
        marks.mark()
        best, dirs = sw_dirs(t_a, t_b, t_la, t_lb, self.params)
        marks.mark()
        ei = best[:, 1].to(torch.int32)
        ej = best[:, 2].to(torch.int32)
        ops, used = local_walk(dirs, ei, ej, max_steps)
        del dirs
        marks.mark()
        pin = self._dev.type == "cuda"
        host = []
        for x in (ops, used, best):
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            buf.copy_(x, non_blocking=pin)
            host.append(buf)
        marks.mark()
        return host, marks, max_steps

    def _emit(self, item, results):
        """Wait for a dispatched chunk and build its results."""
        chunk, a, b, ((ops_h, used_h, best_h), marks, max_steps) = item
        marks.wait()
        for k, name in enumerate(("fill_ms", "walk_ms", "d2h_ms")):
            self.last_phases[name] += marks.ms(k)
        t0 = time.perf_counter()
        used = int(used_h[0])
        if used >= max_steps:
            raise RuntimeError(
                f"local walk ran {used} steps, the bound is {max_steps - 1}:"
                f" corrupt dirs")
        best = best_h.numpy()
        ei = best[:, 1].astype(np.int64)
        ej = best[:, 2].astype(np.int64)
        tt, ii, jj, lens, sa, sb, cigars, extended = walker.local_build(
            ops_h.numpy()[:used].T, ei, ej, a, b)
        for r, k in enumerate(chunk):
            score = float(best[r, 0])
            if score <= 0.0:
                results[k] = LocalAlignmentResult(0.0, 0, 0, 0, 0, [], "", "")
                continue
            L = int(lens[r])
            results[k] = LocalAlignmentResult(
                score=score, start_a=int(sa[r]), start_b=int(sb[r]),
                end_a=int(ei[r]), end_b=int(ej[r]),
                chain=LazyChain(tt[r, :L].copy(), ii[r, :L].copy(),
                                jj[r, :L].copy()),
                cigar=cigars[r], cigar_extended=extended[r])
        self.last_phases["build_ms"] += (time.perf_counter() - t0) * 1e3
