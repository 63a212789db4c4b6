"""Bucketed batched Smith-Waterman local aligner (affine gaps) + CIGARs.

The port of the JAX package's ``models/local.py`` (BASELINE config 3:
batch SW with verified traceback CIGARs). Pairs are bucketed by a
quantum on both axes (no parity swap: local mode has no reference
quirks) and padded. ``align_batch`` runs, per chunk of a bucket whose
dirs fit ``dirs_budget``: the K9d fill (ops/local.py) with its skew dirs
and best cells, the K9w walk (ops/device_walk.py) from each best cell,
and a copy of only the walk's table streams and the best values to
pinned host memory; the dirs never leave the card. The host then builds
chains, spans and CIGARs in the native library (native/walker.py
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
from cse305_parallel_sequence_alignment_torch.models.batch import (
    _bucket_arrays,
    _buckets,
    _encode_many,
    _Marks,
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


PHASES = ("fill_ms", "walk_ms", "d2h_ms", "build_ms")


@dataclasses.dataclass
class LocalBatchAligner:
    """Aligns many pairs locally, length-bucketed like BatchAligner.

    ``max_batch`` caps pairs per launch and ``dirs_budget`` the bytes of
    one chunk's dirs. ``device`` is where the kernels run.
    ``last_phases`` holds the phase times (ms) of the latest
    ``align_batch``: fill, walk and device-to-host on the device's clock,
    the chain and CIGAR build on the host's; ``last_chunks`` its number
    of chunks.
    """

    params: ScoringParams = LOCAL_PARAMS
    bucket_quantum: int = 128
    max_batch: int = 512
    dirs_budget: int = 2 << 30  # align_batch chunk cap (bytes of dirs)
    device: str = "cuda"

    def __post_init__(self):
        self._dev = torch.device(self.device)
        if self._dev.type not in ("cpu", "cuda"):
            raise ValueError(f"device {self.device!r}: 'cuda' or 'cpu'")
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"LocalBatchAligner(device={self.device!r}) needs a CUDA "
                "card and none is available; pass device='cpu' to run the "
                "plain PyTorch kernels on the CPU")
        self.last_phases = dict.fromkeys(PHASES, 0.0)
        self.last_chunks = 0

    def _prep(self, pairs):
        enc_a = _encode_many([p[0] for p in pairs])
        enc_b = _encode_many([p[1] for p in pairs])
        return enc_a, enc_b, _buckets(enc_a, enc_b, self.bucket_quantum)

    def _to_dev(self, *arrays):
        return [torch.from_numpy(x).to(self._dev) for x in arrays]

    def score_batch(self, pairs):
        """(scores, end_i, end_j) arrays for all pairs."""
        enc_a, enc_b, buckets = self._prep(pairs)
        scores = np.zeros(len(pairs), np.float32)
        ei = np.zeros(len(pairs), np.int32)
        ej = np.zeros(len(pairs), np.int32)
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                arrays = _bucket_arrays(enc_a, enc_b, chunk, key)
                best = sw_score(*self._to_dev(*arrays),
                                self.params).cpu().numpy()
                scores[chunk] = best[:, 0]
                ei[chunk] = best[:, 1].astype(np.int32)
                ej[chunk] = best[:, 2].astype(np.int32)
        return scores, ei, ej

    def align_batch(self, pairs):
        """Full local alignments with CIGARs for all pairs."""
        enc_a, enc_b, buckets = self._prep(pairs)
        results: list = [None] * len(pairs)
        self.last_phases = dict.fromkeys(PHASES, 0.0)
        self.last_chunks = 0
        pending: list = []
        for key, idxs in buckets.items():
            bm, bn = key
            per_pair = (bm + bn + 1) * (bn + 1)  # uint8 skew dirs
            step = max(1, min(self.max_batch,
                              self.dirs_budget // per_pair))
            if step < len(idxs):
                # equal chunks: a ragged tail pays a whole sweep for little
                nchunks = -(-len(idxs) // step)
                step = -(-len(idxs) // nchunks)
            for s in range(0, len(idxs), step):
                chunk = idxs[s: s + step]
                a, b, la, lb = _bucket_arrays(enc_a, enc_b, chunk, key)
                pending.append((chunk, a, b, self._dispatch(a, b, la, lb)))
                self.last_chunks += 1
                # the device fills the next chunk while the host builds
                while len(pending) > 1:
                    self._emit(pending.pop(0), results)
        while pending:
            self._emit(pending.pop(0), results)
        return results

    def _dispatch(self, a, b, la, lb):
        """Queue fill, walk and the device-to-host copies of one chunk on
        the current stream; returns the handles without waiting."""
        max_steps = max(1, int(la.max(initial=0)) + int(lb.max(initial=0)))
        marks = _Marks(self._dev)
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
        for k, name in enumerate(PHASES[:3]):
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
