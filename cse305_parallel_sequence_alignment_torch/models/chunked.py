"""Shared driver of the aligners whose dirs stay on the card: local
(models/local.py), semi-global (models/semiglobal.py) and overlap
(models/overlap.py).

Pairs are bucketed by a quantum on both axes (no parity swap) and padded.
``align_batch`` cuts each bucket into equal chunks of at most
``max_batch`` pairs whose dirs fit ``dirs_budget`` bytes, and keeps two
chunks in flight on the current stream: the device fills and walks
chunk c+1 while the host builds the results of chunk c. ``score_batch``
fills chunks of ``max_batch`` pairs with the mode's score kernel only.

A subclass is a dataclass with the fields ``params``, ``bucket_quantum``,
``max_batch``, ``dirs_budget`` and ``device``, and supplies
``_dirs_bytes(bm, bn)`` (one pair's dirs in a bucket), ``_dispatch(a, b,
la, lb)`` (queue one chunk, return its handles without waiting),
``_emit(item, results)`` (wait for a chunk and build its results),
``_score_fill`` and ``score_width`` (the score kernel and its output
width).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.models.batch import (
    _bucket_arrays,
    _buckets,
    _encode_many,
    chunk_size,
)

PHASES = ("prep_ms", "fill_ms", "walk_ms", "d2h_ms", "build_ms")


class ChunkedAligner:
    """``last_phases`` holds the phase times (ms) of the latest
    ``align_batch``: prep and build on the host's clock, fill, walk and
    device-to-host on the device's; ``last_chunks`` its number of
    chunks."""

    score_width = 4

    def __post_init__(self):
        self._dev = torch.device(self.device)
        if self._dev.type not in ("cpu", "cuda"):
            raise ValueError(f"device {self.device!r}: 'cuda' or 'cpu'")
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}(device={self.device!r}) needs a "
                "CUDA card and none is available; pass device='cpu' to run "
                "the plain PyTorch kernels on the CPU")
        self.last_phases = dict.fromkeys(PHASES, 0.0)
        self.last_chunks = 0

    def _prep(self, pairs):
        enc_a = _encode_many([p[0] for p in pairs])
        enc_b = _encode_many([p[1] for p in pairs])
        return enc_a, enc_b, _buckets(enc_a, enc_b, self.bucket_quantum)

    def _to_dev(self, *arrays):
        return [torch.from_numpy(x).to(self._dev) for x in arrays]

    def _scores(self, pairs):
        """(B, score_width) score-fill outputs of all pairs, in input
        order."""
        enc_a, enc_b, buckets = self._prep(pairs)
        out = np.zeros((len(pairs), self.score_width), np.float32)
        for key, idxs in buckets.items():
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                out[chunk] = self._score_chunk(
                    _bucket_arrays(enc_a, enc_b, chunk, key))
        return out

    def _score_chunk(self, arrays):
        """Score-fill outputs (count, score_width) of one padded chunk."""
        return self._score_fill(*self._to_dev(*arrays),
                                self.params).cpu().numpy()

    def chunk_size(self, key, count):
        """Pairs per ``align_batch`` chunk of a bucket of shape ``key``
        holding ``count`` pairs (models/batch.py ``chunk_size``)."""
        return chunk_size(count, self._dirs_bytes(*key), self.max_batch,
                          self.dirs_budget)

    def align_batch(self, pairs):
        """Full alignments of all pairs, as the mode's result objects."""
        t0 = time.perf_counter()
        self.last_phases = dict.fromkeys(PHASES, 0.0)
        self.last_chunks = 0
        enc_a, enc_b, buckets = self._prep(pairs)
        self.last_phases["prep_ms"] += (time.perf_counter() - t0) * 1e3
        results: list = [None] * len(pairs)
        pending: list = []
        for key, idxs in buckets.items():
            step = self.chunk_size(key, len(idxs))
            for s in range(0, len(idxs), step):
                t0 = time.perf_counter()
                chunk = idxs[s: s + step]
                a, b, la, lb = _bucket_arrays(enc_a, enc_b, chunk, key)
                self.last_phases["prep_ms"] += \
                    (time.perf_counter() - t0) * 1e3
                pending.append((chunk, a, b, self._dispatch(a, b, la, lb)))
                self.last_chunks += 1
                # the device fills the next chunk while the host builds
                while len(pending) > 1:
                    self._emit(pending.pop(0), results)
        while pending:
            self._emit(pending.pop(0), results)
        return results
