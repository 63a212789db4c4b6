"""Bucketed batched overlap (dovetail) aligner.

The port of the JAX package's ``models/overlap.py``: suffix(A) against
prefix(B), or prefix(A) against suffix(B), with both outer ends free,
the suffix-prefix primitive of overlap-layout assemblers. ``align_batch``
runs the K11d fill (ops/rowcb.py ``overlap_dirs``), the K2 run-length
walk from each best edge cell and the native chain build, chunked and
pipelined as the semi-global aligner does (models/semiglobal.py
``FreeEndAligner``). ``score_batch`` runs the K11s score fill
(ops/diag.py ``overlap_score``), the port of the XLA wavefront that the
JAX aligner's ``score_batch`` runs on every backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
    FREE_END_PARAMS,
    FreeEndAligner,
)
from cse305_parallel_sequence_alignment_torch.ops.diag import overlap_score
from cse305_parallel_sequence_alignment_torch.ops.rowcb import overlap_dirs

OVERLAP_PARAMS = FREE_END_PARAMS


@dataclasses.dataclass
class OverlapResult:
    score: float
    chain: list
    cigar: str
    # spans of the aligned cores (1-based inclusive)
    a_span: tuple
    b_span: tuple
    end_table: int


@dataclasses.dataclass
class OverlapBatchAligner(FreeEndAligner):
    """Aligns many pairs in overlap mode, length-bucketed.

    ``max_batch`` caps pairs per launch and ``dirs_budget`` the bytes of
    one chunk's dirs. ``backend``: see ``FreeEndAligner``. ``device`` is
    where the kernels run.

    A pair with an empty B and a non-empty A gets (score 0.0, table 1,
    end (1, 0)) from ``align_batch``, the best that its own
    ``score_batch`` gives (T1 = 0 down column 0): the row-sweep fill
    K11d, bit-equal to the TPU kernel ``_ov_rowdirs_kernel``, scans column
    lb only when lb >= 1 and gives -inf there."""

    params: ScoringParams = OVERLAP_PARAMS
    bucket_quantum: int = 128
    max_batch: int = 512
    backend: str = "auto"
    dirs_budget: int = 2 << 30  # align_batch chunk cap (bytes of dirs)
    device: str = "cuda"

    mode = "overlap"

    @staticmethod
    def _dirs_fill(a, b, la, lb, params):
        dirs, best = overlap_dirs(a, b, la, lb, params)
        # an empty B: score_batch's best, (0.0, table 1, end (1, 0))
        empty_b = ((lb == 0) & (la >= 1))[:, None]
        fix = torch.zeros(4, device=best.device)  # no host copy a chunk
        fix[1:3] = 1.0
        return dirs, torch.where(empty_b, fix, best)

    @staticmethod
    def _score_fill(a, b, la, lb, params):
        return overlap_score(a, b, la, lb, params)

    @staticmethod
    def _result(best, chain, span, cigar, extended):
        return OverlapResult(
            score=best[0], chain=chain, cigar=cigar,
            a_span=(span[0], span[1]), b_span=(span[2], span[3]),
            end_table=int(best[1]))

    def score_batch(self, pairs):
        """(scores, end_tables, end_is, end_js) for all pairs (K11s)."""
        out = self._scores(pairs)
        return (out[:, 0].copy(), out[:, 1].astype(np.int32),
                out[:, 2].astype(np.int32), out[:, 3].astype(np.int32))
