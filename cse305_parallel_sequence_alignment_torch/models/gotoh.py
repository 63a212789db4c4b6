"""Single-pair global affine-gap aligner (Gotoh) as a batch of one.

The counterpart of the JAX package's ``GotohAligner``: the same boundary
types, parity swap and reference-format rows, run through the port's
``BatchAligner`` (K1 fill, K2 walk, K3 score fill) on ``device``.
"""

from __future__ import annotations

import dataclasses

from cse305_parallel_sequence_alignment_torch.core import (
    AlignmentResult,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)


@dataclasses.dataclass
class GotohAligner:
    """Global pairwise aligner with affine gaps.

    ``parity_swap`` mirrors the reference constructor's role swap for
    m > n (quirk B8, subproblem_alignment.h:37-54) so outputs stay
    byte-equal; set False for orientation-preserving behaviour.
    """

    params: ScoringParams = ScoringParams()
    start_type: int = -1
    end_type: int = -1
    parity_swap: bool = True
    device: str = "cuda"

    def _batch(self):
        return BatchAligner(params=self.params, start_type=self.start_type,
                            end_type=self.end_type,
                            parity_swap=self.parity_swap, device=self.device)

    def score(self, a, b) -> float:
        """Boundary-adjusted optimal score (end-table choice applied)."""
        scores, _ = self._batch().score_batch([(a, b)])
        return float(scores[0])

    def align(self, a, b, id_a=0, id_b=0) -> AlignmentResult:
        """Full alignment; ``id_a``/``id_b`` offset the chain's
        coordinates (gap points keep their stored 0, quirk B2), the rows
        are those of the local problem."""
        res = self._batch().align_batch([(a, b)])[0]
        if id_a or id_b:
            res.chain = [(i + id_a if t != 2 else 0,
                          j + id_b if t != 3 else 0, t)
                         for (i, j, t) in res.chain]
        return res
