"""Aligner families ported so far: the bucketed global ``BatchAligner``
(match/mismatch or a substitution matrix), the single-pair
``GotohAligner`` and ``BandedAligner``, and the bucketed
``LocalBatchAligner``, ``SemiGlobalBatchAligner`` and
``OverlapBatchAligner``."""


def __getattr__(name):
    if name == "BatchAligner":
        from cse305_parallel_sequence_alignment_torch.models.batch import (
            BatchAligner,
        )
        return BatchAligner
    if name == "GotohAligner":
        from cse305_parallel_sequence_alignment_torch.models.gotoh import (
            GotohAligner,
        )
        return GotohAligner
    if name == "BandedAligner":
        from cse305_parallel_sequence_alignment_torch.models.banded import (
            BandedAligner,
        )
        return BandedAligner
    if name in ("LocalBatchAligner", "LocalAlignmentResult"):
        from cse305_parallel_sequence_alignment_torch.models import local
        return getattr(local, name)
    if name in ("SemiGlobalBatchAligner", "SemiGlobalResult"):
        from cse305_parallel_sequence_alignment_torch.models import (
            semiglobal,
        )
        return getattr(semiglobal, name)
    if name in ("OverlapBatchAligner", "OverlapResult", "OVERLAP_PARAMS"):
        from cse305_parallel_sequence_alignment_torch.models import overlap
        return getattr(overlap, name)
    raise AttributeError(name)


__all__ = ["BatchAligner", "GotohAligner", "BandedAligner",
           "LocalBatchAligner",
           "LocalAlignmentResult", "SemiGlobalBatchAligner",
           "SemiGlobalResult", "OverlapBatchAligner", "OverlapResult",
           "OVERLAP_PARAMS"]
