"""Aligner families ported so far: the bucketed global ``BatchAligner``,
the single-pair ``GotohAligner``, and the bucketed ``LocalBatchAligner``,
``SemiGlobalBatchAligner`` and ``OverlapBatchAligner``."""


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


__all__ = ["BatchAligner", "GotohAligner", "LocalBatchAligner",
           "LocalAlignmentResult", "SemiGlobalBatchAligner",
           "SemiGlobalResult", "OverlapBatchAligner", "OverlapResult",
           "OVERLAP_PARAMS"]
