"""Aligner families ported so far: the bucketed global ``BatchAligner``
and the single-pair ``GotohAligner``."""


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
    raise AttributeError(name)


__all__ = ["BatchAligner", "GotohAligner"]
