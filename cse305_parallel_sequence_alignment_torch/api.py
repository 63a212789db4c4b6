"""Convenience API over every alignment mode (the JAX package's
``api``):

    align(a, b)                           # one global alignment
    align(a, b, mode="local")             # SW + CIGAR
    align(a, b, mode="semiglobal")        # fit a into b
    align(a, b, mode="overlap")           # dovetail
    align(a, b, mode="banded", band=64)   # banded global
    align(a, b, mode="partitioned", p=8)  # long-pair decomposition
    align_pairs(pairs, mode=...)          # batched full alignments
    score_pairs(pairs, mode=...)          # batched scores

Every call takes ``device`` ("cuda" by default) and the keyword
arguments of its aligner (``BatchAligner``, ``LocalBatchAligner``,
``SemiGlobalBatchAligner``, ``OverlapBatchAligner``, or, in ``align``
only, ``BandedAligner`` for "banded" and ``PartitionedAligner`` for
"partitioned"). Local mode scores with ``LOCAL_PARAMS`` and the
semi-global and overlap modes with ``g=1, h=2, match=1, mismatch=-1``
unless ``params`` is given, as the JAX package does. Banded mode widens
``band`` (64 by default) by |m - n| on both sides.
"""

from __future__ import annotations

from cse305_parallel_sequence_alignment_torch.core import ScoringParams

_MODES = ("global", "local", "semiglobal", "overlap", "banded",
          "partitioned")


def _aligner(mode, params, **kw):
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {_MODES}")
    if mode in ("banded", "partitioned"):
        raise ValueError(f"mode {mode!r} is not batchable; use align()")
    if mode == "local":
        from cse305_parallel_sequence_alignment_torch.models.local import (
            LOCAL_PARAMS,
            LocalBatchAligner,
        )
        return LocalBatchAligner(params=params or LOCAL_PARAMS, **kw)
    if mode == "semiglobal":
        from cse305_parallel_sequence_alignment_torch.models.semiglobal \
            import FREE_END_PARAMS, SemiGlobalBatchAligner
        return SemiGlobalBatchAligner(params=params or FREE_END_PARAMS,
                                      **kw)
    if mode == "overlap":
        from cse305_parallel_sequence_alignment_torch.models.overlap import (
            OVERLAP_PARAMS,
            OverlapBatchAligner,
        )
        return OverlapBatchAligner(params=params or OVERLAP_PARAMS, **kw)
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    return BatchAligner(params=params or ScoringParams(), **kw)


def align(a, b, mode="global", params=None, band=None, p=None, **kw):
    """One pairwise alignment; returns the mode's result object
    (``AlignmentResult``, with ``edge_touched`` in banded mode,
    ``LocalAlignmentResult``, ``SemiGlobalResult`` or
    ``OverlapResult``)."""
    if mode == "banded":
        from cse305_parallel_sequence_alignment_torch.models.banded import (
            BandedAligner,
        )
        w = (band if band is not None else 64) + abs(len(a) - len(b))
        return BandedAligner(params=params or ScoringParams(), w_lo=w,
                             w_hi=w, **kw).align(a, b)
    if mode == "partitioned":
        from cse305_parallel_sequence_alignment_torch.parallel.partition \
            import PartitionedAligner
        return PartitionedAligner(params=params or ScoringParams(),
                                  p=p or 4, **kw).align(a, b)
    return _aligner(mode, params, **kw).align_batch([(a, b)])[0]


def align_pairs(pairs, mode="global", params=None, **kw):
    """Batched full alignments."""
    return _aligner(mode, params, **kw).align_batch(pairs)


def score_pairs(pairs, mode="global", params=None, **kw):
    """Batched scores: the mode's ``score_batch`` tuple, (scores,
    end_tables) in global mode, (scores, end_i, end_j) in local mode,
    (scores, end_tables, end_js) in semi-global mode and (scores,
    end_tables, end_is, end_js) in overlap mode."""
    return _aligner(mode, params, **kw).score_batch(pairs)
