"""Convenience API, global, local, semi-global, overlap and partitioned
modes (the slices of the JAX package's ``api`` that are ported so far):

    align(a, b)                           # one global alignment
    align(a, b, mode="local")             # SW + CIGAR
    align(a, b, mode="semiglobal")        # fit a into b
    align(a, b, mode="overlap")           # dovetail
    align(a, b, mode="partitioned", p=8)  # long-pair decomposition
    align_pairs(pairs, mode=...)          # batched full alignments
    score_pairs(pairs, mode=...)          # batched scores

Every call takes ``device`` ("cuda" by default) and the keyword
arguments of its aligner (``BatchAligner``, ``LocalBatchAligner``,
``SemiGlobalBatchAligner``, ``OverlapBatchAligner``, or
``PartitionedAligner`` for "partitioned"). Local mode scores with
``LOCAL_PARAMS`` and the semi-global and overlap modes with ``g=1, h=2,
match=1, mismatch=-1`` unless ``params`` is given, as the JAX package
does. Banded mode raises ``NotImplementedError`` naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

from cse305_parallel_sequence_alignment_torch.core import ScoringParams

_MODES = ("global", "local", "semiglobal", "overlap", "banded",
          "partitioned")
_LATER = {
    "banded": "queue 1 item 12 (kernel K12)",
}


def _aligner(mode, params, **kw):
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; pick from {_MODES}")
    if mode == "partitioned":
        raise ValueError("mode 'partitioned' is not batchable; use align()")
    if mode in _LATER:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: ROADMAP {_LATER[mode]}")
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


def align(a, b, mode="global", params=None, p=None, **kw):
    """One pairwise alignment; returns the mode's result object
    (``AlignmentResult``, ``LocalAlignmentResult``, ``SemiGlobalResult``
    or ``OverlapResult``)."""
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
