"""PyTorch + CUDA port of the pairwise alignment framework.

A second package beside ``cse305_parallel_sequence_alignment_tpu`` (the
JAX reference, which it never imports). The ported slices are global
Gotoh alignment of many pairs (match/mismatch or a substitution
matrix), banded global alignment, the balanced partition of one long
pair, and local (Smith-Waterman), semi-global and overlap alignment of
many pairs, on an NVIDIA H100:

- ``core``      scoring parameters, substitution matrices, boundary
                semantics, codec, results
- ``ops``       CUDA kernels (``csrc/``) with their plain PyTorch
                versions: K1 dirs16+runs fill, K3 score fill, K2
                run-length walk (row and band layout), K4d/K4s
                substitution-matrix fills, K12s/K12d band fills, K6
                long fill, K7 single-job last row, K8 pipeline step,
                K9s/K9d local fills, K9w local walk, K10s/K10d
                semi-global and K11s/K11d overlap fills
- ``models``    ``BatchAligner`` (global mode), ``GotohAligner``,
                ``BandedAligner``,
                ``LocalBatchAligner`` (local mode, CIGARs),
                ``SemiGlobalBatchAligner`` and ``OverlapBatchAligner``
- ``parallel``  ``PartitionedAligner`` (balanced partition), the
                column-sharded long-pair pipeline (``longseq_score``,
                ``longseq_lastrow``, ``longseq_score_batch``, kernel K8),
                ``ShardedBatchAligner``/``ShardedLocalBatchAligner``,
                meshes (``make_seq_mesh``, ...) and process groups
                (``init_distributed``)
- ``native``    host replay, render and chain builds (built from
                ``csrc/tsalib.cpp``)
- ``utils``     run configuration, FASTA input, BLOSUM62
- ``api``       ``align``, ``align_pairs``, ``score_pairs``

Nothing heavy is imported until used: ``torch`` loads with ``models``
or ``ops``, and the CUDA kernels are compiled at their first launch.
"""

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    AlignmentResult,
    ScoringParams,
    SubstitutionMatrix,
    decode_seq,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.api import (
    align,
    align_pairs,
    score_pairs,
)

__version__ = "0.1.0"

__all__ = [
    "NEG_INF",
    "AlignmentResult",
    "ScoringParams",
    "SubstitutionMatrix",
    "encode_seq",
    "decode_seq",
    "align",
    "align_pairs",
    "score_pairs",
    "LocalBatchAligner",
    "LocalAlignmentResult",
    "PartitionedAligner",
    "ShardedBatchAligner",
    "ShardedLocalBatchAligner",
    "longseq_score",
    "longseq_lastrow",
    "make_seq_mesh",
    "__version__",
]


def __getattr__(name):
    if name in ("LocalBatchAligner", "LocalAlignmentResult"):
        from cse305_parallel_sequence_alignment_torch.models import local
        return getattr(local, name)
    if name in ("PartitionedAligner", "ShardedBatchAligner",
                "ShardedLocalBatchAligner", "longseq_score",
                "longseq_lastrow", "make_seq_mesh"):
        from cse305_parallel_sequence_alignment_torch import parallel
        return getattr(parallel, name)
    raise AttributeError(name)
