"""The port's API surface against the JAX package's, on the CPU.

Overlap ``align`` on an empty B, ``AlignmentResult.cigar()``, the
``backend`` field of the mode aligners and ``PartitionedAligner``'s
``long_threshold``: the same seeded inputs through both packages (the
JAX package on the CPU takes its XLA routes), results equal exactly.
"""

import numpy as np
import pytest

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.models.banded import (
    BandedAligner,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.overlap import (
    OverlapBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
    SemiGlobalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.parallel.batch_shard import (
    ShardedLocalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    make_data_mesh,
)
from cse305_parallel_sequence_alignment_torch.parallel.partition import (
    PartitionedAligner,
)
from cse305_parallel_sequence_alignment_tpu import api as jax_api
from cse305_parallel_sequence_alignment_tpu import core as jax_core
from cse305_parallel_sequence_alignment_tpu.models import (
    banded as jax_banded,
)
from cse305_parallel_sequence_alignment_tpu.models import local as jax_local
from cse305_parallel_sequence_alignment_tpu.models import (
    overlap as jax_overlap,
)
from cse305_parallel_sequence_alignment_tpu.models import (
    semiglobal as jax_semiglobal,
)
from cse305_parallel_sequence_alignment_tpu.parallel import (
    partition as jax_partition,
)

ACGT = list("ACGT")


def dna(rng, n):
    return "".join(rng.choice(ACGT, n))


def free_tuple(r):
    spans = (r.a_span, r.b_span) if hasattr(r, "a_span") else r.target_span
    return (r.score, list(r.chain), r.cigar, spans, r.end_table)


def test_overlap_empty_b_in_a_mixed_bucket():
    """Pairs with an empty B, one empty pair and ordinary pairs in one
    bucket: the port's align_batch equals the JAX package's and its own
    score_batch (an empty B: 0.0, table 1, end (1, 0))."""
    rng = np.random.default_rng(43)
    pairs = [(dna(rng, 60), ""), (dna(rng, 90), dna(rng, 70)), ("A", ""),
             ("", ""), (dna(rng, 40), dna(rng, 100)), ("", dna(rng, 9)),
             (dna(rng, 120), "")]
    got = api.align_pairs(pairs, mode="overlap", device="cpu")
    want = jax_api.align_pairs(pairs, mode="overlap")
    assert [free_tuple(r) for r in got] == [free_tuple(r) for r in want]
    assert [r.score for r in got][:4] == [0.0, got[1].score, 0.0,
                                          float("-inf")]
    scores, tables, eis, ejs = OverlapBatchAligner(
        device="cpu").score_batch(pairs)
    assert scores.tolist() == [r.score for r in got]
    assert tables.tolist() == [r.end_table for r in got]
    assert (eis[0], ejs[0]) == (1, 0)


def parse_chain(text):
    return [tuple(int(x) for x in p.split(","))
            for p in text.strip("()").split(")(")] if text else []


def test_cigar_matches_jax_on_golden(golden_subproblem, golden_pipeline):
    """``AlignmentResult.cigar()`` = the JAX method, on every golden
    chain: the subproblem cases' and the pipeline cases' (the port's
    full-traceback chains)."""
    seen = 0
    for recs, kw in ((golden_subproblem, "sub"), (golden_pipeline, "pipe")):
        for gh in sorted({(r["g"], r["h"]) for r in recs}):
            grp = [r for r in recs if (r["g"], r["h"]) == gh]
            extra = {}
            if kw == "sub":
                extra = dict(start_types=[r["start"] for r in grp],
                             end_types=[r["end"] for r in grp])
            res = BatchAligner(params=ScoringParams(g=gh[0], h=gh[1]),
                               device="cpu").align_batch(
                [(r["A"], r["B"]) for r in grp], **extra)
            for r, got in zip(grp, res):
                if kw == "sub":
                    assert list(got.chain) == parse_chain(r["chain"])
                ref = jax_core.AlignmentResult(score=got.score,
                                               chain=list(got.chain))
                assert got.cigar() == ref.cigar()
                seen += 1
    assert seen == len(golden_subproblem) + len(golden_pipeline)
    assert BatchAligner(device="cpu").align_batch(
        [("AGGA", "AGTGC")])[0].cigar() == "2M1D2M"


def local_tuple(r):
    return (r.score, list(r.chain), r.cigar, r.cigar_extended)


PAIRS = [(dna(np.random.default_rng(s), 30 + 7 * s),
          dna(np.random.default_rng(100 + s), 50 + 5 * s)) for s in range(5)]
BACKENDS = ("auto", "pallas", "wavefront")


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX aligners' results on PAIRS (on the CPU "auto" takes their
    XLA routes)."""
    band = [jax_banded.BandedAligner(w_lo=40, w_hi=40).align(a, b)
            for a, b in PAIRS[:2]]
    return dict(
        local=[local_tuple(r) for r in
               jax_local.LocalBatchAligner().align_batch(PAIRS)],
        semiglobal=[free_tuple(r) for r in
                    jax_semiglobal.SemiGlobalBatchAligner().align_batch(
                        PAIRS)],
        overlap=[free_tuple(r) for r in
                 jax_overlap.OverlapBatchAligner().align_batch(PAIRS)],
        sg_scores=[x.tolist() for x in jax_semiglobal.SemiGlobalBatchAligner(
            backend="wavefront").score_batch(PAIRS)],
        ov_scores=[x.tolist() for x in jax_overlap.OverlapBatchAligner(
            backend="wavefront").score_batch(PAIRS)],
        banded=[(r.score, list(r.chain), r.aligned_a, r.aligned_b)
                for r in band],
        local_scores=[x.tolist() for x in jax_local.LocalBatchAligner(
            backend="wavefront").score_batch(PAIRS)])


@pytest.mark.parametrize("backend", BACKENDS)
def test_local_backend_values(jax_refs, backend):
    got = LocalBatchAligner(backend=backend, device="cpu").align_batch(PAIRS)
    assert [local_tuple(r) for r in got] == jax_refs["local"]
    mesh = make_data_mesh(2, device="cpu")
    sh = ShardedLocalBatchAligner(backend=backend, mesh=mesh, device="cpu")
    assert [x.tolist() for x in sh.score_batch(PAIRS)] == \
        jax_refs["local_scores"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["semiglobal", "overlap"])
def test_free_end_backend_values(jax_refs, mode, backend):
    cls = SemiGlobalBatchAligner if mode == "semiglobal" else \
        OverlapBatchAligner
    al = cls(backend=backend, device="cpu")
    scores = [x.tolist() for x in al.score_batch(PAIRS)]
    assert scores == jax_refs["sg_scores" if mode == "semiglobal"
                              else "ov_scores"]
    if backend == "wavefront":
        # the JAX route is the anti-diagonal dirs fill, not ported
        with pytest.raises(NotImplementedError, match="item 15"):
            al.align_batch(PAIRS)
    else:
        assert [free_tuple(r) for r in al.align_batch(PAIRS)] == \
            jax_refs[mode]


@pytest.mark.parametrize("backend", BACKENDS)
def test_banded_backend_values(jax_refs, backend):
    al = BandedAligner(w_lo=40, w_hi=40, backend=backend, device="cpu")
    got = [al.align(a, b) for a, b in PAIRS[:2]]
    assert [(r.score, list(r.chain), r.aligned_a, r.aligned_b)
            for r in got] == jax_refs["banded"]


@pytest.mark.parametrize("cls", [LocalBatchAligner, SemiGlobalBatchAligner,
                                 OverlapBatchAligner, BandedAligner,
                                 ShardedLocalBatchAligner])
def test_backend_refuses_unknown_values(cls):
    """Anything but the three values raises ValueError on the port (the
    JAX aligners take it and run their "auto" route)."""
    assert cls(device="cpu").backend == "auto"
    with pytest.raises(ValueError, match="backend"):
        cls(backend="rowdirs", device="cpu")


@pytest.fixture(scope="module")
def long_pair():
    rng = np.random.default_rng(47)
    a = dna(rng, 150)
    b = list(a[:140] + dna(rng, 30))
    for k in rng.integers(0, len(b), 12):
        b[k] = ACGT[int(rng.integers(0, 4))]
    return a, "".join(b)


@pytest.mark.parametrize("side", ["above", "below"])
def test_long_threshold_crossings_match_jax(long_pair, side):
    """The crossing points equal the JAX package's with the grid above
    and below ``long_threshold`` (on the port both sides run K6)."""
    a, b = long_pair
    cells = len(a) * len(b)
    t = cells - 1 if side == "above" else cells + 1
    got = PartitionedAligner(p=4, long_threshold=t,
                             device="cpu").partition(a, b)
    want = jax_partition.PartitionedAligner(p=4,
                                            long_threshold=t).partition(a, b)
    assert [tuple(int(x) for x in p) for p in got] == \
        [tuple(int(x) for x in p) for p in want]
    res = PartitionedAligner(p=4, long_threshold=t, device="cpu").align(a, b)
    assert res.score == jax_partition.PartitionedAligner(
        p=4, long_threshold=t).align(a, b).score


def test_long_threshold_field():
    assert PartitionedAligner(device="cpu").long_threshold == \
        jax_partition.PartitionedAligner().long_threshold == 16 * 1024 * 1024
    assert PartitionedAligner(long_threshold=0, device="cpu").long_threshold \
        == 0
    for bad in (-1, 2.5, True, "16"):
        with pytest.raises(ValueError, match="long_threshold"):
            PartitionedAligner(long_threshold=bad, device="cpu")
