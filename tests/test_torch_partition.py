"""The port's balanced partition, ``PartitionedAligner``, the long-bucket
routes of ``BatchAligner``, the api's partitioned mode and the CLI
``partition``/``longscore`` on the CPU == the JAX package's.

The JAX side runs as its own tests run it on the CPU (rowscan crossing
search, wavefront segment solves, Pallas long fill in interpret mode).
Points, scores, chains, rows and end tables must be equal.

The port's partition is also optimal where the JAX package's is not: on
every pair its score is ``align_batch``'s and the benchmark's plain
PyTorch reference's (``seqbench/reference/gotoh.py``), and its end table
theirs. Where the JAX package scores below the optimum, the count of
such cases is pinned. The stitch on arrays equals the loop it replaced.
"""

import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    LazyChain,
    ScoringParams,
    encode_seq,
    format_alignment,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.parallel import partition
from cse305_parallel_sequence_alignment_tpu import api as jax_api
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.models.batch import (
    BatchAligner as JaxBatchAligner,
)
from cse305_parallel_sequence_alignment_tpu.parallel import (
    partition as jax_partition,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rand_pair(rng, m, n):
    return ("".join(rng.choice(list("ACGT"), m)),
            "".join(rng.choice(list("ACGT"), n)))


def same_result(got, want):
    assert got.score == want.score
    assert list(got.chain) == list(want.chain)
    assert (got.aligned_a, got.aligned_b) == (want.aligned_a,
                                              want.aligned_b)
    assert got.end_table == want.end_table


def test_crossing_on_row_matches_jax():
    rng = np.random.default_rng(23)
    for (m, n, st, en) in [(60, 90, -1, -1), (45, 70, 1, -1),
                           (33, 40, 2, 3), (80, 30, 3, 1), (1, 50, -1, 2)]:
        a, b = (encode_seq(s) for s in rand_pair(rng, m, n))
        want = jax_partition.crossing_on_row(a, b, m // 2, JaxParams(), st,
                                             en)
        got = partition.crossing_on_row(a, b, m // 2, ScoringParams(), st,
                                        en, device="cpu")
        assert got == want, (m, n, st, en)


def test_balanced_partition_matches_jax():
    """Level-batched (K6/K7) and serial (K6 last rows) bisection give the
    JAX package's points."""
    rng = np.random.default_rng(31)
    a, b = (encode_seq(s) for s in rand_pair(rng, 210, 290))
    for p in (5, 8):
        want = jax_partition.balanced_partition(a, b, p, JaxParams())
        serial = partition.balanced_partition(a, b, p, ScoringParams(),
                                              device="cpu")
        batched = partition.balanced_partition(
            a, b, p, ScoringParams(), device="cpu",
            crossings_fn=lambda tasks: partition.batched_crossings(
                tasks, ScoringParams(), device="cpu"))
        assert serial == want and batched == want, p


@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_partitioned_aligner_matches_jax(p):
    rng = np.random.default_rng(32)
    for (m, n) in [(40, 40), (33, 57), (64, 48)]:
        a, b = rand_pair(rng, m, n)
        want = jax_partition.PartitionedAligner(p=p).align(a, b)
        got = partition.PartitionedAligner(p=p, device="cpu").align(a, b)
        same_result(got, want)


def test_partitioned_aligner_auto_p_and_params():
    rng = np.random.default_rng(33)
    a, b = rand_pair(rng, 120, 150)
    al = partition.PartitionedAligner(p=0, mem_budget=8000, device="cpu")
    assert al._pick_p(120, 150) == jax_partition.PartitionedAligner(
        p=0, mem_budget=8000)._pick_p(120, 150) >= 4
    same_result(al.align(a, b), jax_partition.PartitionedAligner(
        p=0, mem_budget=8000).align(a, b))
    for (g, h) in [(2, 1), (1, 0), (3, 5)]:
        a, b = rand_pair(rng, 50, 45)
        want = jax_partition.PartitionedAligner(
            params=JaxParams(g=g, h=h), p=4).align(a, b)
        got = partition.PartitionedAligner(
            params=ScoringParams(g=g, h=h), p=4, device="cpu").align(a, b)
        same_result(got, want)


@pytest.mark.parametrize("fill_backend", ["auto", "rowscan"])
def test_partitioned_aligner_medium_grid(fill_backend):
    """300 x 400 at p=8, end to end; both crossing searches."""
    rng = np.random.default_rng(34)
    a, b = rand_pair(rng, 300, 400)
    want = jax_partition.PartitionedAligner(p=8).align(a, b)
    al = partition.PartitionedAligner(p=8, fill_backend=fill_backend,
                                      device="cpu")
    got = al.align(a, b)
    same_result(got, want)
    assert list(al.last_phases) == list(partition.PHASES
                                        + partition.COUNTERS)
    # K6 launches: one a level, or one a unique job of the level
    assert all(v > 0 for v in al.last_phases.values())
    assert al.last_phases["crossing_levels"] == 3
    assert al.last_phases["crossing_launches"] == (
        3 if fill_backend == "auto" else al.last_phases["strip_jobs"])
    assert got.score == partition.score_chain(encode_seq(a), encode_seq(b),
                                              got.chain)
    assert got.aligned_a.replace("-", "") == a
    assert got.aligned_b.replace("-", "") == b


def test_batch_aligner_long_buckets_match_jax():
    """Buckets wider than long_threshold: score_batch through K6 (equal to
    the JAX long fill and the wavefront), align_batch through K1."""
    rng = np.random.default_rng(11)
    pairs = [rand_pair(rng, 600, 700) for _ in range(3)]
    pairs += [rand_pair(rng, 90, 700), rand_pair(rng, 700, 40)]
    port = BatchAligner(device="cpu", long_threshold=512)
    s_p, t_p = port.score_batch(pairs)
    for backend in ("pallas", "wavefront"):
        s_j, t_j = JaxBatchAligner(backend=backend,
                                   long_threshold=512).score_batch(pairs)
        assert np.array_equal(s_p, s_j) and np.array_equal(t_p, t_j)
    want = JaxBatchAligner(backend="wavefront").align_batch(pairs)
    got = port.align_batch(pairs)
    for g, w in zip(got, want):
        same_result(g, w)
    assert np.array_equal(s_p, [r.score for r in got])


def test_api_partitioned_matches_jax():
    rng = np.random.default_rng(35)
    a, b = rand_pair(rng, 70, 90)
    same_result(api.align(a, b, mode="partitioned", device="cpu"),
                jax_api.align(a, b, mode="partitioned"))
    same_result(api.align(a, b, mode="partitioned", p=3, device="cpu"),
                jax_api.align(a, b, mode="partitioned", p=3))
    with pytest.raises(ValueError):
        api.align_pairs([(a, b)], mode="partitioned", device="cpu")


def test_cli_partition_matches_jax_cli(capsys):
    from cse305_parallel_sequence_alignment_torch.__main__ import (
        main as port_main,
    )
    from cse305_parallel_sequence_alignment_tpu.__main__ import (
        main as jax_main,
    )

    rng = np.random.default_rng(36)
    a, b = rand_pair(rng, 80, 110)
    argv = ["partition", "--a", a, "--b", b, "--p", "4"]
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == 2


def test_cli_longscore_subprocess():
    rng = np.random.default_rng(37)
    a, b = rand_pair(rng, 150, 400)
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         "longscore", "--a", a, "--b", b, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.splitlines()[-1])
    want, tables = JaxBatchAligner(backend="wavefront").score_batch([(a, b)])
    assert (rec["score"], rec["end_table"]) == (float(want[0]),
                                                int(tables[0]))
    assert (rec["m"], rec["n"], rec["devices"]) == (150, 400, 1)


# pairs on which the JAX package's partition scores below the optimum
# (g = 1, h = 2): (A, B, optimum)
FAULT_PAIRS = {
    "A": ("GCCAATGTAGATTATAAGGAATGGGCG", "GTAGTAATTCTGACCTGAC", -3.0),
    "B": ("GAACTGTATC", "AAGCTCGTACCAGGCCACGT", -7.0),
}
# of the six (pair, p) cases of FAULT_PAIRS at p = 2, 4 and 8: all but A at
# p = 2 (jax 0.9.0)
JAX_BELOW_OPTIMUM = 5


def oriented(a, b):
    """The pair's codes as the aligners swap it: the shorter first."""
    ea, eb = encode_seq(a), encode_seq(b)
    return (eb, ea) if len(ea) > len(eb) else (ea, eb)


def reference_ends(pairs):
    """(scores, end tables) of the pairs by the benchmark's plain PyTorch
    reference, loaded by path: the optimum, and of the tables that reach
    it the first in the order T1, T2, T3."""
    spec = importlib.util.spec_from_file_location(
        "seqbench_reference_gotoh", ROOT / "seqbench" / "reference" /
        "gotoh.py")
    gotoh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gotoh)
    lut = np.full(256, -1, np.int64)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    fin = gotoh.finals([tuple(lut[x] for x in oriented(a, b))
                        for a, b in pairs], np.eye(4), 1.0, 2.0,
                       device="cpu")
    best = fin.max(axis=1)
    return best, np.argmax(fin >= best[:, None], axis=1) + 1


def row_score(row_a, row_b, params=ScoringParams()):
    """The score of an alignment read off its two rendered rows alone."""
    ra = np.frombuffer(row_a.encode(), np.uint8)
    rb = np.frombuffer(row_b.encode(), np.uint8)
    kind = np.where(ra == ord("-"), 2, np.where(rb == ord("-"), 3, 1))
    opens = (kind != 1) & (kind != np.concatenate([[0], kind[:-1]]))
    same = (kind == 1) & (ra == rb)
    return (params.match * same.sum()
            + params.mismatch * ((kind == 1) & ~same).sum()
            - params.g * (kind != 1).sum() - params.h * opens.sum())


def check_optimal(got, a, b, score, table):
    """``got`` scores ``score``, ends in ``table``, and its chain and rows
    are a path of the pair that scores as much."""
    ea, eb = oriented(a, b)
    assert (got.score, got.end_table) == (score, table)
    assert partition.score_chain(ea, eb, list(got.chain)) == score
    assert row_score(got.aligned_a, got.aligned_b) == score
    assert (got.aligned_a, got.aligned_b) == format_alignment(
        bytes(ea), bytes(eb), list(got.chain))
    assert got.aligned_a.replace("-", "") == bytes(ea).decode()
    assert got.aligned_b.replace("-", "") == bytes(eb).decode()
    assert got.chain[-1][2] == table


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(FAULT_PAIRS))
def test_partition_is_optimal_on_the_fault_pairs(name, p):
    a, b, best = FAULT_PAIRS[name]
    (want,) = BatchAligner(device="cpu").align_batch([(a, b)])
    ref_score, ref_table = reference_ends([(a, b)])
    assert want.score == ref_score[0] == best
    assert want.end_table == ref_table[0]
    for fill_backend in ("auto", "rowscan"):
        got = partition.PartitionedAligner(
            p=p, fill_backend=fill_backend, device="cpu").align(a, b)
        check_optimal(got, a, b, best, want.end_table)


def test_jax_partition_below_optimum_recorded():
    """The JAX package's partition (not repaired: its crossing combine sees
    only paths that enter and leave the middle row's cell by steps of one
    table) scores below the optimum on the fault pairs; where it does
    not, the two agree in every field."""
    below = 0
    for a, b, best in FAULT_PAIRS.values():
        for p in (2, 4, 8):
            want = jax_partition.PartitionedAligner(p=p).align(a, b)
            got = partition.PartitionedAligner(p=p, device="cpu").align(a, b)
            assert got.score == best >= want.score
            if want.score < best:
                below += 1
            else:
                same_result(got, want)
    assert below == JAX_BELOW_OPTIMUM


@pytest.mark.parametrize("p", [2, 4])
def test_partition_ends_in_t2_before_t3(p):
    """Where T1 ends no optimal path and T2 and T3 both do, the free end
    picks T2, as ``align_batch`` does: the bisection that ended in T3 is
    run again with its end forced to T2, one more level of fills."""
    params = ScoringParams(g=0.5, h=0.0, mismatch=-2.0)
    (want,) = BatchAligner(params=params, device="cpu").align_batch(
        [("CAT", "GAA")])
    assert (want.score, want.end_table) == (-1.0, 2)
    al = partition.PartitionedAligner(params=params, p=p, device="cpu")
    got = al.align("CAT", "GAA")
    assert (got.score, got.end_table, got.chain[-1][2]) == (-1.0, 2, 2)
    assert al.last_phases["crossing_levels"] == 2 * math.log2(p)


@pytest.fixture(scope="module")
def random_pairs():
    """400 seeded pairs of 8-64 nt with ``align_batch``'s results and the
    plain reference's scores and end tables."""
    rng = np.random.default_rng(18)
    pairs = [rand_pair(rng, *(int(x) for x in rng.integers(8, 65, 2)))
             for _ in range(400)]
    want = BatchAligner(device="cpu", bucket_quantum=16).align_batch(pairs)
    return pairs, want, reference_ends(pairs)


@pytest.mark.parametrize("p", [2, 4, 8, 16])
def test_partition_is_optimal_on_random_pairs(random_pairs, p):
    pairs, want, (ref_score, ref_table) = random_pairs
    al = partition.PartitionedAligner(p=p, device="cpu", bucket_quantum=16)
    for (a, b), w, s, t in zip(pairs, want, ref_score, ref_table):
        assert (w.score, w.end_table) == (s, t)
        check_optimal(al.align(a, b), a, b, s, t)


def loop_score(a_enc, b_enc, chain, params):
    """The stitch's score as a Python loop over the chain's columns."""
    g, h, match, mismatch = params.astuple()
    score, prev_t = 0.0, None
    for (i, j, t) in chain:
        if t == 1:
            score += match if a_enc[i - 1] == b_enc[j - 1] else mismatch
        else:
            score -= g
            if t != prev_t:
                score -= h
        prev_t = t
    return score


def random_chain(rng, m, n, tail):
    """A path from (0, 0) to (m, n) as (i, j, t) points, the gapped side
    stored as 0, in random steps: it ends in a diagonal step, or with
    ``tail`` in a run of gaps in A."""
    k = int(rng.integers(1, 6)) if tail else 1
    rows, cols = m - (not tail), n - k
    d = int(rng.integers(0, min(rows, cols) + 1))
    steps = [1] * d + [2] * (cols - d) + [3] * (rows - d)
    steps = list(rng.permutation(steps)) + ([2] * k if tail else [1])
    i = j = 0
    pts = []
    for t in steps:
        i += t != 2
        j += t != 3
        pts.append((i if t != 2 else 0, j if t != 3 else 0, int(t)))
    return pts


@pytest.mark.parametrize("seed,tail", [(1, False), (2, False), (3, True),
                                       (4, True)])
@pytest.mark.parametrize("params", [ScoringParams(),
                                    ScoringParams(g=0.3, h=1.7),
                                    ScoringParams(g=2, h=5, match=3,
                                                  mismatch=-2)],
                         ids=["g1h2", "g0.3h1.7", "g2h5"])
def test_array_stitch_equals_the_loop(seed, tail, params):
    """``score_chain`` on arrays equals the loop's float in every bit, for
    a list and for a ``LazyChain``; the native render equals
    ``format_alignment``; the chain ends in a gap run where asked."""
    rng = np.random.default_rng(seed)
    a, b = rand_pair(rng, int(rng.integers(40, 300)),
                     int(rng.integers(40, 300)))
    ea, eb = encode_seq(a), encode_seq(b)
    chain = random_chain(rng, len(ea), len(eb), tail)
    assert (chain[-1][2] != 1) == tail
    want = loop_score(ea, eb, chain, params)
    arr = np.array(chain, np.int64)
    lazy = LazyChain(arr[:, 2].astype(np.int32), arr[:, 0], arr[:, 1])
    assert partition.score_chain(ea, eb, chain, params) == want
    assert partition.score_chain(ea, eb, lazy, params) == want
    assert walker.render(ea, eb, arr[:, 2], arr[:, 0], arr[:, 1]) == \
        format_alignment(a.encode(), b.encode(), chain)
    assert list(lazy) == chain
