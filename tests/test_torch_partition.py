"""The port's balanced partition, ``PartitionedAligner``, the long-bucket
routes of ``BatchAligner``, the api's partitioned mode and the CLI
``partition``/``longscore`` on the CPU == the JAX package's.

The JAX side runs as its own tests run it on the CPU (rowscan crossing
search, wavefront segment solves, Pallas long fill in interpret mode).
Points, scores, chains, rows and end tables must be equal.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
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
    assert list(al.last_phases) == list(partition.PHASES)
    assert all(v > 0 for v in al.last_phases.values())
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
