"""The ported slice end to end on the CPU: the port's
``BatchAligner(device="cpu")`` against the JAX package's
``BatchAligner`` (fused Pallas path in interpret mode, and the wavefront
path), the golden cases, ``score_batch``, the api, ``GotohAligner`` and
the CLI. Scores, chains, rows and end tables must be equal.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.gotoh import (
    GotohAligner,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.models.batch import (
    BatchAligner as JaxBatchAligner,
)
from cse305_parallel_sequence_alignment_tpu.models.gotoh import (
    GotohAligner as JaxGotohAligner,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def rand_pairs(rng, count, max_len, related=False):
    pairs = []
    for _ in range(count):
        a = "".join(rng.choice(list("ACGT"), rng.integers(1, max_len + 1)))
        if related:  # a copy with substitutions: long diagonal runs
            b = list(a)
            for k in rng.integers(0, len(a), max(1, len(a) // 20)):
                b[k] = "ACGT"[rng.integers(0, 4)]
            b = "".join(b) + "".join(rng.choice(list("ACGT"),
                                                rng.integers(0, 5)))
        else:
            b = "".join(rng.choice(list("ACGT"),
                                   rng.integers(1, max_len + 1)))
        pairs.append((a, b))
    return pairs


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.score == w.score
        assert g.end_table == w.end_table
        assert list(g.chain) == list(w.chain)
        assert g.aligned_a == w.aligned_a
        assert g.aligned_b == w.aligned_b


TYPES = [-1, -2, -3, 1, 2, 3]


@pytest.mark.parametrize("backend", ["pallas", "wavefront"])
def test_align_batch_mixed_types_matches_jax(backend):
    rng = np.random.default_rng(31)
    pairs = rand_pairs(rng, 14, 60) + rand_pairs(rng, 4, 60, related=True)
    st = [TYPES[k % 6] for k in range(18)]
    en = [TYPES[(k * 5 + 1) % 6] for k in range(18)]
    kw = dict(start_types=st, end_types=en)
    want = JaxBatchAligner(backend=backend, bucket_quantum=64).align_batch(
        pairs, **kw)
    got = BatchAligner(device="cpu", bucket_quantum=64).align_batch(
        pairs, **kw)
    same_results(got, want)


def test_align_batch_offsets_full_mode_matches_jax():
    rng = np.random.default_rng(32)
    pairs = rand_pairs(rng, 10, 50)
    offsets = [(int(rng.integers(0, 99)), int(rng.integers(0, 99)))
               for _ in pairs]
    kw = dict(offsets=offsets, traceback_mode="full",
              start_types=[TYPES[k % 6] for k in range(10)])
    want = JaxBatchAligner(backend="wavefront",
                           bucket_quantum=64).align_batch(pairs, **kw)
    got = BatchAligner(device="cpu", bucket_quantum=64).align_batch(pairs,
                                                                   **kw)
    same_results(got, want)
    assert all(r.aligned_a is None for r in got)


@pytest.mark.parametrize("params", [ScoringParams(),
                                    ScoringParams(g=2.0, h=1.0),
                                    ScoringParams(g=0.5, h=1.5, match=2.0,
                                                  mismatch=-1.0)])
def test_align_and_score_match_jax_wavefront(params):
    """Random and m > n (parity-swapped) pairs; scores and end tables of
    score_batch agree with align_batch and with the JAX package."""
    rng = np.random.default_rng(33)
    pairs = rand_pairs(rng, 12, 80)
    jp = JaxParams(*params.astuple())
    ja = JaxBatchAligner(params=jp, backend="wavefront", bucket_quantum=64)
    pa = BatchAligner(params=params, device="cpu", bucket_quantum=64)
    assert any(len(a) > len(b) for a, b in pairs)
    same_results(pa.align_batch(pairs), ja.align_batch(pairs))
    s_p, t_p = pa.score_batch(pairs)
    s_j, t_j = ja.score_batch(pairs)
    assert np.array_equal(s_p, s_j) and np.array_equal(t_p, t_j)
    res = pa.align_batch(pairs)
    assert np.array_equal(s_p, [r.score for r in res])
    assert np.array_equal(t_p, [r.end_table for r in res])


def test_golden_pipeline(golden_pipeline):
    for gh in sorted({(r["g"], r["h"]) for r in golden_pipeline}):
        recs = [r for r in golden_pipeline if (r["g"], r["h"]) == gh]
        al = BatchAligner(params=ScoringParams(g=gh[0], h=gh[1]),
                          device="cpu")
        res = al.align_batch([(r["A"], r["B"]) for r in recs])
        for r, got in zip(recs, res):
            assert (got.aligned_a, got.aligned_b) == (r["out_a"],
                                                      r["out_b"]), r


def test_golden_subproblem(golden_subproblem):
    for gh in sorted({(r["g"], r["h"]) for r in golden_subproblem}):
        recs = [r for r in golden_subproblem if (r["g"], r["h"]) == gh]
        params = ScoringParams(g=gh[0], h=gh[1])
        pairs = [(r["A"], r["B"]) for r in recs]
        res = BatchAligner(params=params, device="cpu").align_batch(
            pairs, start_types=[r["start"] for r in recs],
            end_types=[r["end"] for r in recs])
        # raw finals (T1, T2, T3) = the scores of forced end types 1-3
        finals = {}
        for st in sorted({r["start"] for r in recs}):
            idx = [k for k, r in enumerate(recs) if r["start"] == st]
            cols = [BatchAligner(params=params, start_type=st, end_type=e,
                                 device="cpu").score_batch(
                [pairs[k] for k in idx])[0] for e in (1, 2, 3)]
            for w, k in enumerate(idx):
                finals[k] = [float(c[w]) for c in cols]
        for k, (r, got) in enumerate(zip(recs, res)):
            chain = "".join(f"({i},{j},{t})" for (i, j, t) in got.chain)
            assert chain == r["chain"], r
            want = [NEG_INF if v == "-inf" else float(v)
                    for v in r["final"]]
            assert finals[k] == want, r


def test_api_global_and_other_modes():
    rng = np.random.default_rng(34)
    pairs = rand_pairs(rng, 5, 40)
    want = JaxBatchAligner(backend="wavefront").align_batch(pairs)
    same_results(api.align_pairs(pairs, device="cpu"), want)
    same_results([api.align(a, b, device="cpu") for a, b in pairs], want)
    scores, tables = api.score_pairs(pairs, device="cpu")
    assert np.array_equal(scores, [w.score for w in want])
    from cse305_parallel_sequence_alignment_tpu import api as jax_api
    got = api.align("ACGTTGCA", "ACGTGCA", mode="banded", band=2,
                    device="cpu")
    want = jax_api.align("ACGTTGCA", "ACGTGCA", mode="banded", band=2)
    assert (got.score, list(got.chain), got.aligned_a, got.aligned_b,
            got.end_table, got.edge_touched) == (
        want.score, want.chain, want.aligned_a, want.aligned_b,
        want.end_table, want.edge_touched)
    with pytest.raises(ValueError):
        api.align("ACGT", "ACG", mode="nonsense", device="cpu")
    # a bucket wider than long_threshold scores through the long fill
    long_pair = [("A" * 10, "C" * 100)]
    s_p, t_p = BatchAligner(device="cpu", long_threshold=64).score_batch(
        long_pair)
    s_j, t_j = JaxBatchAligner(backend="wavefront").score_batch(long_pair)
    assert np.array_equal(s_p, s_j) and np.array_equal(t_p, t_j)


@pytest.mark.parametrize("start_type,end_type", [(-1, -1), (-2, 3),
                                                 (1, -3)])
def test_gotoh_matches_jax(start_type, end_type):
    rng = np.random.default_rng(35)
    kw = dict(start_type=start_type, end_type=end_type)
    for a, b in rand_pairs(rng, 3, 50):
        want = JaxGotohAligner(**kw).align(a, b)
        got = GotohAligner(device="cpu", **kw).align(a, b)
        assert (got.score, got.end_table, list(got.chain), got.aligned_a,
                got.aligned_b) == (want.score, want.end_table, want.chain,
                                   want.aligned_a, want.aligned_b)
        assert GotohAligner(device="cpu", **kw).score(a, b) == \
            JaxGotohAligner(**kw).score(a, b)
    # offsets shift the chain as the JAX batch path's offsets do
    want = JaxBatchAligner(backend="wavefront").align_batch(
        [("AGGA", "AGTGC")], offsets=[(4, 7)])[0]
    got = GotohAligner(device="cpu").align("AGGA", "AGTGC", id_a=4,
                                           id_b=7)
    assert list(got.chain) == list(want.chain)


def test_cli_align_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         "align", "--a", "AGGA", "--b", "AGTGC", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["AG-GA", "AGTGC"]


def test_walk_past_the_shipped_cap_refetches():
    """A trailing 450-long gap walks as 450 single-step rounds, past the
    256 rounds shipped with the scores; the overflow fetch must give the
    JAX package's result."""
    import torch

    from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
        rle_walk,
    )
    from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
        rowcb_fill,
    )

    pair = ("G" * 150, "G" * 150 + "T" * 450)
    a = np.frombuffer(pair[0].encode(), np.uint8)[None, :].copy()
    b = np.frombuffer(pair[1].encode(), np.uint8)[None, :].copy()
    la, lb = np.array([150], np.int32), np.array([600], np.int32)
    dirs, _ = rowcb_fill(*(torch.from_numpy(x) for x in
                           (a, b, la, lb, np.array([-1], np.int32))),
                         ScoringParams())
    _, used = rle_walk(dirs, torch.from_numpy(la), torch.from_numpy(lb),
                       torch.tensor([2], dtype=torch.int32), 751)
    assert int(used[0]) > 256
    want = JaxBatchAligner(backend="wavefront").align_batch([pair])
    got = BatchAligner(device="cpu").align_batch([pair])
    assert got[0].end_table == 2
    same_results(got, want)


@pytest.mark.parametrize("count,per_pair,max_batch,split_two,want", [
    (10, 100, 32, False, 10),    # one chunk holds the bucket
    (100, 1, 128, True, 50),     # one chunk would; cut in two
    (63, 1, 128, True, 128),     # too few pairs to cut
    (10, 300, 32, False, 3),     # the budget holds 3: 4 chunks of <= 3
    (100, 1, 32, False, 25),     # max_batch 32: 4 equal chunks of 25
])
def test_chunk_size_policy(count, per_pair, max_batch, split_two, want):
    """One chunk policy for every aligner: at most ``max_batch`` pairs
    and ``dirs_budget`` bytes (1,000 here), equal chunks, and the global
    aligner's cut in two."""
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        chunk_size,
    )
    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalBatchAligner,
    )

    assert chunk_size(count, per_pair, max_batch, 1000, split_two) == want
    bm, bn = 10, 12
    al = BatchAligner(max_batch=max_batch, dirs_budget=10 ** 4, device="cpu")
    assert al.chunk_size((bm, bn), count) == chunk_size(
        count, 2 * (bm + 1) * (bn + 1), max_batch, 10 ** 4, True)
    loc = LocalBatchAligner(max_batch=max_batch, dirs_budget=10 ** 4,
                            device="cpu")
    assert loc.chunk_size((bm, bn), count) == chunk_size(
        count, loc._dirs_bytes(bm, bn), max_batch, 10 ** 4)


CARD_FREE = 79 << 30  # an 80 GB card's free bytes before a call
GENES = (16384, 16384)  # dna-genes-batch's full-size bucket, 57 pairs
FUSED_GENES = 2 * (GENES[0] + 1) * (GENES[1] + 1)


def chunk_sizes(al, key, count, free=None):
    step = al.chunk_size(key, count, *(() if free is None else (free,)))
    return [min(step, count - s) for s in range(0, count, step)]


@pytest.mark.parametrize("make,key,count,free,want,by_wave", [
    # the cluster path: half the free bytes, then one wave a chunk
    (dict(), GENES, 57, CARD_FREE, [29, 28], True),
    (dict(backend="pallas_rowscan"), GENES, 57, CARD_FREE, [29, 28], True),
    (dict(), (13312, 16384), 7, CARD_FREE, [7], False),
    (dict(), (2048, 4096), 300, CARD_FREE, [100] * 3, True),
    # a dirs_budget given still caps it: 4 pairs a chunk
    (dict(dirs_budget=4 * FUSED_GENES), GENES, 57, CARD_FREE,
     [4] * 14 + [1], False),
    # the 2 GiB plan: the CPU, a bucket of 4,096 columns or fewer, rows
    # past the cluster's reach, the other routes and aligners
    (dict(), GENES, 57, None, [3] * 19, False),
    (dict(), (2048, 4095), 300, CARD_FREE, [100] * 3, False),
    (dict(), (128, 65536), 300, CARD_FREE, [100] * 3, False),
    (dict(backend="rowdirs"), GENES, 57, CARD_FREE, [7] * 8 + [1], False),
    (dict(backend="wavefront"), GENES, 57, CARD_FREE, [3] * 19, False),
    ("local", GENES, 57, None, [3] * 19, None),
    ("semiglobal", GENES, 57, None, [3] * 19, None),
    ("overlap", GENES, 57, None, [3] * 19, None),
])
def test_cluster_chunk_plan(make, key, count, free, want, by_wave):
    """``BatchAligner.chunk_size`` on the cluster path (rows of more than
    4,096 columns that share the SMs out): pairs a chunk bounded by half
    the card's free bytes and by one wave of K1 at the chunk's geometry
    (the pure floor on the CPU); every other bucket, route and aligner
    keeps the 2 GiB plan."""
    from cse305_parallel_sequence_alignment_torch.models import (
        local,
        overlap,
        semiglobal,
    )

    classes = {"local": local.LocalBatchAligner,
               "semiglobal": semiglobal.SemiGlobalBatchAligner,
               "overlap": overlap.OverlapBatchAligner}
    if isinstance(make, str):
        al = classes[make](device="cpu")
    else:
        al = BatchAligner(device="cpu", **make)
    assert chunk_sizes(al, key, count, free) == want
    if by_wave is not None:
        assert al._plan(key, count, lambda: free)[1] == by_wave


def test_genes_plan_fills_the_card():
    """dna-genes-batch's pass (57 pairs of 16,384 x 16,384 and 7 of
    13,312 x 16,384) on an 80 GB card: three chunks, K1's clusters on
    71.72% of the SMs a launch (18.47% under a fixed 2 GiB)."""
    from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
        SMS,
        fill_geometry,
    )

    al = BatchAligner(device="cpu")
    chunks = (chunk_sizes(al, GENES, 57, CARD_FREE)
              + chunk_sizes(al, (13312, 16384), 7, CARD_FREE))
    assert chunks == [29, 28, 7]
    ctas = sum(B * fill_geometry(B, 16384)[2] for B in chunks)
    assert ctas == 116 + 112 + 56
    assert 100 * ctas / (len(chunks) * SMS) == pytest.approx(71.72, abs=0.01)


@pytest.mark.parametrize("n", [4096, 6000, 8192, 12288, 16384, 32768,
                               65535])
def test_chunks_within_the_wave_floor(n):
    """No cluster-path chunk holds more pairs than the pure floor of one
    wave at its geometry, whatever the count, the budget or max_batch."""
    from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
        fill_geometry,
        fill_wave,
    )

    for max_batch in (512, 40):
        al = BatchAligner(device="cpu", max_batch=max_batch)
        for count in range(1, 400, 7):
            for B in set(chunk_sizes(al, (128, n), count, CARD_FREE)):
                assert B <= fill_wave(fill_geometry(B, n)), (count, B)


@pytest.mark.cuda
def test_align_batch_on_card_matches_cpu():
    """The CUDA path of align_batch/score_batch against the plain path."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(36)
    pairs = rand_pairs(rng, 20, 300) + rand_pairs(rng, 4, 300,
                                                  related=True)
    kw = dict(start_types=[TYPES[k % 6] for k in range(24)],
              end_types=[TYPES[(k + 2) % 6] for k in range(24)])
    same_results(BatchAligner(device="cuda").align_batch(pairs, **kw),
                 BatchAligner(device="cpu").align_batch(pairs, **kw))
    s_c, t_c = BatchAligner(device="cuda").score_batch(pairs)
    s_p, t_p = BatchAligner(device="cpu").score_batch(pairs)
    assert np.array_equal(s_c, s_p) and np.array_equal(t_c, t_p)


@pytest.mark.parametrize("scores_only", [False, True])
def test_cli_batch_matches_jax_cli(tmp_path, capsys, scores_only):
    from cse305_parallel_sequence_alignment_torch.__main__ import (
        main as port_main,
    )
    from cse305_parallel_sequence_alignment_tpu.__main__ import (
        main as jax_main,
    )

    rng = np.random.default_rng(37)
    fasta = tmp_path / "genes.fa"
    fasta.write_text("".join(
        f">gene{k}\n" + "".join(rng.choice(list("ACGT"), 90)) + "\n"
        for k in range(6)))
    argv = ["batch", "--data", str(fasta), "--count", "5",
            "--input-size", "70", "--bucket-quantum", "64"]
    if scores_only:
        argv.append("--scores-only")
    assert jax_main(argv) == 0
    want = capsys.readouterr().out
    assert port_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == (5 if scores_only else 10)


def test_cli_info(capsys):
    import json

    from cse305_parallel_sequence_alignment_torch.__main__ import main
    assert main(["info"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["version"] == "0.1.0" and "torch" in rec
