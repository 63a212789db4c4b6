"""Port K6 long fill and K7 last row (plain PyTorch), the crossing combine
and ``batched_crossings`` == the JAX package's.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays; the Pallas kernels run in interpret mode, as
tests/test_longrow.py and tests/test_longstair.py run them on the CPU.
Tolerance is 0 throughout: the cells are float32 sums of small integers
taken in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rowcb import ACGT, port

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import longrow, longstair
from cse305_parallel_sequence_alignment_tpu.ops import (
    pallas_longrow as jax_longrow,
)
from cse305_parallel_sequence_alignment_tpu.ops import (
    pallas_longstair as jax_longstair,
)
from cse305_parallel_sequence_alignment_tpu.parallel import (
    partition as jax_partition,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)

STARTS = (-1, -2, -3, 1, 2, 3)


def bucket(rng, la, lb, bm, bn):
    B = len(la)
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    return a, b, np.asarray(la, np.int32), np.asarray(lb, np.int32)


def seq(rng, n):
    return ACGT[rng.integers(0, 4, n)]


# (la, lb, bm, bn, chunk_cols, rc): the geometries of
# tests/test_longrow.py:31-33, each with an empty A (la 0) and, for
# chunk_cols 128, a row of exactly one chunk plus one column (lb 128)
FILLS = {
    "50x300-cc128": ([50, 0, 17], [300, 128, 1], 50, 300, 128, 16),
    "200x700-cc256": ([200, 33, 0, 150, 1], [700, 512, 9, 255, 700],
                      200, 700, 256, 64),
    "120x129-cc128": ([120, 0], [128, 129], 120, 129, 128, 32),
}


@pytest.mark.parametrize("case", sorted(FILLS))
def test_long_fill_finals_match_jax_score_batch(case):
    la, lb, bm, bn, cc, rc = FILLS[case]
    rng = np.random.default_rng(len(la) * 100 + bn)
    a, b, la, lb = bucket(rng, la, lb, bm, bn)
    for st in STARTS:
        want = jax_longrow.pallas_long_score_batch(
            a, b, la, lb, start_type=st, chunk_cols=cc, rc=rc)
        got = longrow.long_fill(*port(a, b, la, lb,
                                      np.full(len(la), st, np.int32)),
                                ScoringParams())
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(la),
                                                                   3)
        assert np.array_equal(got.numpy(), want), (case, st)


LASTROWS = [(37, 300, 128, 16), (0, 50, 128, 16), (64, 129, 128, 32),
            (20, 128, 128, 16)]


def test_long_lastrow_matches_jax():
    """One job at a time (``long_lastrow``), and all of them as one
    mixed-type K6 bucket (``long_fill(want_row=True)``)."""
    rng = np.random.default_rng(11)
    pairs = [(seq(rng, m), seq(rng, n)) for m, n, _, _ in LASTROWS]
    jobs, want = [], []
    for (m, n, cc, rc), (x, y) in zip(LASTROWS, pairs):
        for st in STARTS:
            w = jax_longrow.pallas_long_lastrow(x, y, start_type=st,
                                                chunk_cols=cc, rc=rc)
            got = longrow.long_lastrow(x, y, ScoringParams(), st,
                                       device="cpu")
            assert got.shape == (3, n + 1)
            assert np.array_equal(got, w), (m, n, st)
            jobs.append((x, y, st))
            want.append(w)
    rows = longrow.long_fill(*longrow._job_bucket(jobs, "cpu"),
                             ScoringParams(), want_row=True).numpy()
    for k, w in enumerate(want):
        assert np.array_equal(rows[k, :, : w.shape[1]], w), jobs[k][2]


@pytest.mark.parametrize("st", STARTS)
def test_row0_closed_matches_jax(st):
    for g, h in ((1.0, 2.0), (0.5, 1.25)):
        assert np.array_equal(longrow._row0_closed(40, g, h, st),
                              jax_longrow._row0_closed(40, g, h, st))


def test_long_fill_scoring_params():
    rng = np.random.default_rng(9)
    a, b, la, lb = bucket(rng, [150, 90, 12, 150], [400, 399, 250, 1],
                          150, 400)
    params = ScoringParams(g=2.0, h=5.0, match=3.0, mismatch=-2.0)
    want = jax_longrow.pallas_long_score_batch(
        a, b, la, lb, g=2.0, h=5.0, match=3.0, mismatch=-2.0,
        chunk_cols=256, rc=32)
    got = longrow.long_fill(*port(a, b, la, lb, np.full(4, -1, np.int32)),
                            params)
    assert np.array_equal(got.numpy(), want)


# (m, n, nl_c, rc) of tests/test_longstair.py:16-17
STAIRS = [(37, 300, 128, 16), (5, 64, 128, 16), (64, 1100, 128, 32),
          (0, 70, 128, 16)]


def test_stair_lastrow_matches_jax():
    rng = np.random.default_rng(13)
    for (m, n, nl_c, rc) in STAIRS:
        x, y = seq(rng, m), seq(rng, n)
        for st in (-1, -2, 3):
            want = jax_longstair.stair_lastrow(x, y, start_type=st,
                                               nl_c=nl_c, rc=rc)
            got = longstair.stair_lastrow(x, y, ScoringParams(), st,
                                          device="cpu")
            assert np.array_equal(got, want), (m, n, st)
            # K7's plain version is K6's plain fill on one job
            assert np.array_equal(
                got, longrow.long_lastrow(x, y, ScoringParams(), st,
                                          device="cpu"))


def test_stair_lastrow_params():
    rng = np.random.default_rng(17)
    x, y = seq(rng, 90), seq(rng, 700)
    want = jax_longstair.stair_lastrow(x, y, g=2.0, h=5.0, match=3.0,
                                       mismatch=-2.0, nl_c=128, rc=16)
    got = longstair.stair_lastrow(
        x, y, ScoringParams(g=2.0, h=5.0, match=3.0, mismatch=-2.0),
        device="cpu")
    assert np.array_equal(got, want)


def test_combine_rows_ties_match_jax():
    """Rows of a few small integers: many exact ties, broken the same
    way (smallest j, then T1, T2, T3)."""
    rng = np.random.default_rng(19)
    C, W = 5, 40
    rows = rng.integers(-3, 2, (2 * C, 3, W)).astype(np.float32)
    rows[3] = -np.inf  # a crossing with no finite total
    n_vec = np.array([39, 20, 0, 7, 33], np.int32)
    jw, tw, bw = (np.asarray(x) for x in jax_longrow._combine_rows(
        jnp.asarray(rows), jnp.asarray(n_vec), C=C, h=2.0))
    jp, tp, bp = longrow.combine_rows(torch.from_numpy(rows),
                                      torch.from_numpy(n_vec).long(), 2.0)
    assert np.array_equal(jp.numpy(), jw) and np.array_equal(tp.numpy(), tw)
    assert np.array_equal(bp.numpy(), bw)


def _tasks(rng, shapes):
    tasks = []
    for (m, n, st, en) in shapes:
        tasks.append((seq(rng, m), seq(rng, n), m // 2, st, en))
    return tasks


# tests/test_longrow.py:105-107 and the wide level of :153-159
LEVELS = {
    "six": (23, [(60, 90, -1, -1), (45, 70, 1, -1), (33, 40, 2, 3),
                 (80, 30, 3, 1), (17, 260, 1, 2), (64, 64, -1, 1)]),
    "nine": (61, None),
}


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_batched_crossings_match_jax(level):
    seed, shapes = LEVELS[level]
    rng = np.random.default_rng(seed)
    if shapes is None:
        shapes = [(int(rng.integers(30, 90)), int(rng.integers(40, 200)),
                   (-1, 1, 2, 3)[q % 4], (-1, 3, 1, 2)[q % 4])
                  for q in range(9)]
    tasks = _tasks(rng, shapes)
    want = jax_longrow.batched_crossings(tasks, chunk_cols=128, rc=16)
    got = longrow.batched_crossings(tasks, ScoringParams(), device="cpu")
    assert got == want
    for task, w in zip(tasks, want):
        a, b, i_mid, st, en = task
        assert jax_partition.crossing_on_row(a, b, i_mid, JaxParams(), st,
                                             en) == w


def test_batched_crossings_stair_branch_matches_jax(monkeypatch):
    """A level of two tasks (four jobs) over ``stair_threshold`` goes
    through K7, one job at a time, with the same crossings."""
    rng = np.random.default_rng(29)
    tasks = _tasks(rng, [(60, 90, -1, -1), (45, 260, 1, 2)])
    want = jax_longrow.batched_crossings(tasks, stair_threshold=0)
    calls = []
    plain = longstair.stair_lastrow_plain

    def spy(a, b, start_type, params):
        calls.append(start_type)
        return plain(a, b, start_type, params)

    monkeypatch.setattr(longstair, "stair_lastrow_plain", spy)
    got = longrow.batched_crossings(tasks, ScoringParams(), device="cpu",
                                    stair_threshold=30)
    assert got == want and calls == [-1, -1, 1, 2]


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    ok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        longrow.long_fill(a.to(torch.int32), a, ok, ok, ok, ScoringParams())
    with pytest.raises(TypeError):
        longstair.stair_lastrow_device(a, a[0], -1, ScoringParams())


@pytest.mark.cuda
def test_long_kernels_match_plain_on_card():
    """K6 (finals and rows) and K7 against their plain versions on the
    card, at widths of several strips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(21)
    a, b, la, lb = bucket(rng, [300, 0, 299, 150, 1, 250],
                          [5000, 4000, 4999, 2500, 5000, 77], 300, 5000)
    st = np.array(STARTS, np.int32)
    args = [x.cuda() for x in port(a, b, la, lb, st)]
    for want_row in (False, True):
        assert torch.equal(
            longrow.long_fill(*args, ScoringParams(), want_row=want_row),
            longrow.long_fill_plain(*args, ScoringParams(), want_row))
    x = torch.from_numpy(seq(rng, 400)).cuda()
    y = torch.from_numpy(seq(rng, 9000)).cuda()
    for t in (-1, -3, 2):
        assert torch.equal(
            longstair.stair_lastrow_device(x, y, t, ScoringParams()),
            longstair.stair_lastrow_plain(x, y, t, ScoringParams()))
