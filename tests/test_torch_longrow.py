"""Port K6 long fill and K7 last row (plain PyTorch), and the crossing
combine and ``batched_crossings`` of ``parallel/partition.py`` == the JAX
package's.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays; the Pallas kernels run in interpret mode, as
tests/test_longrow.py and tests/test_longstair.py run them on the CPU.
Tolerance is 0 throughout: the cells are float32 sums of small integers
taken in the same order.
"""

import pathlib
import re

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
from cse305_parallel_sequence_alignment_torch.parallel import partition
from cse305_parallel_sequence_alignment_torch.utils import observability
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
    rows = longrow.long_fill(*longrow.job_bucket(jobs, "cpu"),
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
    jp, tp, bp = partition.combine_rows(torch.from_numpy(rows),
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
    got = partition.batched_crossings(tasks, ScoringParams(), device="cpu")
    assert got == want
    for task, w in zip(tasks, want):
        a, b, i_mid, st, en = task
        assert jax_partition.crossing_on_row(a, b, i_mid, JaxParams(), st,
                                             en) == w


def test_batched_crossings_stair_branch_matches_jax():
    """A level of two tasks (four jobs) over the old K7 threshold gives
    the JAX package's crossings of its K7 route (``stair_threshold=0``) in
    one K6 launch of all four jobs."""
    rng = np.random.default_rng(29)
    tasks = _tasks(rng, [(60, 90, -1, -1), (45, 260, 1, 2)])
    want = jax_longrow.batched_crossings(tasks, stair_threshold=0)
    with observability.PhaseTimer() as timer:
        got = partition.batched_crossings(tasks, ScoringParams(),
                                          device="cpu")
    assert got == want
    assert timer.totals["crossing_launches"] == 1
    assert timer.totals["strip_jobs"] == 4


# the partition's level shapes at p = 32 of the 77,812 x 97,409 pair:
# (jobs, rows, widest job's columns)
PLAN_LEVELS = [(1, 48705, 98009), (3, 38906, 97409), (4, 19453, 56000),
               (8, 9726, 28000), (16, 4863, 14000), (32, 2431, 7000),
               (8, 12200, 24500), (6, 300, 5000), (1, 1, 1), (2, 0, 70)]


@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("want_row", [False, True])
def test_strip_plan_covers_and_bounds(sms, want_row):
    """``strip_plan`` (a pure function, the SM count passed in): every
    column of every job covered by whole strips, none of them empty, in
    one grid, within the kernel's build."""
    for B, m, n in PLAN_LEVELS:
        C, warps, S = longrow.strip_plan(B, m, n, want_row, sms)
        W = 32 * warps * C
        assert C in longrow.PLAN_C and warps in longrow.PLAN_WARPS
        assert S * W >= n + 1 and (S - 1) * W < n + 1, (B, m, n)
        assert B * S < 2 ** 31 - 1
        assert longrow.strip_plan(B, m, n, want_row, sms) == (C, warps, S)
        assert longrow.plan_cost(B, m, n, C, warps, sms) > 0


KERNEL = (pathlib.Path(longrow.__file__).parents[1] / "csrc"
          / "longrow.cu").read_text()


def kernel_const(name):
    """An int constant of csrc/longrow.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", KERNEL).group(1))


# the kernel's steps a superstep, and the supersteps warp w trails w - 1
STEP = kernel_const("kStep")
LAG = 2 + 30 // STEP


def test_strip_plan_held_to_the_kernel():
    """What ``strip_plan`` picks from is what the kernel has: an instance
    for each C and no more warps a CTA than its launch bounds; the
    emulation below runs the kernel's superstep lag; the kernel's static
    shared memory (the record rings and A's codes) fits the 48 KB a CTA
    takes without opting in."""
    assert re.search(r"kLag = 2 \+ 30 / kStep;", KERNEL)
    assert re.search(r"__launch_bounds__\(32 \* kMaxWarps,", KERNEL)
    assert kernel_const("kMaxWarps") >= max(longrow.PLAN_WARPS)
    launched = tuple(int(c) for c in re.findall(r"STRIP_LAUNCH\((\d+)\);",
                                                KERNEL))
    assert launched == longrow.PLAN_C
    ring = (kernel_const("kMaxWarps") + 1) * 4 * STEP * 8
    assert ring + kernel_const("kCodes") + 4 <= 48 * 1024


@pytest.mark.parametrize("B", [1, 3, 4, 8, 32])
def test_a_level_is_one_launch(B):
    """At B = 1 and at levels of 3, 4, 8 and 32 jobs of unequal widths the
    crossing search launches one grid: one ``crossing_launches``, every
    job counted, the crossings the JAX package's."""
    rng = np.random.default_rng(40 + B)
    shapes = [(int(rng.integers(20, 60)), int(rng.integers(30, 120)),
               (-1, 1, 2, 3)[q % 4], (-1, 3, 1, 2)[q % 4])
              for q in range(max(1, B // 2))]
    tasks = _tasks(rng, shapes)
    with observability.PhaseTimer() as timer:
        got = partition.batched_crossings(tasks, ScoringParams(),
                                          device="cpu")
    assert timer.totals["crossing_launches"] == 1
    assert timer.totals["strip_jobs"] == 2 * len(tasks)
    assert got == jax_longrow.batched_crossings(tasks, chunk_cols=128, rc=16)


def emulate(a, b, la, lb, st, params, want_row, C, warps):
    """csrc/longrow.cu ``strip_kernel<C>`` on the CPU, lane by lane, in its
    schedule: supersteps of ``STEP`` steps, warp w ``LAG`` supersteps
    behind warp w - 1 and run before it within a superstep (so a record
    read in the superstep it is written shows as stale), the rings and
    the strip links tagged with their rows. Returns (out, strips that
    filled a cell, per job)."""
    f = np.float32
    NEG = f(-np.inf)
    K, RING = STEP, 4 * STEP
    g, h, match, mism = (f(x) for x in params.astuple())
    gh = f(g + h)
    B, n = a.shape[0], b.shape[1]
    ncol, W = n + 1, 32 * warps * C
    S = -(-ncol // W)
    out = np.full((B, 3, ncol) if want_row else (B, 3), np.nan, f)
    if not want_row:
        out[:] = NEG
    worked = [set() for _ in range(B)]
    link = {}  # (job, strip, row): the strip's record to the next

    def row0(j, sta):
        if j == 0:
            return (f(0) if sta in (1, -1) else NEG,
                    f(0) if sta == -2 else NEG, f(0) if sta == -3 else NEG)
        jg = f(g * f(j))
        return NEG, (-jg if sta == -2 else NEG if sta in (1, 3)
                     else f(f(-h) - jg)), NEG

    def put(k, j, lB, v):
        if want_row:
            if j < ncol:
                out[k, :, j] = v if j <= lB else NEG
        elif j == lB:
            out[k] = v

    for s in range(S):  # strip-major, as the tickets run
        for k in range(B):
            lA, lB, sta = int(la[k]), int(lb[k]), int(st[k])
            g0 = s * W
            lanes = [dict(c0=g0 + q * C, live=g0 + (q // 32) * 32 * C <= lB)
                     for q in range(32 * warps)]
            for ln in lanes:
                if not ln["live"] and want_row:
                    for c in range(C):
                        put(k, ln["c0"] + c, -1, NEG)
            if g0 > lB:
                continue
            nlive = min(warps, (lB - g0) // (32 * C) + 1)
            for ln in lanes:
                c0 = ln["c0"]
                ln["code"] = [int(b[k, c0 + c - 1]) if 0 < c0 + c <= n
                              else 255 for c in range(C)]
                ln["gj"] = [f(g * f(c0 + c)) for c in range(C + 1)]
                r = [row0(c0 + c, sta) for c in range(C)]
                ln["M12"] = [max(x[0], x[1]) for x in r]
                ln["T3"] = [x[2] for x in r]
                if lA == 0 and ln["live"]:
                    for c in range(C):
                        put(k, c0 + c, lB, r[c])
                ln["dprev"] = max(row0(c0 - 1, sta)) if c0 > 0 else NEG
                ln["rec"] = (0, NEG, NEG)
            ring = [[(-1, NEG, NEG)] * RING for _ in range(warps + 1)]
            if s == 0:
                ring[0] = [(None, NEG, NEG)] * RING
            feed = s + 1 < S and (s + 1) * W <= lB
            steps = lA + 31
            nsup = (-(-steps // K) + (nlive - 1) * LAG) if lA > 0 else 0
            for sup in range(nsup):
                if s > 0:
                    for r in range(sup * K + 1, min(sup * K + K, lA) + 1):
                        ring[0][r % RING] = (r,) + link[(k, s - 1, r)]
                for w in reversed(range(warps)):
                    t0 = (sup - w * LAG) * K
                    if not (lanes[32 * w]["live"] and 0 <= t0 < steps):
                        continue
                    for t in range(t0, t0 + K):
                        prev = [lanes[32 * w + L]["rec"] for L in range(32)]
                        for L in range(32):
                            ln = lanes[32 * w + L]
                            i = t - L + 1
                            rec = (ring[w][(t + 1) % RING] if L == 0
                                   else prev[L - 1])
                            if i < 1 or i > lA:
                                continue
                            assert rec[0] in (i, None), (s, w, L, i, rec)
                            worked[k].add(s)
                            _, rx, rE = rec
                            ac = int(a[k, i - 1])
                            lm3, ln["dprev"] = ln["dprev"], rx
                            first = ln["c0"] == 0
                            P, t1s, run, om = [], [], NEG, NEG
                            for c in range(C):
                                p12, p3 = ln["M12"][c], ln["T3"][c]
                                t1 = f((match if ln["code"][c] == ac
                                        else mism) + lm3)
                                t3 = max(f(p12 - gh), f(p3 - g))
                                if c == 0 and first:
                                    fi = f(i)
                                    t1 = NEG
                                    t3 = (f(-g * fi) if sta == -3 else NEG
                                          if sta in (1, 2)
                                          else f(f(-h) - f(g * fi)))
                                lm3 = max(p12, p3)
                                t1s.append(t1)
                                ln["T3"][c] = t3
                                P.append(run)
                                om = f(f(ln["gj"][c + 1] + max(t1, t3)) - gh)
                                run = max(run, om)
                            t2s = []
                            for c in range(C):
                                pm = max(rE, P[c])
                                t2s.append(NEG if c == 0 and first
                                           else f(pm - ln["gj"][c]))
                            if i == lA:
                                for c in range(C):
                                    put(k, ln["c0"] + c, lB,
                                        (t1s[c], t2s[c], ln["T3"][c]))
                            ln["M12"] = [max(x, y) for x, y in zip(t1s, t2s)]
                            ln["rec"] = (i, max(ln["M12"][-1], ln["T3"][-1]),
                                         max(pm, om))
                            if L == 31 and w + 1 < warps:
                                ring[w + 1][i % RING] = ln["rec"]
                            elif L == 31 and feed:
                                link[(k, s, i)] = ln["rec"][1:]
    return out, worked


@pytest.mark.parametrize("geo", [(4, 2), (8, 1), (4, 3)])
def test_kernel_schedule_emulated_matches_plain(geo):
    """The kernel's schedule and float32 expressions, emulated lane by
    lane on the CPU, give ``long_fill_plain``'s bits in both capture
    modes, on a padded level of unequal widths and every start type; each
    record read carries the row it is read for, and strips wholly past a
    job's own width fill nothing."""
    C, warps = geo
    rng = np.random.default_rng(sum(geo))
    la, lb = [40, 0, 39, 7, 25, 1], [300, 200, 299, 30, 0, 301]
    a, b, la, lb = bucket(rng, la, lb, 40, 301)
    st = np.array(STARTS, np.int32)
    params = (ScoringParams() if C == 8 else
              ScoringParams(g=0.3, h=1.7, match=2.5, mismatch=-1.25))
    W = 32 * warps * C
    for want_row in (False, True):
        got, worked = emulate(a, b, la, lb, st, params, want_row, C, warps)
        want = longrow.long_fill_plain(*port(a, b, la, lb, st), params,
                                       want_row).numpy()
        assert np.array_equal(got, want), (geo, want_row)
        for k in range(len(la)):
            live = set(range(int(lb[k]) // W + 1)) if la[k] else set()
            assert worked[k] == live, (k, worked[k])


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
    card, at widths of several strips, at a batch of one and at a level's
    shape: jobs of unequal widths padded to the widest; and every
    geometry of ``strip_plan``'s choices on one bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(21)
    cases = [([300, 0, 299, 150, 1, 250], [5000, 4000, 4999, 2500, 5000, 77]),
             ([2000], [9000]),
             ([2431, 2430, 2429, 2431], [6100, 5300, 7000, 4800])]
    for la, lb in cases:
        B = len(la)
        a, b, la_, lb_ = bucket(rng, la, lb, max(la), max(lb))
        st = np.array(STARTS * B, np.int32)[:B]
        args = [x.cuda() for x in port(a, b, la_, lb_, st)]
        for want_row in (False, True):
            assert torch.equal(
                longrow.long_fill(*args, ScoringParams(), want_row=want_row),
                longrow.long_fill_plain(*args, ScoringParams(), want_row))
    want = longrow.long_fill_plain(*args, ScoringParams(), True)
    for C in longrow.PLAN_C:
        for warps in longrow.PLAN_WARPS:
            S = -(-(max(lb) + 1) // (32 * warps * C))
            assert torch.equal(longrow._launch(
                *args, ScoringParams(), True, (C, warps, S)), want), (C, warps)
    x = torch.from_numpy(seq(rng, 400)).cuda()
    y = torch.from_numpy(seq(rng, 9000)).cuda()
    for t in (-1, -3, 2):
        assert torch.equal(
            longstair.stair_lastrow_device(x, y, t, ScoringParams()),
            longstair.stair_lastrow_plain(x, y, t, ScoringParams()))
