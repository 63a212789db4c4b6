"""A small pass of each cell through the whole run on the CPU (the
program's plain twins; the look for a card skipped), judged by the frozen
reference; the same run with the timed path broken underneath, which has
to come out not correct; and the control, the reference in bfloat16, which
has to fail the comparison."""

import numpy as np
import pytest
import torch

import check
import generate
import harness
import manifest
from reference import alignment, gotoh

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
GLOBAL = manifest.module("reference", "global")
# (scale, max_items) of a pass small enough for the plain twins
SMALL = {"dna-genes-batch": (0.005, 6)}
SEED = 2 ** 31 + 12345


def small_run(name, seed=SEED):
    scale, items = SMALL[name]
    return harness.run(name, seed, 0.0, False, device="cpu", scale=scale,
                       max_items=items, log=lambda line: None)


def test_every_cell_has_a_small_size():
    assert set(SMALL) == set(CELLS) == set(CONTROL)


@pytest.mark.parametrize("name", CELLS)
def test_small_pass_is_correct(name):
    r = small_run(name)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["window"]["checked"] > 0
    cell = manifest.Cell(BENCH, name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(r["compared"]) == set(cell.entry.LIMITS)
    assert list(r)[-1] == "compared"
    assert harness.forbidden_modules() == []


def _alter_score(monkeypatch):
    """An answer altered where it is produced: one score off by one."""
    from cse305_parallel_sequence_alignment_torch.models import batch

    orig = batch.BatchAligner._collect

    def off(self, *a):
        chains, arrays, tables, scores = orig(self, *a)
        scores = scores.copy()
        scores[0] += 1.0
        return chains, arrays, tables, scores
    monkeypatch.setattr(batch.BatchAligner, "_collect", off)


def _drop_half(monkeypatch):
    """Half of the batch left out: the second half of each call's answers
    never comes."""
    from cse305_parallel_sequence_alignment_torch.models import batch

    orig = batch.BatchAligner.align_batch

    def half(self, pairs, *a, **k):
        out = orig(self, pairs, *a, **k)
        return out[: len(out) // 2] + [None] * (len(out) - len(out) // 2)
    monkeypatch.setattr(batch.BatchAligner, "align_batch", half)


def _alter_column(monkeypatch):
    """A column of an alignment altered where it is produced: the host
    replay's first step moved to the other gap table."""
    from cse305_parallel_sequence_alignment_torch.native import walker

    orig = walker.replay_rle

    def moved(*a, **k):
        tt, ii, jj, lens = orig(*a, **k)
        tt = tt.copy()
        tt[:, 0] = np.where(tt[:, 0] == 2, 3, 2)
        return tt, ii, jj, lens
    monkeypatch.setattr(walker, "replay_rle", moved)


def _alter_row(monkeypatch):
    """A rendered row altered where it is produced."""
    from cse305_parallel_sequence_alignment_torch.native import walker

    def flip(rows):
        a, b = rows
        return ("-" if a[:1] != "-" else "A") + a[1:], b

    orig = walker.render
    monkeypatch.setattr(walker, "render", lambda *a: flip(orig(*a)))


FAULTS = {"alter_score": _alter_score, "drop_half": _drop_half,
          "alter_column": _alter_column, "alter_row": _alter_row}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    r = small_run(name)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["compared"].values()) \
        or r["failed"] > 0


# sizes at which bfloat16 can no longer hold the scores (over 256)
CONTROL = {"dna-genes-batch": (0.1, 4)}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name):
    cell = manifest.Cell(BENCH, name)
    scale, items = CONTROL[name]
    p = generate.make_pass(cell.traffic, cell.config, 21, scale, items)
    n = check.judge_control(cell.entry.LIMITS, cell.config, p, "cpu",
                            "bfloat16")
    assert n["scores_wrong"] > cell.entry.LIMITS["scores_wrong"]


@pytest.mark.parametrize("change", [{"mode": "local"}, {"start_type": 1},
                                    {"end_type": 2}])
def test_reference_refuses_what_it_does_not_compute(change):
    config = dict(manifest.Cell(BENCH, CELLS[0]).config, **change)
    with pytest.raises(ValueError):
        check.Scoring(config)


def _naive_finals(a, b, table, g, h):
    """The recurrence cell by cell (the module docstring of gotoh.py)."""
    m, n = len(a), len(b)
    neg = -np.inf
    T = np.full((3, m + 1, n + 1), neg)
    T[0, 0, 0] = 0.0
    T[1, 0, 1:] = -h - g * np.arange(1, n + 1)
    T[2, 1:, 0] = -h - g * np.arange(1, m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            T[0, i, j] = table[a[i - 1], b[j - 1]] + T[:, i - 1, j - 1].max()
            T[2, i, j] = max(T[0, i - 1, j] - g - h, T[1, i - 1, j] - g - h,
                             T[2, i - 1, j] - g)
            T[1, i, j] = max(T[0, i, j - 1] - g - h, T[1, i, j - 1] - g,
                             T[2, i, j - 1] - g - h)
    return T[:, m, n]


def test_reference_sweep_is_the_recurrence():
    rng = np.random.default_rng(4)
    table = rng.integers(-4, 6, (5, 5)).astype(float)
    pairs = [(rng.integers(0, 5, int(rng.integers(1, 30))),
              rng.integers(0, 5, int(rng.integers(1, 40)))) for _ in range(12)]
    got = gotoh.finals(pairs, table, 1.0, 3.0, device="cpu", max_elems=64)
    want = np.array([_naive_finals(a, b, table, 1.0, 3.0) for a, b in pairs])
    assert np.array_equal(got, want)


def test_path_score_reads_the_chain():
    table = np.eye(4)
    a, b = np.array([0, 1, 2]), np.array([0, 2])
    # A0-B0, A1-gap, A2-B1: 2 matches, one gap of 1 (open 2, extend 1)
    chain = np.array([[1, 1, 1], [2, 0, 3], [3, 2, 1]])
    assert GLOBAL.path_score(a, b, chain, table, 1.0, 2.0) == -1.0
    bad = chain.copy()
    bad[1, 1] = 1  # the gapped side stored as an index
    assert GLOBAL.path_score(a, b, bad, table, 1.0, 2.0) is None
    assert alignment.render(b"ACG", b"AG", chain) == (b"ACG", b"A-G")
    # the leading run along column 0 implied: gap A0, then A1-B0, A2-B1
    implied = np.array([[2, 1, 1], [3, 2, 1]])
    assert GLOBAL.path_score(a, b, implied, table, 1.0, 2.0) == -2.0
    # a first point after an inner cell is no path from (0, 0)
    assert GLOBAL.path_score(a, b, chain[2:], table, 1.0, 2.0) is None


@pytest.mark.cuda
def test_reference_graph_sweep_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reference replays CUDA graphs "
                    "there")
    rng = np.random.default_rng(6)
    table = rng.integers(-4, 6, (20, 20)).astype(float)
    pairs = [(rng.integers(0, 20, int(rng.integers(1, 300))),
              rng.integers(0, 20, int(rng.integers(1, 3000))))
             for _ in range(40)]
    for dtype in (torch.float32, torch.bfloat16):
        cpu = gotoh.finals(pairs, table, 1.0, 11.0, dtype, "cpu", 1 << 18)
        card = gotoh.finals(pairs, table, 1.0, 11.0, dtype, "cuda", 1 << 18)
        assert np.array_equal(cpu, card)


def test_roofline_arithmetic_matches_the_kernel_table():
    """PERF.md's table: K1 at 256 x 2 kb is bound by bytes at 0.642 ms;
    a 17-operation score fill at the same size by operations, 0.272 ms."""
    import roofline
    import devtrace as tracing

    k1 = manifest.module("metrics", "k1_roofline")
    la = lb = np.full(256, 2048, np.int64)
    t_k1, bound = roofline.least_seconds(29, 2, la, lb)
    assert bound == "bytes" and t_k1 * 1e3 == pytest.approx(0.642, abs=5e-4)
    t, bound = roofline.least_seconds(17, 0, la, lb)
    assert bound == "operations" and t * 1e3 == pytest.approx(0.272, abs=5e-4)

    class R:
        passage = generate.Pass(calls=[[("A" * 2048, "C" * 2048)] * 256])
        swap = True
        device = tracing.DeviceWindow(
            busy_s=1.0, window_s=2.0, passes=2,
            kernels={"fill_kernel<16, false, true>": 4 * t_k1,
                     "fill_kernel<4, true, false>": 1.0,
                     "rle_walk_kernel": 1.0})

    assert k1.read(R) == pytest.approx(50.0)
    R.device.kernels.pop("fill_kernel<16, false, true>")
    assert k1.read(R) is None
    assert tracing.short_name("void (anonymous namespace)::fill_kernel<4, "
                              "true, false>(unsigned char const*)") == \
        "fill_kernel<4, true, false>"
