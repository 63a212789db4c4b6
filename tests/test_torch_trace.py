"""The port's tracing (``utils/observability.py``) and the spans and
counters of ``BatchAligner.align_batch`` and
``PartitionedAligner.align``.

On the CPU: every ``last_phases`` key filled on a mixed-length batch,
``chunks`` against ``chunk_size``, ``wave_chunks`` only for chunks the
wave limit cut, a fresh recorder each call, ``count`` outside a
recorder, the ``seqalign.*`` ranges under ``torch.profiler`` and none
without it, the sharded aligner's spans, and the benchmark's five
readers of these keys (``seqbench/metrics/``); the partition's
counters against the bisection's fills, its three ranges once an
``align``, and the readers of its spans and of its kernels' roofline.
On a card (marker
``cuda``): the fill's CTA and SM counters against ``fill_geometry``, and
the wave plan: no launch past CUDA's co-resident clusters, answers equal
to the plain path's.
"""

import importlib.util
import math
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cse305_parallel_sequence_alignment_torch.models import batch
from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops import rowcb
from cse305_parallel_sequence_alignment_torch.parallel import partition
from cse305_parallel_sequence_alignment_torch.parallel.batch_shard import (
    ShardedBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    make_data_mesh,
)
from cse305_parallel_sequence_alignment_torch.utils import observability
from cse305_parallel_sequence_alignment_torch.utils.observability import (
    Marks,
    PhaseTimer,
)

METRICS = pathlib.Path(__file__).resolve().parents[1] / "seqbench" / "metrics"
OLD_KEYS = ("fill_walk_ms", "d2h_ms", "replay_ms", "render_ms")
RANGES = {"seqalign." + n for n in ("align_batch", "prep", "upload",
                                    "dispatch", "wait", "replay", "render")}


def rand_pairs(seed, count, lo=5, hi=300):
    rng = np.random.default_rng(seed)

    def seq():
        return "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
    return [(seq(), seq()) for _ in range(count)]


def expected_chunks(al, pairs):
    _, _, buckets = al._prep(pairs)
    return sum(-(-len(idxs) // al.chunk_size(key, len(idxs)))
               for key, idxs in buckets.items())


def test_align_batch_fills_every_key():
    al = BatchAligner(device="cpu", max_batch=8)
    pairs = rand_pairs(1, 24)
    al.align_batch(pairs)
    ph = al.last_phases
    assert list(ph) == list(batch.PHASES) + list(batch.COUNTERS)
    assert all(ph[k] > 0 for k in batch.PHASES), ph
    assert ph["chunks"] == expected_chunks(al, pairs) > 1
    # the CPU path runs the plain fill, which counts no CTAs
    assert ph["fill_ctas"] == ph["fill_sm_slots"] == 0
    assert ph["align_batch_ms"] >= ph["prep_ms"] + ph["upload_ms"]


@pytest.mark.parametrize("count,max_batch", [(1, 512), (9, 4), (70, 512)])
def test_chunks_follow_chunk_size(count, max_batch):
    al = BatchAligner(device="cpu", max_batch=max_batch)
    pairs = rand_pairs(2, count, 5, 200 if count < 64 else 100)
    al.align_batch(pairs)
    assert al.last_phases["chunks"] == expected_chunks(al, pairs)
    # one chunk has no gap before it
    assert (al.last_phases["gap_ms"] > 0) == (al.last_phases["chunks"] > 1)


def test_wave_chunks_count_only_wave_set_chunks(monkeypatch):
    """300 pairs of 8 x 4,096 (the cluster path at k = 1, 132 pairs a
    wave by the CPU's floor) go in three chunks of 100 that the wave
    limit set; 10 narrow pairs beside them in one chunk that it did not,
    dispatched last though they come first (the largest bucket first)."""
    rng = np.random.default_rng(9)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))
    wide = [(seq(8), seq(4096)) for _ in range(300)]
    narrow = [(seq(8), seq(100)) for _ in range(10)]
    al = BatchAligner(device="cpu", bucket_quantum=8)
    widths = []
    dispatch = al._dispatch

    def spy(a, b, *args):
        widths.append(b.shape[1])
        return dispatch(a, b, *args)
    monkeypatch.setattr(al, "_dispatch", spy)
    out = al.align_batch(narrow + wide)
    assert all(r is not None for r in out)
    assert widths == [4096] * 3 + [104]
    assert al.last_phases["chunks"] == expected_chunks(al, wide + narrow) == 4
    assert al.last_phases["wave_chunks"] == 3
    al.align_batch(narrow + wide[:60])  # 60 wide pairs: one chunk
    assert al.last_phases["chunks"] == 2
    assert al.last_phases["wave_chunks"] == 0


def test_last_phases_start_afresh_each_call():
    al = BatchAligner(device="cpu", max_batch=4)
    al.align_batch(rand_pairs(3, 12, 5, 100))
    first = al.last_phases
    assert first["chunks"] == 3
    al.align_batch(rand_pairs(4, 4, 5, 100))
    assert al.last_phases is not first and first["chunks"] == 3
    assert al.last_phases["chunks"] == 1
    assert al.last_phases["gap_ms"] == 0.0
    assert all(k in al.last_phases for k in OLD_KEYS)


def test_count_outside_a_recorder_does_nothing():
    observability.count("chunks", 5)  # no recorder: no error, no state
    outer, inner = PhaseTimer(), PhaseTimer()
    with outer:
        observability.count("x")
        with inner:
            observability.count("x", 2)
        observability.count("x", 3)
    observability.count("x", 7)
    assert outer.totals == {"x": 4} and outer.counts == {"x": 2}
    assert inner.totals == {"x": 2}


def test_span_adds_ms_and_leaves_the_stack_on_error():
    t = PhaseTimer({"prep_ms": 0.0})
    with pytest.raises(KeyError):
        with t, t.span("prep"):
            raise KeyError
    assert t.totals["prep_ms"] > 0 and t.counts == {"prep_ms": 1}
    assert observability.active() is not t
    observability.count("prep_ms", 1)
    assert t.counts == {"prep_ms": 1}


def test_marks_on_the_cpu():
    early, late = Marks(torch.device("cpu")), Marks(torch.device("cpu"))
    early.mark()
    early.mark()
    late.mark()
    late.mark()
    assert early.ms(0) >= 0 and late.since(early) >= 0
    assert late.since(early) <= (late.marks[1] - early.marks[0]) * 1e3


def test_ranges_under_the_profiler_nest_in_align_batch():
    al = BatchAligner(device="cpu", max_batch=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        al.align_batch(rand_pairs(5, 10, 5, 100))
    ev = [e for e in prof.events() if e.name.startswith("seqalign.")]
    assert {e.name for e in ev} == RANGES
    (top,) = [e for e in ev if e.name == "seqalign.align_batch"]
    for e in ev:
        assert top.time_range.start <= e.time_range.start
        assert e.time_range.end <= top.time_range.end
    # spans a chunk, never a pair: three chunks of 4, 4 and 2 pairs
    assert sum(e.name == "seqalign.render" for e in ev) == 3


def test_no_range_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    al = BatchAligner(device="cpu", max_batch=4)
    out = al.align_batch(rand_pairs(6, 10, 5, 100))
    assert all(r is not None for r in out)
    assert al.last_phases["chunks"] == 3


def test_sharded_spans_count_into_the_call():
    pairs = rand_pairs(7, 11, 5, 60)
    sh = ShardedBatchAligner(mesh=make_data_mesh(2, device="cpu"),
                             device="cpu", max_batch=4)
    got = sh.align_batch(pairs)
    want = BatchAligner(device="cpu", max_batch=4).align_batch(pairs)
    assert [(r.score, r.aligned_a) for r in got] == \
        [(r.score, r.aligned_a) for r in want]
    ph = sh.last_phases
    assert ph["chunks"] == expected_chunks(sh, pairs) == 3
    assert all(ph[k] > 0 for k in batch.PHASES), ph


def metric_module(name):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    return metric_module(name).read


@pytest.mark.parametrize("p", [8, 32])
def test_partition_counts_its_fills(p):
    """On a 2,000 x 3,000 pair: the crossing fills cover (2 - 2/p) m n
    cells over the bisection's levels and m n / 2 more for the first
    level's reverse fill that ends in T1, within 0.1%; each level's jobs
    go through one K6 launch (``crossing_launches`` = the levels), the
    first level's forward job filled once for its two tasks."""
    rng = np.random.default_rng(18)
    a, b = (rng.integers(0, 4, n).astype(np.uint8) for n in (2000, 3000))
    tasks = []

    def record(level):
        tasks.append(len(level))
        return partition.batched_crossings(level, ScoringParams(),
                                           device="cpu")
    with observability.PhaseTimer() as timer:
        partition.balanced_partition(a, b, p, crossings_fn=record,
                                     device="cpu")
    got = timer.totals
    assert got["crossing_cells"] == pytest.approx(
        (2.5 - 2 / p) * 2000 * 3000, rel=1e-3)
    assert got["crossing_levels"] == len(tasks) == math.log2(p)
    assert tasks[0] == 2 and tasks[1:] == [2 ** k for k in
                                           range(1, len(tasks))]
    assert got["crossing_launches"] == got["crossing_levels"]
    assert got["strip_jobs"] == 2 * sum(tasks) - 1


def test_partition_ranges_once_an_align():
    """Under the profiler each ``align`` opens ``seqalign.crossing``,
    ``seqalign.segments`` and ``seqalign.stitch`` once, in that order,
    with ``align_batch``'s ranges inside ``seqalign.segments``; its
    ``last_phases`` is a fresh recorder's."""
    al = partition.PartitionedAligner(p=4, device="cpu", bucket_quantum=16)
    (a, b), (c, d) = rand_pairs(8, 2, 60, 120)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        al.align(a, b)
        first = al.last_phases
        al.align(c, d)
    ev = sorted((e for e in prof.events() if e.name.startswith("seqalign.")),
                key=lambda e: e.time_range.start)
    tops = [e.name for e in ev if e.name.split(".")[1] in
            ("crossing", "segments", "stitch")]
    assert tops == ["seqalign.crossing", "seqalign.segments",
                    "seqalign.stitch"] * 2
    segs = [e for e in ev if e.name == "seqalign.segments"]
    inner = [e for e in ev if e.name == "seqalign.align_batch"]
    assert len(inner) == 2
    for s, e in zip(segs, inner):
        assert s.time_range.start <= e.time_range.start
        assert e.time_range.end <= s.time_range.end
    assert al.last_phases is not first
    assert list(first) == list(partition.PHASES + partition.COUNTERS)
    assert all(first[k] > 0 for k in partition.PHASES)


SPANS = {"prep_ms": 12.0, "upload_ms": 900.0, "wait_ms": 3.0,
         "gap_ms": 40.0, "fill_ctas": 480, "fill_sm_slots": 2640,
         "fill_walk_ms": 1000.0, "crossing_ms": 2500.0,
         "segments_ms": 300.0, "stitch_ms": 90.0}
READERS = [
    ("host_prep_us_per_pair.gcups", ["prep_ms"], 1e3 * 12.0 / 64),
    ("upload_us_per_pair.gcups", ["upload_ms"], 1e3 * 900.0 / 64),
    ("collect_wait_us_per_pair.gcups", ["wait_ms"], 1e3 * 3.0 / 64),
    ("chunk_gap_us_per_pair.gcups", ["gap_ms"], 1e3 * 40.0 / 64),
    ("fill_sm_share_pct.gcups", ["fill_ctas", "fill_sm_slots"],
     100.0 * 480 / 2640),
    ("crossing_ms_per_pair.gcups", ["crossing_ms"], 2500.0 / 64),
    ("segments_ms_per_pair.gcups", ["segments_ms"], 300.0 / 64),
    ("stitch_ms_per_pair.gcups", ["stitch_ms"], 90.0 / 64),
]


@pytest.mark.parametrize("name,keys,want", READERS,
                         ids=[r[0] for r in READERS])
def test_benchmark_readers(name, keys, want):
    """The harness's ``Readings`` as the readers see it: the window's
    summed ``last_phases`` and its pairs."""
    read = reader(name)
    assert read(types.SimpleNamespace(spans=dict(SPANS), pairs=64)) == \
        pytest.approx(want, rel=1e-12)
    for k in keys:  # the parent program has no such key
        spans = {n: v for n, v in SPANS.items() if n != k}
        assert read(types.SimpleNamespace(spans=spans, pairs=64)) is None
    if name.startswith("fill_sm_share"):  # the CPU's plain fill counts 0
        spans = {**SPANS, "fill_ctas": 0, "fill_sm_slots": 0}
        assert read(types.SimpleNamespace(spans=spans, pairs=64)) is None


def test_crossing_roofline_reader(monkeypatch):
    """The crossing search's least time from the pass and the cell's p:
    17 operations a cell over (5/2 - 2/p) m n cells, bound by operations,
    over the traced time of ``strip_kernel`` a pass; nothing without that
    kernel in the trace or without a cell on the command line."""
    monkeypatch.syspath_prepend(str(METRICS.parent))
    mod = metric_module("crossing_roofline")
    import generate
    import devtrace

    pairs = [("A" * 13309, "C" * 80240), ("G" * 97409, "T" * 77812)]
    cells = 13309 * 80240 + 77812 * 97409
    least = 17 * (2.5 - 2 / 32) * cells / 67e12
    r = types.SimpleNamespace(
        passage=generate.Pass(calls=[[p] for p in pairs]), swap=True,
        device=devtrace.DeviceWindow(
            busy_s=1.0, window_s=2.0, passes=3,
            kernels={"strip_kernel": 6 * least, "fill_kernel<16, false, "
                     "true>": 1.0}))
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "dna-genes-partition", "--seed", "1"])
    assert mod.read(r) == pytest.approx(50.0, rel=1e-12)
    la, lb = r.passage.oriented_lengths(True)
    assert mod.least_seconds(la, lb, 32) == pytest.approx(least, rel=1e-12)
    monkeypatch.setattr(sys, "argv", ["run.py"])
    assert mod.read(r) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload",
                                      "dna-genes-partition"])
    r.device.kernels.pop("strip_kernel")
    assert mod.read(r) is None


@pytest.mark.cuda
def test_fill_counters_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    al = BatchAligner(device="cuda", max_batch=3)
    pairs = rand_pairs(8, 6, 5000, 5001)  # one bucket past 4,096 columns
    al.align_batch(pairs)
    _, _, buckets = al._prep(pairs)
    ((key, idxs),) = buckets.items()
    step = al.chunk_size(key, len(idxs))
    sizes = [len(idxs[s: s + step]) for s in range(0, len(idxs), step)]
    ctas = sum(B * rowcb.fill_geometry(B, key[1])[2] for B in sizes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ph = al.last_phases
    assert ph["chunks"] == len(sizes) == 2
    assert ph["fill_ctas"] == ctas
    assert ph["fill_sm_slots"] == len(sizes) * sms
    assert ph["gap_ms"] > 0 and ph["fill_walk_ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("count,la,lb", [(300, 250, 4600), (140, 100, 8300)])
def test_wave_plan_on_card(count, la, lb, monkeypatch):
    """A cluster-path bucket that the wave limit cuts (k = 1 at 4,608
    columns, k = 2 at 8,320): every K1 launch holds at most the pairs
    CUDA co-schedules at its geometry, and the answers are the plain
    path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(count)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))
    pairs = [(seq(la), seq(lb)) for _ in range(count)]
    launches = []
    fill = rowcb._fill

    def spy(a, b, *args):
        launches.append((a.shape[0], args[-1]))
        return fill(a, b, *args)
    monkeypatch.setattr(rowcb, "_fill", spy)
    al = BatchAligner(device="cuda")
    got = al.align_batch(pairs)
    ph = al.last_phases
    assert ph["wave_chunks"] == ph["chunks"] == len(launches) > 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, (C, threads, k) in launches:
        per_sm, clusters = rowcb.fill_occupancy(C, threads, k)
        assert B <= (clusters if k > 1 else per_sm * sms), (B, C, threads, k)
    want = BatchAligner(device="cpu").align_batch(pairs)
    assert [(r.score, r.end_table, list(r.chain), r.aligned_a, r.aligned_b)
            for r in got] == \
        [(r.score, r.end_table, list(r.chain), r.aligned_a, r.aligned_b)
         for r in want]
