"""The port's tracing (``utils/observability.py``) and the spans and
counters of ``BatchAligner.align_batch``.

On the CPU: every ``last_phases`` key filled on a mixed-length batch,
``chunks`` against ``chunk_size``, ``wave_chunks`` only for chunks the
wave limit cut, a fresh recorder each call, ``count`` outside a
recorder, the ``seqalign.*`` ranges under ``torch.profiler`` and none
without it, the sharded aligner's spans, and the benchmark's five
readers of these keys (``seqbench/metrics/``). On a card (marker
``cuda``): the fill's CTA and SM counters against ``fill_geometry``, and
the wave plan: no launch past CUDA's co-resident clusters, answers equal
to the plain path's.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cse305_parallel_sequence_alignment_torch.models import batch
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops import rowcb
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


def reader(name):
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


SPANS = {"prep_ms": 12.0, "upload_ms": 900.0, "wait_ms": 3.0,
         "gap_ms": 40.0, "fill_ctas": 480, "fill_sm_slots": 2640,
         "fill_walk_ms": 1000.0}
READERS = [
    ("host_prep_us_per_pair.gcups", ["prep_ms"], 1e3 * 12.0 / 64),
    ("upload_us_per_pair.gcups", ["upload_ms"], 1e3 * 900.0 / 64),
    ("collect_wait_us_per_pair.gcups", ["wait_ms"], 1e3 * 3.0 / 64),
    ("chunk_gap_us_per_pair.gcups", ["gap_ms"], 1e3 * 40.0 / 64),
    ("fill_sm_share_pct.gcups", ["fill_ctas", "fill_sm_slots"],
     100.0 * 480 / 2640),
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
