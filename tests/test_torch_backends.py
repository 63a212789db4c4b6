"""The port's ``BatchAligner`` backends and their kernels on the CPU ==
the JAX package's: K3' ``rowscan_score_fill``, K1' ``rowdirs_fill``
(uint8 codes and the ``with_runs`` form), K5 ``skew_dirs_fill``, K2s
``step_walk`` and ``walk_batch_device``, and the routes
``backend="pallas_rowscan"``, ``"rowdirs"`` and ``"wavefront"`` of
``BatchAligner`` and ``PartitionedAligner``.

Inputs come from numpy seeds. The JAX references run as the JAX tests run
them on the CPU (Pallas in interpret mode, which ``_default_interpret``
picks there), in subprocesses whose XLA:CPU emits no fused multiply-add
(``jax_nofma``), at the default parameters and at g=0.3, h=1.7. The plain
versions must equal them bit for bit: tolerance 0 throughout.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_numerics import SETS, jax_nofma, result_tuple
from test_torch_rowcb import ACGT, STARTS, make_bucket, port

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops import (
    device_walk,
    diag,
    rowcb,
)
from cse305_parallel_sequence_alignment_torch.parallel import partition
from cse305_parallel_sequence_alignment_torch.utils import matrices

PSETS = {"default": ScoringParams(), "g0.3-h1.7": SETS["g0.3-h1.7"]}
TYPES = [-1, -2, -3, 1, 2, 3]
ROUTE_CASES = {
    # traceback mode, per-pair types, offsets
    "parity": ("parity", False, False),
    "parity-mixed-types": ("parity", True, False),
    "full-mixed-types-offsets": ("full", True, True),
}


def kernel_bucket():
    """Six ragged pairs with an empty side possible, one start type
    each."""
    a, b, la, lb = make_bucket(np.random.default_rng(61), 6, 40, 60, 0)
    return a, b, la, lb, STARTS.copy()


def skew_bucket():
    return make_bucket(np.random.default_rng(62), 6, 30, 40, 0)


def walk_tables(B):
    return (np.arange(B) % 3 + 1).astype(np.int32)


def route_pairs():
    """Ragged pairs up to ~200 nt (a <= b, so no parity swap), some of
    them related (long diagonal runs); one bucket at quantum 256."""
    rng = np.random.default_rng(63)
    pairs = []
    for k in range(12):
        n = int(rng.integers(20, 200))
        b = ACGT[rng.integers(0, 4, n)]
        if k % 3 == 0:  # a copy of b with substitutions
            a = b[: int(rng.integers(1, n + 1))].copy()
            hits = rng.integers(0, len(a), max(1, len(a) // 15))
            a[hits] = ACGT[rng.integers(0, 4, len(hits))]
        else:
            a = ACGT[rng.integers(0, 4, int(rng.integers(1, n + 1)))]
        pairs.append((a.tobytes().decode(), b.tobytes().decode()))
    return pairs


def route_kwargs(case):
    mode, typed, offs = ROUTE_CASES[case]
    kw = dict(traceback_mode=mode)
    if typed:
        kw["start_types"] = [TYPES[k % 6] for k in range(12)]
        kw["end_types"] = [TYPES[(k * 5 + 1) % 6] for k in range(12)]
    if offs:
        kw["offsets"] = [(3 * k, 7 * k + 1) for k in range(12)]
    return kw


def partition_pairs():
    rng = np.random.default_rng(64)
    base = ACGT[rng.integers(0, 4, 400)]
    rel = base[50:350].copy()
    rel[rng.integers(0, 300, 12)] = ACGT[rng.integers(0, 4, 12)]
    return [(rel.tobytes().decode(), base.tobytes().decode()),
            (ACGT[rng.integers(0, 4, 310)].tobytes().decode(),
             ACGT[rng.integers(0, 4, 390)].tobytes().decode())]


def _jax_rowdirs(a, b, la, lb, st, kw, with_runs):
    """``_pallas_rowdirs`` with per-pair start types, prepared as
    ``pallas_rowdirs_batch`` prepares its inputs; (dirs, finals)."""
    from cse305_parallel_sequence_alignment_tpu.ops import pallas_fill as pf
    B, m = a.shape
    n = b.shape[1]
    nl = -(-(n + 1) // 128) * 128
    ma = max(-(-m // 128) * 128, 128) + 128
    block_b = 8
    Bp = -(-B // block_b) * block_b
    a_pad = np.full((Bp, ma), 254, np.int32)
    a_pad[:B, :m] = a
    b_ext = np.full((Bp, nl), 255, np.int32)
    b_ext[:B, 1: n + 1] = b
    lbmask = np.zeros((Bp, nl), np.int32)
    lbmask[np.arange(B), lb] = 1
    la_t = np.full((Bp, 128), -1, np.int32)
    la_t[:B] = la[:, None]
    st_t = np.full((Bp, 128), -1, np.int32)
    st_t[:B] = st[:, None]
    dirs, fin = pf._pallas_rowdirs(
        a_pad, b_ext, lbmask, la_t, st_t, m=m, n=n, nl=nl, block_b=block_b,
        interpret=True, with_runs=with_runs, **kw)
    return np.asarray(dirs)[:, :B], np.asarray(fin)[:B, :3]


def _references(pset):
    """Every JAX reference of this module at ``PSETS[pset]`` (run by
    ``jax_nofma``)."""
    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.models.batch import (
        BatchAligner as JaxBatchAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.models.batch import (
        _end_choice_vec,
    )
    from cse305_parallel_sequence_alignment_tpu.ops import device_walk as dw
    from cse305_parallel_sequence_alignment_tpu.ops import pallas_fill as pf
    from cse305_parallel_sequence_alignment_tpu.parallel import (
        partition as jax_partition,
    )

    p = PSETS[pset]
    jp = JaxParams(*p.astuple())
    kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
    ref = {}
    a, b, la, lb, st = kernel_bucket()
    ref["k3p"] = {int(s): pf.pallas_rowscan_score_batch(
        a, b, la, lb, start_type=int(s), **kw) for s in STARTS}
    ref["k1p_batch"] = {s: pf.pallas_rowdirs_batch(
        a, b, la, lb, start_type=s, **kw) for s in (-1, 2)}
    ref["k1p"] = _jax_rowdirs(a, b, la, lb, st, kw, with_runs=False)
    ref["k1p_runs"] = _jax_rowdirs(a, b, la, lb, st, kw, with_runs=True)
    sa, sb, sla, slb = skew_bucket()
    ref["k5"] = {int(s): pf.pallas_dirs_batch(
        sa, sb, sla, slb, start_type=int(s), **kw) for s in STARTS}

    # K2s over both layouts, from the JAX kernels' own dirs
    walks = {}
    for layout, dirs, wla, wlb in (
            ("row", ref["k1p"][0], la, lb),
            ("skew", ref["k5"][-1][1], sla, slb)):
        t0 = walk_tables(len(wla))
        steps = int(wla.max() + wlb.max()) + 1
        walks[layout] = {"ops": np.asarray(dw._device_walk(
            dirs, wla, wlb, t0, max_steps=steps, pair_axis=1,
            layout=layout))}
        for mode in ("parity", "full"):
            walks[layout][mode] = dw.walk_batch_device(
                dirs, wla, wlb, t0, mode=mode, pair_axis=1, layout=layout)
    ref["walks"] = walks

    # the routes: rowdirs is the JAX package's non-fused Pallas route
    # (_dirs_walk_grouped: K1' in interpret mode, then the device walk)
    pairs = route_pairs()
    pallas = JaxBatchAligner(params=jp, backend="pallas", bucket_quantum=256)
    pallas._fused_ok = lambda: False
    wave = JaxBatchAligner(params=jp, backend="wavefront",
                           bucket_quantum=256)
    ref["routes"] = {
        case: {"rowdirs": [result_tuple(r) for r in pallas.align_batch(
                   pairs, **route_kwargs(case))],
               "wavefront": [result_tuple(r) for r in wave.align_batch(
                   pairs, **route_kwargs(case))]}
        for case in ROUTE_CASES}
    ref["score"] = {
        be: JaxBatchAligner(params=jp, backend=be,
                            bucket_quantum=256).score_batch(pairs)
        for be in ("pallas_rowscan", "wavefront")}
    # the Pallas K5 route: pallas_dirs_batch, then the device walk
    fin, dirs = pf.pallas_dirs_batch(sa, sb, sla, slb, device_dirs=True,
                                     **kw)
    tables, _ = _end_choice_vec(fin, -1, p.h)
    ref["k5_chains"] = (tables, dw.walk_batch_device(
        dirs, sla, slb, tables, pair_axis=1, layout="skew"))
    if pset == "default":
        ref["partition"] = [result_tuple(jax_partition.PartitionedAligner(
            params=jp, p=4, backend="wavefront").align(x, y))
            for x, y in partition_pairs()]
    return ref


def _references_default():
    return _references("default")


def _references_g03():
    return _references("g0.3-h1.7")


@pytest.fixture(scope="module")
def refs():
    with ThreadPoolExecutor(2) as pool:
        futs = {name: pool.submit(jax_nofma, "test_torch_backends", fn)
                for name, fn in (("default", "_references_default"),
                                 ("g0.3-h1.7", "_references_g03"))}
        return {name: f.result() for name, f in futs.items()}


@pytest.mark.parametrize("pset", sorted(PSETS))
def test_rowscan_score_fill_matches_jax(refs, pset):
    """K3' plain against ``pallas_rowscan_score_batch``, one call per
    start type (the JAX kernel keys it statically), and equal to K1's
    finals."""
    a, b, la, lb, _ = kernel_bucket()
    for s in STARTS:
        st = np.full(len(la), s, np.int32)
        got = rowcb.rowscan_score_fill(*port(a, b, la, lb, st), PSETS[pset])
        assert np.array_equal(got.numpy(), refs[pset]["k3p"][int(s)]), s
        _, k1 = rowcb.rowcb_fill(*port(a, b, la, lb, st), PSETS[pset])
        assert torch.equal(got, k1)


@pytest.mark.parametrize("pset", sorted(PSETS))
@pytest.mark.parametrize("with_runs", [False, True], ids=["u8", "u16"])
def test_rowdirs_fill_matches_jax(refs, pset, with_runs):
    """K1' plain against ``_pallas_rowdirs`` (per-pair start types) on
    every cell of the bucket's (m+1) x (n+1), padding included, and the
    finals; row 0 is zero."""
    a, b, la, lb, st = kernel_bucket()
    dirs, fin = rowcb.rowdirs_fill(*port(a, b, la, lb, st), PSETS[pset],
                                   with_runs=with_runs)
    dj, fj = refs[pset]["k1p_runs" if with_runs else "k1p"]
    assert dirs.dtype == (torch.uint16 if with_runs else torch.uint8)
    assert tuple(dirs.shape) == (a.shape[1] + 1, len(la), b.shape[1] + 1)
    m, n = a.shape[1], b.shape[1]
    assert np.array_equal(fin.numpy(), fj)
    assert np.array_equal(dirs.numpy(), dj[: m + 1, :, : n + 1])
    assert not dirs.numpy()[0].any()


@pytest.mark.parametrize("pset", sorted(PSETS))
def test_rowdirs_batch_wrapper_matches_jax(refs, pset):
    """K1' against the public ``pallas_rowdirs_batch`` at two scalar
    start types."""
    a, b, la, lb, _ = kernel_bucket()
    for s, (fj, dj) in refs[pset]["k1p_batch"].items():
        st = np.full(len(la), s, np.int32)
        dirs, fin = rowcb.rowdirs_fill(*port(a, b, la, lb, st), PSETS[pset])
        m, n = a.shape[1], b.shape[1]
        assert np.array_equal(fin.numpy(), fj)
        assert np.array_equal(dirs.numpy(), dj[: m + 1, :, : n + 1]), s


def test_rowdirs_u8_is_k1_codes_at_dyadic_parameters():
    """At dyadic parameters both omega orders round alike: K1' u8 is
    K1's word & 0x3F on every cell."""
    a, b, la, lb, st = kernel_bucket()
    args = port(a, b, la, lb, st)
    d8, f8 = rowcb.rowdirs_fill(*args, ScoringParams(g=0.5, h=1.25))
    d16, f16 = rowcb.rowcb_fill(*args, ScoringParams(g=0.5, h=1.25))
    assert torch.equal(d8.to(torch.int32),
                       d16.view(torch.int16).to(torch.int32) & 0x3F)
    assert torch.equal(f8, f16)


@pytest.mark.parametrize("pset", sorted(PSETS))
def test_skew_dirs_fill_matches_jax(refs, pset):
    """K5 plain against ``pallas_dirs_batch`` (interpret), one call per
    start type: the whole (m+n+1, B, n+1) leading part of the padded JAX
    array, and the finals, which are also K3's."""
    a, b, la, lb = skew_bucket()
    m, n = a.shape[1], b.shape[1]
    for s in STARTS:
        st = np.full(len(la), s, np.int32)
        dirs, fin = diag.skew_dirs_fill(*port(a, b, la, lb, st), PSETS[pset])
        fj, dj = refs[pset]["k5"][int(s)]
        assert dirs.dtype == torch.uint8
        assert tuple(dirs.shape) == (m + n + 1, len(la), n + 1)
        assert np.array_equal(dirs.numpy(), dj[: m + n + 1, :, : n + 1]), s
        assert np.array_equal(fin.numpy(), fj), s
        k3 = diag.score_fill(*port(a, b, la, lb, st), PSETS[pset])
        assert torch.equal(fin, k3)


@pytest.mark.parametrize("pset", sorted(PSETS))
@pytest.mark.parametrize("layout", ["row", "skew"])
def test_step_walk_matches_jax(refs, pset, layout):
    """K2s plain against ``_device_walk`` (ops, the same window of
    max_steps) and ``walk_batch_device`` against the JAX one (chains in
    both traceback modes), over the JAX kernels' own dirs."""
    if layout == "row":
        a, b, la, lb, _ = kernel_bucket()
        m, n = a.shape[1], b.shape[1]
        dirs = refs[pset]["k1p"][0][: m + 1, :, : n + 1]
    else:
        a, b, la, lb = skew_bucket()
        m, n = a.shape[1], b.shape[1]
        dirs = refs[pset]["k5"][-1][1][: m + n + 1, :, : n + 1]
    dirs = torch.from_numpy(np.ascontiguousarray(dirs))
    want = refs[pset]["walks"][layout]
    t0 = walk_tables(len(la))
    steps = int(la.max() + lb.max()) + 1
    ops, used = device_walk.step_walk(dirs, *port(la, lb, t0), steps, layout)
    assert np.array_equal(ops.numpy().T, want["ops"])
    assert int(used[0]) == int((want["ops"] != 0).sum(axis=1).max())
    for mode in ("parity", "full"):
        got = device_walk.walk_batch_device(dirs, la, lb, t0, mode=mode,
                                            layout=layout)
        assert got == [list(c) for c in want[mode]], mode


def test_step_walk_edges_and_errors():
    """A pair that starts on row 0 or column 0 writes nothing; bad
    inputs raise."""
    dirs = torch.zeros((5, 3, 6), dtype=torch.uint8)
    la, lb, t0 = (torch.tensor(v, dtype=torch.int32)
                  for v in ([0, 3, 4], [5, 0, 5], [1, 2, 3]))
    ops, used = device_walk.step_walk(dirs, la, lb, t0, 10)
    assert not ops[:, :2].any() and int(used[0]) == 4
    assert ops[:4, 2].tolist() == [1, 1, 1, 1]  # T3 code 0: up into T1
    with pytest.raises(ValueError):
        device_walk.step_walk(dirs, la, lb, t0, 10, layout="band")
    with pytest.raises(TypeError):
        device_walk.step_walk(dirs.to(torch.int16), la, lb, t0, 10)
    with pytest.raises(ValueError):
        device_walk.step_walk(dirs, la.to(torch.int64), lb, t0, 10)


def bad_starts(layout):
    """Zero dirs and six starts: a valid one, then a row past the dirs, a
    column past them, a negative row, table 0 and table 4."""
    rows = 5 if layout == "row" else 9
    dirs = torch.zeros((rows, 6, 5), dtype=torch.uint8)
    return dirs, ([3, rows, 2, -1, 3, 3], [4, 1, 5, 2, 4, 4],
                  [1, 1, 1, 1, 0, 4])


@pytest.mark.parametrize("layout", ["row", "skew"])
def test_step_walk_refuses_starts_outside_the_dirs(layout):
    """A start cell outside the dirs, or a table outside 1-3, takes no
    step (the kernel reads nothing there), and the host replay refuses
    the empty walk; the valid pair walks alone."""
    dirs, (la, lb, t0) = bad_starts(layout)
    ops, used = device_walk.step_walk(
        dirs, *(torch.tensor(v, dtype=torch.int32) for v in (la, lb, t0)),
        12, layout)
    assert ops[:3, 0].tolist() == [1, 1, 1] and int(used[0]) == 3
    assert not ops[3:].any() and not ops[:, 1:].any()
    with pytest.raises(RuntimeError, match="never reached"):
        device_walk.walk_batch_device(dirs, la, lb, t0, layout=layout)
    chain = device_walk.walk_batch_device(dirs[:, :1].contiguous(), la[:1],
                                          lb[:1], t0[:1], layout=layout)
    assert chain == [[(1, 2, 1), (2, 3, 1), (3, 4, 1)]]


def same(got, want):
    assert [result_tuple(r) for r in got] == want


@pytest.mark.parametrize("pset", sorted(PSETS))
@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
@pytest.mark.parametrize("backend", ["rowdirs", "wavefront"])
def test_align_routes_match_jax(refs, pset, case, backend):
    """``align_batch`` under "rowdirs" against the JAX aligner's
    non-fused Pallas route (``_dirs_walk_grouped``: K1' then the device
    walk, grouped by type), and under "wavefront" against the JAX
    ``backend="wavefront"`` aligner: scores, chains, rows, end tables."""
    al = BatchAligner(params=PSETS[pset], backend=backend, bucket_quantum=256,
                      device="cpu")
    same(al.align_batch(route_pairs(), **route_kwargs(case)),
         refs[pset]["routes"][case][backend])


@pytest.mark.parametrize("pset", sorted(PSETS))
def test_wavefront_chains_match_pallas_dirs_route(refs, pset):
    """K5 + K2s chains equal the JAX ``pallas_dirs_batch`` +
    ``walk_batch_device`` chains on the same bucket."""
    a, b, la, lb = skew_bucket()
    tables, want = refs[pset]["k5_chains"]
    dirs, fin = diag.skew_dirs_fill(
        *port(a, b, la, lb, np.full(len(la), -1, np.int32)), PSETS[pset])
    got = device_walk.walk_batch_device(dirs, la, lb, tables)
    assert got == [list(c) for c in want]


@pytest.mark.parametrize("pset", sorted(PSETS))
@pytest.mark.parametrize("backend", ["pallas_rowscan", "wavefront"])
def test_score_routes_match_jax(refs, pset, backend):
    """``score_batch`` under "pallas_rowscan" (K3') and "wavefront" (K3)
    against the JAX aligner's on the same backend."""
    al = BatchAligner(params=PSETS[pset], backend=backend, bucket_quantum=256,
                      device="cpu")
    s, t = al.score_batch(route_pairs())
    s_j, t_j = refs[pset]["score"][backend]
    assert np.array_equal(s, s_j) and np.array_equal(t, t_j)


def test_partitioned_aligner_wavefront_matches_jax(refs):
    """``PartitionedAligner(backend="wavefront")``: K6 crossings, then
    the segments through K5 and K2s, against the JAX aligner's wavefront
    segment solves: score, chain and rows."""
    for (x, y), want in zip(partition_pairs(), refs["default"]["partition"]):
        al = partition.PartitionedAligner(p=4, backend="wavefront",
                                          device="cpu")
        assert result_tuple(al.align(x, y)) == want


@pytest.mark.parametrize("backend", ["pallas_rowscan", "wavefront",
                                     "rowdirs"])
def test_golden_cases_through_backend(golden_pipeline, golden_subproblem,
                                      backend):
    """The 186 golden cases through each new backend: pipeline rows,
    subproblem chains (mixed types, one launch a chunk) and the raw
    finals of ``score_batch`` under the forced end types."""
    for gh in sorted({(r["g"], r["h"]) for r in golden_pipeline}):
        recs = [r for r in golden_pipeline if (r["g"], r["h"]) == gh]
        al = BatchAligner(params=ScoringParams(g=gh[0], h=gh[1]),
                          backend=backend, device="cpu")
        res = al.align_batch([(r["A"], r["B"]) for r in recs])
        for r, got in zip(recs, res):
            assert (got.aligned_a, got.aligned_b) == (r["out_a"],
                                                      r["out_b"]), r
    for gh in sorted({(r["g"], r["h"]) for r in golden_subproblem}):
        recs = [r for r in golden_subproblem if (r["g"], r["h"]) == gh]
        params = ScoringParams(g=gh[0], h=gh[1])
        pairs = [(r["A"], r["B"]) for r in recs]
        res = BatchAligner(params=params, backend=backend,
                           device="cpu").align_batch(
            pairs, start_types=[r["start"] for r in recs],
            end_types=[r["end"] for r in recs])
        for r, got in zip(recs, res):
            chain = "".join(f"({i},{j},{t})" for (i, j, t) in got.chain)
            assert chain == r["chain"], r
        for st in sorted({r["start"] for r in recs}):
            idx = [k for k, r in enumerate(recs) if r["start"] == st]
            cols = [BatchAligner(params=params, start_type=st, end_type=e,
                                 backend=backend, device="cpu").score_batch(
                [pairs[k] for k in idx])[0] for e in (1, 2, 3)]
            for w, k in enumerate(idx):
                want = [NEG_INF if v == "-inf" else float(v)
                        for v in recs[k]["final"]]
                assert [float(c[w]) for c in cols] == want, recs[k]


def test_backend_errors():
    """A matrix runs on "auto"/"pallas" only; unknown backends raise in
    both aligners."""
    for be in ("pallas_rowscan", "wavefront", "rowdirs"):
        with pytest.raises(ValueError, match="matrix"):
            BatchAligner(matrix=matrices.BLOSUM62, backend=be, device="cpu")
    BatchAligner(matrix=matrices.BLOSUM62, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        BatchAligner(backend="xla", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        partition.PartitionedAligner(backend="xla", device="cpu")


def test_chunks_follow_the_routes_dirs_bytes():
    """Each route cuts its chunks by its own dirs bytes, and the results
    do not depend on the cut."""
    bm, bn = 128, 256
    budget = 25 * (bm + bn + 1) * (bn + 1)  # 25 pairs of skew dirs
    sizes = {be: BatchAligner(backend=be, dirs_budget=budget,
                              device="cpu").chunk_size((bm, bn), 60)
             for be in ("auto", "rowdirs", "wavefront")}
    assert sizes == {"auto": 30, "rowdirs": 74, "wavefront": 20}
    pairs = [(encode_seq(x), encode_seq(y)) for x, y in route_pairs()]
    for be in ("rowdirs", "wavefront"):
        whole = BatchAligner(backend=be, bucket_quantum=256, device="cpu")
        cut = BatchAligner(backend=be, bucket_quantum=256, max_batch=5,
                           device="cpu")
        assert [result_tuple(r) for r in whole.align_batch(pairs)] == \
            [result_tuple(r) for r in cut.align_batch(pairs)]


@pytest.mark.cuda
def test_backend_kernels_match_plain_on_card():
    """K3', K1' (u8 and u16), K5 and K2s against their plain versions on
    the card, and the routes against the fused route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for params in PSETS.values():
        a, b, la, lb, st = kernel_bucket()
        args = [x.cuda() for x in port(a, b, la, lb, st)]
        cpu = [x.cpu() for x in args]
        assert torch.equal(rowcb.rowscan_score_fill(*args, params).cpu(),
                           rowcb.rowscan_score_fill(*cpu, params))
        for runs in (False, True):
            d_k, f_k = rowcb.rowdirs_fill(*args, params, with_runs=runs)
            d_p, f_p = rowcb.rowdirs_fill(*cpu, params, with_runs=runs)
            assert torch.equal(d_k.cpu().view(torch.uint8),
                               d_p.view(torch.uint8))
            assert torch.equal(f_k.cpu(), f_p)
        d5_k, f5_k = diag.skew_dirs_fill(*args, params)
        d5_p, f5_p = diag.skew_dirs_fill(*cpu, params)
        assert torch.equal(d5_k.cpu(), d5_p) and torch.equal(f5_k.cpu(), f5_p)
        t0 = torch.from_numpy(walk_tables(len(la))).cuda()
        steps = int(la.max() + lb.max()) + 1
        for dirs, layout in ((rowcb.rowdirs_fill(*args, params)[0], "row"),
                             (d5_k, "skew")):
            w_k = device_walk.step_walk(dirs, args[2], args[3], t0, steps,
                                        layout)
            w_p = device_walk.step_walk_plain(dirs, args[2], args[3], t0,
                                              steps, layout)
            assert all(torch.equal(x, y) for x, y in zip(w_k, w_p))
    for layout in ("row", "skew"):
        dirs, starts = bad_starts(layout)
        args = [dirs.cuda()] + [torch.tensor(v, dtype=torch.int32).cuda()
                                for v in starts]
        w_k = device_walk.step_walk(*args, 12, layout)
        w_p = device_walk.step_walk_plain(*args, 12, layout)
        assert all(torch.equal(x, y) for x, y in zip(w_k, w_p))
    pairs = route_pairs()
    fused = [result_tuple(r) for r in
             BatchAligner(bucket_quantum=256).align_batch(pairs)]
    for be in ("rowdirs", "wavefront"):
        assert [result_tuple(r) for r in BatchAligner(
            backend=be, bucket_quantum=256).align_batch(pairs)] == fused
