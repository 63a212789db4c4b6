"""Port global fills and aligners == the JAX package at non-dyadic gap
costs: K1, K3, K6, K7, ``BatchAligner`` and ``PartitionedAligner``.

At integer or dyadic parameters every order of float32 operations gives
the same bits. At g = 0.3, h = 1.7 it does not, and the port takes the
operations that XLA runs for the JAX kernels: it folds ``x - g - h`` into
one subtraction of ``gh = g + h`` (rounded to float32), and K3 is the
anti-diagonal sweep of ``_score_kernel``, with T2 computed directly.

The JAX references run in interpret mode in a separate process whose
XLA:CPU emits no fused multiply-add (``--xla_cpu_max_isa=SSE4_2``). On a
host with FMA, XLA:CPU contracts some of the kernels' ``g * j`` products
into the adjacent add, in some fusions and not in others: the lane
prefix max of K1's T2 is flattened into eight fusions that each recompute
omega, and they disagree by an ulp. Those bits belong to XLA's code
generation, not to the kernels' arithmetic; without contraction the port
equals every JAX kernel and aligner here bit for bit. Tolerance is 0
throughout. Against the kernels as XLA:CPU runs them by default, the
number of cells and finals that differ is pinned exactly
(``FMA_RESIDUE``), so a drift on either side shows.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from test_torch_rowcb import ACGT, STARTS, jax_rowcb, make_bucket, port

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops import longrow, longstair
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    rowcb_fill,
    score_fill,
)
from cse305_parallel_sequence_alignment_torch.parallel import partition

TESTS = pathlib.Path(__file__).resolve().parent
SETS = {
    "g0.3-h1.7": ScoringParams(g=0.3, h=1.7, match=1.0, mismatch=0.0),
    "g0.1-h0.7": ScoringParams(g=0.1, h=0.7, match=1.3, mismatch=-0.4),
}
NOFMA_FLAG = "--xla_cpu_max_isa=SSE4_2"


def jax_nofma(module, fn_name, fma=False):
    """``fn_name()`` of the test module ``module``, run in a new process
    whose XLA:CPU emits no fused multiply-add (with ``fma``, XLA:CPU's
    default code generation); returns its result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    flags = env.get("XLA_FLAGS", "").replace(NOFMA_FLAG, "")
    env["XLA_FLAGS"] = (flags if fma else flags + " " + NOFMA_FLAG).strip()
    code = ("import importlib, pickle, sys; "
            f"sys.path[:0] = [{str(TESTS)!r}, {str(TESTS.parent)!r}]; "
            "out = getattr(importlib.import_module(sys.argv[1]), "
            "sys.argv[2])(); "
            "pickle.dump(out, open(sys.argv[3], 'wb'))")
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "refs.pkl"
        proc = subprocess.run(
            [sys.executable, "-c", code, module, fn_name, str(path)],
            env=env, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with open(path, "rb") as f:
            return pickle.load(f)


def result_tuple(r):
    """A global result as plain values (pickles across processes)."""
    return (float(r.score), list(r.chain), r.aligned_a, r.aligned_b,
            int(r.end_table))


def k1_bucket(seed):
    rng = np.random.default_rng(seed)
    a, b, la, lb = make_bucket(rng, 6, 60, 150, 0)
    return a, b, la, lb, STARTS[np.arange(6) % 6]


def k3_bucket(seed):
    # tall and wide pairs, so both edge boundaries reach the finals
    rng = np.random.default_rng(seed)
    return make_bucket(rng, 6, 90, 70, 0)


def k6_bucket():
    rng = np.random.default_rng(9)
    a = np.full((4, 150), PAD_A, np.uint8)
    b = np.full((4, 400), PAD_B, np.uint8)
    la, lb = [150, 90, 12, 0], [400, 399, 250, 1]
    for k in range(4):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    return a, b, np.array(la, np.int32), np.array(lb, np.int32)


def seq(rng, n):
    return ACGT[rng.integers(0, 4, n)]


STAIRS = [(37, 300, 128, 16), (5, 64, 128, 16), (200, 300, 128, 16)]


def stair_pairs():
    rng = np.random.default_rng(13)
    return [(seq(rng, m), seq(rng, n)) for m, n, _, _ in STAIRS]


def batch_pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(10):
        m, n = rng.integers(1, 150, 2)
        out.append((ACGT[rng.integers(0, 4, m)].tobytes().decode(),
                    ACGT[rng.integers(0, 4, n)].tobytes().decode()))
    return out


def partition_pair():
    rng = np.random.default_rng(41)
    return (ACGT[rng.integers(0, 4, 130)].tobytes().decode(),
            ACGT[rng.integers(0, 4, 170)].tobytes().decode())


def _kernel_references():
    """The JAX kernels' outputs for K1, K3, K6 and K7 (run by
    ``jax_nofma``)."""
    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.ops import (
        pallas_longrow as jax_longrow,
    )
    from cse305_parallel_sequence_alignment_tpu.ops import (
        pallas_longstair as jax_longstair,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
        pallas_score_batch,
    )
    out = {}
    for name, p in SETS.items():
        jp = JaxParams(*p.astuple())
        kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
        ref = out[name] = {}
        ref["k1"] = [jax_rowcb(*k1_bucket(s), jp) for s in (1, 2)]
        ref["k3"] = {(s, st): pallas_score_batch(
            *k3_bucket(s), start_type=st, interpret=True, **kw)
            for s in (3, 4) for st in STARTS}
        a, b, la, lb = k6_bucket()
        ref["k6"] = {st: jax_longrow.pallas_long_score_batch(
            a, b, la, lb, start_type=st, chunk_cols=128, rc=32, **kw)
            for st in STARTS}
        ref["k6_row"] = {st: jax_longrow.pallas_long_lastrow(
            a[1, :90], b[1, :399], start_type=st, chunk_cols=128, rc=16,
            **kw) for st in STARTS}
        ref["k7"] = {(k, st): jax_longstair.stair_lastrow(
            x, y, start_type=st, nl_c=STAIRS[k][2], rc=STAIRS[k][3], **kw)
            for k, (x, y) in enumerate(stair_pairs()) for st in (-1, -2, 3)}
    return out


def _references():
    """Every JAX reference of this module (run by ``jax_nofma``)."""
    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.models.batch import (
        BatchAligner as JaxBatchAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.parallel import (
        partition as jax_partition,
    )
    out = _kernel_references()
    for name, p in SETS.items():
        jp = JaxParams(*p.astuple())
        ref = out[name]
        ja = JaxBatchAligner(params=jp, backend="pallas", bucket_quantum=64)
        ref["align"] = [result_tuple(r)
                        for r in ja.align_batch(batch_pairs(5))]
        ref["score"] = ja.score_batch(batch_pairs(5))
        x, y = partition_pair()
        jpa = jax_partition.PartitionedAligner(
            params=jp, p=4, backend="pallas", fill_backend="longrow")
        ref["points"] = jpa.partition(x, y)
        ref["partition"] = result_tuple(jpa.align(x, y))
    return out


@pytest.fixture(scope="module")
def refs():
    return jax_nofma("test_torch_numerics", "_references")


@pytest.mark.parametrize("pset", sorted(SETS))
def test_k1_matches_jax_rowcb(refs, pset):
    """K1 plain: every finals and every dirs16+runs cell of the pairs."""
    for k, seed in enumerate((1, 2)):
        a, b, la, lb, st = k1_bucket(seed)
        dj, fj = refs[pset]["k1"][k]
        dirs, fin = rowcb_fill(*port(a, b, la, lb, st), SETS[pset])
        assert np.array_equal(fin.numpy(), fj)
        dn = dirs.numpy()
        for r in range(len(la)):
            assert np.array_equal(dn[: la[r] + 1, r, : lb[r] + 1],
                                  dj[: la[r] + 1, r, : lb[r] + 1]), (seed, r)


@pytest.mark.parametrize("pset", sorted(SETS))
def test_k3_matches_jax_score_kernel(refs, pset):
    """K3 plain (the anti-diagonal sweep) in all six start types."""
    for seed in (3, 4):
        a, b, la, lb = k3_bucket(seed)
        for st in STARTS:
            got = score_fill(*port(a, b, la, lb, np.full(6, st, np.int32)),
                             SETS[pset])
            assert np.array_equal(got.numpy(), refs[pset]["k3"][seed, st]), \
                (seed, st)


@pytest.mark.parametrize("pset", sorted(SETS))
def test_k6_matches_jax_longrow(refs, pset):
    a, b, la, lb = k6_bucket()
    for st in STARTS:
        got = longrow.long_fill(*port(a, b, la, lb, np.full(4, st, np.int32)),
                                SETS[pset])
        assert np.array_equal(got.numpy(), refs[pset]["k6"][st]), st
        row = longrow.long_lastrow(a[1, :90], b[1, :399], SETS[pset], st,
                                   device="cpu")
        assert np.array_equal(row, refs[pset]["k6_row"][st]), st


@pytest.mark.parametrize("pset", sorted(SETS))
def test_k7_matches_jax_stair(refs, pset):
    for k, (x, y) in enumerate(stair_pairs()):
        for st in (-1, -2, 3):
            got = longstair.stair_lastrow(x, y, SETS[pset], st, device="cpu")
            assert np.array_equal(got, refs[pset]["k7"][k, st]), (k, st)


@pytest.mark.parametrize("pset", sorted(SETS))
def test_batch_aligner_matches_jax_pallas(refs, pset):
    """Scores, chains, rendered rows and end tables of ``align_batch``
    (K1 + K2) and ``score_batch`` (K3) against the JAX aligner's Pallas
    route (fused rowcb fill and walk, anti-diagonal score kernel)."""
    al = BatchAligner(params=SETS[pset], bucket_quantum=64, device="cpu")
    got = [result_tuple(r) for r in al.align_batch(batch_pairs(5))]
    assert got == refs[pset]["align"]
    s, t = al.score_batch(batch_pairs(5))
    s_j, t_j = refs[pset]["score"]
    assert np.array_equal(s, s_j) and np.array_equal(t, t_j)


@pytest.mark.parametrize("pset", sorted(SETS))
def test_partitioned_aligner_matches_jax_pallas(refs, pset):
    """Points (the crossings of the K6 level fills), then the stitched
    chain, score and rows (K1 segment solves) against the JAX
    ``PartitionedAligner`` on its Pallas route."""
    x, y = partition_pair()
    al = partition.PartitionedAligner(params=SETS[pset], p=4, device="cpu")
    ea, eb = encode_seq(x), encode_seq(y)
    points = partition.balanced_partition(
        ea, eb, 4, SETS[pset], device="cpu",
        crossings_fn=lambda tasks: partition.batched_crossings(
            tasks, SETS[pset], device="cpu"))
    assert points == refs[pset]["points"]
    assert result_tuple(al.align(x, y)) == refs[pset]["partition"]


def residue(ref, pset):
    """Cells and finals (float32 values) where the port's plain versions
    differ from the JAX references ``ref`` of ``SETS[pset]``, by kernel;
    aligner results that differ in any field."""
    p = SETS[pset]
    out = dict.fromkeys(("k1_dirs", "k1_finals", "k3", "k6", "k6_row",
                         "k7", "align", "score", "partition"), 0)
    for k, seed in enumerate((1, 2)):
        a, b, la, lb, st = k1_bucket(seed)
        dj, fj = ref["k1"][k]
        dirs, fin = rowcb_fill(*port(a, b, la, lb, st), p)
        out["k1_finals"] += int((fin.numpy() != fj).sum())
        dn = dirs.numpy()
        for r in range(len(la)):
            out["k1_dirs"] += int((dn[: la[r] + 1, r, : lb[r] + 1]
                                   != dj[: la[r] + 1, r, : lb[r] + 1]).sum())
    for seed in (3, 4):
        a, b, la, lb = k3_bucket(seed)
        for st in STARTS:
            got = score_fill(*port(a, b, la, lb, np.full(6, st, np.int32)), p)
            out["k3"] += int((got.numpy() != ref["k3"][seed, st]).sum())
    a, b, la, lb = k6_bucket()
    for st in STARTS:
        got = longrow.long_fill(*port(a, b, la, lb, np.full(4, st, np.int32)),
                                p)
        out["k6"] += int((got.numpy() != ref["k6"][st]).sum())
        row = longrow.long_lastrow(a[1, :90], b[1, :399], p, st, device="cpu")
        out["k6_row"] += int((row != ref["k6_row"][st]).sum())
    for k, (x, y) in enumerate(stair_pairs()):
        for st in (-1, -2, 3):
            got = longstair.stair_lastrow(x, y, p, st, device="cpu")
            out["k7"] += int((got != ref["k7"][k, st]).sum())
    al = BatchAligner(params=p, bucket_quantum=64, device="cpu")
    got = [result_tuple(r) for r in al.align_batch(batch_pairs(5))]
    out["align"] = sum(x != y for x, y in zip(got, ref["align"]))
    s, t = al.score_batch(batch_pairs(5))
    s_j, t_j = ref["score"]
    out["score"] = int(((s != s_j) | (t != t_j)).sum())
    x, y = partition_pair()
    pa = partition.PartitionedAligner(params=p, p=4, device="cpu")
    out["partition"] = int(result_tuple(pa.align(x, y)) != ref["partition"])
    return out


def host_has_fma():
    """Whether this CPU has FMA3, which XLA:CPU contracts into by
    default (numpy's own dispatch probe of the CPU)."""
    try:
        from numpy._core._multiarray_umath import __cpu_features__
    except ImportError:  # numpy < 2
        from numpy.core._multiarray_umath import __cpu_features__
    return bool(__cpu_features__.get("FMA3"))


# What ``residue`` counts against the JAX package as XLA:CPU runs it by
# default on an x86-64 host with FMA3 (jax/jaxlib 0.9.0); 0 everywhere on
# a host without FMA. Every difference is one ulp of a float32 value or a
# dirs code that follows from one (ROADMAP queue 3).
FMA_RESIDUE = {
    "g0.1-h0.7": {"k1_dirs": 573, "k1_finals": 9, "k3": 0, "k6": 0,
                  "k6_row": 0, "k7": 15, "align": 2, "score": 0,
                  "partition": 1},
    "g0.3-h1.7": {"k1_dirs": 1253, "k1_finals": 4, "k3": 2, "k6": 0,
                  "k6_row": 0, "k7": 254, "align": 3, "score": 0,
                  "partition": 1},
}


@pytest.fixture(scope="module")
def fma_refs():
    return jax_nofma("test_torch_numerics", "_references", fma=True)


@pytest.mark.parametrize("pset", sorted(SETS))
def test_fma_residue_is_pinned(fma_refs, pset):
    """Against XLA:CPU's default code generation the port differs by the
    exact counts of ``FMA_RESIDUE``, kernel by kernel."""
    got = residue(fma_refs[pset], pset)
    want = FMA_RESIDUE[pset] if host_has_fma() else dict.fromkeys(got, 0)
    assert got == want


def test_nofma_reference_runs_interpret_mode():
    """The reference process runs the Pallas kernels in interpret mode on
    the CPU with the flag set (a guard on the helper above)."""
    out = jax_nofma("test_torch_numerics", "_probe")
    assert out["backend"] == "cpu" and NOFMA_FLAG in out["flags"]
    assert out["interpret"] is True


def _probe():
    import jax

    from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
        _default_interpret,
    )
    return {"backend": jax.default_backend(),
            "flags": os.environ.get("XLA_FLAGS", ""),
            "interpret": _default_interpret(None)}


@pytest.mark.cuda
def test_global_kernels_match_plain_on_card_non_dyadic():
    """K1, K3 and K6 against their plain versions on the card at a
    non-dyadic parameter set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = SETS["g0.3-h1.7"]
    a, b, la, lb, st = k1_bucket(1)
    args = [x.cuda() for x in port(a, b, la, lb, st)]
    d_k, f_k = rowcb_fill(*args, params)
    d_p, f_p = rowcb_fill(*[x.cpu() for x in args], params)
    assert torch.equal(d_k.cpu().view(torch.int16), d_p.view(torch.int16))
    assert torch.equal(f_k.cpu(), f_p)
    assert torch.equal(score_fill(*args, params).cpu(),
                       score_fill(*[x.cpu() for x in args], params))
    assert torch.equal(longrow.long_fill(*args, params).cpu(),
                       longrow.long_fill(*[x.cpu() for x in args], params))
