"""Port overlap mode (K11s/K11d fills, K2 walk, native build, aligner,
api, CLI) == the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays or strings; the JAX Pallas kernels run in
interpret mode. At the default parameters the references are computed in
this process; at the two non-dyadic sets they come from a process whose
XLA:CPU emits no fused multiply-add (``jax_nofma`` of
tests/test_torch_numerics.py, which says why). Each port route is held
against its own JAX counterpart: ``score_batch`` against the XLA
wavefront ``overlap_score_batch``, ``align_batch`` against the row sweep
``_ov_rowdirs_kernel`` (the two JAX routes round differently at
non-dyadic parameters, and differ on a pair whose B is empty). Tolerance
is 0 throughout.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_numerics import SETS, jax_nofma

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.overlap import (
    OVERLAP_PARAMS,
    OverlapBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops import cigar as port_cigar
from cse305_parallel_sequence_alignment_torch.ops import (
    traceback as port_tb,
)
from cse305_parallel_sequence_alignment_torch.ops.device_walk import rle_walk
from cse305_parallel_sequence_alignment_torch.ops.diag import (
    diag_fill_plain,
    overlap_score,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    overlap_dirs,
    overlap_dirs_plain,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACGT = np.frombuffer(b"ACGT", np.uint8)
PARAMS = dict(SETS, default=OVERLAP_PARAMS)


def _dna(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes().decode()


def _mutate(rng, s, rate):
    out = list(s)
    for k in np.nonzero(rng.random(len(out)) < rate)[0]:
        out[k] = "ACGT"[rng.integers(0, 4)]
    return "".join(out)


def _cases():
    rng = np.random.default_rng(29)
    ragged, dovetails = [], []
    for _ in range(6):
        ragged.append((_dna(rng, int(rng.integers(1, 90))),
                       _dna(rng, int(rng.integers(1, 90)))))
    for k in range(6):
        core = _dna(rng, int(rng.integers(10, 50)))
        x = _dna(rng, int(rng.integers(0, 40)))
        y = _dna(rng, int(rng.integers(0, 40)))
        if k % 2:  # suffix of A on a prefix of B
            dovetails.append((x + core, _mutate(rng, core, 0.08) + y))
        else:      # prefix of A on a suffix of B
            dovetails.append((core + x, y + _mutate(rng, core, 0.08)))
    run = _dna(rng, 300)
    return {
        "ragged": ragged,
        "dovetails": dovetails,
        "edges": [("", "ACGTA"), ("ACG", ""), ("", ""), ("G", "G"),
                  ("GATTACA", "TTAC"), ("AAAA", "CCCCAAAA")],
        "wide": [(_dna(rng, 40) + run[:90], run[:90] + _dna(rng, 200))],
        "long-run": [(_dna(rng, 9) + run, run + _dna(rng, 4))],
    }


CASES = _cases()


def bucket(pairs):
    """(a, b, la, lb) numpy bucket of the pairs, padded as the aligners
    pad (PAD_A / PAD_B) to the longest member (at least one column)."""
    la = np.array([len(x) for x, _ in pairs], np.int32)
    lb = np.array([len(y) for _, y in pairs], np.int32)
    a = np.full((len(pairs), max(1, la.max())), PAD_A, np.uint8)
    b = np.full((len(pairs), max(1, lb.max())), PAD_B, np.uint8)
    for k, (x, y) in enumerate(pairs):
        a[k, : la[k]] = np.frombuffer(x.encode(), np.uint8)
        b[k, : lb[k]] = np.frombuffer(y.encode(), np.uint8)
    return a, b, la, lb


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def result_tuple(r):
    return (float(r.score), list(r.chain), r.cigar, tuple(r.a_span),
            tuple(r.b_span), int(r.end_table))


def _jax_refs(names):
    import jax.numpy as jnp

    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.models.overlap import (
        OverlapBatchAligner as JaxAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.overlap import (
        overlap_score_batch,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.pallas_overlap import (
        pallas_overlap_dirs_batch,
    )
    out = {}
    for name in names:
        p = PARAMS[name]
        kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
        for case, pairs in CASES.items():
            a, b, la, lb = bucket(pairs)
            m, n = a.shape[1], b.shape[1]
            fin, dirs = pallas_overlap_dirs_batch(
                a, b, la, lb, with_runs=True, perm=False, interpret=True,
                **kw)
            ja = JaxAligner(params=JaxParams(*p.astuple()),
                            backend="pallas", bucket_quantum=64)
            out[name, case] = {
                "k11s": np.asarray(overlap_score_batch(
                    *(jnp.asarray(x) for x in (a, b, la, lb)), **kw)),
                "k11d": (fin, np.ascontiguousarray(
                    dirs[: m + 1, :, : n + 1])),
                "align": [result_tuple(r) for r in ja.align_batch(pairs)],
                "score": ja.score_batch(pairs),
            }
    return out


def _references():
    """The non-dyadic references (run by ``jax_nofma``)."""
    return _jax_refs(sorted(SETS))


@pytest.fixture(scope="module")
def refs():
    return {**_jax_refs(["default"]),
            **jax_nofma("test_torch_overlap", "_references")}


GRID = [(p, c) for p in sorted(PARAMS) for c in sorted(CASES)]


@pytest.mark.parametrize("pname,case", GRID)
def test_k11s_matches_jax(refs, pname, case):
    """K11s plain (through its CPU wrapper): score, end table, end cell,
    against the JAX wavefront."""
    a, b, la, lb = bucket(CASES[case])
    got = overlap_score(*port(a, b, la, lb), PARAMS[pname])
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(la), 4)
    assert np.array_equal(got.numpy(), refs[pname, case]["k11s"])


@pytest.mark.parametrize("pname,case", GRID)
def test_k11d_matches_jax(refs, pname, case):
    """K11d plain: bests and every dirs16+runs cell of the pairs."""
    a, b, la, lb = bucket(CASES[case])
    dirs, best = overlap_dirs(*port(a, b, la, lb), PARAMS[pname])
    fin, dj = refs[pname, case]["k11d"]
    assert dirs.dtype == torch.uint16
    assert tuple(dirs.shape) == (a.shape[1] + 1, len(la), b.shape[1] + 1)
    assert np.array_equal(best.numpy(), fin)
    dn = dirs.numpy()
    for k in range(len(la)):
        assert np.array_equal(dn[: la[k] + 1, k, : lb[k] + 1],
                              dj[: la[k] + 1, k, : lb[k] + 1]), k


@pytest.mark.parametrize("pname,case", GRID)
def test_align_batch_matches_jax(refs, pname, case):
    """Scores, chains, CIGARs, A and B spans and end tables against
    ``OverlapBatchAligner(backend="pallas")``."""
    al = OverlapBatchAligner(params=PARAMS[pname], bucket_quantum=64,
                             device="cpu")
    got = [result_tuple(r) for r in al.align_batch(CASES[case])]
    want = list(refs[pname, case]["align"])
    for k, (x, y) in enumerate(CASES[case]):
        if x and not y:
            # an empty B: the TPU route's K11d scans no column and gives
            # -inf; the port gives its score_batch's best, as the JAX
            # package's XLA route does (tests/test_torch_surface.py)
            assert want[k][0] == float("-inf")
            want[k] = (0.0, [], "", (0, 0), (0, 0), 1)
    assert got == want
    assert list(al.last_phases) == ["prep_ms", "fill_ms", "walk_ms",
                                    "d2h_ms", "build_ms"]


@pytest.mark.parametrize("pname,case", GRID)
def test_score_batch_matches_jax(refs, pname, case):
    al = OverlapBatchAligner(params=PARAMS[pname], bucket_quantum=64,
                             device="cpu")
    for g, w in zip(al.score_batch(CASES[case]),
                    refs[pname, case]["score"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walks_match_jax_traceback(case):
    """The port's host walk equals the JAX package's on the same row
    dirs, and K2 from the K11d bests + the native build equal both, with
    the CIGAR of ops/cigar.py; every end lies on the last row or column."""
    from cse305_parallel_sequence_alignment_tpu.ops.traceback import (
        traceback_overlap_from_dirs as jax_walk,
    )
    pairs = CASES[case]
    a, b, la, lb = bucket(pairs)
    dirs, best = overlap_dirs_plain(*port(a, b, la, lb), PARAMS["default"])
    best = best.numpy()
    et, ei, ej = (best[:, k].astype(np.int64) for k in (1, 2, 3))
    ent, used = rle_walk(dirs, *port(ei.astype(np.int32),
                                     ej.astype(np.int32),
                                     et.astype(np.int32)),
                         int(la.max() + lb.max()) + 1)
    tt, ii, jj, lens, spans, cigars, _ = walker.free_end_build(
        ent.numpy()[: int(used[0])].T, ei, ej, et, a, b, "overlap")
    dn = dirs.numpy()
    for k in range(len(pairs)):
        want = jax_walk(dn[:, k, :], et[k], ei[k], ej[k], layout="row")
        assert port_tb.traceback_overlap_from_dirs(
            dn[:, k, :], et[k], ei[k], ej[k]) == want
        L = int(lens[k])
        assert list(zip(ii[k, :L].tolist(), jj[k, :L].tolist(),
                        tt[k, :L].tolist())) == want
        assert cigars[k] == port_cigar.chain_to_cigar(want)
        arows = [i for (i, _, t) in want if t in (1, 3)]
        bcols = [j for (_, j, t) in want if t in (1, 2)]
        assert tuple(spans[k]) == (
            (arows[0], arows[-1]) if arows else (0, 0)) + (
            (bcols[0], bcols[-1]) if bcols else (0, 0))
        if np.isfinite(best[k, 0]):
            assert ei[k] == la[k] or ej[k] == lb[k]


def test_k11s_k11d_plain_share_the_scores_at_default_params():
    """At integer parameters the anti-diagonal and the row sweep agree
    (pairs with a non-empty B)."""
    a, b, la, lb = bucket(CASES["ragged"] + CASES["dovetails"])
    s = diag_fill_plain(*port(a, b, la, lb, np.zeros(len(la), np.int32)),
                        PARAMS["default"], "overlap")
    _, d = overlap_dirs_plain(*port(a, b, la, lb), PARAMS["default"])
    assert torch.equal(s, d)


def test_api_matches_jax():
    from cse305_parallel_sequence_alignment_tpu import api as jax_api
    pairs = CASES["dovetails"][:4]
    got = [result_tuple(r) for r in api.align_pairs(
        pairs, mode="overlap", device="cpu")]
    want = [result_tuple(r) for r in jax_api.align_pairs(
        pairs, mode="overlap")]
    assert got == want
    one = api.align(*pairs[0], mode="overlap", device="cpu")
    assert result_tuple(one) == want[0]
    s_p = api.score_pairs(pairs, mode="overlap", device="cpu")
    s_j = jax_api.score_pairs(pairs, mode="overlap")
    assert all(np.array_equal(x, y) for x, y in zip(s_p, s_j))


def test_cli_matches_jax_cli(capsys):
    from cse305_parallel_sequence_alignment_tpu.__main__ import (
        main as jax_main,
    )
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    for x, y in CASES["dovetails"][:3]:
        for extra in ([], ["--ov-mismatch", "-2"]):
            argv = ["overlap", "--a", x, "--b", y, *extra]
            assert jax_main(argv) == 0
            want = json.loads(capsys.readouterr().out)
            assert main(argv + ["--device", "cpu"]) == 0
            assert json.loads(capsys.readouterr().out) == want


def test_cli_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         "overlap", "--a", "GGGGGACGTACGT", "--b", "ACGTACGTCCCCCC",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {"score": 8.0, "cigar": "8M",
                                      "a_span": [6, 13], "b_span": [1, 8]}


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    ok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        overlap_dirs(a.to(torch.int32), a, ok, ok, ScoringParams())
    with pytest.raises(ValueError):
        overlap_score(a, a, ok.to(torch.int64), ok, ScoringParams())
    with pytest.raises(ValueError):
        OverlapBatchAligner(device="meta")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K11s and K11d against their plain versions on the card, at the
    default and a non-dyadic parameter set, ragged and > 1,024 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(29)
    pairs = CASES["dovetails"] + CASES["edges"] + [
        (_dna(rng, 250), _dna(rng, 1100))]
    a, b, la, lb = bucket(pairs)
    args = [x.cuda() for x in port(a, b, la, lb)]
    for p in (PARAMS["default"], PARAMS["g0.3-h1.7"]):
        d_k, f_k = overlap_dirs(*args, p)
        d_p, f_p = overlap_dirs_plain(*[x.cpu() for x in args], p)
        assert torch.equal(d_k.cpu().view(torch.int16),
                           d_p.view(torch.int16))
        assert torch.equal(f_k.cpu(), f_p)
        assert torch.equal(overlap_score(*args, p).cpu(),
                           overlap_score(*[x.cpu() for x in args], p))
