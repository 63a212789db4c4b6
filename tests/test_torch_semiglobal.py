"""Port semi-global mode (K10s/K10d fills, K2 walk, native build,
aligner, api, CLI) == the JAX package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays or strings; the JAX Pallas kernels run in
interpret mode. At the default parameters the references are computed in
this process; at the two non-dyadic sets they come from a process whose
XLA:CPU emits no fused multiply-add (``jax_nofma`` of
tests/test_torch_numerics.py, which says why). Each port route is held
against its own JAX counterpart: ``score_batch`` against the
anti-diagonal ``_sg_score_kernel``, ``align_batch`` against the row
sweep ``_sg_rowdirs_kernel`` (the two JAX routes round differently at
non-dyadic parameters). Tolerance is 0 throughout.
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
from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
    SemiGlobalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops import cigar as port_cigar
from cse305_parallel_sequence_alignment_torch.ops import (
    traceback as port_tb,
)
from cse305_parallel_sequence_alignment_torch.ops.device_walk import rle_walk
from cse305_parallel_sequence_alignment_torch.ops.diag import (
    diag_fill_plain,
    semiglobal_score,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    semiglobal_dirs,
    semiglobal_dirs_plain,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACGT = np.frombuffer(b"ACGT", np.uint8)
PARAMS = dict(SETS, default=ScoringParams(g=1.0, h=2.0, match=1.0,
                                          mismatch=-1.0))


def _dna(rng, n):
    return ACGT[rng.integers(0, 4, n)].tobytes().decode()


def _mutate(rng, s, rate):
    out = list(s)
    for k in np.nonzero(rng.random(len(out)) < rate)[0]:
        out[k] = "ACGT"[rng.integers(0, 4)]
    return "".join(out)


def _cases():
    rng = np.random.default_rng(23)
    ragged = []
    for k in range(8):
        a = _dna(rng, int(rng.integers(1, 70)))
        b = _dna(rng, int(rng.integers(1, 110)))
        if k % 2:  # the read placed into its window, with substitutions
            o = int(rng.integers(0, len(b)))
            b = b[:o] + _mutate(rng, a, 0.1) + b[o:]
        ragged.append((a, b))
    read = _dna(rng, 60)
    run = _dna(rng, 300)
    return {
        "ragged": ragged,  # m > n and m < n, placed and unplaced reads
        "edges": [("", "ACGTA"), ("ACG", ""), ("", ""), ("G", "G"),
                  ("GATTACA", "TTAC"), ("AAAA", "CCCCAAAACC")],
        "wide": [(read, _dna(rng, 100) + _mutate(rng, read, 0.05)
                  + _dna(rng, 140)), (_dna(rng, 40), _dna(rng, 290))],
        "long-run": [(run, _dna(rng, 7) + run + _dna(rng, 5))],
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
    return (float(r.score), list(r.chain), r.cigar, r.cigar_extended,
            tuple(r.target_span), int(r.end_table))


def _jax_refs(names):
    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.models.semiglobal import (
        SemiGlobalBatchAligner as JaxAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.pallas_semiglobal \
        import pallas_semiglobal_dirs_batch, pallas_semiglobal_score_batch
    out = {}
    for name in names:
        p = PARAMS[name]
        kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
        for case, pairs in CASES.items():
            a, b, la, lb = bucket(pairs)
            m, n = a.shape[1], b.shape[1]
            fin, dirs = pallas_semiglobal_dirs_batch(
                a, b, la, lb, with_runs=True, perm=False, interpret=True,
                **kw)
            ja = JaxAligner(params=JaxParams(*p.astuple()),
                            backend="pallas", bucket_quantum=64)
            out[name, case] = {
                "k10s": pallas_semiglobal_score_batch(
                    a, b, la, lb, interpret=True, **kw),
                "k10d": (fin, np.ascontiguousarray(
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
            **jax_nofma("test_torch_semiglobal", "_references")}


GRID = [(p, c) for p in sorted(PARAMS) for c in sorted(CASES)]


@pytest.mark.parametrize("pname,case", GRID)
def test_k10s_matches_jax(refs, pname, case):
    """K10s plain (through its CPU wrapper): score, end table, end cell."""
    a, b, la, lb = bucket(CASES[case])
    got = semiglobal_score(*port(a, b, la, lb), PARAMS[pname])
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(la), 4)
    assert np.array_equal(got.numpy(), refs[pname, case]["k10s"])


@pytest.mark.parametrize("pname,case", GRID)
def test_k10d_matches_jax(refs, pname, case):
    """K10d plain: bests and every dirs16+runs cell of the pairs."""
    a, b, la, lb = bucket(CASES[case])
    dirs, best = semiglobal_dirs(*port(a, b, la, lb), PARAMS[pname])
    fin, dj = refs[pname, case]["k10d"]
    assert dirs.dtype == torch.uint16
    assert tuple(dirs.shape) == (a.shape[1] + 1, len(la), b.shape[1] + 1)
    assert np.array_equal(best.numpy(), fin)
    dn = dirs.numpy()
    for k in range(len(la)):
        assert np.array_equal(dn[: la[k] + 1, k, : lb[k] + 1],
                              dj[: la[k] + 1, k, : lb[k] + 1]), k


@pytest.mark.parametrize("pname,case", GRID)
def test_align_batch_matches_jax(refs, pname, case):
    """Scores, chains, CIGARs, extended CIGARs, target spans and end
    tables against ``SemiGlobalBatchAligner(backend="pallas")``."""
    al = SemiGlobalBatchAligner(params=PARAMS[pname], bucket_quantum=64,
                                device="cpu")
    got = [result_tuple(r) for r in al.align_batch(CASES[case])]
    assert got == refs[pname, case]["align"]
    assert list(al.last_phases) == ["prep_ms", "fill_ms", "walk_ms",
                                    "d2h_ms", "build_ms"]


@pytest.mark.parametrize("pname,case", GRID)
def test_score_batch_matches_jax(refs, pname, case):
    al = SemiGlobalBatchAligner(params=PARAMS[pname], bucket_quantum=64,
                                device="cpu")
    for g, w in zip(al.score_batch(CASES[case]),
                    refs[pname, case]["score"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walks_match_jax_traceback(case):
    """The port's host walk equals the JAX package's on the same row
    dirs, and K2 from the K10d bests + the native build equal both, with
    the CIGAR strings of ops/cigar.py."""
    from cse305_parallel_sequence_alignment_tpu.ops.traceback import (
        traceback_semiglobal_from_dirs as jax_walk,
    )
    pairs = CASES[case]
    a, b, la, lb = bucket(pairs)
    dirs, best = semiglobal_dirs_plain(*port(a, b, la, lb),
                                       PARAMS["default"])
    best = best.numpy()
    et, ei, ej = (best[:, k].astype(np.int64) for k in (1, 2, 3))
    ent, used = rle_walk(dirs, *port(ei.astype(np.int32),
                                     ej.astype(np.int32),
                                     et.astype(np.int32)),
                         int(la.max() + lb.max()) + 1)
    tt, ii, jj, lens, spans, cigars, ext = walker.free_end_build(
        ent.numpy()[: int(used[0])].T, ei, ej, et, a, b, "semiglobal")
    dn = dirs.numpy()
    for k, (x, y) in enumerate(pairs):
        want = jax_walk(dn[:, k, :], et[k], ei[k], ej[k], layout="row")
        assert port_tb.traceback_semiglobal_from_dirs(
            dn[:, k, :], et[k], ei[k], ej[k]) == want
        L = int(lens[k])
        assert list(zip(ii[k, :L].tolist(), jj[k, :L].tolist(),
                        tt[k, :L].tolist())) == want
        ea = np.frombuffer(x.encode(), np.uint8)
        eb = np.frombuffer(y.encode(), np.uint8)
        assert cigars[k] == port_cigar.chain_to_cigar(want)
        assert ext[k] == port_cigar.chain_to_cigar_extended(ea, eb, want)
        bcols = [j for (_, j, t) in want if t in (1, 2)]
        assert tuple(spans[k, 2:]) == ((bcols[0], bcols[-1]) if bcols
                                       else (0, 0))
        # every CIGAR consumes the whole read
        assert port_cigar.cigar_consumed(cigars[k])[0] == len(x)


def test_k10s_k10d_plain_share_the_scores_at_default_params():
    """At integer parameters the anti-diagonal and the row sweep agree."""
    a, b, la, lb = bucket(CASES["ragged"])
    s = diag_fill_plain(*port(a, b, la, lb, np.zeros(len(la), np.int32)),
                        PARAMS["default"], "semiglobal")
    _, d = semiglobal_dirs_plain(*port(a, b, la, lb), PARAMS["default"])
    assert torch.equal(s, d)


def test_api_matches_jax():
    from cse305_parallel_sequence_alignment_tpu import api as jax_api
    pairs = CASES["ragged"][:4]
    got = [result_tuple(r) for r in api.align_pairs(
        pairs, mode="semiglobal", device="cpu")]
    want = [result_tuple(r) for r in jax_api.align_pairs(
        pairs, mode="semiglobal")]
    assert got == want
    one = api.align(*pairs[0], mode="semiglobal", device="cpu")
    assert result_tuple(one) == want[0]
    s_p = api.score_pairs(pairs, mode="semiglobal", device="cpu")
    s_j = jax_api.score_pairs(pairs, mode="semiglobal")
    assert all(np.array_equal(x, y) for x, y in zip(s_p, s_j))


def test_cli_matches_jax_cli(capsys):
    from cse305_parallel_sequence_alignment_tpu.__main__ import (
        main as jax_main,
    )
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    for x, y in CASES["ragged"][:3]:
        for extra in ([], ["--sg-mismatch", "-2"]):
            argv = ["semiglobal", "--a", x, "--b", y, *extra]
            assert jax_main(argv) == 0
            want = json.loads(capsys.readouterr().out)
            assert main(argv + ["--device", "cpu"]) == 0
            assert json.loads(capsys.readouterr().out) == want


def test_cli_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         "semiglobal", "--a", "ACGTACGT", "--b", "TTTTACGTACGTTTTT",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == {"score": 8.0, "cigar": "8M",
                                      "cigar_extended": "8=",
                                      "target_span": [5, 12]}


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    ok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        semiglobal_dirs(a.to(torch.int32), a, ok, ok, ScoringParams())
    with pytest.raises(ValueError):
        semiglobal_score(a, a, ok.to(torch.int64), ok, ScoringParams())
    with pytest.raises(ValueError):
        SemiGlobalBatchAligner(device="meta")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """K10s and K10d against their plain versions on the card, at the
    default and a non-dyadic parameter set, ragged and > 1,024 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(29)
    pairs = CASES["ragged"] + CASES["edges"] + [
        (_dna(rng, 250), _dna(rng, 1100))]
    a, b, la, lb = bucket(pairs)
    args = [x.cuda() for x in port(a, b, la, lb)]
    for p in (PARAMS["default"], PARAMS["g0.3-h1.7"]):
        d_k, f_k = semiglobal_dirs(*args, p)
        d_p, f_p = semiglobal_dirs_plain(*[x.cpu() for x in args], p)
        assert torch.equal(d_k.cpu().view(torch.int16),
                           d_p.view(torch.int16))
        assert torch.equal(f_k.cpu(), f_p)
        assert torch.equal(semiglobal_score(*args, p).cpu(),
                           semiglobal_score(*[x.cpu() for x in args], p))
