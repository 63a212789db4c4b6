"""Port local mode (K9s/K9d fills, K9w walk, aligner, api, CLI) == the JAX
package's, on the CPU.

Inputs come from ``np.random.default_rng(seed)`` or fixed strings and go
through both packages as numpy arrays or strings; the JAX Pallas kernels
run in interpret mode, as tests/test_pallas_local.py runs them. Tolerance
is 0 throughout, at ``LOCAL_PARAMS`` and at non-dyadic parameters: the
fills take the JAX package's float32 operations in its order, and best
indices, dirs, chains, spans and CIGARs are integers or strings.
"""

import json
import pathlib
import subprocess
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.local_oracle import (
    LOCAL_PARAMS,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops import cigar as port_cigar
from cse305_parallel_sequence_alignment_torch.ops import (
    device_walk as port_dw,
)
from cse305_parallel_sequence_alignment_torch.ops import (
    traceback as port_tb,
)
from cse305_parallel_sequence_alignment_torch.ops.local import (
    sw_dirs,
    sw_fill_plain,
    sw_score,
)
from cse305_parallel_sequence_alignment_tpu import api as jax_api
from cse305_parallel_sequence_alignment_tpu.__main__ import main as jax_main
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.models.local import (
    LocalBatchAligner as JaxLocalAligner,
)
from cse305_parallel_sequence_alignment_tpu.models.local_oracle import (
    LOCAL_PARAMS as JAX_LOCAL_PARAMS,
)
from cse305_parallel_sequence_alignment_tpu.models.local_oracle import (
    sw_oracle_align,
)
from cse305_parallel_sequence_alignment_tpu.ops import cigar as jax_cigar
from cse305_parallel_sequence_alignment_tpu.ops.device_walk import (
    walk_local_batch_device,
)
from cse305_parallel_sequence_alignment_tpu.ops.local import (
    sw_dirs_batch,
    sw_score_batch,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_local import (
    pallas_sw_dirs_batch,
    pallas_sw_score_batch,
)
from cse305_parallel_sequence_alignment_tpu.ops.traceback import (
    traceback_local_from_dirs,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ACGT = np.frombuffer(b"ACGT", np.uint8)
PARAMS = {
    "local": LOCAL_PARAMS,
    "non-dyadic": ScoringParams(g=0.3, h=1.7, match=1.1, mismatch=-0.7),
}
# repetitive pairs (ties everywhere), an all-mismatch pair (best (0, 0, 0)),
# pairs with m > n, a one-base pair
SPECIAL = [("AC" * 20, "ACA" * 14), ("ACA" * 10, "AC" * 25),
           ("A" * 30, "C" * 40), ("ACGT" * 16, "CGTA" * 5),
           ("AAAAAAAA" * 4, "AAAA" * 5), ("GATTACA" * 9, "TTAC" * 4),
           ("G", "G"), ("CCGGA" * 12, "CCGA" * 16)]


def random_pairs(rng, count, max_len, related=False):
    pairs = []
    for _ in range(count):
        a = ACGT[rng.integers(0, 4, rng.integers(1, max_len + 1))]
        if related:  # a core copy with substitutions in random flanks
            core = a.copy()
            core[rng.integers(0, len(core), max(1, len(core) // 10))] = \
                ACGT[rng.integers(0, 4)]
            b = np.concatenate([ACGT[rng.integers(0, 4, rng.integers(0, 9))],
                                core, ACGT[rng.integers(0, 4, 5)]])
        else:
            b = ACGT[rng.integers(0, 4, rng.integers(1, max_len + 1))]
        pairs.append((a.tobytes().decode(), b.tobytes().decode()))
    return pairs


CASES = {
    "ragged": random_pairs(np.random.default_rng(1), 8, 64),
    "special": SPECIAL,
}


def bucket(pairs):
    """(a, b, la, lb) numpy bucket of the pairs, padded as the aligners
    pad (PAD_A / PAD_B) to the longest member."""
    la = np.array([len(x) for x, _ in pairs], np.int32)
    lb = np.array([len(y) for _, y in pairs], np.int32)
    a = np.full((len(pairs), la.max()), PAD_A, np.uint8)
    b = np.full((len(pairs), lb.max()), PAD_B, np.uint8)
    for k, (x, y) in enumerate(pairs):
        a[k, : la[k]] = np.frombuffer(x.encode(), np.uint8)
        b[k, : lb[k]] = np.frombuffer(y.encode(), np.uint8)
    return a, b, la, lb


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def jax_params(params):
    return JaxParams(*params.astuple())


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_matches_jax_wavefront(case, params):
    """K9s/K9d (plain, through their CPU wrappers) against the JAX
    package's vmapped fill: best cells and every dirs byte."""
    a, b, la, lb = bucket(CASES[case])
    p = PARAMS[params]
    kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
    want_best, want_dirs = (np.asarray(x) for x in sw_dirs_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        **kw))
    best, dirs = sw_dirs(*port(a, b, la, lb), p)
    m, n = a.shape[1], b.shape[1]
    assert dirs.dtype == torch.uint8
    assert tuple(dirs.shape) == (m + n + 1, len(la), n + 1)
    assert np.array_equal(best.numpy(), want_best)
    assert np.array_equal(dirs.numpy().transpose(1, 0, 2), want_dirs)
    score = sw_score(*port(a, b, la, lb), p).numpy()
    assert np.array_equal(score, want_best)
    assert np.array_equal(score, np.asarray(sw_score_batch(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb),
        **kw)))
    if case == "special":
        assert best.numpy()[2].tolist() == [0.0, 0.0, 0.0]  # all mismatch


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_fill_matches_pallas_interpret(params):
    """The plain fills against the TPU kernels themselves (interpret
    mode): best cells, and dirs bytes up to the bucket's width."""
    a, b, la, lb = bucket(SPECIAL)
    p = PARAMS[params]
    kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
    want_best, want_dirs = pallas_sw_dirs_batch(a, b, la, lb, interpret=True,
                                                **kw)
    best, dirs = sw_fill_plain(*port(a, b, la, lb), p, want_dirs=True)
    n = b.shape[1]
    assert np.array_equal(best.numpy(), want_best)
    assert np.array_equal(dirs.numpy(), np.asarray(want_dirs)[:, :, : n + 1])
    assert np.array_equal(
        sw_fill_plain(*port(a, b, la, lb), p, want_dirs=False)[0].numpy(),
        pallas_sw_score_batch(a, b, la, lb, interpret=True, **kw))


def port_build(dirs, best, a, b):
    """The plain K9w walk and the native build of its streams."""
    ei = best[:, 1].to(torch.int32)
    ej = best[:, 2].to(torch.int32)
    max_steps = int(ei.max()) + int(ej.max()) + 1
    ops, used = port_dw.local_walk(dirs, ei, ej, max_steps)
    assert int(used) == int((ops != 0).sum(dim=0).max())
    return walker.local_build(ops.numpy()[: int(used)].T, ei.numpy(),
                              ej.numpy(), a, b)


def port_chains(dirs, best, a, b):
    """Chains of the plain K9w walk + native build, as lists."""
    tt, ii, jj, lens = port_build(dirs, best, a, b)[:4]
    return [list(zip(ii[r, : lens[r]].tolist(), jj[r, : lens[r]].tolist(),
                     tt[r, : lens[r]].tolist())) for r in range(len(lens))]


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_walk_matches_traceback_and_device_walk(params):
    """K9w + host chains against the JAX host traceback, the JAX device
    walk, and the port's numpy traceback, on the same dirs."""
    pairs = CASES["special"] + random_pairs(np.random.default_rng(3), 8, 48,
                                            related=True)
    a, b, la, lb = bucket(pairs)
    best, dirs = sw_dirs(*port(a, b, la, lb), PARAMS[params])
    got = port_chains(dirs, best, a, b)
    bn = best.numpy().astype(np.int64)
    dn = dirs.numpy()
    device = walk_local_batch_device(dn, bn[:, 1], bn[:, 2], pair_axis=1)
    for r in range(len(pairs)):
        if bn[r, 0] <= 0:
            assert got[r] == [] == device[r]
            continue
        want = traceback_local_from_dirs(dn[:, r, :], bn[r, 1], bn[r, 2])
        assert got[r] == want == device[r], pairs[r]
        assert port_tb.traceback_local_from_dirs(
            dn[:, r, :], bn[r, 1], bn[r, 2]) == want
    assert any(t != 1 for c in got for (_, _, t) in c)  # gaps were walked


def test_walk_matches_oracle_on_pallas_dirs():
    """K9w over the TPU kernel's dirs (interpret mode) gives the serial
    oracle's score and chain."""
    pairs = random_pairs(np.random.default_rng(4), 6, 40, related=True) + [
        ("AC" * 12, "ACA" * 8), ("A" * 9, "C" * 9)]
    a, b, la, lb = bucket(pairs)
    best, dirs = pallas_sw_dirs_batch(a, b, la, lb, interpret=True)
    n = b.shape[1]
    dirs = torch.from_numpy(np.ascontiguousarray(
        np.asarray(dirs)[:, :, : n + 1]))
    got = port_chains(dirs, torch.from_numpy(np.array(best)), a, b)
    for r, (x, y) in enumerate(pairs):
        score, chain = sw_oracle_align(x, y)
        assert best[r, 0] == score
        assert got[r] == chain, (x, y)


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.score, g.start_a, g.start_b, g.end_a, g.end_b,
                list(g.chain), g.cigar, g.cigar_extended) == (
            w.score, w.start_a, w.start_b, w.end_a, w.end_b, w.chain,
            w.cigar, w.cigar_extended)


def aligner_pairs():
    rng = np.random.default_rng(5)
    return (random_pairs(rng, 5, 64) + random_pairs(rng, 5, 50, related=True)
            + SPECIAL[:4])


@pytest.mark.parametrize("params", sorted(PARAMS))
def test_aligner_matches_jax(params):
    """``LocalBatchAligner(device="cpu")`` against the JAX aligner's
    wavefront path, field for field; buckets on both axes (quantum 16),
    several chunks per bucket."""
    pairs = aligner_pairs()
    p = PARAMS[params]
    kw = dict(bucket_quantum=16, max_batch=2)
    want = JaxLocalAligner(params=jax_params(p), backend="wavefront",
                           **kw).align_batch(pairs)
    al = LocalBatchAligner(params=p, device="cpu", **kw)
    got = al.align_batch(pairs)
    same_results(got, want)
    sizes = Counter(((len(x) + 15) // 16, (len(y) + 15) // 16)
                    for x, y in pairs)
    assert al.last_chunks == sum(-(-c // 2) for c in sizes.values())
    assert al.last_chunks > len(sizes)
    assert set(al.last_phases) == {"prep_ms", "fill_ms", "walk_ms",
                                   "d2h_ms", "build_ms"}
    scores, ei, ej = al.score_batch(pairs)
    w_s, w_i, w_j = JaxLocalAligner(params=jax_params(p), backend="wavefront",
                                    **kw).score_batch(pairs)
    assert np.array_equal(scores, w_s)
    assert np.array_equal(ei, w_i) and np.array_equal(ej, w_j)
    assert np.array_equal(scores, [r.score for r in got])
    assert np.array_equal(ei, [r.end_a for r in got])


def test_aligner_dirs_budget_chunks():
    """A budget of one pair's dirs gives one chunk per pair and the same
    results as one chunk for the whole bucket."""
    pairs = random_pairs(np.random.default_rng(6), 5, 30, related=True)
    whole = LocalBatchAligner(device="cpu").align_batch(pairs)
    al = LocalBatchAligner(device="cpu", dirs_budget=1)
    same_results(al.align_batch(pairs), whole)
    assert al.last_chunks == len(pairs)


def test_api_local_matches_jax():
    pairs = random_pairs(np.random.default_rng(7), 4, 40, related=True)
    want = jax_api.align_pairs(pairs, mode="local")
    same_results(api.align_pairs(pairs, mode="local", device="cpu"), want)
    same_results([api.align(x, y, mode="local", device="cpu")
                  for x, y in pairs], want)
    got = api.score_pairs(pairs, mode="local", device="cpu")
    for g, w in zip(got, jax_api.score_pairs(pairs, mode="local")):
        assert np.array_equal(g, w)
    p = PARAMS["non-dyadic"]
    same_results(api.align_pairs(pairs, mode="local", params=p,
                                 device="cpu"),
                 jax_api.align_pairs(pairs, mode="local",
                                     params=jax_params(p)))


@pytest.mark.parametrize("extra", [[], ["--sw-match", "1.1",
                                        "--sw-mismatch", "-0.7",
                                        "--g", "0.3", "--h", "1.7"]],
                         ids=["defaults", "non-dyadic"])
def test_cli_local_matches_jax(extra, capsys):
    args = ["local", "--a", "GGGACGTACGTGGGTTAGACCA",
            "--b", "TTTACGTACCGTTTTAGACA"] + extra
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out)
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         *args, "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == want
    assert want["score"] > 0 and want["cigar"]


def test_cigars_match_jax():
    """The copied CIGAR functions, the JAX package's and the aligner's
    natively built strings agree on the aligner's chains."""
    pairs = aligner_pairs()
    res = LocalBatchAligner(device="cpu").align_batch(pairs)
    for (x, y), r in zip(pairs, res):
        chain = list(r.chain)
        ea, eb = (np.frombuffer(s.encode(), np.uint8) for s in (x, y))
        assert port_cigar.chain_to_cigar(chain) == \
            jax_cigar.chain_to_cigar(chain) == r.cigar
        assert port_cigar.chain_to_cigar_extended(ea, eb, chain) == \
            jax_cigar.chain_to_cigar_extended(ea, eb, chain) == \
            r.cigar_extended
        assert port_cigar.cigar_consumed(r.cigar) == \
            jax_cigar.cigar_consumed(r.cigar) == (
                (r.end_a - r.start_a + 1, r.end_b - r.start_b + 1)
                if chain else (0, 0))
    with pytest.raises(ValueError):
        port_cigar.cigar_consumed("3S")


def test_native_local_build_matches_jax():
    """The native build's spans and CIGARs equal what the JAX aligner
    derives from the JAX device walk's chains, empty chains included."""
    pairs = CASES["special"] + random_pairs(np.random.default_rng(9), 8, 60,
                                            related=True)
    a, b, la, lb = bucket(pairs)
    best, dirs = sw_dirs(*port(a, b, la, lb), LOCAL_PARAMS)
    tt, ii, jj, lens, sa, sb, cig, ext = port_build(dirs, best, a, b)
    bn = best.numpy().astype(np.int64)
    chains = walk_local_batch_device(dirs.numpy(), bn[:, 1], bn[:, 2],
                                     pair_axis=1)
    for r, chain in enumerate(chains):
        assert (cig[r], ext[r]) == (
            jax_cigar.chain_to_cigar(chain),
            jax_cigar.chain_to_cigar_extended(a[r], b[r], chain))
        assert (sa[r], sb[r]) == (
            next((i for i, _, t in chain if t in (1, 3)), 0),
            next((j for _, j, t in chain if t in (1, 2)), 0))
    assert (lens == 0).any() and lens.max() > 20


def test_local_params_and_result_fields_match_jax():
    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalAlignmentResult,
    )
    from cse305_parallel_sequence_alignment_tpu.models.local import (
        LocalAlignmentResult as JaxResult,
    )
    assert LOCAL_PARAMS.astuple() == JAX_LOCAL_PARAMS.astuple()
    assert [f.name for f in LocalAlignmentResult.__dataclass_fields__
            .values()] == list(JaxResult.__dataclass_fields__)
    import cse305_parallel_sequence_alignment_torch as pkg
    assert pkg.LocalBatchAligner is LocalBatchAligner


def test_local_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        sw_score(a.to(torch.int32), a, ok, ok, LOCAL_PARAMS)
    with pytest.raises(ValueError):
        sw_dirs(a, a, ok[:1], ok, LOCAL_PARAMS)
    with pytest.raises(ValueError):
        sw_dirs(a, a[:1], ok, ok, LOCAL_PARAMS)
    dirs = torch.zeros((9, 2, 5), dtype=torch.uint8)
    with pytest.raises(TypeError):
        port_dw.local_walk(dirs.to(torch.int16), ok, ok, 4)
    with pytest.raises(ValueError):
        port_dw.local_walk(dirs, ok.to(torch.int64), ok, 4)
    with pytest.raises(ValueError):
        port_dw.local_walk(dirs, ok, ok, 0)
    with pytest.raises(ValueError):
        LocalBatchAligner(device="meta")


def test_local_aligner_refuses_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        LocalBatchAligner()
    with pytest.raises(RuntimeError, match="CUDA"):
        api.align("ACGT", "ACG", mode="local")


@pytest.mark.cuda
def test_local_kernels_match_plain_on_card():
    """K9s, K9d and K9w against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for params in PARAMS.values():
        for pairs in (SPECIAL, random_pairs(np.random.default_rng(8), 8,
                                            300, related=True)):
            args = [x.cuda() for x in port(*bucket(pairs))]
            b_k, d_k = sw_dirs(*args, params)
            b_p, d_p = sw_fill_plain(*args, params, want_dirs=True)
            assert torch.equal(b_k, b_p) and torch.equal(d_k, d_p)
            assert torch.equal(sw_score(*args, params), b_p)
            ei = b_k[:, 1].to(torch.int32)
            ej = b_k[:, 2].to(torch.int32)
            steps = int(ei.max()) + int(ej.max()) + 1
            o_k, u_k = port_dw.local_walk(d_k, ei, ej, steps)
            o_p, u_p = port_dw.local_walk_plain(d_k, ei, ej, steps)
            assert torch.equal(o_k, o_p) and torch.equal(u_k, u_p)


@pytest.mark.cuda
def test_local_aligner_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pairs = aligner_pairs()
    for params in PARAMS.values():
        kw = dict(params=params, bucket_quantum=16, max_batch=3)
        same_results(LocalBatchAligner(device="cuda", **kw).align_batch(pairs),
                     LocalBatchAligner(device="cpu", **kw).align_batch(pairs))
        for g, w in zip(
                LocalBatchAligner(device="cuda", **kw).score_batch(pairs),
                LocalBatchAligner(device="cpu", **kw).score_batch(pairs)):
            assert np.array_equal(g, w)
