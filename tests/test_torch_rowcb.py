"""Port K1/K3 fills (plain PyTorch) == the JAX package's Pallas fills.

Inputs come from ``np.random.default_rng(seed)`` and go through both
packages as numpy arrays; the Pallas kernels run in interpret mode, as
tests/test_rowcb.py runs them on the CPU. Tolerance is 0 throughout:
scores are float32 sums of small integers or binary fractions taken in
the same order, dirs are integers.
"""

import numpy as np
import pytest
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    dirs_from_jax,
    rowcb_fill,
    rowcb_fill_plain,
    score_fill,
    score_fill_plain,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    pallas_score_batch,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_rowcb import (
    _pallas_rowcb,
    rowcb_prep,
)
from cse305_parallel_sequence_alignment_tpu.ops.rowscan import (
    rowscan_score,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)
STARTS = np.array([-1, -2, -3, 1, 2, 3], np.int32)


def make_bucket(rng, B, bm, bn, min_len=1):
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    la = rng.integers(min_len, bm + 1, B).astype(np.int32)
    lb = rng.integers(min_len, bn + 1, B).astype(np.int32)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    return a, b, la, lb


def jax_rowcb(a, b, la, lb, st, params):
    """JAX dirs16+runs fill with per-pair start types, perm=False."""
    B = a.shape[0]
    args, meta = rowcb_prep(a, b, la, lb, -1, perm=False)
    args[4][:B] = st[:, None]
    g, h, match, mismatch = params.astuple()
    dirs, fin = _pallas_rowcb(
        *args, g=g, h=h, match=match, mismatch=mismatch, interpret=True,
        want_dirs=True, with_runs=True, k1=0, **meta)
    return np.asarray(dirs), np.asarray(fin)[:B, :3]


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


CASES = {
    # (B, bm, bn, seed, params, min_len)
    "short-all-starts": (6, 40, 60, 1, ScoringParams(), 0),
    "lengths-1-90": (6, 90, 90, 2, ScoringParams(), 1),
    "wide-lb-over-1024": (2, 24, 1100, 3, ScoringParams(), 1),
    "fractional-params": (6, 50, 70, 4,
                          ScoringParams(g=0.5, h=1.25, match=2.0,
                                        mismatch=-1.0), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rowcb_matches_jax(case):
    B, bm, bn, seed, params, min_len = CASES[case]
    rng = np.random.default_rng(seed)
    a, b, la, lb = make_bucket(rng, B, bm, bn, min_len)
    st = STARTS[np.arange(B) % 6]
    dj, fj = jax_rowcb(a, b, la, lb, st,
                       JaxParams(*params.astuple()))
    dirs, fin = rowcb_fill(*port(a, b, la, lb, st), params)
    assert dirs.dtype == torch.uint16
    assert tuple(dirs.shape) == (bm + 1, B, bn + 1)
    assert np.array_equal(fin.numpy(), fj)
    dn = dirs.numpy()
    for k in range(B):
        assert np.array_equal(dn[: la[k] + 1, k, : lb[k] + 1],
                              dj[: la[k] + 1, k, : lb[k] + 1]), (case, k)
    # the converted JAX array holds the same real cells
    dc = dirs_from_jax(dj, la, lb).numpy()
    assert dc.shape == (la.max() + 1, B, lb.max() + 1)
    for k in range(B):
        assert np.array_equal(dc[: la[k] + 1, k, : lb[k] + 1],
                              dn[: la[k] + 1, k, : lb[k] + 1])
    # K3, the anti-diagonal sweep, gives the same finals at these
    # integer and dyadic parameters
    assert np.array_equal(
        score_fill(*port(a, b, la, lb, st), params).numpy(), fj)


def test_rowcb_run_cap():
    """A diagonal run longer than 255 caps its length and resets the
    after-run code, bit-equal to the JAX kernel."""
    rng = np.random.default_rng(6)
    s = ACGT[rng.integers(0, 4, 300)]
    a = s[None, :].copy()
    b = np.concatenate([ACGT[:1], s])[None, :]
    la, lb = np.array([300], np.int32), np.array([301], np.int32)
    st = np.array([-1], np.int32)
    dj, fj = jax_rowcb(a, b, la, lb, st, JaxParams())
    dirs, fin = rowcb_fill(*port(a, b, la, lb, st), ScoringParams())
    dn = dirs.numpy()
    assert (dn[:, 0, :] >> 8).max() == 255
    assert np.array_equal(dn[:301, 0, :302], dj[:301, 0, :302])
    assert np.array_equal(fin.numpy(), fj)


@pytest.mark.parametrize("start_type", [-1, -2, -3, 1, 2, 3])
def test_score_fill_matches_pallas_score(start_type):
    rng = np.random.default_rng(10 + start_type)
    a, b, la, lb = make_bucket(rng, 5, 30, 45)
    want = pallas_score_batch(a, b, la, lb, start_type=start_type,
                              interpret=True)
    st = np.full(5, start_type, np.int32)
    got = score_fill(*port(a, b, la, lb, st), ScoringParams())
    assert np.array_equal(got.numpy(), want)


def test_score_fill_matches_rowscan_score():
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    a, b, la, lb = make_bucket(rng, 4, 64, 64)
    for k in range(4):
        for st in (-1, 2):
            want = np.asarray(rowscan_score(
                jnp.asarray(a[k, : la[k]]), jnp.asarray(b[k, : lb[k]]),
                start_type=st))
            got = score_fill(*port(a[k: k + 1], b[k: k + 1], la[k: k + 1],
                                   lb[k: k + 1],
                                   np.array([st], np.int32)),
                             ScoringParams())
            assert np.array_equal(got.numpy()[0], want), (k, st)


def test_fill_rejects_bad_inputs():
    a = torch.zeros((2, 4), dtype=torch.uint8)
    b = torch.zeros((2, 5), dtype=torch.uint8)
    ok = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        rowcb_fill(a.to(torch.int32), b, ok, ok, ok, ScoringParams())
    with pytest.raises(ValueError):
        rowcb_fill(a, b, ok.to(torch.int64), ok, ok, ScoringParams())
    with pytest.raises(ValueError):
        score_fill(a.to("meta"), b.to("meta"), ok.to("meta"),
                   ok.to("meta"), ok.to("meta"), ScoringParams())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(13)
    a, b, la, lb = make_bucket(rng, 6, 200, 300, 0)
    st = STARTS[np.arange(6) % 6]
    args = [x.cuda() for x in port(a, b, la, lb, st)]
    d_k, f_k = rowcb_fill(*args, ScoringParams())
    d_p, f_p = rowcb_fill_plain(*args, ScoringParams())
    assert torch.equal(d_k.view(torch.int16), d_p.view(torch.int16))
    assert torch.equal(f_k, f_p)
    assert torch.equal(score_fill(*args, ScoringParams()),
                       score_fill_plain(*args, ScoringParams()))
