"""Port P-sweep and P-attrib2 (plain PyTorch) == the TPU probe kernels
they replace.

scripts/kern_sweep.py's module-level ``_kernel`` is loaded as it is, its
M shrunk with ``mock.patch``, and run in a test-local interpret-mode
``pallas_call`` for each of the script's twelve cases cut to size.
scripts/probes/attrib2_r5.py's ``variant_kernel`` (with ``lane_pm`` and
``make_shift``) lives inside its ``main``, so ``_variant2_kernel`` below
transcribes it (:60-166), as tests/test_torch_rowprobe.py transcribes
attrib_r5.py's. Every Pallas call runs in interpret mode (``pltpu.roll``
included); inputs come from numpy seeds; tolerance 0, NaN equal to NaN.
"""

import functools
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import diag, rowcb, rowprobe
from cse305_parallel_sequence_alignment_torch.probes import sweep
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    NEG_INF,
    _char_col,
    _col0_t3,
    _emit_row,
    _lane_prefix_max,
    _pack3,
    _pallas_rowscan,
    _row0_t2,
    _shift_right_neg,
    _unpack3,
    rowscan_prep,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
M = 32  # the scripts' rows, cut to size
# kern_sweep.py's widths cut to size (the kernel stores columns 0-127)
WIDTHS = {512: 128, 1088: 256, 2176: 384}


def same(x, y):
    return np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)


def t8(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint8))


# ---------------------------------------------------------------- P-sweep


@pytest.fixture(scope="module")
def kern_sweep():
    spec = importlib.util.spec_from_file_location(
        "kern_sweep", ROOT / "scripts" / "kern_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B,W,U", sweep.GRID,
                         ids=[f"B{b}-W{w}-u{u}" for b, w, u in sweep.GRID])
def test_sweep_matches_kern_sweep(kern_sweep, B, W, U):
    """``_kernel`` (the script's b_ext: seed 7, codes 60-69, every column)
    at min(B, 16) pairs, the width cut to 128-384 and 32 rows = the port's
    fill at every C on the script's window, x[:8, :128]."""
    bb, nl = min(B, 16), WIDTHS[W]
    b_ext = np.random.default_rng(7).integers(
        60, 70, size=(bb, nl)).astype(np.int32)
    with mock.patch.object(kern_sweep, "M", M):
        kern = functools.partial(kern_sweep._kernel, nl=nl, block_b=bb,
                                 unroll=U)
        want = np.asarray(pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)(jnp.asarray(b_ext)))
    for C in sweep.COLUMNS:
        got = rowprobe.sweep_fill(t8(b_ext), C, U, rows=M)
        assert got.shape == (bb, nl)
        assert same(got[:8, :128], want), C


def test_sweep_equals_stripes_and_shares_its_twin_rows():
    """The sweep's function is P-stripes' (A's character 65, K3''s column
    0), whatever C; and a (B, W) draw from seed 7 starts with the rows of
    every smaller B's draw, so the probe's reduced twin serves each B."""
    b_ext = t8(np.random.default_rng(7).integers(60, 70, size=(16, 256)))
    want = rowprobe.stripes_fill(b_ext, 1, rows=M)
    for C in sweep.COLUMNS:
        assert torch.equal(rowprobe.sweep_fill(b_ext, C, rows=M), want)
    big = np.random.default_rng(7).integers(60, 70, size=(64, 2176))
    for B in (8, 16, 32):
        small = np.random.default_rng(7).integers(60, 70, size=(B, 2176))
        assert np.array_equal(big[:B], small)


# ---------------------------------------------------------------- P-attrib2


def _variant2_kernel(a_ref, bext_ref, lbmask_ref, la_ref, out_ref, *, mode,
                     K, L, nl, g, h, match, mismatch, start_type, m,
                     unroll=4):
    """scripts/probes/attrib2_r5.py:60-166: ``lane_pm``, ``make_shift``
    and ``variant_kernel``, their closure (nl, g, h, match, mismatch,
    start_type, m) passed in."""

    def lane_pm(x, mode, jj):
        neg = jnp.float32(NEG_INF)
        if mode == "pm_roll":
            s = 1
            while s < nl:
                rolled = pltpu.roll(x, s, 1)
                x = jnp.maximum(x, jnp.where(jj < s, neg, rolled))
                s *= 2
            return x
        strides = []
        s = 1
        while s < nl:
            strides.append(s)
            s *= 2
        if mode == "pm_unaligned":
            strides = [s for s in strides if s < 128]
        elif mode == "pm_aligned":
            strides = [s for s in strides if s >= 128]
        for s in strides:
            shifted = jnp.concatenate(
                [jnp.full(x.shape[:-1] + (s,), neg), x[..., :-s]], axis=-1)
            x = jnp.maximum(x, shifted)
        return x

    def make_shift(mode, jj):
        neg = jnp.float32(NEG_INF)
        if mode == "shift_roll":
            def sh(x):
                return jnp.where(jj < 1, neg, pltpu.roll(x, 1, 1))
            return sh
        return _shift_right_neg

    bb = bext_ref.shape[0]
    jj = jax.lax.broadcasted_iota(jnp.int32, (bb, nl), 1)
    b_ext = bext_ref[...]
    lbmask = lbmask_ref[...] != 0
    gf, hf = jnp.float32(g), jnp.float32(h)
    neg_inf = jnp.float32(NEG_INF)
    lane0 = jj == 0
    jg = gf * jj.astype(jnp.float32)
    r1 = jnp.where(lane0, jnp.float32(0.0), neg_inf)
    r2 = jnp.where(lane0, neg_inf, _row0_t2(jj, gf, hf, start_type))
    r3 = jnp.full((bb, nl), neg_inf)
    shift = make_shift(mode, jj)

    def row_step(i, t123):
        p1, p2, p3 = t123
        a_col = _char_col(a_ref, i - 1)
        fb = jnp.where(b_ext == a_col, jnp.float32(match),
                       jnp.float32(mismatch))
        mp12 = jnp.maximum(p1, p2)
        t1 = fb + shift(jnp.maximum(mp12, p3))
        t3 = jnp.maximum(mp12 - gf - hf, p3 - gf)
        t1 = jnp.where(lane0, neg_inf, t1)
        t3 = jnp.where(lane0, _col0_t3(i, gf, hf, start_type), t3)
        m13 = shift(jnp.maximum(t1, t3))
        omega = jg + m13 - gf - hf
        pm = lane_pm(omega, mode, jj)
        t2 = jnp.where(lane0, neg_inf, pm - jg)
        return (t1, t2, t3)

    if mode == "live":
        def body(s, pq):
            p1, p2, p3 = _unpack3(pq, nl)
            arrs = [p1, p2, p3][:max(L, 1)]
            while len(arrs) < L:
                arrs.append(arrs[len(arrs) % 3] +
                            jnp.float32(0.125 * len(arrs)))
            x = arrs[0]
            for k in range(K):
                x = jnp.maximum(x + jnp.float32(0.5), arrs[(k + 1) % L])
            return _pack3((x, p2, p3))

        pq = jax.lax.fori_loop(0, m, body, _pack3((r1, r2, r3)))
        t123 = _unpack3(pq, nl)
    elif mode == "chain_i16":
        def body(s, pq):
            p1, p2, p3 = _unpack3(pq, nl)
            x = p1.astype(jnp.int16)
            y = p2.astype(jnp.int16)
            for k in range(K):
                x = jnp.maximum(x + jnp.int16(1), y)
            return _pack3((x.astype(jnp.float32), p2, p3))

        pq = jax.lax.fori_loop(0, m, body, _pack3((r1, r2, r3)))
        t123 = _unpack3(pq, nl)
    elif mode == "chain_i32":
        def body(s, pq):
            p1, p2, p3 = _unpack3(pq, nl)
            x = p1.astype(jnp.int32)
            y = p2.astype(jnp.int32)
            for k in range(K):
                x = jnp.maximum(x + jnp.int32(1), y)
            return _pack3((x.astype(jnp.float32), p2, p3))

        pq = jax.lax.fori_loop(0, m, body, _pack3((r1, r2, r3)))
        t123 = _unpack3(pq, nl)
    else:
        def body(s, pq):
            t123 = _unpack3(pq, nl)
            for u in range(unroll):
                t123 = row_step(s * unroll + u + 1, t123)
            return _pack3(t123)

        pq = jax.lax.fori_loop(0, m // unroll, body, _pack3((r1, r2, r3)))
        t123 = _unpack3(pq, nl)
    finals = [jnp.max(jnp.where(lbmask, t, neg_inf), axis=-1, keepdims=True)
              for t in t123]
    out_ref[...] = _emit_row(finals)


def probe_bucket(B=16, m=24, n=300, seed=11):
    """The P-attrib2 bucket cut to size: codes 65-68, a then b, every la =
    m, lb drawn from [n - 60, n]."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, size=(B, m)).astype(np.uint8)
    b = rng.integers(65, 69, size=(B, n)).astype(np.uint8)
    lb = rng.integers(n - 60, n + 1, size=B).astype(np.int32)
    return a, b, np.full(B, m, np.int32), lb


def jax_variant2(a, b, la, lb, mode, K=0, L=3, block_b=16):
    """``run_variant`` (attrib2_r5.py:168-198) in interpret mode;
    ``full_b32`` is ``full`` at half the pairs a program."""
    if mode == "full_b32":
        mode, block_b = "full", block_b // 2
    args, meta = rowscan_prep(a, b, la, lb, block_b=block_b, carries=7)
    a_pad, b_ext, lbmask, la_t = args
    nl, block_b = meta["nl"], meta["block_b"]
    kern = functools.partial(
        _variant2_kernel, mode=mode, K=K, L=L, nl=nl, g=1.0, h=2.0,
        match=1.0, mismatch=0.0, start_type=-1, m=meta["m"])
    spec = lambda w: pl.BlockSpec((block_b, w), lambda i: (i, 0))  # noqa
    out = pl.pallas_call(
        kern, grid=(a_pad.shape[0] // block_b,),
        in_specs=[spec(a_pad.shape[1]), spec(nl), spec(nl), spec(128)],
        out_specs=spec(128),
        out_shape=jax.ShapeDtypeStruct((a_pad.shape[0], 128), jnp.float32),
        interpret=True)(a_pad, b_ext, lbmask, la_t)
    return np.asarray(out)[: len(la), :3]


def port(a, b, lb, mode, K=0, L=0):
    return rowprobe.ablate_finals(t8(a), t8(b), torch.from_numpy(lb), mode,
                                  K, L)


@pytest.fixture(scope="module")
def bucket():
    a, b, la, lb = probe_bucket()
    args, meta = rowscan_prep(a, b, la, lb, block_b=16)
    k3p = _pallas_rowscan(*args, g=1.0, h=2.0, match=1.0, mismatch=0.0,
                          start_type=-1, interpret=True, **meta)
    return a, b, la, lb, np.asarray(k3p)[: len(la), :3]


@pytest.mark.parametrize("mode", list(rowprobe.ATTRIB2))
def test_attrib2_modes_match_variant_kernel(bucket, mode):
    """Each row_step mode against the transcribed ``variant_kernel``; the
    full step and its roll lowerings (and full_b32) give K3''s finals."""
    a, b, la, lb, k3p = bucket
    want = jax_variant2(a, b, la, lb, mode)
    assert same(port(a, b, lb, mode), want)
    assert same(want, k3p) == (mode in ("full", "pm_roll", "shift_roll",
                                        "full_b32"))


@pytest.mark.parametrize("mode,K,L", [(m, K, L) for m, KLs in
                                      rowprobe.FLOORS2.items()
                                      for K, L in KLs])
def test_attrib2_floors_match_variant_kernel(bucket, mode, K, L):
    """The live-array floors and the integer floors (int16 wrapping past
    32,767, -inf saturating to the type's least value)."""
    a, b, la, lb, _ = bucket
    assert same(port(a, b, lb, mode, K, L),
                jax_variant2(a, b, la, lb, mode, K, L or 3))


@pytest.mark.parametrize("mode", ["chain_i16", "chain_i32"])
def test_integer_floors_past_int16(mode):
    """At 2,100 rows x 16 increments the int16 floor passes 32,767 and
    wraps (the finals fall back to y = -2 - lb), the int32 one does not."""
    a, b, la, lb = probe_bucket(B=8, m=2100, n=100)
    want = jax_variant2(a, b, la, lb, mode, 16, 3, block_b=8)
    assert same(port(a, b, lb, mode, 16), want)
    wrapped = want[:, 0] < 2100 * 16 - 2 - lb - 32768
    assert wrapped.all() == (mode == "chain_i16")


def test_attrib2_equalities():
    """pm_roll = shift_roll = full = full_b32 = K3''s finals (the port's
    twins); pm_unaligned = the P-knock prefix7 window (the two JAX forms
    are one function); diag (K3) = pin (K3')."""
    a, b, la, lb = (torch.from_numpy(x) for x in probe_bucket(B=9, m=40,
                                                              n=150))
    st = torch.full_like(la, -1)
    k3p = rowcb.rowscan_score_fill(a, b, la, lb, st, ScoringParams())
    for mode in ("full", "pm_roll", "shift_roll", "full_b32"):
        assert torch.equal(rowprobe.ablate_finals(a, b, lb, mode), k3p)
    assert torch.equal(diag.score_fill(a, b, la, lb, st, ScoringParams()),
                       k3p)
    assert not torch.equal(rowprobe.ablate_finals(a, b, lb, "pm_aligned"),
                           k3p)
    assert torch.equal(
        rowprobe.ablate_finals(a, b, lb, "pm_unaligned"),
        rowprobe.replica_plain(a, rowprobe._bext(b), 40, ("prefix7",),
                               lb=lb))
    assert rowprobe.ATTRIB2["pm_unaligned"] == ("prefix7",)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(8, 384)).astype(np.float32))
    # lane_pm(x, "pm_unaligned") is the strides under 128 of nl's: the
    # same sweeps as _lane_prefix_max(x, 128)
    strides = [s for s in (1, 2, 4, 8, 16, 32, 64, 128, 256) if s < 128]
    y = x
    for s in strides:
        y = jnp.maximum(y, jnp.concatenate(
            [jnp.full((8, s), NEG_INF, jnp.float32), y[:, :-s]], axis=1))
    assert same(y, _lane_prefix_max(x, 128))
    assert same(rowprobe._window_max(torch.from_numpy(np.array(x))), y)
    # pm_aligned: the aligned sweeps of nl = 384 against the port's form
    z = x
    for s in (128, 256):
        z = jnp.maximum(z, jnp.concatenate(
            [jnp.full((8, s), NEG_INF, jnp.float32), z[:, :-s]], axis=1))
    assert same(rowprobe._aligned_max(torch.from_numpy(np.array(x))), z)


def test_wrappers_refuse_what_the_new_kernels_do_not_take():
    a, b, _, lb = probe_bucket(B=4)
    ta, tb, tlb = t8(a), t8(b), torch.from_numpy(lb)
    with pytest.raises(ValueError, match="floor live"):
        rowprobe.ablate_finals(ta, tb, tlb, "live", 16, 3)
    with pytest.raises(ValueError, match="floor chain_i16"):
        rowprobe.ablate_finals(ta, tb, tlb, "chain_i16", 8)
    with pytest.raises(ValueError, match="K of"):
        rowprobe.ablate_finals(ta, tb, tlb, "chain", 8, 2)
    with pytest.raises(ValueError, match="no instantiation"):
        rowprobe.sweep_fill(tb, 2)
    with pytest.raises(ValueError, match="no instantiation"):
        rowprobe.sweep_fill(tb, 8, unroll=8)
    assert rowprobe.threads_for(2176, columns=8) == 288
    assert rowprobe.threads_for(2176, columns=16) == 160
    assert rowprobe.threads_for(2049, knock=("twocta",)) == 544
    with pytest.raises(ValueError, match="columns"):
        rowprobe.threads_for(2177, knock=("twocta",))
    with pytest.raises(ValueError, match="columns"):
        rowprobe.threads_for(4097, columns=16)


@pytest.mark.cuda
def test_rowprobe2_kernels_match_plain_on_card():
    """Every P-sweep and P-attrib2 instantiation against its twin on the
    card, at 16 pairs of 2 kb (256 rows) and on a ragged width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (2048, 1000):
        a, b, _, lb = probe_bucket(B=16, m=256, n=n)
        cpu = [t8(a), t8(b), torch.from_numpy(lb)]
        cuda = [x.cuda() for x in cpu]
        for mode in rowprobe.ATTRIB2:
            assert same(rowprobe.ablate_finals(*cuda, mode).cpu(),
                        rowprobe.ablate_finals(*cpu, mode)), mode
        for mode, KLs in rowprobe.FLOORS2.items():
            for K, L in KLs:
                assert same(rowprobe.ablate_finals(*cuda, mode, K, L).cpu(),
                            rowprobe.ablate_finals(*cpu, mode, K, L))
        ext = t8(np.random.default_rng(7).integers(60, 70, (16, n + 1)))
        want = rowprobe.sweep_fill(ext, rows=256)
        for U in (1, 4, 16):
            for C in sweep.COLUMNS:
                assert same(rowprobe.sweep_fill(ext.cuda(), C, U,
                                                rows=256).cpu(), want)
