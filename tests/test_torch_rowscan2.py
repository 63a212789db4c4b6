"""Port K3'' ``rowscan2_score_fill``, P-trim ``trim_rowscan_fill`` and
P-dual ``dual_rowscan2_fill`` (plain PyTorch) == the JAX package's.

K3'' is held against ``pallas_rowscan2_score_batch`` (Pallas in interpret
mode, as tests/test_pallas.py runs it) on its ragged branch and on its
uniform-la branch (every la = m), at every start type and four integral
(g, h); P-trim against ``_trim_kernel`` of scripts/kern_rowscan2.py in a
test-local interpret-mode ``pallas_call`` (the script stays as it is);
P-dual against ``pallas_rowscan2_score_batch`` pair for pair, odd B. At
g = 0.3, h = 1.7 the references come from XLA:CPU without FMA
(``jax_nofma``), and the finals where K3'' and K3' part are pinned as a
count. Inputs come from numpy seeds; tolerance 0 throughout.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_numerics import SETS, jax_nofma
from test_torch_rowcb import ACGT, STARTS, make_bucket, port

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowscan2
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    pallas_rowscan2_score_batch,
    pallas_rowscan_score_batch,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GH = [(1.0, 2.0), (2.0, 1.0), (1.0, 0.0), (3.0, 5.0)]
G03 = SETS["g0.3-h1.7"]
# finals (of 6 start types x 9 pairs x 3 tables, both branches) where the
# JAX K3'' and K3' part at g=0.3, h=1.7: omega's order (jax 0.9.0, no FMA)
K3PP_VS_K3P = {"ragged": 17, "uniform": 15}


def ragged_bucket():
    """Nine pairs of up to 19 x 23, an empty side possible."""
    return make_bucket(np.random.default_rng(81), 9, 19, 23, 0)


def uniform_bucket():
    """The JAX kernel's uniform-la branch: every la = m."""
    rng = np.random.default_rng(82)
    a, b, _, lb = make_bucket(rng, 9, 19, 23, 0)
    a = ACGT[rng.integers(0, 4, a.shape)]
    return a, b, np.full(9, 19, np.int32), lb


def dual_bucket():
    """Seven pairs (odd B) of uniform la = 31, lb up to 40."""
    rng = np.random.default_rng(83)
    a, b, _, lb = make_bucket(rng, 7, 31, 40, 0)
    a = ACGT[rng.integers(0, 4, a.shape)]
    return a, b, lb


BUCKETS = {"ragged": ragged_bucket, "uniform": uniform_bucket}


def params_of(g, h):
    return ScoringParams(g=g, h=h, match=1.0, mismatch=0.0)


def port_k3pp(a, b, la, lb, s, params):
    st = np.full(len(la), s, np.int32)
    return rowscan2.rowscan2_score_fill(*port(a, b, la, lb, st), params)


def _trim_module():
    spec = importlib.util.spec_from_file_location(
        "kern_rowscan2", ROOT / "scripts" / "kern_rowscan2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_trim(a, b, lb, params):
    """``_trim_kernel`` in an interpret-mode ``pallas_call`` over blocks
    of 8 pairs, laid out as the probe's ``main`` lays it out."""
    kern_rowscan2 = _trim_module()
    B, m = a.shape
    n = b.shape[1]
    nl = -(-(n + 1) // 128) * 128
    ma = max(-(-m // 128) * 128, 128) + 128
    Bp = -(-B // 8) * 8
    a_pad = np.full((Bp, ma), PAD_A, np.int32)
    a_pad[:B, :m] = a
    b_ext = np.full((Bp, nl), PAD_B, np.int32)
    for k in range(B):
        b_ext[k, 1: lb[k] + 1] = b[k, : lb[k]]
    lbc = np.zeros((Bp, 128), np.int32)
    lbc[:B] = lb[:, None]
    g, h, match, mismatch = params.astuple()
    kernel = functools.partial(
        kern_rowscan2._trim_kernel, m=m, nl=nl, g=g, h=h, match=match,
        mismatch=mismatch, unroll=4)
    spec = lambda w: pl.BlockSpec((8, w), lambda i: (i, 0))  # noqa: E731
    out = pl.pallas_call(
        kernel, grid=(Bp // 8,), in_specs=[spec(ma), spec(nl), spec(128)],
        out_specs=spec(128),
        out_shape=jax.ShapeDtypeStruct((Bp, 128), jnp.float32),
        interpret=True)(a_pad, b_ext, lbc)
    return np.asarray(out)[:B, :3]


def _references_g03():
    """The JAX references at g=0.3, h=1.7 (run by ``jax_nofma``)."""
    kw = dict(zip(("g", "h", "match", "mismatch"), G03.astuple()))
    ref = {}
    for name, make in BUCKETS.items():
        a, b, la, lb = make()
        ref[name] = {int(s): (
            pallas_rowscan2_score_batch(a, b, la, lb, start_type=int(s),
                                        block_b=8, interpret=True, **kw),
            pallas_rowscan_score_batch(a, b, la, lb, start_type=int(s),
                                       block_b=8, interpret=True, **kw))
            for s in STARTS}
    a, b, la, lb = uniform_bucket()
    ref["trim"] = jax_trim(a, b, lb, G03)
    a, b, lb = dual_bucket()
    ref["dual"] = pallas_rowscan2_score_batch(
        a, b, np.full(len(lb), a.shape[1], np.int32), lb, block_b=8,
        interpret=True, **kw)
    return ref


@pytest.fixture(scope="module")
def refs_g03():
    return jax_nofma("test_torch_rowscan2", "_references_g03")


@pytest.mark.parametrize("branch", sorted(BUCKETS))
@pytest.mark.parametrize("gh", GH, ids=[f"g{g:g}-h{h:g}" for g, h in GH])
def test_rowscan2_matches_jax(branch, gh):
    """K3'' against ``pallas_rowscan2_score_batch`` at every start type,
    and equal to K3' (the three-table sweep) at integral g, h."""
    a, b, la, lb = BUCKETS[branch]()
    g, h = gh
    for s in STARTS:
        want = pallas_rowscan2_score_batch(a, b, la, lb, g=g, h=h,
                                           start_type=int(s), block_b=8,
                                           interpret=True)
        got = port_k3pp(a, b, la, lb, s, params_of(g, h))
        assert np.array_equal(got.numpy(), want), s
        st = np.full(len(la), s, np.int32)
        k3p = rowcb.rowscan_score_fill(*port(a, b, la, lb, st),
                                       params_of(g, h))
        assert torch.equal(got, k3p), s


def test_rowscan2_score_batch_wrapper():
    """The counterpart of ``pallas_rowscan2_score_batch``: numpy in,
    numpy (B, 3) out, one start type a call."""
    a, b, la, lb = ragged_bucket()
    for s in (-1, 3):
        got = rowscan2.rowscan2_score_batch(a, b, la, lb, g=2.0, h=1.0,
                                            start_type=s, device="cpu")
        want = pallas_rowscan2_score_batch(a, b, la, lb, g=2.0, h=1.0,
                                           start_type=s, block_b=8,
                                           interpret=True)
        assert got.dtype == np.float32 and got.shape == (9, 3)
        assert np.array_equal(got, want)


def test_rowscan2_branches_agree_with_la_zero():
    """The ragged and the uniform-la branch give the same finals where
    their inputs overlap, and la = 0 reads row 0."""
    a, b, _, lb = uniform_bucket()
    la = np.full(9, 19, np.int32)
    la[[2, 5]] = 0
    for s in STARTS:
        ragged = pallas_rowscan2_score_batch(a, b, la, lb, start_type=int(s),
                                             block_b=8, interpret=True)
        got = port_k3pp(a, b, la, lb, s, ScoringParams()).numpy()
        assert np.array_equal(got, ragged), s
        full = port_k3pp(a, b, np.full(9, 19, np.int32), lb, s,
                         ScoringParams()).numpy()
        keep = la == 19
        assert np.array_equal(got[keep], full[keep]), s


@pytest.mark.parametrize("branch", sorted(BUCKETS))
def test_rowscan2_non_dyadic_matches_jax(refs_g03, branch):
    """At g=0.3, h=1.7: K3'' equal to the JAX kernel without FMA, every
    start type; the finals where K3'' and K3' part are pinned (jax 0.9.0),
    and the port's two fills part in the same finals."""
    a, b, la, lb = BUCKETS[branch]()
    apart = 0
    for s in STARTS:
        want, want_k3p = refs_g03[branch][int(s)]
        got = port_k3pp(a, b, la, lb, s, G03)
        assert np.array_equal(got.numpy(), want), s
        st = np.full(len(la), s, np.int32)
        k3p = rowcb.rowscan_score_fill(*port(a, b, la, lb, st), G03)
        assert np.array_equal(k3p.numpy(), want_k3p), s
        apart += int((want != want_k3p).sum())
        assert np.array_equal(got.numpy() != k3p.numpy(), want != want_k3p)
    assert apart == K3PP_VS_K3P[branch]


@pytest.mark.parametrize("pset", ["default", "g1-h0", "g0.3-h1.7"])
def test_trim_rowscan_matches_jax(refs_g03, pset):
    """P-trim against ``_trim_kernel`` and against K3'', start type -1,
    every la = m."""
    a, b, la, lb = uniform_bucket()
    params = {"default": ScoringParams(), "g1-h0": params_of(1.0, 0.0),
              "g0.3-h1.7": G03}[pset]
    want = refs_g03["trim"] if pset == "g0.3-h1.7" else jax_trim(
        a, b, lb, params)
    ta, tb, tlb = port(a, b, lb)
    got = rowcb.trim_rowscan_fill(ta, tb, tlb, params)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, port_k3pp(a, b, la, lb, -1, params))


@pytest.mark.parametrize("pset", ["default", "g0.3-h1.7"])
def test_dual_rowscan2_matches_jax(refs_g03, pset):
    """P-dual against ``pallas_rowscan2_score_batch`` pair for pair, with
    an odd number of pairs, and equal to K3''."""
    a, b, lb = dual_bucket()
    la = np.full(len(lb), a.shape[1], np.int32)
    if pset == "default":
        params = ScoringParams()
        want = pallas_rowscan2_score_batch(a, b, la, lb, block_b=8,
                                           interpret=True)
    else:
        params, want = G03, refs_g03["dual"]
    ta, tb, tlb = port(a, b, lb)
    got = rowscan2.dual_rowscan2_fill(ta, tb, tlb, params)
    assert got.shape == (7, 3)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, port_k3pp(a, b, la, lb, -1, params))


def test_geometry_and_errors():
    assert rowscan2.geometry(2048) == (4, 544)
    assert rowscan2.geometry(5000) == (16, 320)
    assert rowscan2.geometry(100) == (4, 32)
    assert rowscan2.geometry(2048, 16) == (16, 160)
    with pytest.raises(ValueError, match="columns"):
        rowscan2.geometry(100, 3)
    with pytest.raises(ValueError, match="registers"):
        rowscan2.geometry(32 * 512)
    a, b, la, lb = ragged_bucket()
    st = np.full(9, -1, np.int32)
    with pytest.raises(ValueError, match="int32"):
        rowscan2.rowscan2_score_fill(*port(a, b, la, lb,
                                           st.astype(np.int64)),
                                     ScoringParams())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rowscan2.rowscan2_score_batch(a, b, la, lb)


@pytest.mark.cuda
def test_rowscan2_kernels_match_plain_on_card():
    """K3'', P-trim and P-dual against their plain versions on the card,
    at every chunk width, the default and a non-dyadic parameter set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for params in (ScoringParams(), G03):
        a, b, la, lb = ragged_bucket()
        for s in STARTS:
            st = np.full(len(la), s, np.int32)
            cpu = port(a, b, la, lb, st)
            cuda = [x.cuda() for x in cpu]
            want = rowscan2.rowscan2_score_fill(*cpu, params)
            for c in rowscan2.COLUMNS:
                got = rowscan2.rowscan2_score_fill(*cuda, params, columns=c)
                assert torch.equal(got.cpu(), want), (s, c)
        a, b, lb = dual_bucket()
        cpu = port(a, b, lb)
        cuda = [x.cuda() for x in cpu]
        assert torch.equal(rowscan2.dual_rowscan2_fill(*cuda, params).cpu(),
                           rowscan2.dual_rowscan2_fill(*cpu, params))
        assert torch.equal(rowcb.trim_rowscan_fill(*cuda, params).cpu(),
                           rowcb.trim_rowscan_fill(*cpu, params))
