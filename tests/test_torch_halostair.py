"""Port K8 pipeline step (plain PyTorch) == the JAX package's
``halostair_step`` in interpret mode.

A 200 x 3,000 pair on two column blocks of S=8 x nl_c=256 columns (the
JAX kernel's layout, reshaped to the port's (2, nc) and (3, nc) carries),
R = 128 rows a step: two chained steps on block 0 and two on block 1, fed
block 0's halos, so the diagonal carry crosses steps and blocks and row
la = 200 is captured in the second step. Every start type, at the
default parameters, at g=2, h=3 and at g=0.3, h=1.7. The JAX references
run in a process whose XLA:CPU emits no fused multiply-add (the tests'
``jax_nofma``). Tolerance is 0.
"""

import numpy as np
import pytest
import torch
from test_torch_numerics import SETS, jax_nofma
from test_torch_rowcb import ACGT

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import halostair

S, NL, R = 8, 256, 128
NC = S * NL
M, N = 200, 3000
C = -(-M // R)
STARTS = (-1, -2, -3, 1, 2, 3)
PSETS = {"default": ScoringParams(), "g2-h3": ScoringParams(g=2.0, h=3.0),
         "g0.3-h1.7": SETS["g0.3-h1.7"]}


def pair():
    rng = np.random.default_rng(71)
    return ACGT[rng.integers(0, 4, M)], ACGT[rng.integers(0, 4, N)]


def b_blocks():
    """Global columns 0..2*NC-1: column j > 0 holds B[j-1]."""
    _, b = pair()
    flat = np.full(2 * NC, PAD_B, np.uint8)
    flat[1: N + 1] = b
    return flat


def _jax_chain(p, st):
    """{(block, step): (halo rows (3, R), state (2, NC), fin (3, NC))} and
    the initial carries of both blocks, from the JAX kernel."""
    import jax.numpy as jnp

    from cse305_parallel_sequence_alignment_tpu.ops.pallas_halostair import (
        build_askew,
        halostair_init,
        halostair_step,
    )
    a, _ = pair()
    g, h, match, mismatch = p.astuple()
    a_pad = np.full((1, 128 + C * R + 256), PAD_A, np.int32)
    a_pad[0, 128: 128 + M] = a
    askew = build_askew(jnp.asarray(a_pad), S)
    flat = b_blocks().astype(np.int32)
    carries = [halostair_init(jnp.int32(k), S, NL, g, h, st) for k in (0, 1)]
    init = {k: (np.asarray(carries[k][0]).reshape(2, NC),
                float(np.asarray(carries[k][2])[2, 0, 0])) for k in (0, 1)}
    out = {}
    for c in range(C):
        msg = jnp.full((3, R, 128), NEG_INF, jnp.float32)
        for k in (0, 1):
            sc = jnp.array([[k * NC, M, st, c * R]], jnp.int32)
            bnd, *carries[k] = halostair_step(
                askew[:, c * R: c * R + R + 256],
                jnp.asarray(flat[k * NC: (k + 1) * NC].reshape(S, NL)), sc,
                msg, *carries[k], S=S, nl_c=NL, R=R, g=g, h=h, match=match,
                mismatch=mismatch, interpret=True)
            out[(k, c)] = (np.asarray(bnd)[:, :, 0],
                           np.asarray(carries[k][0]).reshape(2, NC),
                           np.asarray(carries[k][3]).reshape(3, NC))
            msg = bnd
    return out, init


def _references():
    return {name: {st: _jax_chain(p, st) for st in STARTS}
            for name, p in PSETS.items()}


@pytest.fixture(scope="module")
def refs():
    return jax_nofma("test_torch_halostair", "_references")


def port_chain(p, st):
    """The port's plain steps, in the order of ``_jax_chain``."""
    a, _ = pair()
    a_pad = np.full(C * R, PAD_A, np.uint8)
    a_pad[:M] = a
    flat = b_blocks()
    blocks = [halostair.halostair_init(k * NC, NC, st, p, "cpu")
              for k in (0, 1)]
    out = {}
    for c in range(C):
        halo = torch.full((R + 1, 4), NEG_INF)
        for k in (0, 1):
            state, fin, _ = blocks[k]
            halo = halostair.halostair_step(
                torch.from_numpy(a_pad[c * R: (c + 1) * R]),
                torch.from_numpy(flat[k * NC: (k + 1) * NC]), halo, state,
                fin, k * NC, c * R, M, st, p)
            out[(k, c)] = (halo.numpy().copy(), state.numpy().copy(),
                           fin.numpy().copy())
    return out, blocks


@pytest.mark.parametrize("pset", sorted(PSETS))
@pytest.mark.parametrize("st", STARTS)
def test_step_matches_jax(refs, pset, st):
    want, _ = refs[pset][st]
    got, _ = port_chain(PSETS[pset], st)
    for (k, c), (bnd, state, fin) in want.items():
        halo, p_state, p_fin = got[(k, c)]
        rows = min(R, M - c * R)  # the JAX kernel leaves stale records past m
        np.testing.assert_array_equal(halo[1: rows + 1, :3].T,
                                      bnd[:, :rows], err_msg=f"{k} {c}")
        assert np.all(halo[rows + 1:] == NEG_INF)
        np.testing.assert_array_equal(p_state, state, err_msg=f"{k} {c}")
        np.testing.assert_array_equal(p_fin, fin, err_msg=f"{k} {c}")
    # the capture of row la = M happened, in the second step
    assert np.isfinite(got[(0, 1)][2]).any()
    assert not np.isfinite(got[(0, 0)][2]).any()


@pytest.mark.parametrize("st", STARTS)
def test_init_matches_jax(refs, st):
    """Row 0's carries, and the left ghost H(0, cs-1) of each block."""
    _, init = refs["g0.3-h1.7"][st]
    for k in (0, 1):
        state, fin, halo0 = halostair.halostair_init(
            k * NC, NC, st, PSETS["g0.3-h1.7"], "cpu")
        np.testing.assert_array_equal(state.numpy(), init[k][0])
        assert float(halo0[2]) == init[k][1]
        assert torch.all(fin == NEG_INF)


@pytest.mark.parametrize("st", STARTS)
def test_halo_row0_is_the_next_blocks_ghost(st):
    """Record 0 of block 0's halo is H(0, NC-1): block 1's left ghost."""
    p = ScoringParams(g=0.3, h=1.7)
    a, _ = pair()
    state, fin, _ = halostair.halostair_init(0, NC, st, p, "cpu")
    halo = halostair.halostair_step(
        torch.from_numpy(a[:R].copy()), torch.from_numpy(b_blocks()[:NC]),
        torch.full((R + 1, 4), NEG_INF), state, fin, 0, 0, M, st, p)
    _, _, ghost = halostair.halostair_init(NC, NC, st, p, "cpu")
    assert torch.equal(halo[0], ghost)
    # a block starting at column 1 has the corner on its left
    _, _, corner = halostair.halostair_init(1, 4, st, p, "cpu")
    assert float(corner[2]) == (NEG_INF if st in (2, 3) else 0.0)


def test_step_rejects_bad_inputs():
    p = ScoringParams()
    state, fin, _ = halostair.halostair_init(0, 8, -1, p, "cpu")
    a = torch.zeros(4, dtype=torch.uint8)
    b = torch.zeros(8, dtype=torch.uint8)
    halo = torch.full((5, 4), NEG_INF)
    with pytest.raises(TypeError):
        halostair.halostair_step(a.int(), b, halo, state, fin, 0, 0, 4, -1, p)
    with pytest.raises(ValueError):
        halostair.halostair_step(a, b, halo[:4], state, fin, 0, 0, 4, -1, p)
    with pytest.raises(ValueError):  # no row left: base at la
        halostair.halostair_step(a, b, halo, state, fin, 0, 4, 4, -1, p)


@pytest.mark.cuda
def test_step_kernel_matches_plain_on_card():
    """K8 against its plain version on the card: several strips, both
    blocks, a capture on the call's last row and inside it, every start
    type, at the default parameters and at g=0.3, h=1.7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    nc, rr = 5000, 64
    a = torch.from_numpy(ACGT[rng.integers(0, 4, rr)])
    b = torch.from_numpy(ACGT[rng.integers(0, 4, 2 * nc)])
    for p in (ScoringParams(), SETS["g0.3-h1.7"]):
        for st in STARTS:
            for k, la in ((0, rr), (1, 40)):
                halo = torch.from_numpy(rng.normal(0, 20, (rr + 1, 4)).astype(
                    np.float32)) if k else torch.full((rr + 1, 4), NEG_INF)
                outs = []
                for dev in ("cpu", "cuda"):
                    state, fin, _ = halostair.halostair_init(k * nc, nc, st, p,
                                                             dev)
                    blk = b[k * nc: (k + 1) * nc].contiguous()
                    hout = halostair.halostair_step(
                        a.to(dev), blk.to(dev), halo.to(dev), state, fin,
                        k * nc, 0, la, st, p)
                    outs.append([x.cpu() for x in (hout, state, fin)])
                for x, y in zip(*outs):
                    assert torch.equal(x, y), (p, st, k)
