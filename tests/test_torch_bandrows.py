"""K12d's H100 body (csrc/banded.cu ``band_rows_kernel``): its geometry
rule, its pitched dirs and K2 in band layout on them.

On the CPU: ``band_geometry``'s invariants and width rule; the plain K2
band walk on a pitched view of K12d's dirs equal to the walk on the
contiguous array and to the JAX package's ``_walk_core_rle`` in layout
("band", w_lo), at the run cap and on ragged pairs with every start type.
On a card (marker ``cuda``): the kernel against ``banded_fill_plain`` at
each C (one CTA a pair, several warps), ragged pairs of every start type
at the default parameters and g=0.3, h=1.7, the banded path's W = 1,329
on a shorter pair, and K2 on its pitched dirs; ``band_kernel`` on the
same tensors. Tolerance 0: the dirs and walk entries are integers, the finals
float32 taken in the plain version's order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import SETS

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import banded, device_walk
from cse305_parallel_sequence_alignment_tpu.ops import (
    device_walk as jax_dw,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)
STARTS = np.array([-1, -2, -3, 1, 2, 3], np.int32)


@pytest.mark.parametrize("B", [1, 8, 256])
@pytest.mark.parametrize("W", [129, 513, 1329, 8192, 18001])
def test_band_geometry_invariants(B, W):
    geo = banded.band_geometry(B, W)
    if W > banded.ROWS_REACH:  # band_kernel with global scratch
        assert geo is None
        return
    C, threads = geo
    assert C in banded.ROWS_C
    assert threads % 32 == 0
    assert 32 <= threads <= banded.ROWS_THREADS[C]
    assert threads * C >= W  # the lanes are covered
    assert (threads - 32) * C < W  # by the fewest whole warps
    assert threads == banded.band_threads(W, C)


def test_band_geometry_choices():
    # C = 4 ran fastest at the banded path's W and on 256 pairs at 129
    # and 513; near the reach C = 8's fewer warps win
    assert banded.band_geometry(1, 1329) == (4, 352)
    assert banded.band_geometry(256, 129) == (4, 64)
    assert banded.band_geometry(256, 513) == (4, 160)
    assert banded.band_geometry(1, banded.ROWS_REACH) == (8, 512)
    assert banded.band_geometry(1, banded.ROWS_REACH + 1) is None
    assert banded.band_geometry(2, 18001) is None


def related_bucket(seed):
    """Three identical pairs of 600 nt (diagonal runs past the 255 cap,
    one ending off the diagonal) and six ragged ones, one per start type,
    in the band (4, 4)."""
    rng = np.random.default_rng(seed)
    la = np.array([600, 600, 600, 500, 1, 90, 333, 0, 47], np.int32)
    lb = np.array([600, 603, 598, 497, 4, 90, 330, 3, 50], np.int32)
    B, m, n = len(la), int(la.max()), int(lb.max())
    a = np.full((B, m), PAD_A, np.uint8)
    b = np.full((B, n), PAD_B, np.uint8)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    for k in range(3):
        s = min(la[k], lb[k])
        b[k, :s] = a[k, :s]
    st = np.concatenate([np.full(3, -1, np.int32), STARTS])
    return a, b, la, lb, st


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def pitched(dirs, fill=0x5A5A):
    """A copy of ``dirs`` in rows pitched as the kernel's, the padding
    set to ``fill``."""
    rows, B, W = dirs.shape
    big = torch.full((rows, B, banded.dirs_pitch(W - 1)), fill,
                     dtype=torch.int32).to(torch.int16).view(torch.uint16)
    big[:, :, :W] = dirs
    return big[:, :, :W]


def jax_band_walk(dirs, la, lb, t0, max_steps, w_lo):
    walk = jax.jit(functools.partial(
        jax_dw._walk_core_rle, max_steps=max_steps, pair_axis=1,
        layout=("band", w_lo)))
    ent, used = walk(jnp.asarray(dirs.view(torch.int16).numpy()),
                     jnp.asarray(la), jnp.asarray(lb), jnp.asarray(t0))
    return np.asarray(ent), int(used)


@pytest.mark.parametrize("pname", ["default", "g0.3-h1.7"])
def test_band_walk_on_pitched_dirs(pname):
    params = ScoringParams() if pname == "default" else SETS[pname]
    a, b, la, lb, st = related_bucket(3)
    w_lo = w_hi = 4
    dirs, fin = banded.banded_fill_plain(*port(a, b, la, lb, st), w_lo,
                                         w_hi, params, True)
    words = dirs.view(torch.int16).to(torch.int32) & 0xFFFF
    assert int(words.max() >> 8) == 255  # the cap is reached
    view = pitched(dirs)
    assert not view.is_contiguous()
    assert device_walk.row_pitch(view) == banded.dirs_pitch(w_lo + w_hi)
    t0 = np.array([1, 2, 3, 1, 2, 3, 1, 2, 3], np.int32)
    max_steps = int(la.max() + lb.max()) + 1
    args = port(la, lb, t0)
    ent, used = device_walk.rle_walk_plain(dirs, *args, max_steps, w_lo)
    ent_v, used_v = device_walk.rle_walk(view, *args, max_steps,
                                         band_lo=w_lo)
    assert torch.equal(used, used_v)
    assert torch.equal(ent.view(torch.int16), ent_v.view(torch.int16))
    ent_j, used_j = jax_band_walk(dirs, la, lb, t0, max_steps, w_lo)
    u = int(used[0])
    assert used_j == -(-u // 8) * 8  # the JAX walk unrolls by 8
    assert np.array_equal(ent.view(torch.int16).numpy()[:u],
                          ent_j[:u].astype(np.int16))
    assert (ent.numpy()[:u] >> 2).max() == 255  # whole capped runs taken


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_band_equal(args, w_lo, w_hi, params, geometry):
    d_k, f_k = banded._rows_fill(*args, w_lo, w_hi, params, geometry)
    d_p, f_p = banded.banded_fill_plain(*[x.cpu() for x in args], w_lo,
                                        w_hi, params, True)
    assert d_k.shape == d_p.shape
    W = w_lo + w_hi + 1
    assert device_walk.row_pitch(d_k) == banded.dirs_pitch(W - 1)
    assert torch.equal(d_k.cpu().view(torch.int16), d_p.view(torch.int16))
    assert torch.equal(f_k.cpu(), f_p)
    return d_k, f_k


@pytest.mark.cuda
@pytest.mark.parametrize("C", banded.ROWS_C)
@pytest.mark.parametrize("params", [ScoringParams(), SETS["g0.3-h1.7"]])
def test_band_rows_match_plain_on_card(C, params):
    dev = card()
    a, b, la, lb, st = related_bucket(5)
    args = [x.to(dev) for x in port(a, b, la, lb, st)]
    for w_lo, w_hi in ((4, 4), (100, 180), (3, 700)):
        W = w_lo + w_hi + 1
        geometry = (C, banded.band_threads(W, C))
        d_k, f_k = assert_band_equal(args, w_lo, w_hi, params, geometry)
        old_d, old_f = banded._launch(*args, w_lo, w_hi, params, True)
        assert torch.equal(old_d.view(torch.int16), d_k.view(torch.int16))
        assert torch.equal(old_f, f_k)
        t0 = torch.ones(len(la), dtype=torch.int32, device=dev)
        steps = int(la.max() + lb.max()) + 1
        w_k = device_walk.rle_walk(d_k, args[2], args[3], t0, steps,
                                   band_lo=w_lo)
        w_p = device_walk.rle_walk_plain(d_k.cpu(), args[2].cpu(),
                                         args[3].cpu(), t0.cpu(), steps,
                                         w_lo)
        assert torch.equal(w_k[0].cpu().view(torch.int16),
                           w_p[0].view(torch.int16))
        assert torch.equal(w_k[1].cpu(), w_p[1])


@pytest.mark.cuda
@pytest.mark.parametrize("C", banded.ROWS_C)
def test_band_rows_at_the_path_width_on_card(C):
    """W = 1,329, the banded path's, on a 1,500 x 1,520 pair."""
    dev = card()
    rng = np.random.default_rng(9)
    x = ACGT[rng.integers(0, 4, 1500)]
    y = np.concatenate([x[:700], ACGT[rng.integers(0, 4, 20)], x[700:]])
    args = [v.to(dev) for v in port(x[None], y[None],
                                     np.array([1500], np.int32),
                                     np.array([1520], np.int32),
                                     np.array([-1], np.int32))]
    assert_band_equal(args, 664, 664, ScoringParams(),
                      (C, banded.band_threads(1329, C)))
