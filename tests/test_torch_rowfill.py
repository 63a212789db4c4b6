"""K1/K4d's H100 fill (csrc/rowfill.cu): its geometry, its pitched dirs
and K2 on them.

On the CPU: ``fill_geometry``'s invariants and width rule, and the K2
walk (plain) on a pitched view of K1's dirs equal to the walk on the
contiguous array and to the JAX package's ``_walk_core_rle``, at the run
cap and on ragged pairs. On a card (marker ``cuda``): the kernel against
``_sweep_plain`` bit for bit, on one CTA at C = 4, 8, 16 and on clusters
of 2 to 4 CTAs, with and without a substitution table, the global-scratch
route past the cluster's reach, and K2 and K2' on the pitched dirs.
Tolerance 0 throughout: the dirs and walk entries are integers, the
finals float32 taken in the plain version's order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rowcb import STARTS, make_bucket, port

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import device_walk, rowcb
from cse305_parallel_sequence_alignment_torch.utils.matrices import BLOSUM62
from cse305_parallel_sequence_alignment_tpu.ops import (
    device_walk as jax_dw,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)
NON_DYADIC = ScoringParams(g=0.3, h=1.7, match=1.0, mismatch=-0.7)


@pytest.mark.parametrize("B, n", [(1, 0), (1, 1), (7, 100), (256, 2048),
                                  (128, 2048), (300, 511), (4096, 1024),
                                  (16, 4095), (16, 4096), (132, 8191),
                                  (16, 8192), (8, 12300), (4, 27136),
                                  (300, 27136), (1, 65535)])
def test_fill_geometry_invariants(B, n):
    C, threads, k = rowcb.fill_geometry(B, n)
    assert C in rowcb.FILL_C and 1 <= k <= rowcb.MAX_CLUSTER
    assert threads % 32 == 0 and 32 <= threads <= rowcb.FILL_THREADS[C]
    assert k * threads * C >= n + 1
    # the fewest whole warps: one warp less no longer covers the row
    assert k * (threads - 32) * C < n + 1
    k_min = -(-(n + 1) // rowcb.CTA_REACH)
    if n + 1 > 4096:  # C = 16, the SMs shared out, at least k_min
        assert C == 16 and k == max(k_min, min(8, rowcb.SMS // B))
    else:
        assert k == 1 and C in (4, 8)
    assert rowcb.fill_geometry(B, n, k1=25) == (C, threads, k)


def test_fill_geometry_waves_and_width_rule():
    # 256 x 2 kb: C = 8 fits three CTAs an SM at its 64-register cap, one
    # wave; C = 4 one (two waves). 128 pairs: one wave at C = 4 already
    assert rowcb.fill_geometry(256, 2048) == (8, 288, 1)
    assert 256 <= rowcb.SMS * (65536 // (288 * rowcb.FILL_REGS[8]))
    assert rowcb.fill_geometry(128, 2048) == (4, 544, 1)
    # few wide pairs spread over the card: 8 CTAs a pair, 128 threads
    assert rowcb.fill_geometry(8, 12288) == (16, 128, 8)
    assert rowcb.fill_geometry(2, 26624) == (16, 224, 8)
    # many: the fewest CTAs that hold the row
    assert rowcb.fill_geometry(300, 27136) == (16, 448, 4)
    assert rowcb.fill_geometry(132, 8191) == (16, 512, 1)
    # past 8 CTAs' reach: None, the width rule's global-scratch sweep
    assert rowcb.fill_geometry(1, rowcb.CLUSTER_REACH - 1)[2] == 8
    assert rowcb.fill_geometry(1, rowcb.CLUSTER_REACH) is None
    assert rowcb.fill_geometry(300, 70000) is None


@pytest.mark.parametrize("n", [0, 1, 7, 8, 2047, 2048, 26624])
def test_dirs_pitch(n):
    p = rowcb.dirs_pitch(n)
    assert p % 8 == 0 and n + 1 <= p < n + 9


def pitched(dirs, fill=0xA5A5):
    """A copy of ``dirs`` in pitched rows, the padding set to ``fill``."""
    rows, B, cols = dirs.shape
    big = torch.full((rows, B, rowcb.dirs_pitch(cols - 1)), fill,
                     dtype=torch.int32).to(torch.int16).view(torch.uint16)
    big[:, :, :cols] = dirs
    return big[:, :, :cols]


def jax_walk(dirs, la, lb, t0, max_steps):
    walk = jax.jit(functools.partial(
        jax_dw._walk_core_rle, max_steps=max_steps, pair_axis=1,
        layout="row"))
    ent, used = walk(jnp.asarray(dirs), jnp.asarray(la), jnp.asarray(lb),
                     jnp.asarray(t0))
    return np.asarray(ent), int(used)


@pytest.fixture(scope="module")
def run_cap_bucket():
    """Three related pairs of 600 nt (diagonal runs past the 255 cap) and
    five ragged ones, their K1 dirs (plain) and end tables."""
    rng = np.random.default_rng(23)
    a, b, la, lb = make_bucket(rng, 8, 600, 610, 0)
    for k in range(3):
        la[k], lb[k] = 600, 600 + k
        b[k, :600] = a[k, :600]
        b[k, 600:lb[k]] = ACGT[0]
    st = STARTS[np.arange(8) % 6]
    dirs, _ = rowcb.rowcb_fill_plain(*port(a, b, la, lb, st),
                                     ScoringParams())
    t0 = rng.integers(1, 4, 8).astype(np.int32)
    return (a, b, la, lb, st), dirs, t0


def test_walk_on_pitched_dirs_at_run_cap(run_cap_bucket):
    (_, _, la, lb, _), dirs, t0 = run_cap_bucket
    assert int((dirs.view(torch.int16).to(torch.int32) & 0xFFFF).max()
               >> 8) == 255  # the cap is reached
    view = pitched(dirs)
    assert not view.is_contiguous()
    assert device_walk.row_pitch(view) == rowcb.dirs_pitch(610)
    max_steps = int(la.max() + lb.max()) + 1
    args = port(la, lb, t0)
    ent, used = device_walk.rle_walk_plain(dirs, *args, max_steps)
    ent_v, used_v = device_walk.rle_walk(view, *args, max_steps)
    assert torch.equal(used, used_v)
    assert torch.equal(ent.view(torch.int16), ent_v.view(torch.int16))
    ent_j, used_j = jax_walk(dirs.numpy(), la, lb, t0, max_steps)
    u = int(used[0])
    assert used_j == -(-u // 8) * 8  # the JAX walk unrolls by 8
    assert np.array_equal(ent.numpy()[:u], ent_j[:u])
    assert (ent.numpy()[:u] >> 2).max() == 255  # whole capped runs taken


def test_group_walk_on_pitched_dirs(run_cap_bucket):
    (_, _, la, lb, _), dirs, t0 = run_cap_bucket
    args = port(la, lb, t0)
    want = device_walk.group_walk_rle(dirs, *args, 1300)
    got = device_walk.group_walk_rle(pitched(dirs), *args, 1300)
    assert all(torch.equal(x, y) for x, y in zip(want, got))


def test_row_pitch_refuses_other_layouts():
    d = torch.zeros((3, 4, 9), dtype=torch.int16).view(torch.uint16)
    assert device_walk.row_pitch(d) == 9
    assert device_walk.row_pitch(d[:, :, :5]) == 9
    assert device_walk.row_pitch(d[:, :1]) == 36  # one pair: rows 36 apart
    with pytest.raises(ValueError):
        device_walk.row_pitch(d.transpose(0, 1))
    with pytest.raises(ValueError):
        device_walk.rle_walk(d[::2], *port(*[np.ones(4, np.int32)] * 3), 4)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_fill_equal(args, params, table=None, geometry=None):
    """The kernel at ``geometry`` (through ``rowcb_fill`` at its own
    choice when None, which counts one launch) against the plain
    sweep."""
    if geometry is None:
        before = (rowcb.rowcb_fill.launches,
                  rowcb.rowcb_fill.table_launches)
        d_k, f_k = rowcb.rowcb_fill(*args, params, table)
        after = (rowcb.rowcb_fill.launches, rowcb.rowcb_fill.table_launches)
        assert after[table is not None] == before[table is not None] + 1
    else:
        d_k, f_k = rowcb._fill(*args, params, table, geometry)
    if table is None:
        d_p, f_p = rowcb.rowcb_fill_plain(*args, params)
    else:
        d_p, f_p = rowcb.matrix_dirs_plain(*args, table, params)
    assert d_k.shape == d_p.shape
    assert device_walk.row_pitch(d_k) == rowcb.dirs_pitch(d_k.shape[2] - 1)
    assert torch.equal(d_k.view(torch.int16), d_p.view(torch.int16))
    assert torch.equal(f_k, f_p)
    return d_k


# one CTA at each C, and clusters whose CTA boundaries (every 512
# columns at 32 threads) fall inside the 1,001 columns
GEOMETRIES = [(4, 256, 1), (8, 128, 1), (16, 64, 1), (16, 32, 2),
              (16, 32, 3), (16, 32, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("params", [ScoringParams(), NON_DYADIC])
def test_rowfill_matches_plain_on_card(geometry, params):
    dev = card()
    rng = np.random.default_rng(31)
    a, b, la, lb = make_bucket(rng, 12, 90, 1000, 0)
    st = STARTS[np.arange(12) % 6]
    la[0], lb[0] = 90, 1000
    assert_fill_equal([x.to(dev) for x in port(a, b, la, lb, st)], params,
                      geometry=geometry)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(4, 192, 1), (16, 64, 1), (16, 32, 2)])
def test_rowfill_table_matches_plain_on_card(geometry):
    dev = card()
    rng = np.random.default_rng(37)
    k1 = BLOSUM62.k + 1
    a = rng.integers(0, k1, (8, 70)).astype(np.uint8)
    b = rng.integers(0, k1, (8, 700)).astype(np.uint8)
    la = rng.integers(0, 71, 8).astype(np.int32)
    lb = rng.integers(0, 701, 8).astype(np.int32)
    st = STARTS[np.arange(8) % 6]
    table = torch.from_numpy(BLOSUM62.table()).to(dev)
    assert_fill_equal([x.to(dev) for x in port(a, b, la, lb, st)],
                      ScoringParams(g=1.0, h=11.0), table, geometry)


@pytest.mark.cuda
def test_rowfill_run_cap_and_walks_on_card(run_cap_bucket):
    dev = card()
    bucket, dirs, t0 = run_cap_bucket
    la, lb = bucket[2:4]
    args = [x.to(dev) for x in port(*bucket)]
    for geometry in (None, (16, 32, 2)):
        d_k = assert_fill_equal(args, ScoringParams(), geometry=geometry)
        assert torch.equal(d_k.cpu().view(torch.int16),
                           dirs.view(torch.int16))
        wargs = [x.to(dev) for x in port(la, lb, t0)]
        max_steps = int(la.max() + lb.max()) + 1
        got = device_walk.rle_walk(d_k, *wargs, max_steps)
        want = device_walk.rle_walk_plain(d_k, *wargs, max_steps)
        assert all(torch.equal(x.view(torch.int16) if x.dtype ==
                               torch.uint16 else x,
                               y.view(torch.int16) if y.dtype ==
                               torch.uint16 else y)
                   for x, y in zip(got, want))
        got = device_walk.group_walk_rle(d_k, *wargs, 1300)
        want = device_walk.group_walk_rle_plain(d_k, *wargs, 1300)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_wide_rows_take_the_scratch_sweep_on_card():
    dev = card()
    rng = np.random.default_rng(41)
    n = rowcb.CLUSTER_REACH  # one column past 8 CTAs' reach
    a, b, la, lb = make_bucket(rng, 2, 3, n, 1)
    lb[0] = n
    args = [x.to(dev) for x in port(a, b, la, lb, STARTS[:2])]
    before = rowcb.rowcb_fill.wide_launches
    d_k, f_k = rowcb.rowcb_fill(*args, ScoringParams())
    assert rowcb.rowcb_fill.wide_launches == before + 1
    assert d_k.is_contiguous()
    d_p, f_p = rowcb.rowcb_fill_plain(*args, ScoringParams())
    assert torch.equal(d_k.view(torch.int16), d_p.view(torch.int16))
    assert torch.equal(f_k, f_p)
