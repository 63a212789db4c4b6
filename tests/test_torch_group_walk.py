"""Port K2' ``group_walk_rle`` (plain PyTorch) == the JAX package's Pallas
walk ``pallas_walk_rle`` in interpret mode.

The dirs16+runs arrays come from ``_pallas_rowdirs(with_runs=True,
interpret=True)``, built as tests/test_pallas_walk.py builds them, and go
to the port unchanged: the JAX array's padded rows, pairs and columns are
the port's row-major (row, pair, column) layout, and both walks clamp
into the same array. Covered: G of 1, 2 and 8, B not divisible by G (the
JAX wrapper halves G; the port's kernel masks the last group), an R_pad
that cuts walks short (the terminator then overwrites the last entry),
and pairs with an empty side (no round). Past its terminator the JAX
kernel leaves its scratch (in interpret mode the previous group's entries
or the integer minimum), so the comparison ends at the terminator; the
port writes zeros there. The streams are also the nonzero entries of
the port's K2 ``rle_walk``. Inputs come from numpy seeds; exact.

The JAX kernel fetches an (8, W) tile of int32 column pairs, W = min(128,
nl / 2), at a multiple of W; when nl / 2 is not a multiple of W (nl =
384) the last tile runs past the array, interpret mode clamps its start,
and the walk reads another cell. The buckets above are 512 columns wide;
at 384 the port keeps the stream of ``_walk_core_rle`` and the count of
pairs where ``pallas_walk_rle`` leaves it is pinned.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cse305_parallel_sequence_alignment_torch.ops import device_walk
from cse305_parallel_sequence_alignment_tpu.models.batch import (
    _end_choice_vec,
)
from cse305_parallel_sequence_alignment_tpu.ops.device_walk import (
    _walk_core_rle,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    _pallas_rowdirs,
    rowscan_prep,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_walk import (
    pallas_walk_rle,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_dirs(seed, la, lb, bm, bn):
    """JAX dirs16+runs (rows, Bp, nl) of a bucket with lengths la, lb,
    and each pair's end table, as numpy arrays."""
    rng = np.random.default_rng(seed)
    B = len(la)
    a = np.full((B, bm), 254, np.uint8)
    b = np.full((B, bn), 255, np.uint8)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    args, meta = rowscan_prep(a, b, la, lb, block_b=8, carries=17)
    meta.pop("uniform_la", None)
    st = np.full((args[0].shape[0], 128), -1, np.int32)
    d16, fin = _pallas_rowdirs(*args[:4], st, with_runs=True, interpret=True,
                               g=1.0, h=2.0, match=1.0, mismatch=0.0, **meta)
    tables, _ = _end_choice_vec(np.asarray(fin)[:B, :3], -1, 2.0)
    return np.array(d16), tables.astype(np.int32)


# (B, la, lb) with the bucket's widths: ragged pairs, two empty ones, and
# wide gaps whose walks pass 128 rounds
RAGGED = (np.array([40, 1, 33, 0, 25, 40, 17, 8, 39, 12, 40], np.int32),
          np.array([300, 290, 35, 50, 26, 0, 280, 9, 200, 12, 41],
                   np.int32), 40, 400)


@pytest.fixture(scope="module")
def bucket():
    la, lb, bm, bn = RAGGED
    d16, tables = make_dirs(71, la, lb, bm, bn)
    return d16, la, lb, tables


def jax_walk(d16, la, lb, tables, R_pad, G):
    ent, used = pallas_walk_rle(jnp.asarray(d16), jnp.asarray(la),
                                jnp.asarray(lb), jnp.asarray(tables),
                                R_pad=R_pad, G=G, interpret=True)
    return np.asarray(ent), np.asarray(used)


def port_walk(d16, la, lb, tables, R_pad, G):
    ent, used = device_walk.group_walk_rle(
        torch.from_numpy(d16), *(torch.from_numpy(np.ascontiguousarray(x))
                                 for x in (la, lb, tables)), R_pad, G=G)
    return ent.numpy(), used.numpy()


def assert_same_streams(got, want):
    (ge, gu), (we, wu) = got, want
    assert ge.dtype == np.int32 and gu.dtype == np.int32
    assert ge.shape == we.shape and np.array_equal(gu, wu)
    R = ge.shape[1]
    for k in range(len(gu)):
        end = min(int(gu[k]), R - 1) + 1  # through the terminator
        assert np.array_equal(ge[k, :end], we[k, :end]), k
        assert not ge[k, end:].any(), k


@pytest.mark.parametrize("G", [1, 2, 8])
def test_group_walk_matches_pallas_walk(bucket, G):
    """Whole walks (R_pad above every walk), 11 pairs: no G > 1 divides
    B, two pairs have an empty side."""
    d16, la, lb, tables = bucket
    want = jax_walk(d16, la, lb, tables, 700, G)
    got = port_walk(d16, la, lb, tables, 700, G)
    assert got[0].shape == (11, 768)
    assert_same_streams(got, want)
    assert got[1][3] == 0 and got[1][5] == 0
    assert (got[1][[0, 6, 8]] > 128).all()


@pytest.mark.parametrize("G", [1, 8])
def test_group_walk_cut_at_r_pad(bucket, G):
    """R_pad 100 rounds up to 128 and cuts the three widest walks: their
    used is 128 and their last entry became the terminator."""
    d16, la, lb, tables = bucket
    want = jax_walk(d16, la, lb, tables, 100, G)
    got = port_walk(d16, la, lb, tables, 100, G)
    assert got[0].shape == (11, 128)
    assert_same_streams(got, want)
    cut = got[1] == 128
    assert cut.sum() >= 3 and (got[0][cut, 127] == 0).all()


def test_group_walk_g_divides_b(bucket):
    """Eight of the pairs, G = 8 and 4 dividing B: one and two groups."""
    d16, la, lb, tables = bucket
    for G in (8, 4):
        want = jax_walk(d16, la[:8], lb[:8], tables[:8], 300, G)
        got = port_walk(d16, la[:8], lb[:8], tables[:8], 300, G)
        assert_same_streams(got, want)


def test_group_walk_equals_k2_streams(bucket):
    """Each pair's stream is the nonzero column of K2 ``rle_walk`` on the
    same dirs, and its round count that column's length."""
    d16, la, lb, tables = bucket
    B = len(la)
    ent, used = port_walk(d16, la, lb, tables, 700, 8)
    dirs = torch.from_numpy(np.ascontiguousarray(d16[:, :B]))
    k2, k2_used = device_walk.rle_walk(
        dirs, *(torch.from_numpy(x) for x in (la, lb, tables)), 700)
    k2 = (k2.view(torch.int16).to(torch.int32) & 0xFFFF).numpy()
    assert int(k2_used[0]) == used.max()
    for k in range(B):
        col = k2[:, k]
        assert np.array_equal(col[col != 0], ent[k, : used[k]]), k


# pairs of RAGGED at 300 columns (nl = 384) whose pallas_walk_rle stream
# leaves _walk_core_rle's (jax 0.9.0, interpret mode)
TILE_OVERRUN_PAIRS = 2


def test_group_walk_keeps_xla_stream_past_jax_tile_overrun():
    """At nl = 384 the port's streams equal the XLA walk's and K2's; the
    Pallas walk's tile overrun changes the pinned number of pairs."""
    la, lb, bm, _ = RAGGED
    d16, tables = make_dirs(71, la, lb, bm, 300)
    assert d16.shape[2] == 384
    ms = 701
    xla, _ = jax.jit(functools.partial(
        _walk_core_rle, max_steps=ms, pair_axis=1))(
        jnp.asarray(d16), jnp.asarray(la), jnp.asarray(lb),
        jnp.asarray(tables))
    xla = np.asarray(xla).T.astype(np.int32)
    pe, pu = jax_walk(d16, la, lb, tables, ms, 8)
    ge, gu = port_walk(d16, la, lb, tables, ms, 8)
    apart = 0
    for k in range(len(la)):
        want = xla[k][xla[k] != 0]
        assert np.array_equal(ge[k, : gu[k]], want), k
        apart += not np.array_equal(pe[k, : pu[k]], want)
    assert apart == TILE_OVERRUN_PAIRS


def test_group_walk_errors(bucket):
    d16, la, lb, tables = bucket
    args = [torch.from_numpy(d16)] + [torch.from_numpy(x)
                                      for x in (la, lb, tables)]
    with pytest.raises(ValueError, match="G 3"):
        device_walk.group_walk_rle(*args, 128, G=3)
    with pytest.raises(TypeError, match="uint16"):
        device_walk.group_walk_rle(args[0].view(torch.int16), *args[1:],
                                   128)
    with pytest.raises(ValueError, match="pairs to walk"):
        device_walk.group_walk_rle(args[0][:, :4].contiguous(), *args[1:],
                                   128)


@pytest.mark.cuda
def test_group_walk_kernel_matches_plain_on_card(bucket):
    """K2' at every G against its plain version on the card, whole and
    cut walks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d16, la, lb, tables = bucket
    cpu = [torch.from_numpy(d16)] + [torch.from_numpy(x)
                                     for x in (la, lb, tables)]
    cuda = [x.cuda() for x in cpu]
    for R_pad in (700, 100):
        want = device_walk.group_walk_rle(*cpu, R_pad)
        for G in device_walk.GROUPS:
            got = device_walk.group_walk_rle(*cuda, R_pad, G=G)
            assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
