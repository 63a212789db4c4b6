"""Port K2 walk (plain PyTorch) and host replays == the JAX package's.

Dirs come from the JAX Pallas fill (interpret mode) through
``dirs_from_jax``, and the port's own dirs go to the JAX walk. Entries,
rounds and chains are integers: equality is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rowcb import STARTS, jax_rowcb, make_bucket, port

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.native import (
    walker as port_walker,
)
from cse305_parallel_sequence_alignment_torch.ops import (
    device_walk as port_dw,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    dirs_from_jax,
    rowcb_fill,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.native import (
    walker as jax_walker,
)
from cse305_parallel_sequence_alignment_tpu.ops import (
    device_walk as jax_dw,
)


def jax_walk(dirs, la, lb, t0):
    max_steps = int(la.max() + lb.max()) + 1
    walk = jax.jit(functools.partial(
        jax_dw._walk_core_rle, max_steps=max_steps, pair_axis=1,
        layout="row"))
    ent, used = walk(jnp.asarray(dirs), jnp.asarray(la), jnp.asarray(lb),
                     jnp.asarray(t0))
    return np.asarray(ent), int(used), max_steps


def assert_same_stream(ent_j, used_j, ent_p, used_p):
    """Same entries; the JAX walk rounds its count up to its unroll 8."""
    assert used_j == -(-used_p // 8) * 8
    assert np.array_equal(ent_p[:used_p], ent_j[:used_p])
    assert not ent_j[used_p:].any() and not ent_p[used_p:].any()


@pytest.fixture(scope="module")
def filled():
    rng = np.random.default_rng(21)
    a, b, la, lb = make_bucket(rng, 8, 70, 90, 0)
    st = STARTS[np.arange(8) % 6]
    dj, _ = jax_rowcb(a, b, la, lb, st, JaxParams())
    t0 = rng.integers(1, 4, 8).astype(np.int32)
    return a, b, la, lb, st, dj, t0


def test_walk_on_jax_dirs_matches_jax(filled):
    a, b, la, lb, st, dj, t0 = filled
    ent_j, used_j, max_steps = jax_walk(dj, la, lb, t0)
    ent, used = port_dw.rle_walk(dirs_from_jax(dj, la, lb),
                                 *port(la, lb, t0), max_steps)
    assert ent.dtype == torch.uint16 and tuple(ent.shape) == (max_steps, 8)
    assert_same_stream(ent_j, used_j, ent.numpy(), int(used[0]))


def test_jax_walk_on_port_dirs_matches_port(filled):
    a, b, la, lb, st, dj, t0 = filled
    dirs, _ = rowcb_fill(*port(a, b, la, lb, st), ScoringParams())
    ent_j, used_j, max_steps = jax_walk(dirs.numpy(), la, lb, t0)
    ent, used = port_dw.rle_walk(dirs, *port(la, lb, t0), max_steps)
    assert_same_stream(ent_j, used_j, ent.numpy(), int(used[0]))


@pytest.mark.parametrize("mode,offsets", [("parity", False),
                                          ("full", False),
                                          ("full", True)])
def test_host_replays_match_jax(filled, mode, offsets):
    """expand_rle_ops + replay_ops, and the native replay, equal the JAX
    package's on the same entry stream."""
    a, b, la, lb, st, dj, t0 = filled
    ent, used = port_dw.rle_walk(dirs_from_jax(dj, la, lb),
                                 *port(la, lb, t0),
                                 int(la.max() + lb.max()) + 1)
    ent_b = np.ascontiguousarray(ent.numpy()[: int(used[0])].T)
    max_steps = int(la.max() + lb.max()) + 1
    offs = [(3 * k, 5 * k + 1) for k in range(8)] if offsets else None
    chunk = list(range(8)) if offsets else None
    ops_p = port_dw.expand_rle_ops(ent_b, max_steps)
    ops_j = jax_dw.expand_rle_ops(ent_b, max_steps)
    assert np.array_equal(ops_p, ops_j)
    ops_p = np.pad(ops_p, ((0, 0), (0, max_steps - ops_p.shape[1])))
    kw = dict(mode=mode, offsets=offs, chunk=chunk)
    la64, lb64, t64 = (x.astype(np.int64) for x in (la, lb, t0))
    want = jax_dw.replay_ops(ops_p, la64, lb64, t64, **kw)
    got = port_dw.replay_ops(ops_p, la64, lb64, t64, **kw)
    nat_j = jax_walker.replay_rle(ent_b, la, lb, t0, **kw)
    nat_p = port_walker.replay_rle(ent_b, la, lb, t0, **kw)
    for r in range(8):
        L = int(want[3][r])
        assert int(got[3][r]) == L == int(nat_p[3][r]) == int(nat_j[3][r])
        for k in range(3):
            assert np.array_equal(got[k][r, :L], want[k][r, :L])
            assert np.array_equal(nat_p[k][r, :L], want[k][r, :L])


def test_render_matches_jax(filled):
    a, b, la, lb, st, dj, t0 = filled
    ent, used = port_dw.rle_walk(dirs_from_jax(dj, la, lb),
                                 *port(la, lb, t0),
                                 int(la.max() + lb.max()) + 1)
    ent_b = np.ascontiguousarray(ent.numpy()[: int(used[0])].T)
    tt, ii, jj, lens = port_walker.replay_rle(ent_b, la, lb, t0, "parity")
    for r in range(8):
        L = int(lens[r])
        args = (a[r, : la[r]], b[r, : lb[r]], tt[r, :L], ii[r, :L],
                jj[r, :L])
        assert port_walker.render(*args) == jax_walker.render(*args)


def test_walk_and_replay_reject_bad_inputs():
    dirs = torch.zeros((3, 2, 4), dtype=torch.uint16)
    ok = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_dw.rle_walk(dirs.view(torch.int16), ok, ok, ok, 4)
    with pytest.raises(ValueError):
        port_dw.rle_walk(dirs, ok[:1], ok, ok, 4)
    with pytest.raises(ValueError):
        port_walker.replay_rle(np.zeros((2, 1), np.uint16), np.ones(2),
                               np.ones(2), np.ones(2), "local")
    with pytest.raises(RuntimeError):  # stream ends before an edge
        port_walker.replay_rle(np.zeros((1, 1), np.uint16), np.array([3]),
                               np.array([3]), np.array([1]), "parity")
