"""Port data-sharded aligners (``parallel/batch_shard.py``) == the JAX
package's and the port's unsharded aligners.

19 pairs (not a multiple of the mesh's eight entries, so the last shard
is padded with copies of the last pair) on a data mesh of eight CPU
entries, against the JAX aligners on the conftest's eight virtual CPU
devices. Tolerance is 0.
"""

import numpy as np
import pytest
import torch

from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.parallel.batch_shard import (
    ShardedBatchAligner,
    ShardedLocalBatchAligner,
    shard_rows,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    Mesh,
    make_data_mesh,
)
from cse305_parallel_sequence_alignment_torch.utils.matrices import BLOSUM62
from cse305_parallel_sequence_alignment_tpu.parallel import (
    batch_shard as jax_shard,
)


def rand_pairs(rng, count, lo=10, hi=50):
    return [("".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))),
             "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi)))))
            for _ in range(count)]


def result(r):
    return (r.score, list(r.chain), r.aligned_a, r.aligned_b, r.end_table)


def mesh(D=8):
    return make_data_mesh(D, device="cpu")


@pytest.mark.parametrize("hi", [50, 300], ids=["10-50", "10-300"])
def test_sharded_scores_match_jax_and_unsharded(hi):
    pairs = rand_pairs(np.random.default_rng(91), 19, hi=hi)
    s1, t1 = BatchAligner(device="cpu").score_batch(pairs)
    s2, t2 = ShardedBatchAligner(mesh=mesh(), device="cpu").score_batch(pairs)
    s3, t3 = jax_shard.ShardedBatchAligner().score_batch(pairs)
    for x, y in ((s1, s2), (t1, t2), (s3, s2), (t3, t2)):
        np.testing.assert_array_equal(x, y)


def test_sharded_align_matches_jax_and_unsharded():
    pairs = rand_pairs(np.random.default_rng(92), 19, hi=200)
    got = ShardedBatchAligner(mesh=mesh(), device="cpu").align_batch(pairs)
    plain = BatchAligner(device="cpu").align_batch(pairs)
    want = jax_shard.ShardedBatchAligner().align_batch(pairs)
    assert [result(r) for r in got] == [result(r) for r in plain]
    assert [result(r) for r in got] == [result(r) for r in want]


def test_sharded_align_with_offsets_and_types():
    """The partition's segment batch: per-pair types, offsets, full mode."""
    pairs = rand_pairs(np.random.default_rng(95), 11, hi=120)
    kw = dict(offsets=[(3 * k, 5 * k) for k in range(11)],
              traceback_mode="full",
              start_types=[(-1, 1, 2, 3)[k % 4] for k in range(11)],
              end_types=[(-1, -2, -3, 1)[k % 4] for k in range(11)])
    got = ShardedBatchAligner(mesh=mesh(3), device="cpu",
                              parity_swap=False).align_batch(pairs, **kw)
    want = BatchAligner(device="cpu", parity_swap=False).align_batch(pairs,
                                                                     **kw)
    assert [(r.score, list(r.chain), r.end_table) for r in got] == \
        [(r.score, list(r.chain), r.end_table) for r in want]


def test_sharded_local_scores_match_jax_and_unsharded():
    pairs = rand_pairs(np.random.default_rng(94), 19, hi=150)
    s1 = LocalBatchAligner(device="cpu").score_batch(pairs)
    s2 = ShardedLocalBatchAligner(mesh=mesh(), device="cpu").score_batch(
        pairs)
    s3 = jax_shard.ShardedLocalBatchAligner(
        backend="wavefront").score_batch(pairs)
    for x, y, z in zip(s1, s2, s3):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(z, y)
    # align_batch runs unsharded, as the JAX package's does
    got = ShardedLocalBatchAligner(mesh=mesh(), device="cpu").align_batch(
        pairs[:5])
    want = LocalBatchAligner(device="cpu").align_batch(pairs[:5])
    assert [(r.score, r.cigar) for r in got] == \
        [(r.score, r.cigar) for r in want]


def test_sharded_fewer_devices_and_matrix():
    pairs = rand_pairs(np.random.default_rng(93), 6)
    sh = ShardedBatchAligner(num_devices=2, device="cpu")
    assert sh.num_devices == 2 and sh.mesh.size == 2
    s1, _ = sh.score_batch(pairs)
    s2, _ = jax_shard.ShardedBatchAligner(num_devices=2).score_batch(pairs)
    np.testing.assert_array_equal(s1, s2)
    prot = [("HEAGAWGHEE", "PAWHEAE"), ("MKVLA", "MKVLAW"), ("WW", "W")]
    got = ShardedBatchAligner(matrix=BLOSUM62, mesh=mesh(2),
                              device="cpu").score_batch(prot)
    want = BatchAligner(matrix=BLOSUM62, device="cpu").score_batch(prot)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("count,parts", [(19, 8), (8, 8), (1, 3), (5, 2)])
def test_shard_rows_pad_with_the_last_pair(count, parts):
    rows = shard_rows(count, parts)
    assert rows.shape == (parts, -(-count // parts))
    flat = rows.reshape(-1)
    assert list(flat[:count]) == list(range(count))
    assert all(x == count - 1 for x in flat[count:])


@pytest.mark.cuda
def test_sharded_on_a_repeated_card():
    """Two entries of one card: the same results as the unsharded
    aligners there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pairs = rand_pairs(np.random.default_rng(96), 19, hi=300)
    two = Mesh(["cuda:0"] * 2, ("data",))
    got = ShardedBatchAligner(mesh=two).align_batch(pairs)
    want = BatchAligner().align_batch(pairs)
    assert [result(r) for r in got] == [result(r) for r in want]
    for x, y in zip(ShardedLocalBatchAligner(mesh=two).score_batch(pairs),
                    LocalBatchAligner().score_batch(pairs)):
        np.testing.assert_array_equal(x, y)
