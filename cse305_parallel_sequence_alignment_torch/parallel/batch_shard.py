"""Many-pairs data parallelism over a mesh (the port of the JAX package's
``parallel/batch_shard.py``).

Each padded chunk of a length bucket is padded to a multiple of the
``data`` mesh's size by repeating its last pair, as the JAX package pads
for ``shard_map``, and cut into one equal shard per mesh entry. Every
entry runs the port's own route for that bucket on its device (the fused
K1 fill + K2 walk of ``BatchAligner.align_batch``, the score fill of
``score_batch``, K9s for the local scores); the shards are queued on all
devices before any is waited for, and the results are gathered in pair
order with the padding dropped. There is no communication between the
devices in this mode.

``ShardedLocalBatchAligner`` shards the local score fill only; its
``align_batch`` runs unsharded on its ``device``, as the JAX package's
does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.models.local import (
    LocalBatchAligner,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    make_data_mesh,
)


def shard_rows(count, parts):
    """(parts, per) row indices of ``parts`` equal shards of ``count``
    pairs, padded to a multiple of ``parts`` by repeating the last pair."""
    per = -(-count // parts)
    return np.minimum(np.arange(per * parts), count - 1).reshape(parts, per)


def _shards(aligner, base_cls):
    """One ``base_cls`` aligner per entry of the aligner's data mesh, with
    the aligner's settings."""
    if aligner.mesh is None:
        aligner.mesh = make_data_mesh(aligner.num_devices or None,
                                      device=aligner.device)
    aligner.num_devices = aligner.mesh.size
    fields = {f.name: getattr(aligner, f.name)
              for f in dataclasses.fields(base_cls)}
    return [base_cls(**{**fields, "device": str(d)})
            for d in aligner.mesh.devices]


def _pad_cols(arrays):
    """Row-stack 2-D arrays of different widths, padding with zeros."""
    width = max(x.shape[1] for x in arrays)
    return np.concatenate([np.pad(x, ((0, 0), (0, width - x.shape[1])))
                           for x in arrays])


@dataclasses.dataclass
class ShardedBatchAligner(BatchAligner):
    """``BatchAligner`` whose chunks (``align_batch`` and
    ``score_batch``) are sharded over the ``data`` mesh: ``mesh``, or
    ``make_data_mesh(num_devices, device=device)`` (0: every card)."""

    num_devices: int = 0
    mesh: object = None

    def __post_init__(self):
        super().__post_init__()
        self._shards = _shards(self, BatchAligner)

    def _score_chunk(self, fill, a, b, la, lb, st, en):
        rows = shard_rows(len(la), self.num_devices)
        queued = [sh._score_dispatch(fill, *(x[r] for x in (a, b, la, lb,
                                                              st, en)))
                  for sh, r in zip(self._shards, rows)]
        return tuple(np.concatenate([q[k].cpu().numpy() for q in queued])
                     [: len(la)] for k in range(2))

    def _dispatch(self, a, b, la, lb, st, en, index=0):
        return [(r, sh._dispatch(a[r], b[r], la[r], lb[r], st[r], en[r],
                                 index))
                for sh, r in zip(self._shards, shard_rows(len(la),
                                                          self.num_devices))]

    def _collect(self, handles, la, lb, mode, offsets, chunk):
        B = len(la)
        parts = [BatchAligner._collect(self, h, la[r], lb[r], mode, offsets,
                                       [chunk[i] for i in r])
                 for r, h in handles]
        chains = [c for p in parts for c in p[0]][:B]
        arrays = None
        if offsets is None:
            arrays = tuple(_pad_cols([p[1][k] for p in parts])[:B]
                           for k in range(3)) + (
                np.concatenate([p[1][3] for p in parts])[:B],)
        tables, scores = (np.concatenate([p[k] for p in parts])[:B]
                          for k in (2, 3))
        return chains, arrays, tables, scores


@dataclasses.dataclass
class ShardedLocalBatchAligner(LocalBatchAligner):
    """``LocalBatchAligner`` whose score fill (K9s) is sharded over the
    ``data`` mesh (the high-throughput filtering mode); ``align_batch``
    runs unsharded on ``device``."""

    num_devices: int = 0
    mesh: object = None

    def __post_init__(self):
        super().__post_init__()
        self._shards = _shards(self, LocalBatchAligner)

    def _score_chunk(self, arrays):
        count = len(arrays[2])
        queued = [sh._score_fill(*sh._to_dev(*(x[r] for x in arrays)),
                                 self.params)
                  for sh, r in zip(self._shards, shard_rows(
                      count, self.num_devices))]
        return np.concatenate([q.cpu().numpy() for q in queued])[:count]
