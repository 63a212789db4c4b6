"""Faults planted in the timed path of the ``partition`` entry, each of
which has to make a cell's small pass come out not correct."""

import numpy as np


def _move_crossing(monkeypatch):
    """An answer altered where it is produced: the middle crossing point
    of each bisection moved by one column."""
    from cse305_parallel_sequence_alignment_torch.parallel import partition

    orig = partition.PartitionedAligner._bisect

    def moved(self, *a, **k):
        points, end = orig(self, *a, **k)
        q = len(points) // 2
        (i, j, t), (_, j_next, _) = points[q], points[q + 1]
        points[q] = (i, j + 1 if j < j_next else j - 1, t)
        return points, end
    monkeypatch.setattr(partition.PartitionedAligner, "_bisect", moved)


def _move_column(monkeypatch):
    """A column of an alignment altered where it is produced: the first
    gap of each stitched chain moved to the other gap table."""
    from cse305_parallel_sequence_alignment_torch.parallel import partition

    orig = partition.LazyChain

    def moved(tt, ii, jj):
        tt = tt.copy()
        gaps = np.nonzero(tt != 1)[0]
        if len(gaps):
            tt[gaps[0]] = 5 - tt[gaps[0]]
        return orig(tt, ii, jj)
    monkeypatch.setattr(partition, "LazyChain", moved)


def _drop_answer(monkeypatch):
    """Every other answer left out: its call returns no alignment."""
    from cse305_parallel_sequence_alignment_torch.parallel import partition

    orig = partition.PartitionedAligner.align
    calls = []

    def dropped(self, a, b):
        calls.append(None)
        return orig(self, a, b) if len(calls) % 2 else None
    monkeypatch.setattr(partition.PartitionedAligner, "align", dropped)


FAULTS = {"move_crossing": _move_crossing, "move_column": _move_column,
          "drop_answer": _drop_answer}
# what each fault does to the answers; every entry needs both kinds
KINDS = {"altered": ("move_crossing", "move_column"),
         "left_out": ("drop_answer",)}
