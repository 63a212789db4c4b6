"""Faults planted in the timed path of the ``align_batch`` entry, each of
which has to make a cell's small pass come out not correct."""

import numpy as np


def _alter_score(monkeypatch):
    """An answer altered where it is produced: one score off by one."""
    from cse305_parallel_sequence_alignment_torch.models import batch

    orig = batch.BatchAligner._collect

    def off(self, *a):
        chains, arrays, tables, scores = orig(self, *a)
        scores = scores.copy()
        scores[0] += 1.0
        return chains, arrays, tables, scores
    monkeypatch.setattr(batch.BatchAligner, "_collect", off)


def _drop_half(monkeypatch):
    """Half of the batch left out: the second half of each call's answers
    never comes."""
    from cse305_parallel_sequence_alignment_torch.models import batch

    orig = batch.BatchAligner.align_batch

    def half(self, pairs, *a, **k):
        out = orig(self, pairs, *a, **k)
        return out[: len(out) // 2] + [None] * (len(out) - len(out) // 2)
    monkeypatch.setattr(batch.BatchAligner, "align_batch", half)


def _alter_column(monkeypatch):
    """A column of an alignment altered where it is produced: the host
    replay's first step moved to the other gap table."""
    from cse305_parallel_sequence_alignment_torch.native import walker

    orig = walker.replay_rle

    def moved(*a, **k):
        tt, ii, jj, lens = orig(*a, **k)
        tt = tt.copy()
        tt[:, 0] = np.where(tt[:, 0] == 2, 3, 2)
        return tt, ii, jj, lens
    monkeypatch.setattr(walker, "replay_rle", moved)


def _alter_row(monkeypatch):
    """A rendered row altered where it is produced."""
    from cse305_parallel_sequence_alignment_torch.native import walker

    def flip(rows):
        a, b = rows
        return ("-" if a[:1] != "-" else "A") + a[1:], b

    orig = walker.render
    monkeypatch.setattr(walker, "render", lambda *a: flip(orig(*a)))


FAULTS = {"alter_score": _alter_score, "drop_half": _drop_half,
          "alter_column": _alter_column, "alter_row": _alter_row}
# what each fault does to the answers; every entry needs both kinds
KINDS = {"altered": ("alter_score", "alter_column", "alter_row"),
         "left_out": ("drop_half",)}
