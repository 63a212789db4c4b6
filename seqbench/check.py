"""The comparison that decides ``correct``.

Every answer of the window's first pass is judged against the plain
reference of the configuration's mode (``reference/<mode>.py``) by what
it says: its score against the reference's optimum, its end table
against the reference's end choice, its chain as a path of the pair
whose own score is that optimum and which ends in that table, and its
rows against the rows that chain renders. The entry's ``LIMITS`` name
the numbers compared and their limits; each counts answers. An answer
the program did not return counts as missing.
"""

from __future__ import annotations

import numpy as np
import torch

import manifest
from reference import alignment

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Scoring:
    """The configuration's alphabet codes, score table, gap costs and
    mode, as the reference reads them. A configuration the mode's
    reference does not compute is refused."""

    def __init__(self, config):
        try:
            self.mode = manifest.module("reference", config["mode"])
        except LookupError:
            raise ValueError(f"no plain reference for mode "
                             f"{config['mode']!r}") from None
        self.mode.check_config(config)
        alphabet = config["alphabet"].encode("ascii")
        k = len(alphabet)
        if "matrix" in config:
            self.table = np.asarray(config["matrix"], np.float64)
        else:
            self.table = np.where(np.eye(k, dtype=bool),
                                  float(config.get("match", 1.0)),
                                  float(config.get("mismatch", 0.0)))
        self.lut = np.full(256, -1, np.int64)
        self.lut[np.frombuffer(alphabet, np.uint8)] = np.arange(k)
        self.g = float(config["gap_extend"])
        self.h = float(config["gap_open"])
        self.swap = bool(config["parity_swap"])
        self.dtype = DTYPES[config["precision"]]

    def codes(self, text):
        c = self.lut[np.frombuffer(text, np.uint8)]
        if (c < 0).any():
            raise ValueError("a residue outside the configuration's alphabet")
        return c

    def orient(self, a, b):
        a, b = a.encode("ascii"), b.encode("ascii")
        return (b, a) if self.swap and len(a) > len(b) else (a, b)

    def ends(self, texts, device, dtype=None):
        """(end tables, scores) of the oriented pairs ``texts`` by the
        plain reference, in ``dtype`` (the configuration's precision by
        default)."""
        return self.mode.ends([(self.codes(a), self.codes(b))
                               for a, b in texts], self.table, self.g,
                              self.h, dtype or self.dtype, device)


def _texts(sc, passage):
    return [sc.orient(a, b) for call in passage.calls for a, b in call]


def judge(entry, limits, config, passage, outputs, device):
    """The compared numbers of a pass's ``outputs`` (one per call), and
    the count of answers checked. ``entry`` reads an answer from the
    outputs; ``limits`` names the numbers."""
    sc = Scoring(config)
    texts = _texts(sc, passage)
    ref_table, ref_score = sc.ends(texts, device)
    n = dict.fromkeys(limits, 0)
    q = -1
    for c, call in enumerate(passage.calls):
        for k in range(len(call)):
            q += 1
            got = entry.answer(outputs[c], k) if c < len(outputs) else None
            if got is None:
                n["missing"] += 1
                continue
            if "scores_wrong" in n:
                n["scores_wrong"] += got.score != ref_score[q]
            if "tables_wrong" in n:
                n["tables_wrong"] += got.table != ref_table[q]
            if got.chain is None:
                continue
            a, b = texts[q]
            chain = alignment.as_chain(got.chain)
            ps = sc.mode.path_score(sc.codes(a), sc.codes(b), chain,
                                    sc.table, sc.g, sc.h)
            if "chains_wrong" in n:
                n["chains_wrong"] += (ps is None or ps != ref_score[q]
                                      or chain[-1, 2] != got.table)
            if "rows_wrong" in n:
                n["rows_wrong"] += (chain.shape[0] == 0 or
                                    alignment.render(a, b, chain) != got.rows)
    return {k: int(v) for k, v in n.items()}, q + 1


def judge_control(limits, config, passage, device, dtype):
    """The compared numbers of the control: the reference in ``dtype``
    put in the program's place. It answers scores and end tables, so the
    score and table numbers judge it."""
    sc = Scoring(config)
    texts = _texts(sc, passage)
    ref_table, ref_score = sc.ends(texts, device)
    low_table, low_score = sc.ends(texts, device, DTYPES[dtype])
    n = {"scores_wrong": int((low_score != ref_score).sum())}
    if "tables_wrong" in limits:
        n["tables_wrong"] = int((low_table != ref_table).sum())
    return n
