"""What an entry is: the program's timed call for a list of pairs, built
once in set-up from the configuration (``entries/<entry>.py``).

An entry module holds ``LIMITS``, the numbers the check compares for it
with their limits, and ``Entry``, a subclass of ``Base``. It imports the
program (the PyTorch and CUDA package) only when the entry is built.
"""

from __future__ import annotations

import collections
import typing


class Answer(typing.NamedTuple):
    """One pair's answer as the check reads it; ``chain`` and ``rows``
    are None where the entry returns no alignment."""

    score: float
    table: int
    chain: typing.Any = None  # (i, j, t) points
    rows: typing.Any = None  # (A row, B row), bytes


class Base:
    """``self(pairs)`` returns one call's outputs; ``spans`` sums the
    program's phase times over the calls since the last
    ``spans.clear()``."""

    def __init__(self, config, device):
        self.config = config
        self.device = device
        self.spans = collections.Counter()

    @staticmethod
    def answered(outputs):
        """How many answers a call's outputs hold (read in the window)."""
        return sum(r is not None for r in outputs)

    @staticmethod
    def answer(outputs, k):
        """The ``Answer`` to pair k of a call, or None if it never came;
        read by the check once the entry is freed."""
        raise NotImplementedError


def scoring(config):
    """The program's (ScoringParams, SubstitutionMatrix or None) for a
    configuration; the benchmark hands the same numbers to the
    reference."""
    from cse305_parallel_sequence_alignment_torch.core import (
        ScoringParams,
        SubstitutionMatrix,
    )
    params = ScoringParams(g=float(config["gap_extend"]),
                           h=float(config["gap_open"]),
                           match=float(config.get("match", 1.0)),
                           mismatch=float(config.get("mismatch", 0.0)))
    matrix = None
    if "matrix" in config:
        matrix = SubstitutionMatrix.from_array(config["alphabet"],
                                               config["matrix"])
    return params, matrix
