"""What a chain says, in NumPy, whatever the mode.

A chain is the program's list of (i, j, t) points in the CSE305
reference's convention: each point is one column of the alignment, the
cell (i, j) of table t (1: A[i] with B[j]; 2: a gap in A against B[j];
3: A[i] against a gap), with 0 stored for the gapped side.
"""

from __future__ import annotations

import numpy as np


def as_chain(points):
    """An (L, 3) int64 array of a chain's points."""
    return np.array(points, np.int64).reshape(-1, 3)


def render(a_text, b_text, chain):
    """The print_seq rows (A row, B row) of a chain, as bytes."""
    I, J, T = chain[:, 0], chain[:, 1], chain[:, 2]
    A = np.frombuffer(b"-" + a_text, np.uint8)
    B = np.frombuffer(b"-" + b_text, np.uint8)
    ra = np.where(T != 2, A[np.where(T != 2, I, 0)], ord("-"))
    rb = np.where(T != 3, B[np.where(T != 3, J, 0)], ord("-"))
    return ra.astype(np.uint8).tobytes(), rb.astype(np.uint8).tobytes()
