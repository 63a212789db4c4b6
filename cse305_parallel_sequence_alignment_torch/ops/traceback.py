"""Host tracebacks of local, semi-global and overlap mode from packed
direction cells.

Numpy copies of ``traceback_local_from_dirs``,
``traceback_semiglobal_from_dirs`` and ``traceback_overlap_from_dirs``
in the JAX package's ``ops/traceback.py`` (the last two for the row
layout only): the sequential references that the device walks
(``ops/device_walk.py``) and the native chain builds
(``native/walker.py`` ``local_build`` and ``free_end_build``) are tested
against.
"""

from __future__ import annotations

import numpy as np

from cse305_parallel_sequence_alignment_torch.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
)

_SHIFTS = {1: DIR_T1_SHIFT, 2: DIR_T2_SHIFT, 3: DIR_T3_SHIFT}


def traceback_local_from_dirs(dirs, end_i, end_j, layout="skew"):
    """Local-mode walk: from the best T1 cell back to its local start.

    ``dirs`` is one pair's (m+n+1, n+1) skew matrix (cell (i, j) at
    ``[i + j, j]``) or, with ``layout="rect"``, its (m+1, n+1) matrix; T1
    code 3 marks a start. Returns the chain start..end with every aligned
    column; the end cell is (end_i, end_j, 1).
    """
    dirs = np.asarray(dirs)

    def cell(i, j):
        return dirs[i + j, j] if layout == "skew" else dirs[i, j]

    rev = []
    i, j, t = int(end_i), int(end_j), 1
    while True:
        rev.append((i, j, t) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        code = int((cell(i, j) >> _SHIFTS[t]) & 0x3)
        if t == 1 and code == 3:
            # a clamped (value-0) cell is never aligned; it is only
            # reached if the walk started on one
            rev.pop()
            break
        if t == 1:
            pi, pj, pt = i - 1, j - 1, code + 1
        elif t == 2:
            pi, pj, pt = i, j - 1, code + 1
        else:
            pi, pj, pt = i - 1, j, code + 1
        # the predecessor is the empty prefix when it sits on the zero
        # boundary or is a clamped T1 cell (code 3): stop before it
        if pi == 0 or pj == 0:
            break
        if pt == 1 and int((cell(pi, pj) >> _SHIFTS[1]) & 0x3) == 3:
            break
        i, j, t = pi, pj, pt
    return list(reversed(rev))


def _walk_free(dirs, end_t, end_i, end_j):
    """Walk one pair's row dirs (cell (i, j) at ``dirs[i, j]``) back from
    (end_i, end_j, end_t) until row 0 or column 0; returns the reversed
    chain and the stop position."""
    rev = []
    i, j, t = int(end_i), int(end_j), int(end_t)
    while i > 0 and j > 0:
        rev.append((i, j, t) if t == 1 else
                   ((0, j, 2) if t == 2 else (i, 0, 3)))
        code = int((dirs[i, j] >> _SHIFTS[t]) & 0x3)
        if t == 1:
            i, j = i - 1, j - 1
        elif t == 2:
            j = j - 1
        else:
            i = i - 1
        t = code + 1
    return rev, i


def traceback_semiglobal_from_dirs(dirs, end_t, end_i, end_j):
    """Semi-global walk over one pair's (m+1, n+1) row dirs: from the
    best last-row cell back to row 0 (the free B prefix, whose columns
    are not emitted); a path that reaches column 0 with i > 0 still owes
    the forced leading gap-in-B run (i, 0, 3) down to row 1, which is
    emitted. Chain start..end with every aligned column, gap points
    storing 0 for the gapped side (quirk B2), the end point included."""
    rev, i = _walk_free(np.asarray(dirs), end_t, end_i, end_j)
    while i > 0:  # forced leading gap-in-B run along column 0
        rev.append((i, 0, 3))
        i -= 1
    return list(reversed(rev))


def traceback_overlap_from_dirs(dirs, end_t, end_i, end_j):
    """Overlap-mode walk over one pair's (m+1, n+1) row dirs: from the
    best edge cell back to either zero boundary (both prefixes are free,
    so the walk stops there). Chain start..end as in the semi-global
    walk."""
    rev, _ = _walk_free(np.asarray(dirs), end_t, end_i, end_j)
    return list(reversed(rev))
