"""Host traceback of local mode from packed direction bytes.

A numpy copy of ``traceback_local_from_dirs`` in the JAX package's
``ops/traceback.py``: the sequential reference that the local walk (K9w,
``ops/device_walk.py``) and the native chain build
(``native/walker.py`` ``local_build``) are tested against.
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
