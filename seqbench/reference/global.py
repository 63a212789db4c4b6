"""Global alignment, start and end types -1 (free), the CSE305
reference's mode: the optimum's score and end table by the row sweep
(``gotoh``), and the score of the path a chain describes."""

from __future__ import annotations

import numpy as np

from reference import gotoh


def check_config(config):
    """Refuse a configuration this reference does not compute."""
    for key in ("start_type", "end_type"):
        if int(config[key]) != -1:
            raise ValueError(f"the global reference computes {key} -1 "
                             f"only, not {config[key]}")


def ends(pairs, table, g, h, dtype, device):
    """(end tables, scores) of the oriented code pairs: the free end, tie
    order T1 >= T2 >= T3."""
    fin = gotoh.finals(pairs, table, g, h, dtype=dtype, device=device)
    f1, f2, f3 = fin[:, 0], fin[:, 1], fin[:, 2]
    pick1 = (f1 >= f2) & (f1 >= f3)
    pick2 = ~pick1 & (f2 >= f3)
    tables = np.where(pick1, 1, np.where(pick2, 2, 3))
    return tables, np.where(pick1, f1, np.where(pick2, f2, f3))


def path_score(a, b, chain, table, g, h):
    """The score of the whole path a chain describes, or None if it is not
    a path of (a, b) from (0, 0) to (m, n) with the gapped side stored as
    0. The chain lists the path's columns from its first point on; where
    that point follows a cell on row 0 or column 0 other than (0, 0), the
    run along that edge from (0, 0) is implied, one gap (the reference's
    parity mode stops its walk at the first edge cell and drops it).
    ``a``, ``b``: code arrays; ``chain``: (L, 3) int array; ``table``:
    (K, K) scores."""
    m, n = len(a), len(b)
    if chain.ndim != 2 or chain.shape[0] == 0 or chain.shape[1] != 3:
        return None
    I, J, T = chain[:, 0], chain[:, 1], chain[:, 2]
    if not np.isin(T, (1, 2, 3)).all():
        return None
    sa = (T != 2).astype(np.int64)  # the column consumes A[i]
    sb = (T != 3).astype(np.int64)  # the column consumes B[j]
    ci = m - (np.cumsum(sa[::-1])[::-1] - sa)
    cj = n - (np.cumsum(sb[::-1])[::-1] - sb)
    if not (np.where(sa == 1, I == ci, I == 0).all()
            and np.where(sb == 1, J == cj, J == 0).all()):
        return None
    pi, pj = int(ci[0] - sa[0]), int(cj[0] - sb[0])
    if pi != 0 and pj != 0:
        return None
    edge_type, edge_len = (2, pj) if pj > 0 else (3, pi) if pi > 0 else (1, 0)
    diag = T == 1
    s = float(np.asarray(table, np.float64)[a[ci[diag] - 1],
                                            b[cj[diag] - 1]].sum())
    prev = np.concatenate([[edge_type], T[:-1]])
    opens = int(((T != 1) & (T != prev)).sum()) + (1 if edge_len else 0)
    gaps = int((~diag).sum()) + edge_len
    return s - g * gaps - h * opens
