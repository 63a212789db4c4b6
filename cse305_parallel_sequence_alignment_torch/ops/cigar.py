"""CIGAR extraction from alignment chains.

Chains are lists of (i, j, t) points in the engine's convention
(core.AlignmentResult): t=1 consumes A[i] and B[j], t=2 consumes B[j] only,
t=3 consumes A[i] only. With A as the query and B as the reference this
maps to SAM operations M (t=1), I (t=3: query-only), D (t=2:
reference-only); extended form distinguishes = (match) and X (mismatch).

``chain_to_cigar``, ``chain_to_cigar_extended`` and ``cigar_consumed``
are copies of the JAX package's ``ops/cigar.py``. The local aligner
builds the same strings for a whole chunk in the native library
(native/walker.py ``local_build``); these are its test references.
"""

from __future__ import annotations

_OP = {1: "M", 2: "D", 3: "I"}


def chain_to_cigar(chain) -> str:
    """Run-length encoded SAM CIGAR (M/I/D) for a chain."""
    out = []
    run_op, run_len = None, 0
    for (_, _, t) in chain:
        op = _OP[t]
        if op == run_op:
            run_len += 1
        else:
            if run_op is not None:
                out.append(f"{run_len}{run_op}")
            run_op, run_len = op, 1
    if run_op is not None:
        out.append(f"{run_len}{run_op}")
    return "".join(out)


def chain_to_cigar_extended(a_enc, b_enc, chain) -> str:
    """Extended CIGAR (=/X/I/D), resolving matches against the sequences.

    ``a_enc``/``b_enc``: the original (0-indexed) sequences; chain indices
    are 1-based per the engine convention.
    """
    out = []
    run_op, run_len = None, 0
    for (i, j, t) in chain:
        if t == 1:
            op = "=" if a_enc[i - 1] == b_enc[j - 1] else "X"
        else:
            op = _OP[t]
        if op == run_op:
            run_len += 1
        else:
            if run_op is not None:
                out.append(f"{run_len}{run_op}")
            run_op, run_len = op, 1
    if run_op is not None:
        out.append(f"{run_len}{run_op}")
    return "".join(out)


def cigar_consumed(cigar: str):
    """(query_consumed, reference_consumed) cell counts of a CIGAR."""
    q = r = 0
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
            continue
        k = int(num)
        num = ""
        if ch in "M=X":
            q += k
            r += k
        elif ch == "I":
            q += k
        elif ch == "D":
            r += k
        else:
            raise ValueError(f"unknown CIGAR op {ch!r}")
    return q, r
