"""Two-carry row-sweep score fill: K3'' and P-dual, its two-pair form.

K3'' ``rowscan2_score_fill`` is the port of the TPU kernel
``_rowscan2_kernel`` (cse305_parallel_sequence_alignment_tpu/ops/
pallas_fill.py:896, through ``_pallas_rowscan2`` :1010), and
``rowscan2_score_batch`` of its entry ``pallas_rowscan2_score_batch``
(:1040). It computes the global Gotoh finals of K3' (ops/rowcb.py) with
the row carry (H, T3), H = max(T1, T2, T3), in place of three tables:

- ``T1 = f(A[i], B[j]) + H(i-1, j-1)``
- ``T3 = max(H(i-1, j) - gh, T3(i-1, j) - g)``
- ``T2 = prefixmax(omega) - g*j``, ``omega = (g*j - gh) + max(T1, T3)(j-1)``
- ``H = max(max(T1, T3), T2)``

with ``gh = g + h`` rounded to float32: what XLA runs for the JAX kernel
(both of its ``x - g - h`` folded), so omega takes the free modes' order
of K1', and at non-dyadic g, h some finals differ from K3' ones. Column 0's
T1 and T2 are -inf through the -inf shift fill, as in the JAX kernel.
Per-pair start types ``st`` set row 0 and column 0 (the JAX kernel takes
one start type a call); the finals (B, 3) float32 are (T1, T2, T3) at
(la, lb). The JAX kernel's uniform-la branch (every la = m) gives the
same finals as its ragged one, and so does this fill, which captures row
la in both cases.

P-dual ``dual_rowscan2_fill`` is the port of ``dual_kernel`` of the TPU
probe scripts/probes/dual_halostair_r4.py:68 (through ``dual`` :136):
K3'' with start type -1 and every la = m, two independent pairs carried
by one CTA so that their dependent row chains interleave. Its finals are
those of K3'', in input pair order, for any B.

The kernel is ``csrc/rowscan2.cu``: each thread keeps C columns of (H,
T3) in registers (``columns``, 4, 8, 16 or 32; the narrowest that covers
the row in 512 threads, or 1,024 at 4, by default). A row of n + 1
columns must fit in 32 columns of 512 threads. A CPU tensor goes to the
plain PyTorch version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.rowcb import _shift

COLUMNS = (4, 8, 16, 32)  # columns per thread csrc/rowscan2.cu is built for


def rowscan2_score_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K3'': the (H, T3) row loop in the kernel's float32
    order; finals (B, 3) at (la, lb)."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    j = torch.arange(n + 1, device=dev)
    jg = g * j.to(f32)
    jgc = jg - gh
    lane0 = (j == 0)[None, :]
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    stc = st.to(torch.int32)[:, None]
    lbi = lb.to(torch.int64)[:, None]

    # row 0 (quirk: start +2 acts as -1 on row 0)
    row0_t2 = torch.where(stc == -2, -jg,
                          torch.where((stc == 1) | (stc == 3), neg, -h - jg))
    r1 = torch.where(lane0 & ((stc == 1) | (stc == -1)), zero, neg)
    r2 = torch.where(lane0, torch.where(stc == -2, zero, neg), row0_t2)
    r3 = torch.where(lane0 & (stc == -3), zero, neg)
    hp = torch.maximum(torch.maximum(r1, r2), r3)
    t3p = r3

    def at_lb(*rows):
        return torch.cat([t.gather(1, lbi) for t in rows], dim=1)

    fin = torch.where((la == 0)[:, None], at_lb(r1, r2, r3), neg)
    for i in range(1, m + 1):
        fi = torch.tensor(float(i), dtype=f32, device=dev)
        # column 0 of T3 (quirk: start +3 acts as -1 on column 0)
        col0 = torch.where(stc == -3, -g * fi,
                           torch.where((stc == 1) | (stc == 2), neg,
                                       -h - g * fi))
        fb = torch.where(bext == a[:, i - 1:i].to(torch.int32), match,
                         mismatch)
        t1 = fb + _shift(hp, NEG_INF)
        t3 = torch.where(lane0, col0, torch.maximum(hp - gh, t3p - g))
        m13 = torch.maximum(t1, t3)
        t2 = torch.cummax(jgc + _shift(m13, NEG_INF), dim=1).values - jg
        fin = torch.where((la == i)[:, None], at_lb(t1, t2, t3), fin)
        hp, t3p = torch.maximum(m13, t2), t3
    return fin


def dual_rowscan2_fill_plain(a, b, lb, params):
    """Plain PyTorch P-dual: the plain K3'' loop with start type -1 and
    every la = m; finals (B, 3) in input order."""
    B, m = a.shape
    la = torch.full((B,), m, dtype=torch.int32, device=a.device)
    st = torch.full((B,), -1, dtype=torch.int32, device=a.device)
    return rowscan2_score_fill_plain(a, b, la, lb, st, params)


def geometry(n, columns=None):
    """(columns a thread, threads a CTA) of csrc/rowscan2.cu for a row of
    n + 1 columns: ``columns`` if given, else the narrowest chunk whose
    threads fit; threads cover the row in whole warps."""
    ncol = n + 1
    if columns is None:
        columns = next((c for c in COLUMNS
                        if -(-ncol // c) <= (1024 if c <= 4 else 512)),
                       None)
        if columns is None:
            raise ValueError(f"a row of {ncol} columns: K3'' keeps a row "
                             f"in registers, at most {32 * 512}")
    if columns not in COLUMNS:
        raise ValueError(f"columns {columns}: pick from {COLUMNS}")
    threads = -(-ncol // (32 * columns)) * 32
    if threads > (1024 if columns <= 4 else 512):
        raise ValueError(f"a row of {ncol} columns needs {threads} threads "
                         f"of {columns} columns, over the kernel's limit")
    return columns, threads


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/rowscan2.cu: 6 pointers, then B, m, n,
    columns, threads, pairs a CTA, g, h, match, mismatch, stream."""
    fn = _build.cuda_library("rowscan2").rowscan2_fill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def _launch(a, b, la, lb, st, params, pairs, columns):
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    C, threads = geometry(n, columns)
    out = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=dev)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry()(a.data_ptr(), b.data_ptr(), la.data_ptr(),
                       lb.data_ptr(), st.data_ptr(), out.data_ptr(), B, m,
                       n, C, threads, pairs, g, h, match, mismatch,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"rowscan2_fill({pairs} pair(s) a CTA, {C} columns "
                      f"a thread)")
    return out


def rowscan2_score_fill(a, b, la, lb, st, params, columns=None):
    """K3'': finals (B, 3) of a bucket by the two-carry row sweep; see the
    module docstring. ``columns``: columns a thread (card only)."""
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return rowscan2_score_fill_plain(a, b, la, lb, st, params)
    out = _launch(a, b, la, lb, st, params, 1, columns)
    rowscan2_score_fill.launches += 1
    return out


def dual_rowscan2_fill(a, b, lb, params, columns=None):
    """P-dual: finals (B, 3) of K3'' with start type -1 and every la = m
    (the width of ``a``), two pairs a CTA; in input pair order."""
    B, m = a.shape
    la = torch.full((B,), m, dtype=torch.int32, device=a.device)
    st = torch.full((B,), -1, dtype=torch.int32, device=a.device)
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return dual_rowscan2_fill_plain(a, b, lb, params)
    out = _launch(a, b, la, lb, st, params, 2, columns)
    dual_rowscan2_fill.launches += 1
    return out


rowscan2_score_fill.launches = 0
dual_rowscan2_fill.launches = 0


def rowscan2_score_batch(a_enc, b_enc, len_a, len_b, g=1.0, h=2.0,
                         match=1.0, mismatch=0.0, start_type=-1,
                         device="cuda"):
    """Counterpart of ``pallas_rowscan2_score_batch``: a bucket of uint8
    codes (B, m) and (B, n) with lengths, one start type; returns the
    finals as a numpy (B, 3) float32 array."""
    dev = _build.resolve_device(device, "rowscan2_score_batch")
    a = torch.from_numpy(np.ascontiguousarray(a_enc, np.uint8)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(b_enc, np.uint8)).to(dev)
    la = torch.from_numpy(np.ascontiguousarray(len_a, np.int32)).to(dev)
    lb = torch.from_numpy(np.ascontiguousarray(len_b, np.int32)).to(dev)
    st = torch.full_like(la, int(start_type))
    out = rowscan2_score_fill(a, b, la, lb, st,
                              ScoringParams(g, h, match, mismatch))
    return out.cpu().numpy()
