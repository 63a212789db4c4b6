"""Gotoh row-sweep fills: K1 (global), K4d and K4s (global under a
substitution matrix), K3' (global score), P-trim (K3' at uniform la), K1'
(global uint8 dirs), K10d (semi-global), K11d (overlap), and the
re-export of K3.

K1 ``rowcb_fill`` is the port of the TPU kernel ``_rowcb_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_rowcb.py:126) with
``want_dirs=True, with_runs=True, k1=0``; K10d ``semiglobal_dirs`` of
``_sg_rowdirs_kernel`` (ops/pallas_semiglobal.py:195) and K11d
``overlap_dirs`` of ``_ov_rowdirs_kernel`` (ops/pallas_overlap.py:54),
both with ``with_runs=True, perm=False``. K4d is ``rowcb_fill`` given a
``table``: the ``k1 > 0`` branch of ``_rowcb_kernel`` (pallas_rowcb.py:244,
f(A[i], B[j]) = table[A[i], B[j]]), and K4s ``submat_score_fill`` the
score-only ``_submat_kernel`` (ops/pallas_fill.py:1110) with the same
arithmetic, so its finals equal K4d's. All of them compute one row
sweep:

- ``T1 = f(A[i], B[j]) + max3(prev row, j-1)``
- ``T3 = max(max(T1,T2)(prev, j) - gh, T3(prev, j) - g)``
- ``T2 = prefixmax(omega) - g*j`` with ``omega = (g*j + max(T1,T3)(j-1))
  - gh`` in global mode and ``omega = (g*j - gh) + max(T1,T3)(j-1)`` in
  the two free modes (reference P2)

where ``gh = g + h`` is rounded to float32: the JAX source writes
``x - g - h`` and XLA folds the two constants into one subtraction.

Global mode takes per-pair start types ``st`` for row 0 and column 0 and
returns the finals (B, 3) float32 (T1, T2, T3) at (la, lb). Semi-global
mode has T1 = 0 on row 0 and T3 = -h - g*i on column 0 and returns the
best over the last query row (value desc, column asc, table T1 > T2 >
T3) as (B, 4) float32 [score, end_table, end_i = la, end_j]. Overlap mode
has T1 = 0 on row 0 and column 0 and returns the best over row la
(columns 1..lb) and column lb (rows 1..la, when lb >= 1), value desc,
then anti-diagonal asc, then table, then column, as (B, 4) [score,
end_table, end_i, end_j], or (-inf, 1, 0, 0) when no cell qualifies.

Inputs are a bucket: ``a`` (B, m) and ``b`` (B, n) uint8 codes padded
with ``PAD_A``/``PAD_B`` (under a table: alphabet codes padded with the
matrix's pad code k1 - 1, the table being (k1, k1) float32 with k1 <=
255, as ``core.SubstitutionMatrix.table()`` gives it) and lengths
``la``/``lb``, each (B,) int32.
Every cell of the bucket is computed, padding included. ``dirs`` is
(m+1, B, n+1) uint16, cell (i, j) of pair b at ``dirs[i, b, j]``,
packing [d1 | d2 << 2 | d3 << 4 | after-run code << 6 | run length << 8]
(the JAX ``with_runs`` encoding) in every mode.

The kernels. K1 and K4d on a card run ``csrc/rowfill.cu``, their
redesign for the H100: each thread's C columns of the rows in registers,
one vector store of a thread's words a row into dirs with a row pitch
of ``round_up(n + 1, 8)`` columns (``rowcb_fill`` returns the view of
the first n + 1, so its dirs are not contiguous; K2 reads the pitch from
the strides), and a thread-block cluster of k <= 8 CTAs for each pair
wider than 4,096 columns (the card's SMs shared out over the pairs).
``fill_geometry`` picks (C, threads, k) from the bucket's shape;
``fill_wave`` (a floor) and ``card_wave`` (CUDA's count) give the pairs
one launch of a geometry runs at once, and ``wave_step`` cuts a bucket's
chunks to them (``models/batch.py``). One width rule: rows of more than
``CLUSTER_REACH`` columns (8 CTAs' reach) run ``csrc/rowcb.cu``'s sweep
with its row buffers in global scratch, counted in
``rowcb_fill.wide_launches``, and get contiguous dirs. Every
other fill here is ``csrc/rowcb.cu``'s one CUDA template with a mode
parameter and three flags: a table, what it stores a cell, and the omega
order.

K3' ``rowscan_score_fill`` is the port of ``_rowscan_kernel``
(ops/pallas_fill.py:750): K1's sweep storing nothing, per-pair start
types, finals equal to K1's bit for bit. K1' ``rowdirs_fill`` is the port
of ``_rowdirs_kernel`` (ops/pallas_fill.py:508): the global sweep with
omega in the free modes' order (``jgc = g*j - g - h`` first, as that
kernel computes it), storing the uint8 codes ``d1 | d2 << 2 | d3 << 4``
in a (m+1, B, n+1) tensor, or with ``with_runs`` the uint16 dirs16+runs
word; at non-dyadic g, h its cells are not K1's.

P-trim ``trim_rowscan_fill`` is the port of ``_trim_kernel`` of the TPU
probe scripts/kern_rowscan2.py:42 (through ``trim_rowscan`` :96): K3' with
start type -1 and every la = m (the width of ``a``), lb per pair, the
finals read after row m instead of captured row by row, and omega in the
free modes' order (what XLA runs for the probe's ``jgc = g*j - g - h``).
Its finals equal those of K3'' (ops/rowscan2.py) and, at integral g, h,
those of K3' too.

K3 ``score_fill`` (global finals only) is the anti-diagonal kernel of
``ops/diag.py``, re-exported here under its old name.

A CPU tensor goes to the plain PyTorch version beside each kernel; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    NEG_INF,
    PAD_B,
)
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.diag import (  # noqa: F401
    _argmax3,
    score_fill,
    score_fill_plain,
)
from cse305_parallel_sequence_alignment_torch.utils import observability

RUN_CAP = 255
_BIG = 1 << 30  # above any column or anti-diagonal index
# dynamic shared memory above which the row buffers go to global scratch
SMEM_LIMIT = 200 * 1024

# csrc/rowfill.cu's geometry: columns a thread, and for each C the
# threads a CTA takes and the registers a thread its __launch_bounds__
# leave (65,536 / (threads x the CTAs an SM they promise)); the portable
# cluster size, and what one CTA and a cluster hold
FILL_C = (4, 8, 16)
FILL_THREADS = {4: 1024, 8: 512, 16: 512}
FILL_REGS = {4: 64, 8: 64, 16: 128}
MAX_CLUSTER = 8
CTA_REACH = FILL_THREADS[16] * 16
CLUSTER_REACH = MAX_CLUSTER * CTA_REACH
# an H100 SXM: SMs, and the shared memory an SM and a CTA (static arrays
# and the 1 KB the runtime reserves) take
SMS = 132
SM_SMEM = 228 * 1024
FILL_STATIC_SMEM = 1024 + 1024 + 256 + 8192 + 1024
DIRS_PITCH = 8  # dirs row pitch quantum: 16-byte aligned rows


def dirs_pitch(n):
    """The row pitch (columns) of K1's dirs for a bucket of width n."""
    return -(-(n + 1) // DIRS_PITCH) * DIRS_PITCH


def fill_geometry(B, n, k1=0, sms=SMS):
    """(C, threads, k) of ``csrc/rowfill.cu`` for B pairs of width n under
    a (k1, k1) table (k1 = 0: none), or None past ``CLUSTER_REACH``
    columns (the width rule: ``csrc/rowcb.cu``'s sweep takes those).

    Rows that a CTA at C = 4 or 8 covers (up to 4,096 columns) take one
    CTA a pair and the smallest C whose grid needs the fewest waves over
    ``sms`` SMs, the CTAs an SM counted at the register cap of the
    instance's launch bounds (``FILL_REGS``), the 64 warps and 32 CTAs an
    SM and the shared memory: a floor of what the card holds. Wider rows
    take C = 16 and a cluster of k CTAs a pair, k the card's SMs shared
    out over the pairs, at least the fewest CTAs that hold the row and at
    most ``MAX_CLUSTER``; each CTA takes the fewest whole warps that
    cover its share. Pure: no card is asked."""
    ncol = n + 1
    if ncol > CLUSTER_REACH:
        return None
    if shares_sms(n):
        k = min(MAX_CLUSTER, max(-(-ncol // CTA_REACH), sms // max(B, 1)))
        return 16, 32 * -(-ncol // (32 * 16 * k)), k
    best = None
    for C in FILL_C:
        threads = 32 * -(-ncol // (32 * C))
        if threads > FILL_THREADS[C]:
            continue
        waves = -(-B // (sms * _ctas_per_sm(C, threads, k1)))
        if best is None or waves < best[0]:
            best = (waves, C, threads)
    return best[1], best[2], 1


def _ctas_per_sm(C, threads, k1):
    """The floor of the CTAs of C columns a thread that an SM holds: its
    register cap (``FILL_REGS``), 64 warps, 32 CTAs and shared memory."""
    return max(1, min(32, 64 // (threads // 32),
                      65536 // (threads * FILL_REGS[C]),
                      SM_SMEM // (FILL_STATIC_SMEM + k1 * k1 * 4)))


def shares_sms(n):
    """Whether ``fill_geometry`` shares the card's SMs out over the pairs
    of a bucket of width n: rows of more than 4,096 columns (n + 1) and
    at most ``CLUSTER_REACH``, C = 16 and k CTAs a pair."""
    return FILL_THREADS[8] * 8 < n + 1 <= CLUSTER_REACH


def fill_wave(geometry, k1=0):
    """The pairs one wave of ``csrc/rowfill.cu`` runs at ``geometry`` (C,
    threads, k) under a (k1, k1) table or none: the clusters of k CTAs
    that ``SMS`` SMs hold at ``fill_geometry``'s floor of CTAs an SM.
    Pure: no card is asked (``card_wave`` asks one)."""
    C, threads, k = geometry
    return SMS * _ctas_per_sm(C, threads, k1) // k


@functools.lru_cache(maxsize=None)
def card_wave(geometry, k1, device):
    """``fill_wave`` as CUDA counts it on ``device``: the clusters of k
    that the card co-schedules (``cudaOccupancyMaxActiveClusters``), or
    at k = 1 its resident CTAs an SM times its SMs. One query a geometry."""
    C, threads, k = geometry
    per_sm, clusters = fill_occupancy(C, threads, k, k1, device)
    return clusters if k > 1 else per_sm * _card_sms(device)


def wave_step(count, n, step, wave):
    """Pairs per chunk of a bucket of ``count`` pairs of width n that the
    other limits cut into chunks of at most ``step``: the largest equal
    cut whose chunks fit one wave, ``wave(geometry)`` pairs at the
    geometry ``fill_geometry`` picks for the chunk, so that no launch runs
    a second wave. Pure where ``wave`` is."""
    nchunks = -(-count // step)
    while True:
        B = -(-count // nchunks)
        if B <= 1 or B <= wave(fill_geometry(B, n)):
            return B
        nchunks += 1


def _shift(x, fill):
    """Shift columns right by one (column j gets j-1), ``fill`` at 0."""
    col = torch.full_like(x[:, :1], fill)
    return torch.cat([col, x[:, :-1]], dim=1)


def _sweep_plain(a, b, la, lb, st, params, want_dirs, want_row=False,
                 mode="global", table=None, runs=True, free=False):
    """Row loop over (B, n+1) tensors in the kernel's float32 order.

    Returns (dirs or None, out). In global mode ``out`` is the finals
    (B, 3) at (la, lb), or with ``want_row`` the whole row la of each
    pair, (B, 3, n+1); in semi-global and overlap mode it is the best
    (B, 4) [score, end_table, end_i, end_j] (see the module docstring).
    With a ``table`` (global mode) f(A[i], B[j]) is read from it. Without
    ``runs`` the dirs are the uint8 codes alone; ``free`` takes omega in
    the free modes' order in global mode too (K1')."""
    code = _build.MODES[mode]
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h  # float32, as XLA folds the JAX kernels' x - g - h
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    j = torch.arange(n + 1, device=dev)
    jg = g * j.to(f32)
    jgc = jg - gh  # the free modes' omega offset, folded as XLA folds it
    lane0 = (j == 0)[None, :]
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    if table is not None:
        # column 0's sentinel never scores: T1 is -inf there
        bcol = bext.clamp(max=table.shape[0] - 1).to(torch.int64)
    stc = st.to(torch.int32)[:, None]
    lbi = lb.to(torch.int64)[:, None]

    if code == 0:
        # row 0 (quirk: start +2 acts as -1 on row 0)
        row0_t2 = torch.where(stc == -2, -jg,
                              torch.where((stc == 1) | (stc == 3), neg,
                                          -h - jg))
        p1 = torch.where(lane0 & ((stc == 1) | (stc == -1)), zero, neg)
        p2 = torch.where(lane0, torch.where(stc == -2, zero, neg), row0_t2)
        p3 = torch.where(lane0 & (stc == -3), zero, neg)
    else:  # T1 row 0 is free
        p1 = torch.zeros((B, n + 1), dtype=f32, device=dev)
        p2 = p3 = torch.full((B, n + 1), NEG_INF, dtype=f32, device=dev)
    row_out = want_row or code > 0
    fin = torch.full((B, 3, n + 1) if row_out else (B, 3), NEG_INF,
                     dtype=f32, device=dev)
    if code == 2:  # last-column candidates: value and row, per table
        colv = torch.full((B, 3), NEG_INF, dtype=f32, device=dev)
        coli = torch.zeros((B, 3), dtype=torch.int64, device=dev)
        col_live = lb >= 1

    def capture(fin, i, t1, t2, t3):
        if row_out:
            return torch.where((la == i)[:, None, None],
                               torch.stack([t1, t2, t3], dim=1), fin)
        vals = torch.cat([t.gather(1, lbi) for t in (t1, t2, t3)], dim=1)
        return torch.where((la == i)[:, None], vals, fin)

    fin = capture(fin, 0, p1, p2, p3)
    dirs = None
    if want_dirs:
        # int16 holds the uint16 bits: few PyTorch kernels take uint16
        dirs = torch.empty((m + 1, B, n + 1),
                           dtype=torch.int16 if runs else torch.uint8,
                           device=dev)
        dirs[0] = 0
        word = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        fi = torch.tensor(float(i), dtype=f32, device=dev)
        if code == 0:
            # column 0 of T3 (quirk: start +3 acts as -1 on column 0)
            col0_3 = torch.where(stc == -3, -g * fi,
                                 torch.where((stc == 1) | (stc == 2), neg,
                                             -h - g * fi))
        else:
            col0_3 = -h - g * fi if code == 1 else neg
        mp12 = torch.maximum(p1, p2)
        mp3 = torch.maximum(mp12, p3)
        if table is not None:
            fb = table[a[:, i - 1:i].to(torch.int64), bcol]
        else:
            fb = torch.where(bext == a[:, i - 1:i].to(torch.int32), match,
                             mismatch)
        t1 = torch.where(lane0, zero if code == 2 else neg,
                         fb + _shift(mp3, NEG_INF))
        t3 = torch.where(lane0, col0_3, torch.maximum(mp12 - gh, p3 - g))
        m13s = _shift(torch.maximum(t1, t3), NEG_INF)
        if code == 0 and not free:
            omega = (jg + m13s) - gh
        else:
            omega = jgc + m13s
        omega = torch.where(lane0, neg, omega)
        t2 = torch.where(lane0, neg, torch.cummax(omega, dim=1).values - jg)
        if want_dirs:
            d1 = _shift(_argmax3(p1, p2, p3), 0)
            d3 = _argmax3(p1, p2, p3 + h)
            d2 = _shift(_argmax3(t1 - h, t2, t3 - h), 0)
            codes = ((d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                     | (d3 << DIR_T3_SHIFT))
        if want_dirs and not runs:
            dirs[i] = codes.to(torch.uint8)
        elif want_dirs:
            r_prev = _shift(word >> 8, 0)
            ca_prev = _shift((word >> 6) & 3, 0)
            is_run = d1 == 0
            r_cur = torch.where(is_run,
                                torch.clamp(r_prev + 1, max=RUN_CAP), 0)
            ca_cur = torch.where(
                is_run, torch.where(r_prev >= RUN_CAP, 0, ca_prev), d1)
            word = codes | (ca_cur << 6) | (r_cur << 8)
            dirs[i] = word.to(torch.int16)
        fin = capture(fin, i, t1, t2, t3)
        if code == 2:
            # strictly better keeps the earliest row, per table
            val = torch.cat([t.gather(1, lbi) for t in (t1, t2, t3)], dim=1)
            better = (val > colv) & ((la >= i) & col_live)[:, None]
            colv = torch.where(better, val, colv)
            coli = torch.where(better, i, coli)
        p1, p2, p3 = t1, t2, t3
    if want_dirs and runs:
        dirs = dirs.view(torch.uint16)
    if code == 0:
        return dirs, fin
    # the best over row la, columns 1..lb: value desc, column asc, table
    live = (j[None, :] >= 1) & (j[None, :] <= lbi)
    rv = torch.where(live[:, None, :], fin, neg)
    v = rv.max(dim=2).values                       # (B, 3) per table
    jx = j[None, None, :].expand(B, 3, -1)
    jmin = torch.where(rv == v[:, :, None], jx, _BIG).min(dim=2).values
    tabs = torch.arange(1, 4, device=dev)[None, :].expand(B, -1)
    laf = la.to(torch.int64)[:, None]
    if code == 1:
        cv = v.max(dim=1).values
        cjs = torch.where(v == cv[:, None], jmin, _BIG)
        cj = cjs.min(dim=1).values
        ct = torch.where(cjs[:, 0] == cj, 1, torch.where(cjs[:, 1] == cj, 2,
                                                           3))
        return dirs, torch.stack([cv, ct.to(f32), la.to(f32), cj.to(f32)],
                                 dim=1)
    # overlap: six candidates, value desc, anti-diagonal asc, table asc,
    # column asc; (-inf, 1, 0, 0) when none is finite
    cand_v = torch.cat([v, colv], dim=1)
    cand_d = torch.cat([laf + jmin, coli + lbi], dim=1)
    cand_t = torch.cat([tabs, tabs], dim=1)
    cand_j = torch.cat([jmin, lbi.expand(B, 3)], dim=1)
    vmax = cand_v.max(dim=1).values
    mask = (cand_v == vmax[:, None]) & (cand_v > NEG_INF)
    dmin = torch.where(mask, cand_d, _BIG).min(dim=1).values
    mask = mask & (cand_d == dmin[:, None])
    tmin = torch.where(mask, cand_t, _BIG).min(dim=1).values
    mask = mask & (cand_t == tmin[:, None])
    jmn = torch.where(mask, cand_j, _BIG).min(dim=1).values
    dead = vmax <= NEG_INF
    out = torch.stack([vmax, torch.where(dead, 1, tmin).to(f32),
                       torch.where(dead, 0, dmin - jmn).to(f32),
                       torch.where(dead, 0, jmn).to(f32)], dim=1)
    return dirs, out


def rowcb_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K1: (dirs (m+1, B, n+1) uint16, finals (B, 3))."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=True)


def matrix_dirs_plain(a, b, la, lb, st, table, params):
    """Plain PyTorch K4d: (dirs (m+1, B, n+1) uint16, finals (B, 3))."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=True,
                        table=table)


def submat_score_fill_plain(a, b, la, lb, st, table, params):
    """Plain PyTorch K4s: finals (B, 3), the same sweep without dirs."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=False,
                        table=table)[1]


def rowscan_score_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K3': finals (B, 3), K1's sweep without dirs."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=False)[1]


def rowdirs_fill_plain(a, b, la, lb, st, params, with_runs=False):
    """Plain PyTorch K1': (dirs (m+1, B, n+1) uint8 codes, or uint16
    dirs16+runs ``with_runs``, finals (B, 3)), omega in the free modes'
    order."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=True,
                        runs=with_runs, free=True)


def trim_rowscan_fill_plain(a, b, lb, params):
    """Plain PyTorch P-trim: finals (B, 3), the sweep without dirs at
    start type -1, every la = m, omega in the free modes' order."""
    B, m = a.shape
    la = torch.full((B,), m, dtype=torch.int32, device=a.device)
    st = torch.full((B,), -1, dtype=torch.int32, device=a.device)
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=False,
                        free=True)[1]


def semiglobal_dirs_plain(a, b, la, lb, params):
    """Plain PyTorch K10d: (dirs (m+1, B, n+1) uint16, best (B, 4))."""
    return _sweep_plain(a, b, la, lb, torch.zeros_like(la), params,
                        want_dirs=True, mode="semiglobal")


def overlap_dirs_plain(a, b, la, lb, params):
    """Plain PyTorch K11d: (dirs (m+1, B, n+1) uint16, best (B, 4))."""
    return _sweep_plain(a, b, la, lb, torch.zeros_like(la), params,
                        want_dirs=True, mode="overlap")


def _launch_geometry(n, runs=True, k1=0):
    """(C, threads, row_bytes, base_smem) for a bucket of width n, with
    or without the run state, under a (k1, k1) table or none (k1 = 0)."""
    ncol = n + 1
    C = max(4, -(-ncol // 1024))
    threads = -(-ncol // (32 * C)) * 32  # whole warps covering ncol
    row_bytes = (ncol * (28 if runs else 24) + 15) // 16 * 16
    base_smem = 512 + (ncol + 15) // 16 * 16 + (k1 * k1 * 4 + 15) // 16 * 16
    return C, threads, row_bytes, base_smem


# what a sweep stores for each cell (csrc/rowcb.cu): nothing, the uint16
# dirs16+runs word, or the uint8 codes alone
NO_DIRS, DIRS16, DIRS8 = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/rowcb.cu: 8 pointers, then mode, B, m,
    n, C, threads, shared bytes, g, h, match, mismatch, the table
    pointer, k1, dirs_kind, free_order, stream."""
    fn = _build.cuda_library("rowcb").rowcb_fill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _fill_entry():
    """ctypes entry point of csrc/rowfill.cu: 7 pointers, then B, m, n,
    pitch, C, threads, k, g, h, match, mismatch, the table pointer, k1,
    stream."""
    fn = _build.cuda_library("rowfill").rowfill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p])
    return fn


def fill_occupancy(C, threads, k=1, k1=0, device="cuda"):
    """(CTAs an SM, clusters of k at once; 0 when k = 1) that CUDA gives
    the ``csrc/rowfill.cu`` instance of a geometry, under a (k1, k1)
    table or none."""
    fn = _build.cuda_library("rowfill").rowfill_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(torch.device(device)):
        err = fn(C, threads, k, int(k1 > 0), k1, ctypes.byref(per_sm),
                 ctypes.byref(clusters))
    _build.check(err, f"rowfill_occupancy(C={C}, threads={threads}, k={k})")
    return per_sm.value, clusters.value


@functools.lru_cache(maxsize=None)
def _card_sms(device):
    """The SMs of a CUDA ``device`` (a ``torch.device`` with its index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fill(a, b, la, lb, st, params, table, geometry):
    """Launch csrc/rowfill.cu at ``geometry`` (C, threads, k; C = 16 when
    k > 1) on a checked CUDA bucket; returns (dirs view (m+1, B, n+1) of
    a (m+1, B, pitch) tensor, finals). ``rowcb_fill`` calls it at
    ``fill_geometry``'s choice; the card tests and ``chip_smoke.py`` at
    others. Counts nothing."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    C, threads, k = geometry
    k1 = 0 if table is None else table.shape[0]
    pitch = dirs_pitch(n)
    out = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=dev)
    dirs = torch.empty((m + 1, B, pitch), dtype=torch.uint16, device=dev)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _fill_entry()(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), dirs.data_ptr(), out.data_ptr(), B, m, n, pitch,
            C, threads, k, g, h, match, mismatch,
            table.data_ptr() if table is not None else None, k1,
            torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise RuntimeError(f"rowfill: a cluster of {k} CTAs of {threads} "
                           f"threads cannot be co-scheduled on {dev}")
    _build.check(err, f"rowfill(C={C}, threads={threads}, k={k}"
                      f"{', table' if k1 else ''})")
    return dirs[:, :, :n + 1], out


@functools.lru_cache(maxsize=None)
def _trim_entry():
    """ctypes entry point of the P-trim sweep in csrc/rowcb.cu: 5
    pointers, then B, m, n, C, threads, shared bytes, g, h, match,
    mismatch, stream."""
    fn = _build.cuda_library("rowcb").rowcb_trim_fill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    return fn


def _launch(a, b, la, lb, st, params, mode, table=None, kind=DIRS16,
            free=False, uniform=False):
    """Launch the sweep; ``uniform`` is P-trim's (no dirs, start type -1,
    every la = m: ``la`` and ``st`` are not read)."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    k1 = 0 if table is None else table.shape[0]
    C, threads, row_bytes, smem = _launch_geometry(n, kind == DIRS16, k1)
    scratch = None
    if smem + row_bytes <= SMEM_LIMIT:
        smem += row_bytes
    else:
        scratch = torch.empty(B * row_bytes, dtype=torch.uint8, device=dev)
    out = torch.full((B, 3 if mode == "global" else 4), NEG_INF,
                     dtype=torch.float32, device=dev)
    dirs = None
    if kind != NO_DIRS:
        dirs = torch.empty((m + 1, B, n + 1), device=dev, dtype=(
            torch.uint16 if kind == DIRS16 else torch.uint8))
    g, h, match, mismatch = params.astuple()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if uniform:
        with torch.cuda.device(dev):
            err = _trim_entry()(
                a.data_ptr(), b.data_ptr(), lb.data_ptr(), out.data_ptr(),
                scratch.data_ptr() if scratch is not None else None, B, m,
                n, C, threads, smem, g, h, match, mismatch, stream)
        _build.check(err, "rowcb_trim_fill")
        return None, out
    with torch.cuda.device(dev):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), dirs.data_ptr() if dirs is not None else None,
            out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            _build.MODES[mode], B, m, n, C, threads, smem, g, h, match,
            mismatch, table.data_ptr() if table is not None else None, k1,
            kind, int(free), stream)
    _build.check(err, f"rowcb_fill({mode}{', table' if k1 else ''}, dirs "
                      f"kind {kind}{', free order' if free else ''})")
    return dirs, out


def check_table(table, a, b, codes=True):
    """Raise unless ``table`` is a contiguous (k1, k1) float32 tensor on
    the codes' device with 2 <= k1 <= 255 (the kernels keep codes in
    uint8 with 255 as the column-0 sentinel), and, with ``codes``, every
    code of ``a`` and ``b`` (``SubstitutionMatrix.encode`` codes, padded
    with its pad code) indexes it: the kernels read the table unchecked.
    The code check reads the codes' maximum, which waits for the card;
    a caller that checked its codes on the host (``check_codes``) passes
    ``codes=False``."""
    if table.dtype != torch.float32 or table.dim() != 2 or \
            table.shape[0] != table.shape[1]:
        raise ValueError(f"table must be (k1, k1) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    k1 = table.shape[0]
    if not 2 <= k1 <= 255:
        raise ValueError(f"a substitution table of K+1 = {k1} codes: the "
                         f"kernels take 2 to 255")
    if table.device != a.device or not table.is_contiguous():
        raise ValueError("table must be contiguous, on the codes' device")
    if codes:
        check_codes(a, b, k1)


def check_codes(a, b, k1):
    """Raise unless every code of ``a`` and ``b`` (tensors or numpy
    arrays) is below ``k1``, the codes a table of k1 rows indexes."""
    top = max((int(x.max()) for x in (a, b) if 0 not in x.shape),
              default=0)
    if top >= k1:
        raise ValueError(f"code {top} does not index a table of {k1} codes: "
                         f"encode with SubstitutionMatrix.encode and pad "
                         f"with its pad_code")


def rowcb_fill(a, b, la, lb, st, params, table=None, checked=False):
    """K1: dirs16+runs fill of a bucket; with a ``table``, K4d (the same
    fill scoring f(A[i], B[j]) = table[A[i], B[j]]). Returns (dirs (m+1,
    B, n+1) uint16, finals (B, 3)); see the module docstring. With
    ``checked`` the caller vouches that its codes index the table (it ran
    ``check_codes`` on the host), and the fill does not read the codes'
    maximum from the card.

    On a card, buckets up to ``CLUSTER_REACH`` columns wide run
    ``csrc/rowfill.cu`` at ``fill_geometry``'s (C, threads, k) and return
    a view of pitched dirs; counted in ``rowcb_fill.launches`` (K1) or
    ``rowcb_fill.table_launches`` (K4d), and in the active recorder
    (``utils/observability.count``) as ``fill_ctas`` (B x k, the CTAs
    of the launch) and ``fill_sm_slots`` (the card's SMs). Wider buckets
    run the global-scratch sweep of ``csrc/rowcb.cu``
    (``wide_launches``)."""
    _build.check_bucket(a, b, la, lb, st)
    if table is not None:
        check_table(table, a, b, codes=not checked)
    if a.device.type == "cpu":
        if table is not None:
            return matrix_dirs_plain(a, b, la, lb, st, table, params)
        return rowcb_fill_plain(a, b, la, lb, st, params)
    k1 = 0 if table is None else table.shape[0]
    geometry = fill_geometry(a.shape[0], b.shape[1], k1)
    if geometry is None:
        out = _launch(a, b, la, lb, st, params, "global", table)
        rowcb_fill.wide_launches += 1
        return out
    out = _fill(a, b, la, lb, st, params, table, geometry)
    observability.count("fill_ctas", a.shape[0] * geometry[2])
    observability.count("fill_sm_slots", _card_sms(a.device))
    if table is None:
        rowcb_fill.launches += 1
    else:
        rowcb_fill.table_launches += 1
    return out


def submat_score_fill(a, b, la, lb, st, table, params, checked=False):
    """K4s: finals (B, 3) of a bucket under a substitution ``table``; the
    K4d sweep storing no dirs, so the finals are K4d's bit for bit.
    ``checked`` as for ``rowcb_fill``."""
    _build.check_bucket(a, b, la, lb, st)
    check_table(table, a, b, codes=not checked)
    if a.device.type == "cpu":
        return submat_score_fill_plain(a, b, la, lb, st, table, params)
    out = _launch(a, b, la, lb, st, params, "global", table,
                  kind=NO_DIRS)[1]
    submat_score_fill.launches += 1
    return out


def rowscan_score_fill(a, b, la, lb, st, params):
    """K3': finals (B, 3) of a bucket, the global row sweep storing no
    dirs; bit for bit K1's finals (omega in K1's order)."""
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return rowscan_score_fill_plain(a, b, la, lb, st, params)
    out = _launch(a, b, la, lb, st, params, "global", kind=NO_DIRS)[1]
    rowscan_score_fill.launches += 1
    return out


def rowdirs_fill(a, b, la, lb, st, params, with_runs=False):
    """K1': row-layout dirs fill of a bucket with omega in the free
    modes' order; returns (dirs (m+1, B, n+1), finals (B, 3)). The dirs
    are uint8 codes ``d1 | d2 << 2 | d3 << 4``, or with ``with_runs`` the
    uint16 dirs16+runs word (counted in ``rowdirs_fill.runs_launches``).
    Row 0 is zero."""
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return rowdirs_fill_plain(a, b, la, lb, st, params, with_runs)
    out = _launch(a, b, la, lb, st, params, "global",
                  kind=DIRS16 if with_runs else DIRS8, free=True)
    if with_runs:
        rowdirs_fill.runs_launches += 1
    else:
        rowdirs_fill.launches += 1
    return out


def trim_rowscan_fill(a, b, lb, params):
    """P-trim: finals (B, 3) of K3' at start type -1 with every la = m
    (the width of ``a``), read after row m, omega in the free modes'
    order; see the module docstring."""
    B, m = a.shape
    la = torch.full((B,), m, dtype=torch.int32, device=a.device)
    _build.check_bucket(a, b, la, lb, la)
    if a.device.type == "cpu":
        return trim_rowscan_fill_plain(a, b, lb, params)
    out = _launch(a, b, la, lb, la, params, "global", kind=NO_DIRS,
                  free=True, uniform=True)[1]
    trim_rowscan_fill.launches += 1
    return out


def semiglobal_dirs(a, b, la, lb, params):
    """K10d: semi-global dirs16+runs fill of a bucket; returns (dirs
    (m+1, B, n+1) uint16, best (B, 4) float32 [score, end_table, end_i,
    end_j])."""
    st = torch.zeros_like(la)
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return semiglobal_dirs_plain(a, b, la, lb, params)
    out = _launch(a, b, la, lb, st, params, "semiglobal")
    semiglobal_dirs.launches += 1
    return out


def overlap_dirs(a, b, la, lb, params):
    """K11d: overlap dirs16+runs fill of a bucket; returns (dirs (m+1, B,
    n+1) uint16, best (B, 4) float32 [score, end_table, end_i, end_j])."""
    st = torch.zeros_like(la)
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return overlap_dirs_plain(a, b, la, lb, params)
    out = _launch(a, b, la, lb, st, params, "overlap")
    overlap_dirs.launches += 1
    return out


rowcb_fill.launches = 0
rowcb_fill.table_launches = 0  # K4d
rowcb_fill.wide_launches = 0  # past CLUSTER_REACH: csrc/rowcb.cu
submat_score_fill.launches = 0
rowscan_score_fill.launches = 0
rowdirs_fill.launches = 0
rowdirs_fill.runs_launches = 0  # the with_runs form
trim_rowscan_fill.launches = 0
semiglobal_dirs.launches = 0
overlap_dirs.launches = 0


def dirs_from_jax(dirs, la, lb):
    """The port's dirs layout from a JAX ``_pallas_rowcb(perm=False,
    with_runs=True)`` array (rows_pad, Bp, nl): the real pairs' rows
    0..max(la) and columns 0..max(lb), as a CPU uint16 tensor with cell
    (i, j) of pair b at ``[i, b, j]``."""
    dirs = np.asarray(dirs)
    la, lb = np.asarray(la), np.asarray(lb)
    B = la.shape[0]
    rows = int(la.max(initial=0)) + 1
    cols = int(lb.max(initial=0)) + 1
    out = np.ascontiguousarray(dirs[:rows, :B, :cols], dtype=np.uint16)
    return torch.from_numpy(out)
