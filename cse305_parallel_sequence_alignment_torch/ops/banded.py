"""Banded Gotoh fills: K12s (finals) and K12d (band-layout dirs16+runs).

``banded_score`` is the port of the TPU kernel ``_banded_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_banded.py:42) and
``banded_dirs`` of ``_banded_dirs_kernel`` (same file, :161) with
``with_runs=True``; both run ``csrc/banded.cu``: K12d its
``band_rows_kernel`` (rows in registers, one barrier a row, one vector
store of a thread's words a row) at ``band_geometry``'s (C, threads),
K12s and bands wider than ``ROWS_REACH`` lanes ``band_kernel`` (rows
in shared memory or global scratch). The band of a pair is
``j in [i - w_lo, i + w_hi]``: lane l in [0, W), W = w_lo + w_hi + 1, of
row i holds column j = i - w_lo + l, so a cell's diagonal predecessor is
the same lane of the previous row, its upper one lane l+1 there and its
left one lane l-1 of its own row (the JAX package's ``ops/banded.py``).

Inputs are a bucket, as for the row sweeps of ops/rowcb.py: ``a`` (B, m)
and ``b`` (B, n) uint8 codes padded with ``PAD_A``/``PAD_B``, lengths
``la``/``lb`` and start types ``st``, each (B,) int32. Lanes whose column
lies outside [1, n] are -inf (T3's column 0 holds its boundary). Every
pair's (0, 0) and (la, lb) must lie inside the band (``band_check``);
the finals (B, 3) float32 are (T1, T2, T3) at (la, lb). ``dirs`` is
(m+1, B, W) uint16 with cell (i, j) of pair b at ``dirs[i, b, j - i +
w_lo]`` (on a card a view of rows pitched to ``dirs_pitch(W - 1)``
lanes), packing [d1 | d2 << 2 | d3 << 4 | after-run code << 6 | run
length << 8]; bytes and run state are zero outside each pair's rectangle
(j <= lb, i <= la), as the TPU kernel masks them. A diagonal run keeps
its lane, so ``rle_walk(..., band_lo=w_lo)`` (ops/device_walk.py) walks
these dirs as it walks the row layout.

The plain versions are row loops over (B, W) tensors in the Pallas
kernels' float32 order, gh = g + h rounded to float32:
``T3 = max(max(u1, u2) - gh, u3 - g)`` with u the previous row's lane
l+1, ``omega = (j*g + max(T1, T3)(l-1)) - gh``, ``T2 = cummax(omega) -
j*g``, and d2 taken from lane l-1 of ``argmax3(T1 - h, T2, T3 - h)``.

A CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cse305_parallel_sequence_alignment_torch.core import (
    DIR_T1_SHIFT,
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
    NEG_INF,
    PAD_B,
)
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    RUN_CAP,
    SMEM_LIMIT,
    SMS,
    _argmax3,
    _shift,
    dirs_pitch,
)


def band_check(m, n, w_lo, w_hi):
    """Raise unless the band [i-w_lo, i+w_hi] covers (0,0) and (m,n)."""
    if w_lo < 0 or w_hi < 0:
        raise ValueError("band widths must be non-negative")
    if n - m > w_hi:
        raise ValueError(
            f"band upper width {w_hi} misses (m, n): need >= {n - m}")
    if m - n > w_lo:
        raise ValueError(
            f"band lower width {w_lo} misses (m, n): need >= {m - n}")


def _check_band(la, lb, w_lo, w_hi):
    """``band_check`` of the widths and of every pair of a bucket."""
    band_check(0, 0, w_lo, w_hi)
    for m, n in zip(la.tolist(), lb.tolist()):
        band_check(m, n, w_lo, w_hi)


def _rows(a, bext, la, lb, st, i0, i1, w_lo, W, g, h, match, mismatch):
    """What rows i0..i1-1 of the band need from the inputs alone, each
    (B, R, W): T1's f(A[i], B[j]) with -inf off the band (-inf + x is
    -inf, as the masked sum is), j*g with -inf off the band (omega) and
    with +inf there (T2 = cummax - j*g), T3 off the band (its column-0
    boundary, quirk: start +3 acts as -1 there, else -inf), whether the
    cell lies in the band and in its pair's rectangle."""
    B, n1 = bext.shape
    dev = a.device
    f32 = torch.float32
    rows = torch.arange(i0, i1, device=dev)
    j = rows[:, None] - w_lo + torch.arange(W, device=dev)[None, :]
    inband = ((j >= 1) & (j < n1))[None]
    jg = (g * j.to(f32))[None]
    chars = bext[:, j.clamp(0, n1 - 1)]
    hit = chars == a[:, i0 - 1:i1 - 1, None].to(torch.int32)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    fb = torch.where(inband, torch.where(hit, match, mismatch), neg)
    stc = st.to(torch.int32)[:, None]
    gi = g * rows.to(f32)[None, :]
    col0_3 = torch.where(stc == -3, -gi,
                         torch.where((stc == 1) | (stc == 2), neg, -h - gi))
    t3_off = torch.where((j == 0)[None], col0_3[:, :, None], neg)
    inpair = inband & (j[None] <= lb.to(torch.int64)[:, None, None]) & \
        (la[:, None] >= rows[None, :])[:, :, None]
    return (fb, torch.where(inband, jg, neg), torch.where(inband, jg, -neg),
            t3_off, inband.expand(B, -1, -1), inpair)


def banded_fill_plain(a, b, la, lb, st, w_lo, w_hi, params, want_dirs):
    """Plain PyTorch K12s / K12d: (dirs (m+1, B, W) uint16 or None,
    finals (B, 3)). What a row needs from the inputs alone is computed
    for blocks of rows (``_rows``); the loop carries the three tables
    and the run state from row to row."""
    B, m = a.shape
    n = b.shape[1]
    W = w_lo + w_hi + 1
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h  # float32, as XLA folds the JAX kernels' x - g - h
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    lanes = torch.arange(W, device=dev)
    negcol = torch.full((B, 1), NEG_INF, dtype=f32, device=dev)
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    stc = st.to(torch.int32)[:, None]
    lbc = lb.to(torch.int64)[:, None]

    # row 0: lanes with 0 <= j <= n (quirk: start +2 acts as -1 on row 0)
    j0 = (lanes - w_lo)[None, :]
    in0 = (j0 >= 0) & (j0 <= n)
    at_c = j0 == 0
    jg0 = g * j0.to(f32)
    row0_t2 = torch.where(stc == -2, -jg0,
                          torch.where((stc == 1) | (stc == 3), neg,
                                      -h - jg0))
    p1 = torch.where(at_c & ((stc == 1) | (stc == -1)), zero, neg)
    p2 = torch.where(in0, torch.where(at_c, torch.where(stc == -2, zero,
                                                        neg), row0_t2), neg)
    p3 = torch.where(at_c & (stc == -3), zero, neg)

    fin = torch.full((B, 3), NEG_INF, dtype=f32, device=dev)
    ends = set(la.tolist())  # the rows that hold a pair's (la, lb)

    def capture(fin, i, t1, t2, t3):
        # the lane of (la, lb) on row la; clamped on the other rows
        lane = (lbc - i + w_lo).clamp(0, W - 1)
        vals = torch.cat([t.gather(1, lane) for t in (t1, t2, t3)], dim=1)
        return torch.where((la == i)[:, None], vals, fin)

    if 0 in ends:
        fin = capture(fin, 0, p1, p2, p3)
    dirs = None
    if want_dirs:
        # int16 holds the uint16 bits: few PyTorch kernels take uint16
        dirs = torch.empty((m + 1, B, W), dtype=torch.int16, device=dev)
        dirs[0] = 0
        word = torch.zeros((B, W), dtype=torch.int32, device=dev)
    block = max(1, min(256, (1 << 20) // max(1, B * W)))
    for i0 in range(1, m + 1, block):
        i1 = min(m + 1, i0 + block)
        fbs, jgo, jgt, t3s, inbs, inps = _rows(
            a, bext, la, lb, st, i0, i1, w_lo, W, g, h, match, mismatch)
        for r, i in enumerate(range(i0, i1)):
            inband = inbs[:, r]
            u1, u2, u3 = (torch.cat([p[:, 1:], negcol], dim=1)
                          for p in (p1, p2, p3))
            t1 = fbs[:, r] + torch.maximum(torch.maximum(p1, p2), p3)
            t3 = torch.where(inband, torch.maximum(
                torch.maximum(u1, u2) - gh, u3 - g), t3s[:, r])
            m_prev = torch.cat([negcol, torch.maximum(t1, t3)[:, :-1]],
                               dim=1)
            omega = (jgo[:, r] + m_prev) - gh
            t2 = torch.cummax(omega, dim=1).values - jgt[:, r]
            if want_dirs:
                d1 = _argmax3(p1, p2, p3)
                d3 = _argmax3(u1, u2, u3 + h)
                d2 = _shift(_argmax3(t1 - h, t2, t3 - h), 0)
                r_prev = word >> 8
                is_run = d1 == 0
                r_cur = torch.where(is_run,
                                    torch.clamp(r_prev + 1, max=RUN_CAP), 0)
                ca_cur = torch.where(
                    is_run, torch.where(r_prev >= RUN_CAP, 0,
                                        (word >> 6) & 3), d1)
                word = torch.where(
                    inps[:, r], (d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                    | (d3 << DIR_T3_SHIFT) | (ca_cur << 6) | (r_cur << 8), 0)
                dirs[i] = word
            if i in ends:
                fin = capture(fin, i, t1, t2, t3)
            p1, p2, p3 = t1, t2, t3
    return (dirs.view(torch.uint16) if want_dirs else None), fin


def sweep_geometry(W, want_dirs):
    """(C, threads, row_bytes) of ``band_kernel`` (K12s, wide K12d) for a
    band of W lanes."""
    C = max(4, -(-W // 1024))
    threads = -(-W // (32 * C)) * 32  # whole warps covering W
    row_bytes = (W * (26 if want_dirs else 24) + 15) // 16 * 16
    return C, threads, row_bytes


# csrc/banded.cu band_rows_kernel: lanes a thread, the most threads a CTA
# takes at each (its __launch_bounds__), the registers ptxas gives it
# (rounded to the allocation's 8), and the widest band it holds
ROWS_C = (4, 8, 16)
ROWS_THREADS = {4: 1024, 8: 512, 16: 256}
ROWS_REGS = {4: 64, 8: 96, 16: 160}
ROWS_REACH = 4096
# A band row's time on an H100 (us), a + b * the warps on its SM: fitted
# to the kernel's times at each C in chip_smoke.py's [banded-kernels]
# lines (W = 129 and 513 on 256 pairs, 1,329 on one; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §6).
BAND_ROW_US = {4: (0.904, 0.0437), 8: (1.60, 0.035), 16: (3.05, 0.0)}


def band_threads(W, C):
    """The fewest whole warps whose threads hold W lanes at C a thread."""
    return -(-W // (32 * C)) * 32


def band_geometry(B, W):
    """(C, threads) of ``band_rows_kernel`` for B pairs in a band of W
    lanes, or None past ``ROWS_REACH`` (``band_kernel`` takes those): the
    C of least modelled time, ties to the smaller C. A CTA a pair; the
    CTAs an SM holds (by threads and registers) run at once, and a row
    costs ``BAND_ROW_US`` at the warps they put on an SM, once a wave.
    A pure function."""
    if W > ROWS_REACH:
        return None
    best = None
    for C in ROWS_C:
        threads = band_threads(W, C)
        if threads > ROWS_THREADS[C]:
            continue
        per_sm = min(32, 2048 // threads,
                     65536 // (threads * ROWS_REGS[C]))
        waves = -(-B // (SMS * per_sm))
        on_sm = min(per_sm, -(-B // SMS)) * threads // 32
        a, b = BAND_ROW_US[C]
        cost = waves * (a + b * on_sm)
        if best is None or cost < best[0]:
            best = (cost, C, threads)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _entry(name):
    """ctypes entry point of csrc/banded.cu: ``band_fill`` (8 pointers,
    then B, m, n, w_lo, W, C, threads, shared bytes, g, h, match,
    mismatch, stream) or ``band_rows_fill`` (7 pointers, then B, m, n,
    w_lo, W, pitch, C, threads, g, h, match, mismatch, stream)."""
    fn = getattr(_build.cuda_library("banded"), name)
    fn.restype = ctypes.c_int
    if name == "band_fill":
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def _launch(a, b, la, lb, st, w_lo, w_hi, params, want_dirs):
    """``band_kernel`` (K12s; K12d past ``ROWS_REACH``) on a checked CUDA
    bucket; returns (dirs (m+1, B, W) or None, finals). Counts
    nothing."""
    B, m = a.shape
    n = b.shape[1]
    W = w_lo + w_hi + 1
    dev = a.device
    C, threads, row_bytes = sweep_geometry(W, want_dirs)
    smem, scratch = 512, None
    if smem + row_bytes <= SMEM_LIMIT:
        smem += row_bytes
    else:
        scratch = torch.empty(B * row_bytes, dtype=torch.uint8, device=dev)
    out = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=dev)
    dirs = (torch.empty((m + 1, B, W), dtype=torch.uint16, device=dev)
            if want_dirs else None)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry("band_fill")(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), dirs.data_ptr() if want_dirs else None,
            out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, B, m, n,
            w_lo, W, C, threads, smem, g, h, match, mismatch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"band_fill({'dirs' if want_dirs else 'score'})")
    return dirs, out


def _rows_fill(a, b, la, lb, st, w_lo, w_hi, params, geometry=None):
    """``band_rows_kernel`` at ``geometry`` (C, threads),
    ``band_geometry``'s by default, on a checked CUDA bucket; returns
    (dirs view (m+1, B, W) of a (m+1, B, pitch) tensor, finals). Counts
    nothing."""
    B, m = a.shape
    n = b.shape[1]
    W = w_lo + w_hi + 1
    dev = a.device
    C, threads = geometry or band_geometry(B, W)
    pitch = dirs_pitch(W - 1)
    out = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=dev)
    dirs = torch.empty((m + 1, B, pitch), dtype=torch.uint16, device=dev)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry("band_rows_fill")(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), dirs.data_ptr(), out.data_ptr(), B, m, n, w_lo,
            W, pitch, C, threads, g, h, match, mismatch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"band_rows_fill(C={C}, threads={threads})")
    return dirs[:, :, :W], out


def banded_score(a, b, la, lb, st, w_lo, w_hi, params):
    """K12s: finals (B, 3) of the banded fill of a bucket."""
    _build.check_bucket(a, b, la, lb, st)
    _check_band(la, lb, w_lo, w_hi)
    if a.device.type == "cpu":
        return banded_fill_plain(a, b, la, lb, st, w_lo, w_hi, params,
                                 want_dirs=False)[1]
    out = _launch(a, b, la, lb, st, w_lo, w_hi, params, False)[1]
    banded_score.launches += 1
    return out


def banded_dirs(a, b, la, lb, st, w_lo, w_hi, params):
    """K12d: (dirs (m+1, B, W) uint16 band layout, finals (B, 3)). On a
    card, bands up to ``ROWS_REACH`` lanes run ``band_rows_kernel`` and
    return a view of pitched rows (counted in ``banded_dirs.launches``);
    wider ones ``band_kernel`` (``banded_dirs.wide_launches``)."""
    _build.check_bucket(a, b, la, lb, st)
    _check_band(la, lb, w_lo, w_hi)
    if a.device.type == "cpu":
        return banded_fill_plain(a, b, la, lb, st, w_lo, w_hi, params,
                                 want_dirs=True)
    if band_geometry(a.shape[0], w_lo + w_hi + 1) is None:
        out = _launch(a, b, la, lb, st, w_lo, w_hi, params, True)
        banded_dirs.wide_launches += 1
        return out
    out = _rows_fill(a, b, la, lb, st, w_lo, w_hi, params)
    banded_dirs.launches += 1
    return out


banded_score.launches = 0
banded_dirs.launches = 0
banded_dirs.wide_launches = 0
