"""Global Gotoh row-sweep fills: K1 (dirs16+runs) and K3 (score only).

K1 ``rowcb_fill`` is the port of the TPU kernel ``_rowcb_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_rowcb.py:126) with
``want_dirs=True, with_runs=True, k1=0``; K3 ``score_fill`` is the port of
``_score_kernel`` (ops/pallas_fill.py:216). Both run the same row sweep
(``csrc/rowcb.cu``, one CUDA template) with per-pair start types:

- ``T1 = f(A[i], B[j]) + max3(prev row, j-1)``
- ``T3 = max((max(T1,T2)(prev, j) - g) - h, T3(prev, j) - g)``
- ``T2 = prefixmax(omega) - g*j`` with
  ``omega = ((g*j + max(T1,T3)(j-1)) - g) - h`` (reference P2)

Inputs are a bucket: ``a`` (B, m) and ``b`` (B, n) uint8 codes padded
with ``PAD_A``/``PAD_B``, lengths ``la``/``lb`` and start types ``st``,
each (B,) int32. Every cell of the bucket is computed, padding included.
K1 returns ``dirs`` of shape (m+1, B, n+1) uint16, cell (i, j) of pair b
at ``dirs[i, b, j]``, packing [d1 | d2 << 2 | d3 << 4 | after-run code
<< 6 | run length << 8] (the JAX ``with_runs`` encoding); both return
the finals (B, 3) float32 (T1, T2, T3) at (la, lb).

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

RUN_CAP = 255
# dynamic shared memory above which the row buffers go to global scratch
SMEM_LIMIT = 200 * 1024


def _argmax3(c1, c2, c3):
    """First index of the max of three (tie order T1 >= T2 >= T3)."""
    return torch.where((c1 >= c2) & (c1 >= c3), 0,
                       torch.where(c2 >= c3, 1, 2))


def _shift(x, fill):
    """Shift columns right by one (column j gets j-1), ``fill`` at 0."""
    col = torch.full_like(x[:, :1], fill)
    return torch.cat([col, x[:, :-1]], dim=1)


def _sweep_plain(a, b, la, lb, st, params, want_dirs, want_row=False):
    """Row loop over (B, n+1) tensors in the kernel's float32 order.

    Returns (dirs or None, out): ``out`` is the finals (B, 3) at (la, lb),
    or with ``want_row`` the whole row la of each pair, (B, 3, n+1)."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    j = torch.arange(n + 1, device=dev)
    jg = g * j.to(f32)
    lane0 = (j == 0)[None, :]
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    stc = st.to(torch.int32)[:, None]
    lbi = lb.to(torch.int64)[:, None]

    # row 0 (quirk: start +2 acts as -1 on row 0)
    row0_t2 = torch.where(stc == -2, -jg,
                          torch.where((stc == 1) | (stc == 3), neg,
                                      -h - jg))
    p1 = torch.where(lane0 & ((stc == 1) | (stc == -1)), zero, neg)
    p2 = torch.where(lane0, torch.where(stc == -2, zero, neg), row0_t2)
    p3 = torch.where(lane0 & (stc == -3), zero, neg)
    fin = torch.full((B, 3, n + 1) if want_row else (B, 3), NEG_INF,
                     dtype=f32, device=dev)

    def capture(fin, i, t1, t2, t3):
        if want_row:
            return torch.where((la == i)[:, None, None],
                               torch.stack([t1, t2, t3], dim=1), fin)
        vals = torch.cat([t.gather(1, lbi) for t in (t1, t2, t3)], dim=1)
        return torch.where((la == i)[:, None], vals, fin)

    fin = capture(fin, 0, p1, p2, p3)
    dirs = None
    if want_dirs:
        # int16 holds the uint16 bits: few PyTorch kernels take uint16
        dirs = torch.empty((m + 1, B, n + 1), dtype=torch.int16,
                           device=dev)
        dirs[0] = 0
        word = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
    for i in range(1, m + 1):
        fi = torch.tensor(float(i), dtype=f32, device=dev)
        # column 0 of T3 (quirk: start +3 acts as -1 on column 0)
        col0_3 = torch.where(stc == -3, -g * fi,
                             torch.where((stc == 1) | (stc == 2), neg,
                                         -h - g * fi))
        mp12 = torch.maximum(p1, p2)
        mp3 = torch.maximum(mp12, p3)
        fb = torch.where(bext == a[:, i - 1:i].to(torch.int32), match,
                         mismatch)
        t1 = torch.where(lane0, neg, fb + _shift(mp3, NEG_INF))
        t3 = torch.where(lane0, col0_3,
                         torch.maximum((mp12 - g) - h, p3 - g))
        m13 = torch.maximum(t1, t3)
        omega = torch.where(lane0, neg,
                            ((jg + _shift(m13, NEG_INF)) - g) - h)
        t2 = torch.where(lane0, neg, torch.cummax(omega, dim=1).values - jg)
        if want_dirs:
            d1 = _shift(_argmax3(p1, p2, p3), 0)
            d3 = _argmax3(p1, p2, p3 + h)
            d2 = _shift(_argmax3(t1 - h, t2, t3 - h), 0)
            r_prev = _shift(word >> 8, 0)
            ca_prev = _shift((word >> 6) & 3, 0)
            is_run = d1 == 0
            r_cur = torch.where(is_run,
                                torch.clamp(r_prev + 1, max=RUN_CAP), 0)
            ca_cur = torch.where(
                is_run, torch.where(r_prev >= RUN_CAP, 0, ca_prev), d1)
            word = ((d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                    | (d3 << DIR_T3_SHIFT) | (ca_cur << 6) | (r_cur << 8))
            dirs[i] = word.to(torch.int16)
        fin = capture(fin, i, t1, t2, t3)
        p1, p2, p3 = t1, t2, t3
    return (dirs.view(torch.uint16) if want_dirs else None), fin


def rowcb_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K1: (dirs (m+1, B, n+1) uint16, finals (B, 3))."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=True)


def score_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K3: finals (B, 3) float32."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=False)[1]


def _check(a, b, la, lb, st):
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8 code tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be (B, m) and (B, n)")
    B = a.shape[0]
    for name, v in (("la", la), ("lb", lb), ("st", st)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (a, b, la, lb, st):
        if v.device != a.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _launch_geometry(n, want_dirs):
    """(C, threads, row_bytes, base_smem) for a bucket of width n."""
    ncol = n + 1
    C = max(4, -(-ncol // 1024))
    threads = -(-ncol // (32 * C)) * 32  # whole warps covering ncol
    row_bytes = (ncol * (28 if want_dirs else 24) + 15) // 16 * 16
    base_smem = 128 + (ncol + 15) // 16 * 16
    return C, threads, row_bytes, base_smem


@functools.lru_cache(maxsize=None)
def _entry(fn_name, n_ptrs):
    """ctypes entry point of csrc/rowcb.cu: n_ptrs pointers, then B, m,
    n, C, threads, shared bytes, g, h, match, mismatch, stream."""
    fn = getattr(_build.cuda_library("rowcb"), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    return fn


def _launch(fn_name, a, b, la, lb, st, params, want_dirs):
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    C, threads, row_bytes, smem = _launch_geometry(n, want_dirs)
    scratch = None
    if smem + row_bytes <= SMEM_LIMIT:
        smem += row_bytes
    else:
        scratch = torch.empty(B * row_bytes, dtype=torch.uint8, device=dev)
    fin = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=dev)
    dirs = None
    ptrs = [a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr()]
    if want_dirs:
        dirs = torch.empty((m + 1, B, n + 1), dtype=torch.uint16,
                           device=dev)
        ptrs.append(dirs.data_ptr())
    ptrs += [fin.data_ptr(), scratch.data_ptr() if scratch is not None
             else None]
    fn = _entry(fn_name, len(ptrs))
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, m, n, C, threads, smem, g, h, match, mismatch,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn_name)
    return dirs, fin


def rowcb_fill(a, b, la, lb, st, params):
    """K1: dirs16+runs fill of a bucket; see the module docstring."""
    _check(a, b, la, lb, st)
    if a.device.type == "cpu":
        return rowcb_fill_plain(a, b, la, lb, st, params)
    out = _launch("rowcb_fill", a, b, la, lb, st, params, True)
    rowcb_fill.launches += 1
    return out


def score_fill(a, b, la, lb, st, params):
    """K3: score-only fill of a bucket, finals (B, 3) float32."""
    _check(a, b, la, lb, st)
    if a.device.type == "cpu":
        return score_fill_plain(a, b, la, lb, st, params)
    _, fin = _launch("score_fill", a, b, la, lb, st, params, False)
    score_fill.launches += 1
    return fin


rowcb_fill.launches = 0
score_fill.launches = 0


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
