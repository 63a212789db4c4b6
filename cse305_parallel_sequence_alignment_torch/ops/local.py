"""Smith-Waterman (local, affine-gap) fills: K9s (score) and K9d (dirs).

K9s ``sw_score`` is the port of the TPU kernel ``_sw_score_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_local.py:118) and K9d
``sw_dirs`` of ``_sw_dirs_kernel`` (same file, :209). Both run one
anti-diagonal sweep (``csrc/local.cu``, one CUDA template) of

- ``T1 = max(f(A[i], B[j]) + max(max(T1, T2), T3)(i-1, j-1), 0)``
- ``T2 = max(max(T1(i, j-1) - gh, T2(i, j-1) - g), T3(i, j-1) - gh)``
- ``T3 = max(max(T1(i-1, j) - gh, T2(i-1, j) - gh), T3(i-1, j) - g)``

with T1 = 0 and T2 = T3 = -inf on row 0 and column 0, in float32 and the
JAX package's operation order (``ops/local.py`` ``_sw_single``). The JAX
source writes ``x - g - h``; XLA folds the two constants into one
subtraction of ``gh = g + h`` (rounded to float32), so the port subtracts
``gh`` too and agrees bit for bit at any parameters, dyadic or not.

Inputs are a bucket: ``a`` (B, m) and ``b`` (B, n) uint8 codes padded
with ``PAD_A``/``PAD_B`` and lengths ``la``/``lb`` (B,) int32. Every cell
of the bucket is computed; the best is taken over the pair's own cells
(1 <= i <= la, 1 <= j <= lb): the largest T1 (strict ``>``), then the
smallest diagonal i + j, then the smallest j, and (0, 0, 0) when no cell
is positive. ``best`` is (B, 3) float32 ``[value, end_i, end_j]``.

K9d also returns the direction bytes in the skew layout of the JAX
Pallas kernel: ``dirs`` (m+n+1, B, n+1) uint8, cell (i, j) of pair b at
``dirs[i + j, b, j]``, packing ``d1 | d2 << 2 | d3 << 4``. ``d1`` is 3
("the alignment starts here") when ``f + max3 > 0`` is false, else the
first argmax of T1, T2, T3 at (i-1, j-1); ``d2``/``d3`` are the first
argmax of their three candidates (tie order T1 >= T2 >= T3). The byte is
0 outside the interior (row 0, column 0, or i outside 0..m).

A CPU tensor goes to the plain PyTorch version beside each kernel; a CUDA
tensor launches the kernel or raises.
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
from cse305_parallel_sequence_alignment_torch.ops.rowcb import _argmax3

DIR_LOCAL_START = 3  # T1 direction code: the alignment starts at this cell
# dynamic shared memory above which the diagonal buffers go to global
# scratch
SMEM_LIMIT = 200 * 1024


def _shift(x):
    """Shift columns right by one (column j gets j-1), -inf at 0."""
    return torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)


def sw_fill_plain(a, b, la, lb, params, want_dirs):
    """Plain PyTorch K9s/K9d: an anti-diagonal loop over (B, n+1) tensors
    in the kernel's float32 order. Returns (best (B, 3), dirs or None)."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h  # float32, as XLA folds the JAX fill's two constants
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    jj = torch.arange(n + 1, device=dev)[None, :]
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    a32 = a.to(torch.int32)
    la_c = la.to(torch.int64)[:, None]
    lb_c = lb.to(torch.int64)[:, None]
    big = torch.tensor(n + 1, device=dev)

    negs = torch.full((B, n + 1), NEG_INF, dtype=f32, device=dev)
    p = (torch.where(jj == 0, zero, neg).expand(B, -1), negs, negs)  # d-1
    q = (negs, negs, negs)                                           # d-2
    bv = torch.zeros(B, dtype=f32, device=dev)
    bi = torch.zeros(B, dtype=torch.int64, device=dev)
    bj = torch.zeros(B, dtype=torch.int64, device=dev)
    dirs = None
    if want_dirs:
        dirs = torch.empty((m + n + 1, B, n + 1), dtype=torch.uint8,
                           device=dev)
        dirs[0] = 0
    for d in range(1, m + n + 1):
        ii = d - jj
        interior = (jj >= 1) & (ii >= 1) & (ii <= m)
        on_edge = ((ii == 0) | (jj == 0)) & (ii >= 0) & (ii <= m)
        av = a32.gather(1, (ii - 1).clamp(0, max(m - 1, 0)).expand(B, -1))
        fvec = torch.where(av == bext, match, mismatch)
        s1, s2, s3 = (_shift(x) for x in q)
        t1_open = fvec + torch.maximum(torch.maximum(s1, s2), s3)
        l1, l2, l3 = (_shift(x) for x in p)
        c2a, c2b, c2c = l1 - gh, l2 - g, l3 - gh
        c3a, c3b, c3c = p[0] - gh, p[1] - gh, p[2] - g
        t1 = torch.where(on_edge, zero,
                         torch.where(interior, torch.maximum(t1_open, zero),
                                     neg))
        t2 = torch.where(interior,
                         torch.maximum(torch.maximum(c2a, c2b), c2c), neg)
        t3 = torch.where(interior,
                         torch.maximum(torch.maximum(c3a, c3b), c3c), neg)
        # running best over the pair's own cells, earliest (d, j) on ties
        cand = torch.where(interior & (ii <= la_c) & (jj <= lb_c), t1, neg)
        cv = cand.max(dim=1).values
        cj = torch.where(cand == cv[:, None], jj, big).min(dim=1).values
        better = cv > bv
        bv = torch.where(better, cv, bv)
        bi = torch.where(better, d - cj, bi)
        bj = torch.where(better, cj, bj)
        if want_dirs:
            d1 = torch.where(t1_open > 0.0, _argmax3(s1, s2, s3),
                             DIR_LOCAL_START)
            d2 = _argmax3(c2a, c2b, c2c)
            d3 = _argmax3(c3a, c3b, c3c)
            packed = ((d1 << DIR_T1_SHIFT) | (d2 << DIR_T2_SHIFT)
                      | (d3 << DIR_T3_SHIFT))
            dirs[d] = torch.where(interior, packed, 0).to(torch.uint8)
        p, q = (t1, t2, t3), p
    best = torch.stack([bv, bi.to(f32), bj.to(f32)], dim=1)
    return best, dirs


def _check(a, b, la, lb):
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8 code tensors")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be (B, m) and (B, n)")
    B = a.shape[0]
    for name, v in (("la", la), ("lb", lb)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (a, b, la, lb):
        if v.device != a.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def _launch_geometry(n):
    """(threads, diagonal buffer bytes) for a bucket of width n: whole
    warps, each thread at most ceil((n+1) / 1024) columns."""
    ncol = n + 1
    per = -(-ncol // 1024)     # columns a thread
    cols = -(-ncol // per)     # threads that cover the row
    return -(-cols // 32) * 32, 9 * 4 * ncol


@functools.lru_cache(maxsize=None)
def _entry(fn_name, n_ptrs):
    """ctypes entry point of csrc/local.cu's fills: n_ptrs pointers, then
    B, m, n, threads, shared bytes, g, h, match, mismatch, stream."""
    fn = getattr(_build.cuda_library("local"), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    return fn


def _launch(fn_name, a, b, la, lb, params, want_dirs):
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    threads, buf_bytes = _launch_geometry(n)
    smem = 512  # the block's best-value reduction
    scratch = None
    if smem + buf_bytes <= SMEM_LIMIT:
        smem += buf_bytes
    else:
        scratch = torch.empty(B * buf_bytes, dtype=torch.uint8, device=dev)
    best = torch.empty((B, 3), dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr()]
    dirs = None
    if want_dirs:
        dirs = torch.empty((m + n + 1, B, n + 1), dtype=torch.uint8,
                           device=dev)
        ptrs.append(dirs.data_ptr())
    ptrs += [best.data_ptr(), scratch.data_ptr() if scratch is not None
             else None]
    fn = _entry(fn_name, len(ptrs))
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = fn(*ptrs, B, m, n, threads, smem, g, h, match, mismatch,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, fn_name)
    return best, dirs


def sw_score(a, b, la, lb, params):
    """K9s: local score fill of a bucket, best (B, 3) float32."""
    _check(a, b, la, lb)
    if a.device.type == "cpu":
        return sw_fill_plain(a, b, la, lb, params, want_dirs=False)[0]
    best, _ = _launch("sw_score", a, b, la, lb, params, False)
    sw_score.launches += 1
    return best


def sw_dirs(a, b, la, lb, params):
    """K9d: local fill of a bucket with skew-layout dirs; returns (best
    (B, 3) float32, dirs (m+n+1, B, n+1) uint8), both on a's device."""
    _check(a, b, la, lb)
    if a.device.type == "cpu":
        return sw_fill_plain(a, b, la, lb, params, want_dirs=True)
    out = _launch("sw_dirs", a, b, la, lb, params, True)
    sw_dirs.launches += 1
    return out


sw_score.launches = 0
sw_dirs.launches = 0
