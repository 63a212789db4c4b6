"""Anti-diagonal fills: K3 (global), K10s (semi-global), K11s (overlap)
score fills, and K5 (global skew dirs).

One sweep over the anti-diagonals d = 1..m+n of every pair of a bucket
(``csrc/diag.cu``, one CUDA template with a mode parameter), in the
order of the JAX package's anti-diagonal kernels:

- ``T1 = f(A[i], B[j]) + max(max(T1, T2), T3)(i-1, j-1)``
- ``T2 = max(max(T1, T3)(i, j-1) - gh, T2(i, j-1) - g)``
- ``T3 = max(max(T1, T2)(i-1, j) - gh, T3(i-1, j) - g)``

T2 is computed directly, with no prefix max, and ``gh = g + h`` is
rounded to float32: the JAX source writes ``x - g - h`` and XLA folds
the two constants into one subtraction. The modes differ only in their
boundaries and in what they return:

- ``global`` (K3, the port of ``_score_kernel``,
  cse305_parallel_sequence_alignment_tpu/ops/pallas_fill.py:216): row 0,
  column 0 and the corner from each pair's start type (``_row0_t2``,
  ``_col0_t3``, ``_diag0`` of that file); returns the finals (B, 3)
  float32 (T1, T2, T3) at (la, lb).
- ``semiglobal`` (K10s, the port of ``_sg_score_kernel``,
  ops/pallas_semiglobal.py:100): T1 = 0 on row 0, T3 = -h - g*i on
  column 0; the best over the last query row (la, 1..lb), largest value,
  then smallest column, then table T1 > T2 > T3. Returns (B, 4) float32
  [score, end_table, end_i = la, end_j]; (-inf, 1, la, 0) when lb = 0.
- ``overlap`` (K11s, the port of the XLA wavefront ``overlap_score_batch``,
  ops/overlap.py:124, which the JAX ``OverlapBatchAligner.score_batch``
  runs on every backend): T1 = 0 on row 0 and column 0; the best over
  the last row or the last column, largest value, then earliest
  anti-diagonal, then table, then column. Returns (B, 4) float32
  [score, end_table, end_i, end_j]; (-inf, 1, 0, 0) when no cell
  qualifies (both sides empty).

Inputs are a bucket: ``a`` (B, m) and ``b`` (B, n) uint8 codes padded
with ``PAD_A``/``PAD_B``, lengths ``la``/``lb`` and, in global mode, the
start types ``st``, each (B,) int32. A CPU tensor goes to the plain
PyTorch version; a CUDA tensor launches the kernel or raises.

K5 ``skew_dirs_fill`` (the port of ``_dirs_kernel``, ops/pallas_fill.py
:310, with per-pair start types) is the global sweep storing one uint8
direction code a cell in the skew layout ``dirs[i + j, b, j]``: d1 the
argmax of the (i-1, j-1) triple, d2 of ``T1 - gh, T2 - g, T3 - gh`` at
(i, j-1), d3 of ``T1 - gh, T2 - gh, T3 - g`` at (i-1, j), tie order T1 >=
T2 >= T3, 0 outside the interior (row 0, column 0, rows past the
bucket's m), as ``_diag_step`` writes them. Its values are K3's: the max
of candidates rounded one by one equals the rounded max.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cse305_parallel_sequence_alignment_torch.core import NEG_INF, PAD_B
from cse305_parallel_sequence_alignment_torch.ops import _build

# dynamic shared memory above which the diagonal buffers go to global
# scratch
SMEM_LIMIT = 200 * 1024
_BIG = 1 << 30


def _shift(x):
    """Shift columns right by one (column j gets j-1), -inf at 0."""
    return torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)


def _first_min(key, mask):
    """Smallest ``key`` where ``mask`` holds, per row; ``_BIG`` if none."""
    return torch.where(mask, key, _BIG).min(dim=1).values


def _argmax3(c1, c2, c3):
    """First index of the max of three (tie order T1 >= T2 >= T3)."""
    return torch.where((c1 >= c2) & (c1 >= c3), 0,
                       torch.where(c2 >= c3, 1, 2))


def diag_fill_plain(a, b, la, lb, st, params, mode, want_dirs=False):
    """Plain PyTorch K3/K10s/K11s: an anti-diagonal loop over (B, n+1)
    tensors in the kernel's float32 order (see the module docstring).
    With ``want_dirs`` (global mode, K5) returns (skew dirs (m+n+1, B,
    n+1) uint8, finals)."""
    code = _build.MODES[mode]
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h  # float32, as XLA folds the JAX fills' x - g - h
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    jj = torch.arange(n + 1, device=dev)[None, :]
    jg = g * jj.to(f32)
    bext = torch.cat([torch.full((B, 1), PAD_B, dtype=torch.int32,
                                 device=dev), b.to(torch.int32)], dim=1)
    a32 = a.to(torch.int32)
    la_c = la.to(torch.int64)[:, None]
    lb_c = lb.to(torch.int64)[:, None]
    stc = st.to(torch.int32)[:, None]
    negs = torch.full((B, n + 1), NEG_INF, dtype=f32, device=dev)

    # diagonal 0: the corner cell
    at0 = jj == 0
    if code == 0:
        c1 = torch.where((stc == 1) | (stc == -1), zero, neg)
        c2 = torch.where(stc == -2, zero, neg)
        c3 = torch.where(stc == -3, zero, neg)
        p = tuple(torch.where(at0, c, neg) for c in (c1, c2, c3))
        row0_2 = torch.where(stc == -2, -jg,
                             torch.where((stc == 1) | (stc == 3), neg,
                                         -h - jg))
        fin = torch.where((la_c + lb_c == 0), torch.cat(
            [t[:, :1] for t in p], dim=1), neg)
    else:
        p = (torch.where(at0, zero, neg).expand(B, -1), negs, negs)
    q = (negs, negs, negs)
    if want_dirs:
        dirs = torch.zeros((m + n + 1, B, n + 1), dtype=torch.uint8,
                           device=dev)
    if code == 1:  # the last query row, captured as each cell passes
        rv = [negs] * 3
    if code == 2:  # best (value, diagonal, table, column)
        bv = torch.full((B,), NEG_INF, dtype=f32, device=dev)
        bd = torch.zeros(B, dtype=torch.int64, device=dev)
        bt = torch.ones(B, dtype=torch.int64, device=dev)
        bj = torch.zeros(B, dtype=torch.int64, device=dev)
    for d in range(1, m + n + 1):
        ii = d - jj
        interior = (jj >= 1) & (ii >= 1) & (ii <= m)
        valid = (ii >= 0) & (ii <= m)
        on_row0 = ii == 0
        on_col0 = at0 & (ii >= 1) & (ii <= m)
        av = a32.gather(1, (ii - 1).clamp(0, max(m - 1, 0)).expand(B, -1))
        fvec = torch.where(av == bext, match, mismatch)
        p1, p2, p3 = p
        q1, q2, q3 = q
        if want_dirs:
            # K5 compares the rounded candidates, as _diag_step does
            s1, s2, s3 = _shift(q1), _shift(q2), _shift(q3)
            c2 = (_shift(p1) - gh, _shift(p2) - g, _shift(p3) - gh)
            c3 = (p1 - gh, p2 - gh, p3 - g)
            t1 = fvec + torch.maximum(torch.maximum(s1, s2), s3)
            t2 = torch.maximum(torch.maximum(c2[0], c2[1]), c2[2])
            t3 = torch.maximum(torch.maximum(c3[0], c3[1]), c3[2])
            dirs[d] = torch.where(interior, _argmax3(s1, s2, s3)
                                  | (_argmax3(*c2) << 2)
                                  | (_argmax3(*c3) << 4), 0).to(torch.uint8)
        else:
            t1 = fvec + _shift(torch.maximum(torch.maximum(q1, q2), q3))
            t2 = _shift(torch.maximum(torch.maximum(p1, p3) - gh, p2 - g))
            t3 = torch.maximum(torch.maximum(p1, p2) - gh, p3 - g)
        t1 = torch.where(interior, t1, neg)
        t2 = torch.where(interior, t2, neg)
        t3 = torch.where(interior, t3, neg)
        df = torch.tensor(float(d), dtype=f32, device=dev)
        if code == 0:
            col0_3 = torch.where(stc == -3, -(g * df),
                                 torch.where((stc == 1) | (stc == 2), neg,
                                             -h - g * df))
            t2 = torch.where(on_row0, row0_2, t2)
            t3 = torch.where(on_col0, col0_3, t3)
        elif code == 1:
            t1 = torch.where(on_row0, zero, t1)
            t3 = torch.where(on_col0, -h - g * df, t3)
        else:
            t1 = torch.where((on_row0 | at0) & valid, zero, t1)
        t1 = torch.where(valid, t1, neg)
        t2 = torch.where(valid, t2, neg)
        t3 = torch.where(valid, t3, neg)
        if code == 0:
            cap = (la_c + lb_c == d)[:, 0]
            vals = torch.cat([t.gather(1, lb_c) for t in (t1, t2, t3)],
                             dim=1)
            fin = torch.where(cap[:, None], vals, fin)
        elif code == 1:
            onrow = (ii == la_c) & (jj >= 1) & (jj <= lb_c)
            rv = [torch.where(onrow, t, r) for t, r in zip((t1, t2, t3),
                                                            rv)]
        else:
            onend = (((ii == la_c) & (jj >= 1) & (jj <= lb_c))
                     | ((jj == lb_c) & (ii >= 1) & (ii <= la_c)))
            cvs = [torch.where(onend, t, neg).max(dim=1).values
                   for t in (t1, t2, t3)]
            cv = torch.maximum(torch.maximum(cvs[0], cvs[1]), cvs[2])
            ct = torch.where(cvs[0] >= cv, 1,
                             torch.where(cvs[1] >= cv, 2, 3))
            row = torch.where((ct == 1)[:, None], t1,
                              torch.where((ct == 2)[:, None], t2, t3))
            cj = _first_min(jj.expand(B, -1), onend & (row == cv[:, None]))
            better = cv > bv
            bv = torch.where(better, cv, bv)
            bt = torch.where(better, ct, bt)
            bd = torch.where(better, d, bd)
            bj = torch.where(better, cj, bj)
        p, q = (t1, t2, t3), p
    if code == 0:
        return (dirs, fin) if want_dirs else fin
    if code == 1:
        # value desc, then column asc, then table T1 > T2 > T3
        cv = torch.maximum(torch.maximum(rv[0].max(dim=1).values,
                                         rv[1].max(dim=1).values),
                           rv[2].max(dim=1).values)
        jx = jj.expand(B, -1)
        cjs = [_first_min(jx, r == cv[:, None]) for r in rv]
        cj = torch.minimum(torch.minimum(cjs[0], cjs[1]), cjs[2])
        ct = torch.where(cjs[0] == cj, 1, torch.where(cjs[1] == cj, 2, 3))
        return torch.stack([cv, ct.to(f32), la.to(f32), cj.to(f32)], dim=1)
    return torch.stack([bv, bt.to(f32), (bd - bj).to(f32), bj.to(f32)],
                       dim=1)


def score_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K3: finals (B, 3) float32."""
    return diag_fill_plain(a, b, la, lb, st, params, "global")


def skew_dirs_fill_plain(a, b, la, lb, st, params):
    """Plain PyTorch K5: (skew dirs (m+n+1, B, n+1) uint8, finals (B, 3))."""
    return diag_fill_plain(a, b, la, lb, st, params, "global", want_dirs=True)


def _launch_geometry(n):
    """(threads, diagonal buffer bytes) for a bucket of width n: whole
    warps, each thread at most ceil((n+1) / 1024) columns."""
    ncol = n + 1
    per = -(-ncol // 1024)
    cols = -(-ncol // per)
    return -(-cols // 32) * 32, 9 * 4 * ncol


@functools.lru_cache(maxsize=None)
def _entry(name="diag_fill"):
    """ctypes entry point of csrc/diag.cu: ``diag_fill`` (7 pointers,
    then mode, B, m, n, threads, shared bytes, g, h, match, mismatch,
    stream) or ``skew_dirs`` (8 pointers, the dirs after out, then the
    same without the mode)."""
    fn = getattr(_build.cuda_library("diag"), name)
    fn.restype = ctypes.c_int
    if name == "diag_fill":
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] + [ctypes.c_float] * 4
                       + [ctypes.c_void_p])
    return fn


def _launch(a, b, la, lb, st, params, mode, want_dirs=False):
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    threads, buf_bytes = _launch_geometry(n)
    smem = 1024  # the block's best-value reduction
    scratch = None
    if smem + buf_bytes <= SMEM_LIMIT:
        smem += buf_bytes
    else:
        scratch = torch.empty(B * buf_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty((B, 3 if mode == "global" else 4),
                      dtype=torch.float32, device=dev)
    g, h, match, mismatch = params.astuple()
    scr = scratch.data_ptr() if scratch is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if want_dirs:  # K5 writes the cells with 0 <= i <= m alone
            dirs = torch.zeros((m + n + 1, B, n + 1), dtype=torch.uint8,
                               device=dev)
            err = _entry("skew_dirs")(
                a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
                st.data_ptr(), out.data_ptr(), dirs.data_ptr(), scr, B, m,
                n, threads, smem, g, h, match, mismatch, stream)
            _build.check(err, "skew_dirs")
            return dirs, out
        err = _entry()(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), out.data_ptr(), scr, _build.MODES[mode], B, m,
            n, threads, smem, g, h, match, mismatch, stream)
    _build.check(err, f"diag_fill({mode})")
    return out


def _fill(a, b, la, lb, st, params, mode):
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return diag_fill_plain(a, b, la, lb, st, params, mode)
    return _launch(a, b, la, lb, st, params, mode)


def score_fill(a, b, la, lb, st, params):
    """K3: global score fill of a bucket, finals (B, 3) float32."""
    out = _fill(a, b, la, lb, st, params, "global")
    if a.device.type == "cuda":
        score_fill.launches += 1
    return out


def semiglobal_score(a, b, la, lb, params):
    """K10s: semi-global score fill of a bucket, (B, 4) float32 [score,
    end_table, end_i, end_j]."""
    out = _fill(a, b, la, lb, torch.zeros_like(la), params, "semiglobal")
    if a.device.type == "cuda":
        semiglobal_score.launches += 1
    return out


def overlap_score(a, b, la, lb, params):
    """K11s: overlap score fill of a bucket, (B, 4) float32 [score,
    end_table, end_i, end_j]."""
    out = _fill(a, b, la, lb, torch.zeros_like(la), params, "overlap")
    if a.device.type == "cuda":
        overlap_score.launches += 1
    return out


def skew_dirs_fill(a, b, la, lb, st, params):
    """K5: global anti-diagonal fill of a bucket storing one uint8 code
    ``d1 | d2 << 2 | d3 << 4`` a cell in the skew layout, cell (i, j) of
    pair b at ``dirs[i + j, b, j]``, 0 on row 0, column 0 and past row m;
    returns (dirs (m+n+1, B, n+1) uint8, finals (B, 3)), the finals K3's
    bit for bit."""
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return skew_dirs_fill_plain(a, b, la, lb, st, params)
    out = _launch(a, b, la, lb, st, params, "global", want_dirs=True)
    skew_dirs_fill.launches += 1
    return out


score_fill.launches = 0
skew_dirs_fill.launches = 0
semiglobal_score.launches = 0
overlap_score.launches = 0
