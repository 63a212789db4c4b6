"""Row-step attribution probes: P-perm, P-stripes, P-knock, P-ablate,
P-lane0, P-sweep and P-attrib2, the K3' row step (ops/rowcb.py
``rowscan_score_fill``) with its parts laid out, interleaved, knocked out
or varied, to time each part.

Each is the port of a TPU probe kernel that ran a variant of
``_rowscan_kernel`` (cse305_parallel_sequence_alignment_tpu/ops/
pallas_fill.py:750) through ``pallas_call``:

- ``perm_finals`` (P-perm), ``perm_kernel`` of scripts/probes/
  attrib3_r5.py:108 (through ``run_perm`` :156): the finals of K3' at start
  type -1, every la = m, in one of two thread layouts, ``"contiguous"``
  (each thread owns a run of columns: the TPU's permuted-lane layout, in
  which each lane owned a run) or ``"strided"`` (column j on thread j mod
  T, the prefix max by log2(W) shift-max sweeps: the TPU's plain layout);
  both give K3''s finals;
- ``stripes_fill`` (P-stripes), ``_kernel`` of scripts/kern_stripes.py:33
  (through ``run_case`` :92): the row step with A's character fixed at 65,
  ``stripes`` pairs interleaved in one CTA;
- ``knock_fill`` (P-knock), ``_kernel`` of scripts/kern_attrib.py:37
  (through ``run_case`` :95): the row step with pieces knocked out
  (``charcol``, ``bcast``, ``prefix``, ``prefix7``, ``shift1``);
- ``ablate_finals`` (P-ablate), ``variant_kernel`` of scripts/probes/
  attrib_r5.py:65 (through ``run_variant`` :156): the finals under one of
  ``ABLATE``'s modes (row_step :83-116), or the raw floors ``chain`` and
  ``indep`` at K wide operations a row (:118-137);
- ``lane0_fill`` (P-lane0), ``_kernel`` of scripts/kern_scalar.py:37
  (through ``run_case`` :95): column 0's T3 as the variants A to E;
- ``sweep_fill`` (P-sweep), ``_kernel`` of scripts/kern_sweep.py:32
  (through ``run_case`` :70): the row step with A's character fixed at 65
  (``charcol``) over every column of ``b_ext``, C columns a thread;
- ``ablate_finals`` under ``ATTRIB2``'s modes and ``FLOORS2``'s floors
  (P-attrib2 and its floors), ``variant_kernel`` of scripts/probes/
  attrib2_r5.py:100 (through ``run_variant`` :190): the prefix max's
  unaligned (``pm_unaligned``, the ``prefix7`` window) or aligned
  (``pm_aligned``) strides alone, the scan or the halo wholly through
  shared memory (``pm_roll``, ``shift_roll``: the TPU's ``pltpu.roll``
  lowerings of the full step), the full step at two CTAs an SM
  (``full_b32``), and the floors ``live`` (K dependent operations over L
  live arrays), ``chain_i32`` and ``chain_i16``.

The fills return the last row's max(max(T1, T2), T3), (B, W) float32, of
every pair; the finals are (T1, T2, T3) at (m, lb), (B, 3). The TPU
kernels stored columns 0-127 of eight pairs, or three lanes of each pair;
a row step reads only columns at or left of its own, so those windows are
these arrays' first columns. Codes are uint8: ``a`` (B, m) holds A's
characters (row i reads ``a[:, i-1]``), ``b_ext`` (B, W) every column's
character of B, column 0 included; the finals take ``b`` (B, n) and put
PAD_B at column 0 (W = n + 1), as ``rowscan_prep`` does. Each fill runs
exactly ``rows`` (or m) rows; the TPU kernels ran ``(m // unroll) *
unroll``.

The probes' parameters are the scripts' own: g = 1, h = 2, match 1,
mismatch 0 (``perm_finals`` takes any). Under them every value is an
integer, a half, a quarter or +-inf, so the kernels, the plain twins and
the JAX kernels agree bit for bit; ``nofb`` makes NaN (fb = 1 + 0 *
P1(i-1, 0), and P1 is -inf at column 0 from row 1 on), which every max
propagates, as XLA's does.

The kernels are ``csrc/rowprobe.cu`` (``replica_kernel`` and
``floor_kernel``), built for the instantiations in ``INSTANCES`` and
``FLOOR_INSTANCES``. A CPU tensor goes to the plain PyTorch twin beside
each wrapper; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.rowcb import _shift

# the probes' parameters (hard-coded in the TPU scripts)
PROBE_PARAMS = ScoringParams(g=1.0, h=2.0, match=1.0, mismatch=0.0)
ROWS = 2048  # M of scripts/kern_stripes.py, kern_scalar.py, kern_sweep.py
COLUMNS = 4  # columns a thread in csrc/rowprobe.cu (P-sweep: also 8, 16)
# csrc/rowprobe.cu's KNOCK bits and LANE0 forms
KNOCK = {"charcol": 1, "bcast": 2, "shift1": 4, "prefix": 8, "prefix7": 16,
         "nochar": 32, "nofb": 64, "not3": 128, "noboundary": 256,
         "aligned": 512, "smemscan": 1024, "smemhalo": 2048,
         "twocta": 4096}
LANE0 = {"K3P": 0, "A": 1, "B": 2, "C": 3, "D": 4, "E": 5}
LAYOUTS = {"contiguous": 0, "strided": 1}
# P-ablate's row_step modes as knock-outs (attrib_r5.py:83-116)
ABLATE = {"full": (), "nochar": ("nochar",), "noshift": ("shift1",),
          "nochar_noshift": ("nochar", "shift1"), "nofb": ("nofb",),
          "nopm": ("prefix",), "not3": ("not3",),
          "noboundary": ("noboundary",)}
# P-ablate's raw floors: K for each (attrib_r5.py:118-137)
FLOORS = {"chain": (4, 8, 16, 34), "indep": (8, 16, 32)}
# P-attrib2's modes as knock-outs and variants (attrib2_r5.py:50-86,
# :234-239): pm_unaligned is prefix7's window, pm_roll and shift_roll move
# the scan's and the halo's values through shared memory, full_b32 is the
# full step at two CTAs an SM
ATTRIB2 = {"full": (), "pm_roll": ("smemscan",),
           "shift_roll": ("smemhalo",), "pm_unaligned": ("prefix7",),
           "pm_aligned": ("aligned",), "full_b32": ("twocta",)}
# P-attrib2's floors: (K, L) for each (attrib2_r5.py:131-166, :240-247)
FLOORS2 = {"live": ((16, 2), (16, 4), (16, 6), (16, 8)),
           "chain_i32": ((16, 0),), "chain_i16": ((16, 0),)}
# csrc/rowprobe.cu's floor_kernel MODEs
FLOOR_MODES = {"indep": 0, "chain": 1, "live": 2, "chain_i32": 3,
               "chain_i16": 4}


def knock_bits(knock):
    """The KNOCK bit mask of an iterable of knock-out names."""
    bits = 0
    for name in knock:
        if name not in KNOCK:
            raise ValueError(f"knock-out {name!r}: pick from {sorted(KNOCK)}")
        bits |= KNOCK[name]
    return bits


# the replica_kernel instantiations of csrc/rowprobe.cu: (knock bits,
# lane0, layout, pairs a CTA, unroll, columns a thread);
# tests/test_torch_rowprobe.py holds this list equal to the source's
INSTANCES = frozenset(
    [(0, 0, lay, 1, u, 4) for lay in (0, 1) for u in (4, 8)]         # P-perm
    + [(0, 1, 0, s, u, 4) for s, u in ((1, 4), (2, 4), (4, 4), (8, 4),
                                       (4, 2), (4, 8))]               # stripes
    + [(0, 0, 0, 1, 16, 4)]
    + [(knock_bits(k), 0, 0, 1, 4, 4) for k in (
        ("charcol",), ("charcol", "bcast"), ("prefix",), ("prefix7",),
        ("shift1",), ("prefix", "shift1"),
        ("charcol", "bcast", "prefix", "shift1"))]                    # knock
    + [(knock_bits(k), 0, 0, 1, 4, 4) for k in ABLATE.values()]      # ablate
    + [(0, LANE0[x], 0, 1, u, 4) for x, u in (
        ("B", 4), ("C", 4), ("D", 4), ("E", 4), ("B", 8), ("C", 8))]  # lane0
    + [(KNOCK["charcol"], 0, 0, 1, u, c) for u in (1, 4, 16)
       for c in (4, 8, 16)]                                            # sweep
    + [(knock_bits(k), 0, 0, 1, 4, 4) for k in ATTRIB2.values()])    # attrib2
# its floor_kernel instantiations: (mode, K, live arrays)
FLOOR_INSTANCES = frozenset(
    [(FLOOR_MODES[k], K, 0) for k, Ks in FLOORS.items() for K in Ks]
    + [(FLOOR_MODES[k], K, L) for k, KLs in FLOORS2.items()
       for K, L in KLs])


def _neg(dev):
    return torch.tensor(NEG_INF, dtype=torch.float32, device=dev)


def _prefix_max(x, nanp):
    """Inclusive prefix max over columns; with ``nanp`` a NaN spreads to
    every column at or right of it, as the TPU's shift-max sweeps
    (``jnp.maximum``) spread it."""
    pm = torch.cummax(x, dim=1).values
    if nanp:
        pm = torch.where(torch.cumsum(torch.isnan(x), dim=1) > 0,
                         float("nan"), pm)
    return pm


def _window_max(x, width=128):
    """``_lane_prefix_max(x, width)``: the max over each column and the
    width - 1 to its left, by the same shift-max sweeps."""
    W = x.shape[1]
    s = 1
    while s < width:
        k = min(s, W)
        x = torch.maximum(x, torch.cat(
            [torch.full_like(x[:, :k], NEG_INF), x[:, :W - k]], dim=1))
        s *= 2
    return x


def _aligned_max(x, stride=128):
    """The aligned strides of ``_lane_prefix_max`` alone: at column j the
    max over columns j, j - stride, j - 2 stride, ..."""
    B, W = x.shape
    q = -(-W // stride)
    pad = torch.full((B, q * stride - W), NEG_INF, dtype=x.dtype,
                     device=x.device)
    lanes = torch.cat([x, pad], dim=1).view(B, q, stride)
    return torch.cummax(lanes, dim=1).values.reshape(B, q * stride)[:, :W]


def replica_plain(a, bext, rows, knock=(), lane0="K3P",
                  params=PROBE_PARAMS, lb=None):
    """Plain PyTorch replica_kernel: ``rows`` rows of the K3' row step over
    (B, W) tensors, with the ``knock`` pieces out and column 0 in the
    ``lane0`` form; the last row's max3 (B, W), or with ``lb`` the finals
    (B, 3) at (rows, lb)."""
    bits = knock_bits(knock)
    B, W = bext.shape
    dev = bext.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h
    neg = _neg(dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    j = torch.arange(W, device=dev)
    jg = g * j.to(f32)
    lane0m = (j == 0)[None, :]
    b32 = bext.to(torch.int32)
    nanp = bool(bits & KNOCK["nofb"])
    shift = not bits & KNOCK["shift1"]
    noboundary = bool(bits & KNOCK["noboundary"])
    sel12 = lane0 == "K3P" and not noboundary
    col0_on = lane0 != "D" and not noboundary

    p1 = torch.where(lane0m, zero, neg).expand(B, W)
    p2 = torch.where(lane0m, neg, -h - jg).expand(B, W)
    p3 = torch.full((B, W), NEG_INF, dtype=f32, device=dev)
    colc = -h
    for i in range(1, rows + 1):
        fi = torch.tensor(float(i), dtype=f32, device=dev)
        if lane0 == "C":
            colc = colc - g
        col0 = (torch.tensor(-5.0, dtype=f32, device=dev) if lane0 == "B"
                else colc if lane0 == "C" else -h - g * fi)
        if lane0 == "E":
            ac = b32[:, i - 1:i]
        elif lane0 != "K3P" or bits & (KNOCK["charcol"] | KNOCK["bcast"]):
            ac = 65
        elif bits & KNOCK["nochar"]:
            ac = 65 + (i & 3)
        else:
            ac = a[:, i - 1:i].to(torch.int32)
        if nanp:
            fb = one + zero * p1[:, 0:1]
        else:
            fb = torch.where(b32 == ac, match, mismatch)
        mp12 = torch.maximum(p1, p2)
        mx = torch.maximum(mp12, p3)
        t1 = fb + (_shift(mx, NEG_INF) if shift else mx)
        t3 = (p3 - g if bits & KNOCK["not3"]
              else torch.maximum(mp12 - gh, p3 - g))
        if sel12:
            t1 = torch.where(lane0m, neg, t1)
        if col0_on:
            t3 = torch.where(lane0m, col0, t3)
        m13 = torch.maximum(t1, t3)
        if shift:
            m13 = _shift(m13, NEG_INF)
        omega = (jg + m13) - gh
        if bits & KNOCK["prefix"]:
            pm = omega
        elif bits & KNOCK["prefix7"]:
            pm = _window_max(omega)
        elif bits & KNOCK["aligned"]:
            pm = _aligned_max(omega)
        else:
            pm = _prefix_max(omega, nanp)
        t2 = pm - jg
        if sel12:
            t2 = torch.where(lane0m, neg, t2)
        p1, p2, p3 = t1, t2, t3
    if lb is None:
        return torch.maximum(torch.maximum(p1, p2), p3).contiguous()
    idx = lb.to(torch.int64)[:, None]
    return torch.cat([t.expand(B, W).gather(1, idx) for t in (p1, p2, p3)],
                     dim=1)


def _to_int(x, bits):
    """float32 to int``bits`` as XLA converts, saturating (-inf to the
    least value), the integers kept in int64."""
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return x.to(torch.float64).clamp(lo, hi).to(torch.int64)


def floor_plain(lb, W, rows, kind, K, params=PROBE_PARAMS, L=0):
    """Plain PyTorch floor_kernel: ``rows`` rows of K dependent (``chain``)
    or K/4 rounds of four independent (``indep``) operations, K dependent
    ones over ``L`` live arrays (``live``), or K dependent integer ones
    (``chain_i32``, ``chain_i16``: int16 adds wrap) from row 0; finals (B,
    3) at (rows, lb). The floors read no pair data, so every pair's row is
    the same: one row is stepped and read at each lb."""
    dev = lb.device
    f32 = torch.float32
    g, h = (torch.tensor(float(x), dtype=f32, device=dev)
            for x in params.astuple()[:2])
    neg = _neg(dev)
    half = torch.tensor(0.5, dtype=f32, device=dev)
    quarter = torch.tensor(0.25, dtype=f32, device=dev)
    j = torch.arange(W, device=dev)
    lane0m = (j == 0)[None, :]
    p1 = torch.where(lane0m, torch.tensor(0.0, dtype=f32, device=dev), neg)
    p2 = torch.where(lane0m, neg, -h - g * j.to(f32))
    p3 = torch.full((1, W), NEG_INF, dtype=f32, device=dev)
    for _ in range(rows):
        if kind == "chain":
            x = p1
            for _ in range(K):
                x = torch.maximum(x + half, p2)
            p1 = x
        elif kind == "live":
            arrs = [p1, p2, p3][:max(L, 1)]
            while len(arrs) < L:
                arrs.append(arrs[len(arrs) % 3] + torch.tensor(
                    0.125 * len(arrs), dtype=f32, device=dev))
            x = arrs[0]
            for k in range(K):
                x = torch.maximum(x + half, arrs[(k + 1) % L])
            p1 = x
        elif kind in ("chain_i32", "chain_i16"):
            bits = 16 if kind == "chain_i16" else 32
            x, y = _to_int(p1, bits), _to_int(p2, bits)
            for _ in range(K):
                # x + 1 wrapping in the type, as XLA's adds do
                x = torch.maximum((x + 1 + 2 ** (bits - 1)) % 2 ** bits
                                  - 2 ** (bits - 1), y)
            p1 = x.to(f32)
        else:
            ys = [p1, p2, p3, p1 + quarter]
            for _ in range(K // 4):
                ys = [y + half for y in ys]
            p1 = torch.maximum(torch.maximum(ys[0], ys[1]),
                               torch.maximum(ys[2], ys[3]))
    idx = lb.to(torch.int64)[None, :]
    return torch.stack([t[0].gather(0, idx[0]) for t in (p1, p2, p3)],
                       dim=1)


def _bext(b):
    """(B, n + 1) codes with PAD_B at column 0, as rowscan_prep lays b."""
    pad = torch.full((b.shape[0], 1), PAD_B, dtype=b.dtype, device=b.device)
    return torch.cat([pad, b], dim=1)


def perm_finals_plain(a, b, lb, params=PROBE_PARAMS):
    """Plain PyTorch P-perm (either layout): K3''s finals (B, 3) at start
    type -1, every la = m."""
    return replica_plain(a, _bext(b), a.shape[1], params=params, lb=lb)


def stripes_fill_plain(b_ext, rows=ROWS):
    """Plain PyTorch P-stripes (any number of stripes): the last row's
    max3 (B, W) with A's character 65."""
    return replica_plain(None, b_ext, rows, lane0="A")


def knock_fill_plain(a, b_ext, knock=()):
    """Plain PyTorch P-knock: the last row's max3 (B, W)."""
    return replica_plain(a, b_ext, a.shape[1], knock)


def ablate_finals_plain(a, b, lb, mode="full", K=0, L=0):
    """Plain PyTorch P-ablate and P-attrib2: finals (B, 3) under ``mode``."""
    if mode in FLOORS or mode in FLOORS2:
        return floor_plain(lb, b.shape[1] + 1, a.shape[1], mode, K, L=L)
    knock = ABLATE[mode] if mode in ABLATE else ATTRIB2[mode]
    return replica_plain(a, _bext(b), a.shape[1], knock, lb=lb)


def lane0_fill_plain(b_ext, mode, rows=ROWS):
    """Plain PyTorch P-lane0: the last row's max3 (B, W) under column 0's
    form ``mode`` (A to E)."""
    return replica_plain(None, b_ext, rows, lane0=mode)


def sweep_fill_plain(b_ext, rows=ROWS):
    """Plain PyTorch P-sweep (any columns a thread): the last row's max3
    (B, W) with A's character 65."""
    return replica_plain(None, b_ext, rows, ("charcol",))


@functools.lru_cache(maxsize=None)
def _entries():
    """ctypes entry points of csrc/rowprobe.cu: rowprobe_replica (4
    pointers, then B, m, W, ext, out_row, knock, lane0, layout, S, U, C,
    g, h, match, mismatch, stream), rowprobe_floor (2 pointers, then B, m,
    W, mode, K, L, g, h, stream) and rowprobe_occupancy (W, knock, lane0,
    layout, S, U, C, then a pointer to the int it writes)."""
    lib = _build.cuda_library("rowprobe")
    rep = lib.rowprobe_replica
    rep.restype = ctypes.c_int
    rep.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                    + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    flo = lib.rowprobe_floor
    flo.restype = ctypes.c_int
    flo.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                    + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    occ = lib.rowprobe_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return rep, flo, occ


def threads_for(W, pairs=1, columns=COLUMNS, knock=()):
    """Threads a CTA of csrc/rowprobe.cu for a row of W columns: whole
    warps of ``columns`` columns each, at most 1,024 (544 at four pairs a
    CTA or more, or at two CTAs an SM) at four columns a thread, 4,096 /
    ``columns`` at more."""
    threads = -(-(-(-W // columns)) // 32) * 32
    if columns != COLUMNS:
        cap = 4096 // columns
    else:
        cap = 544 if pairs > 2 or "twocta" in knock else 1024
    if W < 2 or threads > cap:
        raise ValueError(f"a row of {W} columns needs {threads} threads of "
                         f"{columns} columns; csrc/rowprobe.cu takes 2 to "
                         f"{cap * columns} at {pairs} pair(s) a CTA")
    return threads


def _instance(knock, lane0, layout, pairs, unroll, columns=COLUMNS):
    key = (knock_bits(knock), LANE0[lane0], LAYOUTS[layout], pairs, unroll,
           columns)
    if key not in INSTANCES:
        raise ValueError(f"csrc/rowprobe.cu has no instantiation for knock "
                         f"{sorted(knock)}, lane0 {lane0}, {layout}, "
                         f"{pairs} pair(s) a CTA, unroll {unroll}, "
                         f"{columns} columns a thread")
    return key


def occupancy(W, knock=(), lane0="K3P", layout="contiguous", pairs=1,
              unroll=4, columns=COLUMNS):
    """CTAs an SM of the current card holds of that instantiation at a row
    of W columns (CUDA's occupancy calculator on the built kernel)."""
    key = _instance(knock, lane0, layout, pairs, unroll, columns)
    threads_for(W, pairs, columns, knock)
    blocks = ctypes.c_int(0)
    _build.check(_entries()[2](W, *key, ctypes.addressof(blocks)),
                 f"rowprobe_occupancy{key}")
    return blocks.value


def _check_codes(*codes):
    dev = codes[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    B = codes[0].shape[0]
    for x in codes:
        if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[0] != B:
            raise ValueError(f"codes must be (B, .) uint8 with B = {B}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError("codes must be contiguous, on one device")


def _check_lb(lb, b):
    if lb.dtype != torch.int32 or tuple(lb.shape) != (b.shape[0],):
        raise ValueError(f"lb must be ({b.shape[0]},) int32, got "
                         f"{tuple(lb.shape)} {lb.dtype}")
    if lb.device != b.device or not lb.is_contiguous():
        raise ValueError("lb must be contiguous, on the codes' device")


def _launch(a, b, lb, rows, W, ext, key, params):
    """Launch replica_kernel; out (B, W) when ``lb`` is None, else (B, 3)."""
    B = b.shape[0]
    dev = b.device
    threads_for(W, key[3], key[5],
                [k for k, v in KNOCK.items() if key[0] & v])
    out = torch.full((B, W) if lb is None else (B, 3), NEG_INF,
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entries()[0](
            a.data_ptr() if a is not None else None, b.data_ptr(),
            lb.data_ptr() if lb is not None else None, out.data_ptr(), B,
            rows, W, ext, int(lb is None), *key, *params.astuple(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"rowprobe_replica{key}")
    return out


def perm_finals(a, b, lb, params=PROBE_PARAMS, layout="contiguous",
                unroll=4):
    """P-perm: K3''s finals (B, 3) of ``a`` (B, m) against ``b`` (B, n) at
    start type -1, every la = m, in the ``layout`` given (``"contiguous"``
    or ``"strided"``), the row loop unrolled ``unroll`` times (4 or 8)."""
    _check_codes(a, b)
    _check_lb(lb, b)
    key = _instance((), "K3P", layout, 1, unroll)
    if a.device.type == "cpu":
        return perm_finals_plain(a, b, lb, params)
    out = _launch(a, b, lb, a.shape[1], b.shape[1] + 1, 0, key, params)
    perm_finals.launches += 1
    return out


def stripes_fill(b_ext, stripes, unroll=4, rows=ROWS):
    """P-stripes: the last row's max3 (B, W) of ``rows`` row steps with A's
    character 65, ``stripes`` pairs (1, 2, 4 or 8) interleaved a CTA."""
    _check_codes(b_ext)
    key = _instance((), "A", "contiguous", stripes, unroll)
    if b_ext.device.type == "cpu":
        return stripes_fill_plain(b_ext, rows)
    out = _launch(None, b_ext, None, rows, b_ext.shape[1], 1, key,
                  PROBE_PARAMS)
    stripes_fill.launches += 1
    return out


def knock_fill(a, b_ext, knock=(), unroll=4):
    """P-knock: the last row's max3 (B, W) of ``a.shape[1]`` row steps of
    ``a`` (B, m) against ``b_ext`` (B, W) with the ``knock`` pieces out."""
    _check_codes(a, b_ext)
    key = _instance(knock, "K3P", "contiguous", 1, unroll)
    if a.device.type == "cpu":
        return knock_fill_plain(a, b_ext, knock)
    out = _launch(a, b_ext, None, a.shape[1], b_ext.shape[1], 1, key,
                  PROBE_PARAMS)
    knock_fill.launches += 1
    return out


def ablate_finals(a, b, lb, mode="full", K=0, L=0):
    """P-ablate and P-attrib2: finals (B, 3) of ``a`` (B, m) against ``b``
    (B, n), start type -1, every la = m, under an ``ABLATE`` or
    ``ATTRIB2`` mode, or the floor ``"chain"`` or ``"indep"`` at ``K``
    operations a row (``FLOORS``), or ``"live"`` (over ``L`` live
    arrays), ``"chain_i32"`` or ``"chain_i16"`` (``FLOORS2``), which read
    only the shape of ``a`` and ``b``. Launches count in ``launches``
    (``ABLATE``), ``attrib2_launches`` (the other ``ATTRIB2`` modes),
    ``floor_launches`` (``FLOORS``) and ``floor2_launches`` (``FLOORS2``)."""
    _check_codes(a, b)
    _check_lb(lb, b)
    if mode in FLOORS:
        if K not in FLOORS[mode] or L:
            raise ValueError(f"floor {mode} at K = {K}: csrc/rowprobe.cu has "
                             f"K of {FLOORS[mode]}")
    elif mode in FLOORS2:
        if (K, L) not in FLOORS2[mode]:
            raise ValueError(f"floor {mode} at (K, L) = ({K}, {L}): "
                             f"csrc/rowprobe.cu has K of {FLOORS2[mode]}")
    elif mode in ABLATE or mode in ATTRIB2:
        knock = ABLATE[mode] if mode in ABLATE else ATTRIB2[mode]
        key = _instance(knock, "K3P", "contiguous", 1, 4)
    else:
        raise ValueError(f"mode {mode!r}: pick from "
                         f"{sorted(set(ABLATE) | set(ATTRIB2))} or "
                         f"{sorted(set(FLOORS) | set(FLOORS2))}")
    if a.device.type == "cpu":
        return ablate_finals_plain(a, b, lb, mode, K, L)
    B, m = a.shape
    W = b.shape[1] + 1
    if mode not in FLOORS and mode not in FLOORS2:
        out = _launch(a, b, lb, m, W, 0, key, PROBE_PARAMS)
        if mode in ABLATE:
            ablate_finals.launches += 1
        else:
            ablate_finals.attrib2_launches += 1
        return out
    threads_for(W)
    out = torch.full((B, 3), NEG_INF, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entries()[1](
            lb.data_ptr(), out.data_ptr(), B, m, W, FLOOR_MODES[mode], K, L,
            *PROBE_PARAMS.astuple()[:2],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, f"rowprobe_floor({mode}, K = {K}, L = {L})")
    if mode in FLOORS:
        ablate_finals.floor_launches += 1
    else:
        ablate_finals.floor2_launches += 1
    return out


def lane0_fill(b_ext, mode, unroll=4, rows=ROWS):
    """P-lane0: the last row's max3 (B, W) of ``rows`` row steps (at most
    W) with column 0's T3 in the form ``mode``, A to E."""
    _check_codes(b_ext)
    if mode not in LANE0 or mode == "K3P":
        raise ValueError(f"lane-0 mode {mode!r}: pick from A, B, C, D, E")
    if rows > b_ext.shape[1]:
        raise ValueError(f"{rows} rows: mode E reads b's column i - 1 of "
                         f"{b_ext.shape[1]}")
    key = _instance((), mode, "contiguous", 1, unroll)
    if b_ext.device.type == "cpu":
        return lane0_fill_plain(b_ext, mode, rows)
    out = _launch(None, b_ext, None, rows, b_ext.shape[1], 1, key,
                  PROBE_PARAMS)
    lane0_fill.launches += 1
    return out


def sweep_fill(b_ext, columns=COLUMNS, unroll=4, rows=ROWS):
    """P-sweep: the last row's max3 (B, W) of ``rows`` row steps with A's
    character 65 over every column of ``b_ext`` (B, W), ``columns`` (4, 8
    or 16) columns a thread, the row loop unrolled ``unroll`` (1, 4 or 16)
    times."""
    _check_codes(b_ext)
    key = _instance(("charcol",), "K3P", "contiguous", 1, unroll, columns)
    if b_ext.device.type == "cpu":
        return sweep_fill_plain(b_ext, rows)
    out = _launch(None, b_ext, None, rows, b_ext.shape[1], 1, key,
                  PROBE_PARAMS)
    sweep_fill.launches += 1
    return out


perm_finals.launches = 0
stripes_fill.launches = 0
knock_fill.launches = 0
ablate_finals.launches = 0
ablate_finals.floor_launches = 0
ablate_finals.attrib2_launches = 0
ablate_finals.floor2_launches = 0
lane0_fill.launches = 0
sweep_fill.launches = 0
