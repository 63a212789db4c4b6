"""Run-length traceback walk on the device (K2) and its host replays.

``rle_walk`` is the port of ``_walk_core_rle`` with layout "row"
(cse305_parallel_sequence_alignment_tpu/ops/device_walk.py:124): it walks
the K1 dirs16+runs array ``(rows, B, cols)`` back from each pair's end
cell and ships only one uint16 entry per round, ``(op+1) | R << 2``: in
T1 a round takes the cell's diagonal run of R code-0 steps plus one step
of the after-run code; in T2/T3 one step. With ``band_lo`` it walks the
K12d band layout instead, layout ``("band", w_lo)`` of the same JAX
function (:163-164): cell (i, j) at column ``j - i + band_lo``, clamped
into the array. The kernel is ``csrc/walk.cu``; a CPU tensor goes to the
plain PyTorch version.

``group_walk_rle`` (K2') is the port of the Pallas walk ``pallas_walk_rle``
(ops/pallas_walk.py:146, kernel ``_walk_group_kernel`` :41): the same
stream, laid out per pair ``(B, R_pad)`` int32 with each pair's own round
count, cut at R_pad rounds, one thread walking G pairs interleaved
(``csrc/walk.cu`` ``group_walk_kernel<G>``).

``step_walk`` (K2s) is the port of the single-step ``_walk_core`` (same
file, :35) in the layouts "row" and "skew", as ``_device_walk`` (:266)
runs it: over uint8 dirs, the K1' row layout ``dirs[i, b, j]`` or the K5
skew layout ``dirs[i + j, b, j]``, one step of ``code + 1`` a dependent
read; its kernel is ``csrc/walk.cu``. ``walk_batch_device`` (:311) is K2s,
then ``replay_steps`` (``replay_ops`` of the steps taken), then the chains.

``expand_rle_ops`` and ``replay_ops`` are numpy copies of the JAX
package's host replays (same file, :241-263 and :338-439). The fused
path replays with the native library (native/walker.py); ``replay_ops``
replays the K2s op streams of the non-fused routes.

``local_walk`` (K9w) is the local-mode walk: the port of ``_walk_core``
(same file, :35) as ``walk_local_batch_device`` (:442) uses it, over the
K9d skew dirs ``(m+n+1, B, n+1)`` uint8, with that function's stop rule
on the card; its kernel is in ``csrc/local.cu``. The native library
turns its table streams into chains (native/walker.py ``local_build``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    DIR_T2_SHIFT,
    DIR_T3_SHIFT,
)
from cse305_parallel_sequence_alignment_torch.ops import _build


def rle_walk_plain(dirs, la, lb, t0, max_rounds, band_lo=None):
    """Plain PyTorch K2: (entries (max_rounds, B) uint16, used (1,) int32).

    One gather per round for all pairs; stops when every pair reached an
    edge, so ``used`` is the exact number of rounds any pair took."""
    nrows, B, ncols = dirs.shape
    dev = dirs.device
    bidx = torch.arange(B, device=dev)
    i, j, t = la.to(torch.int64), lb.to(torch.int64), t0.to(torch.int64)
    done = (i == 0) | (j == 0)
    ent = torch.zeros((max_rounds, B), dtype=torch.int32, device=dev)
    r = 0
    d16 = dirs.view(torch.int16)  # few PyTorch kernels take uint16
    while r < max_rounds and not bool(done.all()):
        col = j if band_lo is None else j - i + band_lo
        word = d16[i.clamp(0, nrows - 1), bidx,
                   col.clamp(0, ncols - 1)].to(torch.int32) & 0xFFFF
        is_run = t == 1
        shift = torch.where(t == 2, DIR_T2_SHIFT, DIR_T3_SHIFT)
        k = torch.where(is_run, (word >> 8) & 255, 0)
        op = torch.where(is_run, (word >> 6) & 3, (word >> shift) & 3)
        di = torch.where(is_run, k + 1, (t == 3).to(torch.int32))
        dj = torch.where(is_run, k + 1, (t == 2).to(torch.int32))
        active = ~done
        ent[r] = torch.where(active, (op + 1) | (k << 2), 0)
        t = torch.where(active, op + 1, t)
        i = torch.where(active, i - di, i)
        j = torch.where(active, j - dj, j)
        done = done | (i <= 0) | (j <= 0)
        r += 1
    used = torch.tensor([r], dtype=torch.int32, device=dev)
    return ent.to(torch.int16).view(torch.uint16), used


def row_pitch(dirs):
    """The row pitch (elements) of (rows, B, cols) dirs whose rows may be
    padded, as K1's are (ops/rowcb.py ``dirs_pitch``): cell (r, b, c) at
    ``(r * B + b) * pitch + c``; raise on any other layout."""
    rows, B, cols = dirs.shape
    pitch = dirs.stride(1) if B > 1 else max(dirs.stride(0), cols)
    if (dirs.stride(2) != 1 or pitch < cols
            or (rows > 1 and dirs.stride(0) != B * pitch)
            or (B > 1 and dirs.stride(1) != pitch)):
        raise ValueError(f"dirs must be row-major with padded rows, got "
                         f"strides {dirs.stride()} for {tuple(dirs.shape)}")
    return pitch


def _check(dirs, la, lb, t0, max_rounds, pairs=None):
    """Raise on walk inputs the kernels do not take; ``pairs`` walked may
    be fewer than the dirs' pair axis holds (K2'). The dirs may have a
    row pitch (``row_pitch``)."""
    if dirs.dtype != torch.uint16 or dirs.dim() != 3:
        raise TypeError("dirs must be a (rows, B, cols) uint16 tensor")
    row_pitch(dirs)
    B = dirs.shape[1] if pairs is None else pairs
    if B > dirs.shape[1]:
        raise ValueError(f"{B} pairs to walk, dirs hold {dirs.shape[1]}")
    for name, v in (("la", la), ("lb", lb), ("t0", t0)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (dirs, la, lb, t0):
        if v.device != dirs.device:
            raise ValueError("all inputs must be on one device")
    for v in (la, lb, t0):
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if max_rounds < 1:
        raise ValueError("max_rounds must be >= 1")
    if dirs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dirs.device}")


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/walk.cu."""
    fn = _build.cuda_library("walk").rle_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    return fn


def rle_walk(dirs, la, lb, t0, max_rounds, band_lo=None):
    """K2: run-length walk of every pair from (la, lb) in table t0, over
    row-layout dirs, or band-layout dirs of lower width ``band_lo``. The
    dirs may have a row pitch: K1's are a view of (rows, B, pitch).

    Returns (entries (max_rounds, B) uint16, zero past each pair's last
    round, and used (1,) int32, the largest round count), both on the
    dirs' device; nothing is synchronised. Band-layout launches count in
    ``rle_walk.band_launches``, row-layout ones in ``rle_walk.launches``."""
    _check(dirs, la, lb, t0, max_rounds)
    if band_lo is not None and band_lo < 0:
        raise ValueError(f"band_lo must be >= 0, got {band_lo}")
    if dirs.device.type == "cpu":
        return rle_walk_plain(dirs, la, lb, t0, max_rounds, band_lo)
    nrows, B, ncols = dirs.shape
    dev = dirs.device
    ent = torch.zeros((max_rounds, B), dtype=torch.int16,
                      device=dev).view(torch.uint16)
    used = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(dirs.data_ptr(), la.data_ptr(), lb.data_ptr(),
                       t0.data_ptr(), ent.data_ptr(), used.data_ptr(), B,
                       nrows, ncols, row_pitch(dirs), max_rounds,
                       -1 if band_lo is None else band_lo,
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rle_walk")
    if band_lo is None:
        rle_walk.launches += 1
    else:
        rle_walk.band_launches += 1
    return ent, used


rle_walk.launches = 0
rle_walk.band_launches = 0

GROUPS = (1, 2, 4, 8)  # pairs a thread csrc/walk.cu's K2' is built for


def group_walk_rle_plain(dirs, la, lb, t0, R_pad):
    """Plain PyTorch K2': (entries (B, R_pad') int32, used (B,) int32),
    R_pad' = R_pad rounded up to 128; see ``group_walk_rle``."""
    nrows, _, ncols = dirs.shape
    B = la.shape[0]
    R = -(-R_pad // 128) * 128
    dev = dirs.device
    bidx = torch.arange(B, device=dev)
    i, j, t = la.to(torch.int64), lb.to(torch.int64), t0.to(torch.int64)
    rd = torch.zeros(B, dtype=torch.int64, device=dev)
    alive = (i > 0) & (j > 0)
    ent = torch.zeros((B, R), dtype=torch.int32, device=dev)
    d16 = dirs.view(torch.int16)  # few PyTorch kernels take uint16
    while bool(alive.any()):
        word = d16[i.clamp(0, nrows - 1), bidx,
                   j.clamp(0, ncols - 1)].to(torch.int64) & 0xFFFF
        run = t == 1
        shift = torch.where(t == 2, DIR_T2_SHIFT,
                            torch.where(t == 3, DIR_T3_SHIFT, 0))
        k = torch.where(run, (word >> 8) & 255, 0)
        op = torch.where(run, (word >> 6) & 3, (word >> shift) & 3)
        di = torch.where(run, k + 1, (t == 3).to(torch.int64))
        dj = torch.where(run, k + 1, (t == 2).to(torch.int64))
        live = bidx[alive]
        ent[live, rd[alive]] = ((op + 1) | (k << 2))[alive].to(torch.int32)
        i = torch.where(alive, i - di, i)
        j = torch.where(alive, j - dj, j)
        t = torch.where(alive, op + 1, t)
        rd = torch.where(alive, rd + 1, rd)
        alive = alive & (i > 0) & (j > 0) & (rd < R)
    ent[bidx, rd.clamp(max=R - 1)] = 0
    return ent, rd.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _group_entry():
    """ctypes entry point of csrc/walk.cu's grouped walk (K2')."""
    fn = _build.cuda_library("walk").group_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def group_walk_rle(dirs, la, lb, t0, R_pad, G=8):
    """K2': the run-length walk of ``pallas_walk_rle``, per pair.

    Walks pair b of row-layout dirs16+runs ``dirs`` (rows, Bd, cols),
    Bd >= B = len(la), from (la, lb) in table t0 and returns (entries (B,
    R_pad') int32, R_pad' = R_pad rounded up to 128, with pair b's
    entries ``(op+1) | R << 2`` in row b, and used (B,) int32, its round
    count). A walk stops on row 0 or column 0 or after R_pad' rounds; a 0
    terminator then goes to ``entries[b, min(used, R_pad' - 1)]``, so a
    walk cut at R_pad' loses its last entry, as in the TPU kernel. Past the
    terminator the entries are 0 (the TPU kernel leaves its scratch
    there). ``G`` (1, 2, 4 or 8) pairs a thread, interleaved; it changes no
    result. Nothing is synchronised."""
    _check(dirs, la, lb, t0, R_pad, pairs=la.shape[0])
    if G not in GROUPS:
        raise ValueError(f"G {G}: pick from {GROUPS}")
    if dirs.device.type == "cpu":
        return group_walk_rle_plain(dirs, la, lb, t0, R_pad)
    nrows, Bd, ncols = dirs.shape
    B = la.shape[0]
    R = -(-R_pad // 128) * 128
    dev = dirs.device
    ent = torch.zeros((B, R), dtype=torch.int32, device=dev)
    used = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _group_entry()(dirs.data_ptr(), la.data_ptr(), lb.data_ptr(),
                             t0.data_ptr(), ent.data_ptr(), used.data_ptr(),
                             B, Bd, nrows, ncols, row_pitch(dirs), R, G,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"group_walk(G={G})")
    group_walk_rle.launches += 1
    return ent, used


group_walk_rle.launches = 0


LAYOUTS = ("row", "skew")


def step_walk_plain(dirs, la, lb, t0, max_steps, layout="row"):
    """Plain PyTorch K2s: (ops (max_steps, B) uint8, used (1,) int32).

    One gather per step for all pairs; ``ops[k, b]`` is 1 + the code of
    pair b's k-th visited cell for its table then, 0 past its walk. A
    pair whose start lies outside ``dirs`` or whose table is not 1-3
    takes no step, as in the kernel."""
    nrows, B, ncols = dirs.shape
    dev = dirs.device
    bidx = torch.arange(B, device=dev)
    i, j, t = la.to(torch.int64), lb.to(torch.int64), t0.to(torch.int64)
    r = i + j if layout == "skew" else i
    bad = (i < 0) | (j < 0) | (j >= ncols) | (r >= nrows) | (t < 1) | (t > 3)
    done = (i == 0) | (j == 0) | bad
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    k = 0
    while k < max_steps and not bool(done.all()):
        # a finished pair's read is discarded; cell (0, 0) keeps it inside
        r = torch.where(done, 0, i + j if layout == "skew" else i)
        byte = dirs[r, bidx, torch.where(done, 0, j)].to(torch.int64)
        code = (byte >> (2 * (torch.where(done, 1, t) - 1))) & 3
        active = ~done
        ops[k] = torch.where(active, code + 1, 0).to(torch.uint8)
        i = torch.where(active, i - ((t == 1) | (t == 3)).to(torch.int64), i)
        j = torch.where(active, j - ((t == 1) | (t == 2)).to(torch.int64), j)
        t = torch.where(active, torch.where(code >= 3, 1, code + 1), t)
        done = done | (i == 0) | (j == 0)
        k += 1
    used = torch.tensor([k], dtype=torch.int32, device=dev)
    return ops, used


@functools.lru_cache(maxsize=None)
def _step_entry():
    """ctypes entry point of csrc/walk.cu's single-step walk."""
    fn = _build.cuda_library("walk").step_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    return fn


def step_walk(dirs, la, lb, t0, max_steps, layout="row"):
    """K2s: single-step walk of every pair from (la, lb) in table t0 over
    uint8 dirs ``(rows, B, cols)`` in the ``layout`` "row" (K1') or
    "skew" (K5).

    Returns (ops (max_steps, B) uint8, zero past each pair's walk, and
    used (1,) int32, the longest walk), both on the dirs' device; nothing
    is synchronised. A pair stops on row 0 or column 0 and one that starts
    there writes nothing. A pair whose start cell lies outside ``dirs``
    or whose table is not 1-3 writes nothing either (checking it here
    would wait for the fill that made t0): ``replay_steps`` refuses its
    empty walk. Row-layout launches count in ``step_walk.launches``,
    skew-layout ones in ``step_walk.skew_launches``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: pick from {LAYOUTS}")
    if dirs.dtype != torch.uint8 or dirs.dim() != 3:
        raise TypeError("dirs must be a (rows, B, cols) uint8 tensor")
    B = dirs.shape[1]
    for name, v in (("la", la), ("lb", lb), ("t0", t0)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (dirs, la, lb, t0):
        if v.device != dirs.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if max_steps < 1:
        raise ValueError("max_steps must be >= 1")
    if dirs.device.type == "cpu":
        return step_walk_plain(dirs, la, lb, t0, max_steps, layout)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    dev = dirs.device
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    used = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _step_entry()(dirs.data_ptr(), la.data_ptr(), lb.data_ptr(),
                            t0.data_ptr(), ops.data_ptr(), used.data_ptr(),
                            B, dirs.shape[0], dirs.shape[2], max_steps,
                            int(layout == "skew"),
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"step_walk({layout})")
    if layout == "skew":
        step_walk.skew_launches += 1
    else:
        step_walk.launches += 1
    return ops, used


step_walk.launches = 0
step_walk.skew_launches = 0


def walk_batch_device(dirs, la, lb, tables, mode="parity", offsets=None,
                      chunk=None, layout="skew"):
    """Global-mode chains of every pair: K2s on the dirs' device over the
    uint8 ``dirs`` in ``layout``, then ``replay_steps`` on the host, as
    the aligner's "rowdirs" and "wavefront" routes run them.

    ``la``, ``lb`` and ``tables`` are (B,) end coordinates and end tables;
    ``mode`` "parity" (quirk B1) or "full"; ``offsets`` per-pair (id_a,
    id_b), indexed by ``chunk``. Returns a list of chains (lists of
    (i, j, t), quirk-B2 zeros)."""
    la, lb, tables = (np.ascontiguousarray(x, np.int32)
                      for x in (la, lb, tables))
    max_steps = int(la.max(initial=0)) + int(lb.max(initial=0)) + 1
    dev = dirs.device
    ops, used = step_walk(dirs, *(torch.from_numpy(x).to(dev)
                                  for x in (la, lb, tables)), max_steps,
                          layout)
    tt, ii, jj, lens = replay_steps(ops.cpu().numpy(), int(used[0]), la, lb,
                                    tables, mode, offsets, chunk)
    return [list(zip(ii[r, : lens[r]].tolist(), jj[r, : lens[r]].tolist(),
                     tt[r, : lens[r]].tolist()))
            for r in range(len(la))]


def replay_steps(ops, used, la, lb, tables, mode="parity", offsets=None,
                 chunk=None):
    """Host half of the K2s routes: ``replay_ops`` of the first ``used``
    steps of a host copy of ``step_walk``'s ops (max_steps, B). Returns
    (tt, ii, jj, lens) as ``replay_ops`` does; a pair whose walk never
    reached row 0 or column 0 raises."""
    return replay_ops(np.ascontiguousarray(ops[:used].T),
                      np.asarray(la, np.int64), np.asarray(lb, np.int64),
                      np.asarray(tables, np.int64), mode=mode,
                      offsets=offsets, chunk=chunk)


def local_walk_plain(dirs, ei, ej, max_steps):
    """Plain PyTorch K9w: (ops (max_steps, B) uint8, used (1,) int32).

    One gather per step for all pairs; ``ops[k, b]`` is the table (1-3)
    of pair b's k-th chain point counted from its end cell, 0 past the
    chain, and ``used`` the longest chain."""
    nrows, B, ncols = dirs.shape
    dev = dirs.device
    bidx = torch.arange(B, device=dev)
    i, j = ei.to(torch.int64), ej.to(torch.int64)
    t = torch.ones(B, dtype=torch.int64, device=dev)
    active = (i > 0) & (j > 0) & (j < ncols) & (i + j < nrows)
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)

    def load(i, j):
        return dirs[(i + j).clamp(0, nrows - 1), bidx,
                    j.clamp(0, ncols - 1)].to(torch.int64)

    byte = load(i, j)
    k = 0
    while k < max_steps and bool(active.any()):
        code = (byte >> (2 * (t - 1))) & 3
        active = active & ~((t == 1) & (code == 3))  # a start: not aligned
        ops[k] = torch.where(active, t, 0).to(torch.uint8)
        pi = i - (t != 2).to(torch.int64)
        pj = j - (t != 3).to(torch.int64)
        pt = code + 1
        active = active & (pi > 0) & (pj > 0)  # stop before an edge ...
        nbyte = load(pi, pj)
        active = active & ~((pt == 1) & ((nbyte & 3) == 3))  # ... or a start
        i = torch.where(active, pi, i)
        j = torch.where(active, pj, j)
        t = torch.where(active, pt, t)
        byte = torch.where(active, nbyte, byte)
        k += 1
    used = (ops != 0).sum(dim=0).max() if B else torch.zeros((), device=dev)
    return ops, used.to(torch.int32).reshape(1)


@functools.lru_cache(maxsize=None)
def _local_entry():
    """ctypes entry point of csrc/local.cu's walk."""
    fn = _build.cuda_library("local").local_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def local_walk(dirs, ei, ej, max_steps):
    """K9w: local walk of every pair from its end cell (ei, ej) in T1
    over the K9d skew dirs ``(m+n+1, B, n+1)`` uint8.

    Returns (ops (max_steps, B) uint8, used (1,) int32) on the dirs'
    device, nothing synchronised: ``ops[k, b]`` is the table (1-3) of the
    k-th chain point from the end, 0 past the chain. The walk stops as
    ``walk_local_batch_device`` of the JAX package does: on a start code,
    or before a predecessor on row 0 / column 0 or a start cell."""
    if dirs.dtype != torch.uint8 or dirs.dim() != 3:
        raise TypeError("dirs must be a (m+n+1, B, n+1) uint8 tensor")
    B = dirs.shape[1]
    for name, v in (("ei", ei), ("ej", ej)):
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (dirs, ei, ej):
        if v.device != dirs.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if max_steps < 1:
        raise ValueError("max_steps must be >= 1")
    if dirs.device.type == "cpu":
        return local_walk_plain(dirs, ei, ej, max_steps)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    nrows, B, ncols = dirs.shape
    dev = dirs.device
    ops = torch.zeros((max_steps, B), dtype=torch.uint8, device=dev)
    used = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _local_entry()(dirs.data_ptr(), ei.data_ptr(), ej.data_ptr(),
                             ops.data_ptr(), used.data_ptr(), B, nrows,
                             ncols, max_steps,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "local_walk")
    local_walk.launches += 1
    return ops, used


local_walk.launches = 0


def expand_rle_ops(entries, max_steps):
    """Expand (B, Rn) RLE walk entries to the dense per-step op stream
    ((B, <=max_steps) uint8) of the single-step walk.

    entry = op | k << 2 -> k steps of op 1 (the diagonal run) followed
    by one step of op; op == 0 = round not taken."""
    entries = np.asarray(entries)
    B, Rn = entries.shape
    op = (entries & 3).astype(np.uint8)
    k = (entries >> 2).astype(np.int64)
    lens = np.where(op > 0, k + 1, 0)
    ends = np.cumsum(lens, axis=1)
    total = ends[:, -1] if Rn else np.zeros(B, np.int64)
    L = min(int(total.max(initial=0)), max_steps) if B else 0
    L = max(L, 1)
    dense = np.zeros((B, L), np.uint8)
    pos = np.arange(L, dtype=np.int64)[None, :]
    dense[pos < total[:, None]] = 1
    idx = ends - 1
    valid = (op > 0) & (idx < L)
    bflat = np.broadcast_to(np.arange(B)[:, None], idx.shape)[valid]
    dense[bflat, idx[valid]] = op[valid]
    return dense


def replay_ops(ops, la, lb, tables, mode="parity", offsets=None,
               chunk=None):
    """Vectorised host replay of per-step walk op codes (global mode).

    Positions follow from the table sequence (t_0 = the end table, t_k =
    ops[k-1]) by two cumulative sums. Returns (tt, ii, jj, lens) with
    pair r's chain at [r, :lens[r]] in start->end order, quirk-B2 zeros
    and offsets applied; ``mode`` "parity" drops the edge-entry point
    (quirk B1), "full" emits the forced edge runs to the corner.
    """
    B, L = ops.shape
    if offsets is not None and chunk is not None:
        offs = np.asarray([offsets[chunk[r]] for r in range(B)], np.int32)
        id_a, id_b = offs[:, 0:1], offs[:, 1:2]
    else:
        id_a = id_b = np.zeros((B, 1), np.int32)

    T = np.empty((B, L + 1), np.int32)
    T[:, 0] = tables
    T[:, 1:] = ops
    mv = T[:, :-1]
    di = (mv == 1) | (mv == 3)
    dj = (mv == 1) | (mv == 2)
    pos_i = np.empty((B, L + 1), np.int32)
    pos_j = np.empty((B, L + 1), np.int32)
    pos_i[:, 0] = la
    pos_j[:, 0] = lb
    np.subtract(la[:, None].astype(np.int32),
                np.cumsum(di, axis=1, dtype=np.int32), out=pos_i[:, 1:])
    np.subtract(lb[:, None].astype(np.int32),
                np.cumsum(dj, axis=1, dtype=np.int32), out=pos_j[:, 1:])
    # first index whose ENTRY position sits on an edge = steps taken
    edge = (pos_i == 0) | (pos_j == 0)
    reached = edge.any(axis=1)
    if not reached.all():
        bad = np.nonzero(~reached)[0]
        raise RuntimeError(
            f"walk never reached a DP edge for pairs {bad[:8].tolist()} "
            f"(a start outside the dirs, corrupt dirs or undersized "
            f"max_steps {L})")
    steps = np.argmax(edge, axis=1)
    pts_i = np.where(T == 2, 0, pos_i + id_a)
    pts_j = np.where(T == 3, 0, pos_j + id_b)

    if mode == "parity":
        # out[r, q] = src[r, K_r - 1 - q], q < K_r
        lens = steps.astype(np.int64)
        cap = int(lens.max(initial=0)) if B else 0
        q = np.arange(max(cap, 1))
        idx = lens[:, None] - 1 - q[None, :cap]
        valid = idx >= 0
        idx = np.where(valid, idx, 0)
        tt = np.where(valid, np.take_along_axis(T, idx, axis=1), 0)
        ii = np.where(valid, np.take_along_axis(pts_i, idx, axis=1), 0)
        jj = np.where(valid, np.take_along_axis(pts_j, idx, axis=1), 0)
        return tt, ii, jj, lens
    cap = L + 1 + int(la.max(initial=0) + lb.max(initial=0))
    tt = np.zeros((B, cap), np.int64)
    ii = np.zeros((B, cap), np.int64)
    jj = np.zeros((B, cap), np.int64)
    lens = np.zeros(B, np.int64)
    for r in range(B):
        K = int(steps[r])
        t_r = T[r, K - 1:: -1] if K else T[r, :0]
        i_r = pts_i[r, K - 1:: -1] if K else pts_i[r, :0]
        j_r = pts_j[r, K - 1:: -1] if K else pts_j[r, :0]
        # forced edge runs from the stop position (I, J) to the corner;
        # the chain-order first element (the rev-list's last appended
        # point) is dropped (quirk B1), so the edge-entry point stays in
        si, sj = int(pos_i[r, K]), int(pos_j[r, K])
        parts_t = [np.array([T[r, K]], np.int64), t_r]
        parts_i = [np.array([pts_i[r, K]], np.int64), i_r]
        parts_j = [np.array([pts_j[r, K]], np.int64), j_r]
        if sj > 0:  # gap-in-A run along row 0 (chain order: j 0..sj-1)
            parts_t.insert(0, np.full(sj, 2, np.int64))
            parts_i.insert(0, np.zeros(sj, np.int64))
            parts_j.insert(0, np.arange(0, sj, dtype=np.int64) + id_b[r, 0])
        if si > 0:  # gap-in-B run along column 0
            parts_t.insert(0, np.full(si, 3, np.int64))
            parts_i.insert(0, np.arange(0, si, dtype=np.int64) + id_a[r, 0])
            parts_j.insert(0, np.zeros(si, np.int64))
        t_r = np.concatenate(parts_t)[1:]
        i_r = np.concatenate(parts_i)[1:]
        j_r = np.concatenate(parts_j)[1:]
        lens[r] = t_r.shape[0]
        tt[r, : lens[r]] = t_r
        ii[r, : lens[r]] = i_r
        jj[r, : lens[r]] = j_r
    return tt, ii, jj, lens
