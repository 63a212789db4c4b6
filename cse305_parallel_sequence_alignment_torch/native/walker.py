"""ctypes bindings for the host replay, render, local build and
free-end (semi-global / overlap) build (``tsalib.cpp``).

The library is compiled from the port's ``csrc/tsalib.cpp`` (a copy of
the reference package's ``native/tsalib.cpp``) into the port's own
``_build/`` directory at first use (ops/_build.py). A library that cannot be built is an error: the
main path has no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from cse305_parallel_sequence_alignment_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.host_library()
    lib.tsa_render.restype = None
    lib.tsa_render.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.tsa_replay_rle_batch.restype = ctypes.c_int
    lib.tsa_replay_rle_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.tsa_local_build.restype = ctypes.c_int
    lib.tsa_local_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 4
    lib.tsa_free_end_build.restype = ctypes.c_int
    lib.tsa_free_end_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64] + [ctypes.c_void_p] * 4
    return lib


def local_build(ops, end_i, end_j, a, b):
    """Thread-parallel build of local chains, spans and CIGARs from the
    local walk's table streams (``ops`` (B, L): pair r's tables from its
    end cell back, 0 past the chain); ``a``/``b`` are the bucket's
    codes. Pair r's chain is ``(ii[r, k], jj[r, k], tt[r, k])`` for k <
    lens[r], start->end, with 0 for a gap's gapped side: the chains of
    the JAX package's ``walk_local_batch_device``, and the strings of
    ops/cigar.py's ``chain_to_cigar`` and ``chain_to_cigar_extended``.
    Returns (tt, ii, jj, lens, start_a, start_b, cigars, extended)."""
    lib = _lib()
    ops = np.ascontiguousarray(ops, np.uint8)
    B, L = ops.shape
    ei = np.ascontiguousarray(end_i, np.int64)
    ej = np.ascontiguousarray(end_j, np.int64)
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    cap, scap = max(L, 1), 2 * max(L, 1)
    tt = np.zeros((B, cap), np.int32)
    ii = np.zeros((B, cap), np.int64)
    jj = np.zeros((B, cap), np.int64)
    lens, sa, sb, nc, ne = (np.empty(B, np.int64) for _ in range(5))
    cig = np.empty((B, scap), np.uint8)
    ext = np.empty((B, scap), np.uint8)
    lib.tsa_local_build(
        ops.ctypes.data, L, ei.ctypes.data, ej.ctypes.data, a.ctypes.data,
        a.shape[1], b.ctypes.data, b.shape[1], B, cap, tt.ctypes.data,
        ii.ctypes.data, jj.ctypes.data, lens.ctypes.data, sa.ctypes.data,
        sb.ctypes.data, scap, cig.ctypes.data, nc.ctypes.data,
        ext.ctypes.data, ne.ctypes.data)
    return tt, ii, jj, lens, sa, sb, _strings(cig, nc), _strings(ext, ne)


def free_end_build(entries, end_i, end_j, end_t, a, b, mode):
    """Thread-parallel build of semi-global (``mode`` "semiglobal") or
    overlap ("overlap") chains, spans and CIGARs from the run-length
    walk's entries (``entries`` (B, Rn) uint16, entry = (op+1) | run <<
    2, pair r's walk started at (end_i[r], end_j[r]) in table end_t[r]);
    ``a``/``b`` are the bucket's codes. Pair r's chain is ``(ii[r, k],
    jj[r, k], tt[r, k])`` for k < lens[r], start->end with the end point
    included and 0 for a gap's gapped side, plus in semi-global mode the
    forced leading column-0 run: the chains of the JAX package's
    ``walk_semiglobal_batch_device`` / ``walk_overlap_batch_device``.
    ``spans[r]`` is (first A row, last A row, first B column, last B
    column) the chain consumes, 0 for none; the strings are ops/cigar.py's
    ``chain_to_cigar`` and ``chain_to_cigar_extended``. Returns (tt, ii,
    jj, lens, spans, cigars, extended); raises if a stream ends before row
    0 or column 0."""
    code = {"semiglobal": 1, "overlap": 2}[mode]
    lib = _lib()
    entries = np.ascontiguousarray(entries, np.uint16)
    B, Rn = entries.shape
    ei = np.ascontiguousarray(end_i, np.int64)
    ej = np.ascontiguousarray(end_j, np.int64)
    et = np.ascontiguousarray(end_t, np.int32)
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    cap = max(1, int(ei.max(initial=0) + ej.max(initial=0)))
    scap = 2 * cap
    # pair r's chain fills [r, :lens[r]]; the rest is never read
    tt = np.empty((B, cap), np.int32)
    ii = np.empty((B, cap), np.int64)
    jj = np.empty((B, cap), np.int64)
    lens, nc, ne = (np.empty(B, np.int64) for _ in range(3))
    spans = np.empty((B, 4), np.int64)
    cig = np.empty((B, scap), np.uint8)
    ext = np.empty((B, scap), np.uint8)
    lib.tsa_free_end_build(
        entries.ctypes.data, Rn, ei.ctypes.data, ej.ctypes.data,
        et.ctypes.data, a.ctypes.data, a.shape[1], b.ctypes.data,
        b.shape[1], B, code, cap, tt.ctypes.data, ii.ctypes.data,
        jj.ctypes.data, lens.ctypes.data, spans.ctypes.data, scap,
        cig.ctypes.data, nc.ctypes.data, ext.ctypes.data, ne.ctypes.data)
    if (lens < 0).any():
        bad = np.nonzero(lens < 0)[0]
        raise RuntimeError(
            f"RLE walk stream ended before row 0 or column 0 for pairs "
            f"{bad[:8].tolist()} (corrupt entries)")
    return tt, ii, jj, lens, spans, _strings(cig, nc), _strings(ext, ne)


def _strings(buf, lens):
    """Row r's first lens[r] bytes of a (B, cap) uint8 buffer, as str."""
    raw = buf.tobytes()
    cap = buf.shape[1]
    return [raw[r * cap: r * cap + n].decode("ascii")
            for r, n in enumerate(lens.tolist())]


def replay_rle(entries, la, lb, t0s, mode, offsets=None, chunk=None):
    """Thread-parallel replay of RLE walk entries ((B, Rn) uint16, entry
    = op | runlen << 2). Same output as ops/device_walk.py
    ``replay_ops(expand_rle_ops(...))``: quirk-B1/B2 chains, offsets,
    full mode's forced edge runs. Returns (tt, ii, jj, lens); raises if a
    stream ends before a DP edge."""
    if mode not in ("parity", "full"):
        raise ValueError(f"traceback mode {mode!r}: 'parity' or 'full'")
    lib = _lib()
    entries = np.ascontiguousarray(entries, np.uint16)
    B, Rn = entries.shape
    la = np.ascontiguousarray(la, np.int64)
    lb = np.ascontiguousarray(lb, np.int64)
    t0s = np.ascontiguousarray(t0s, np.int32)
    ida_p = idb_p = None
    if offsets is not None and chunk is not None:
        offs = np.asarray([offsets[chunk[r]] for r in range(B)], np.int64)
        ida = np.ascontiguousarray(offs[:, 0])
        idb = np.ascontiguousarray(offs[:, 1])
        ida_p, idb_p = ida.ctypes.data, idb.ctypes.data
    cap = int(la.max(initial=0) + lb.max(initial=0) + 2)
    if mode == "full":
        cap *= 2
    out_t = np.empty((B, cap), np.int32)
    out_i = np.empty((B, cap), np.int64)
    out_j = np.empty((B, cap), np.int64)
    out_len = np.empty((B,), np.int64)
    lib.tsa_replay_rle_batch(
        entries.ctypes.data, Rn, la.ctypes.data, lb.ctypes.data,
        t0s.ctypes.data, ida_p, idb_p, B, 1 if mode == "full" else 0, cap,
        out_t.ctypes.data, out_i.ctypes.data, out_j.ctypes.data,
        out_len.ctypes.data)
    if (out_len < 0).any():
        bad = np.nonzero(out_len < 0)[0]
        raise RuntimeError(
            f"RLE walk stream ended before a DP edge for pairs "
            f"{bad[:8].tolist()} (corrupt entries)")
    return out_t, out_i, out_j, out_len


def render(a_enc, b_enc, tt, ii, jj):
    """The reference's print_seq rows (main_alignment.cpp:32-55) of one
    chain in start->end order. Returns (row_a, row_b)."""
    lib = _lib()
    tt = np.ascontiguousarray(tt, np.int32)
    ii = np.ascontiguousarray(ii, np.int64)
    jj = np.ascontiguousarray(jj, np.int64)
    a_enc = np.ascontiguousarray(a_enc, np.uint8)
    b_enc = np.ascontiguousarray(b_enc, np.uint8)
    L = len(tt)
    row_a = np.empty(L, np.uint8)
    row_b = np.empty(L, np.uint8)
    lib.tsa_render(a_enc.ctypes.data, b_enc.ctypes.data, tt.ctypes.data,
                   ii.ctypes.data, jj.ctypes.data, L, row_a.ctypes.data,
                   row_b.ctypes.data)
    return row_a.tobytes().decode("ascii"), row_b.tobytes().decode("ascii")
