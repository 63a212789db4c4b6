"""ctypes bindings for the host replay and render (``tsalib.cpp``).

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
    return lib


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
