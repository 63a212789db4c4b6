"""Long fills of any width (K6), their last rows and the crossing search.

``long_fill`` (K6) is the port of the TPU kernel ``_longrow_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_longrow.py:79): the
Gotoh score sweep of a bucket of jobs, each with its own start type,
returning either the finals (B, 3) float32 (T1, T2, T3) at (la, lb), the
contract of ``pallas_long_score_batch``, or with ``want_row`` the whole
row la of each job, (B, 3, n+1), the contract of
``_longrow_lastrow_fins`` and ``pallas_long_lastrow``. Its plain version
is K1's row sweep (ops/rowcb.py ``_sweep_plain``, global mode, ``gh``
folded as in K1) with a last-row capture; the kernel
(``csrc/longrow.cu``) cuts each job into column strips that pass
boundary records to their right neighbour, in place of the TPU's
host loop over 1024-lane column chunks.

``batched_crossings`` finds, for a whole bisection level of the balanced
partition at once, where an optimal path crosses each task's middle row:
one batched forward + reverse last-row fill (K6, or K7 for at most four
jobs of ``stair_threshold`` rows or more) and the combine on the device.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.rowcb import _sweep_plain

# most columns a thread owns; the strip width is threads * C
MAX_C = 8


def _row0_closed(n, g, h, start_type):
    """Closed-form DP row 0, (3, n+1) float32 (core.boundary_row0)."""
    out = np.full((3, n + 1), NEG_INF, np.float32)
    jf = np.arange(n + 1, dtype=np.float32)
    if start_type == -2:
        out[1] = -g * jf
    elif start_type not in (1, 3):
        out[1] = -h - g * jf
    out[0, 0] = 0.0 if start_type in (1, -1) else NEG_INF
    out[1, 0] = 0.0 if start_type == -2 else NEG_INF
    out[2, 0] = 0.0 if start_type == -3 else NEG_INF
    return out


def long_fill_plain(a, b, la, lb, st, params, want_row=False):
    """Plain PyTorch K6: finals (B, 3), or rows la (B, 3, n+1)."""
    return _sweep_plain(a, b, la, lb, st, params, want_dirs=False,
                        want_row=want_row)[1]


def strip_geometry(B, ncol, device):
    """(C, threads, nstrips) of B jobs of ``ncol`` columns: strips of
    ``threads * C`` columns, narrow enough that the B * nstrips CTAs are
    about two per SM (K6, K7 and K8 cut their columns so)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    threads = min(256, -(-ncol // 32) * 32)
    C = max(1, min(MAX_C, ncol * B // (2 * sms * threads)))
    return C, threads, -(-ncol // (threads * C))


def _geometry(B, n, device):
    """(C, threads, nstrips, shared bytes) of a K6/K7 launch."""
    C, threads, nstrips = strip_geometry(B, n + 1, device)
    W = threads * C
    smem = 128 + (W + 15) // 16 * 16 + 24 * (W + 1)
    return C, threads, nstrips, smem


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/longrow.cu."""
    fn = _build.cuda_library("longrow").long_fill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] + [ctypes.c_float] * 4
                   + [ctypes.c_void_p])
    return fn


def _launch(a, b, la, lb, st, params, want_row):
    """Launch csrc/longrow.cu on a CUDA bucket; returns its output."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    C, threads, nstrips, smem = _geometry(B, n, dev)
    f32 = torch.float32
    if want_row:
        out = torch.empty((B, 3, n + 1), dtype=f32, device=dev)
    else:
        out = torch.full((B, 3), NEG_INF, dtype=f32, device=dev)
    rec = torch.empty((B * nstrips * max(m, 1), 4), dtype=f32, device=dev)
    # the strips' row counters, then the CTA ticket
    cnt = torch.zeros(B * nstrips + 1, dtype=torch.int32, device=dev)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), out.data_ptr(), rec.data_ptr(), cnt.data_ptr(),
            cnt[B * nstrips:].data_ptr(), B, m, n, C, threads, nstrips,
            int(want_row), smem, g, h, match, mismatch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "long_fill")
    return out


def long_fill(a, b, la, lb, st, params, want_row=False):
    """K6: score sweep of a bucket of any width (see the module
    docstring); a (B, m) and b (B, n) uint8, la/lb/st (B,) int32."""
    _build.check_bucket(a, b, la, lb, st)
    if a.device.type == "cpu":
        return long_fill_plain(a, b, la, lb, st, params, want_row)
    out = _launch(a, b, la, lb, st, params, want_row)
    long_fill.launches += 1
    return out


long_fill.launches = 0


def _job_bucket(jobs, device):
    """Pad a list of (a_enc, b_enc, start_type) jobs into one bucket:
    (a, b, la, lb, st) tensors on ``device``."""
    J = len(jobs)
    m = max(len(x) for x, _, _ in jobs)
    n = max(len(y) for _, y, _ in jobs)
    a = np.full((J, m), PAD_A, np.uint8)
    b = np.full((J, n), PAD_B, np.uint8)
    la = np.zeros(J, np.int32)
    lb = np.zeros(J, np.int32)
    st = np.zeros(J, np.int32)
    for k, (x, y, t) in enumerate(jobs):
        la[k], lb[k], st[k] = len(x), len(y), t
        a[k, : len(x)] = x
        b[k, : len(y)] = y
    return [torch.from_numpy(v).to(device) for v in (a, b, la, lb, st)]


def long_lastrow(a_enc, b_enc, params=ScoringParams(), start_type=-1,
                 device="cuda"):
    """Last DP row (3, n+1) of one pair as a host array, through K6 (the
    contract of ``pallas_long_lastrow``): the serial crossing search's
    primitive (parallel/partition.py ``crossing_on_row``)."""
    a_enc = np.asarray(a_enc, np.uint8).reshape(-1)
    b_enc = np.asarray(b_enc, np.uint8).reshape(-1)
    if a_enc.shape[0] == 0:
        return _row0_closed(b_enc.shape[0], params.g, params.h, start_type)
    rows = long_fill(*_job_bucket([(a_enc, b_enc, start_type)], device),
                     params, want_row=True)
    return rows[0].cpu().numpy()


def combine_rows(rows, n_vec, h):
    """Crossing combine on the device over assembled last rows.

    ``rows``: (2C, 3, W) with row 2c the forward fill of crossing c and
    row 2c+1 its reverse fill; ``n_vec``: (C,) int64 widths. The optimal
    path crosses the middle row of crossing c at the argmax over (j, t) of
    T1+TR1, T2+TR2+h, T3+TR3+h (the gap-open refund when a gap is split),
    ties to the smallest j, then T1, T2, T3 (key j*4 + t). Returns (j,
    t, best) tensors of shape (C,)."""
    F, R = rows[0::2], rows[1::2]
    C, _, W = F.shape
    dev = rows.device
    jv = torch.arange(W, device=dev)[None, :]
    n_col = n_vec[:, None]
    ridx = (n_col - jv).clamp(0, W - 1)  # reverse column of j
    rrev = R.gather(2, ridx[:, None, :].expand(C, 3, W))
    hoff = torch.tensor([0.0, h, h], dtype=torch.float32,
                        device=dev)[None, :, None]
    tot = F + rrev + hoff
    tot = torch.where((jv <= n_col)[:, None, :], tot,
                      torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
    best = tot.amax(dim=(1, 2))
    key = jv[:, None, :] * 4 + torch.arange(3, device=dev)[None, :, None]
    key = torch.where(tot >= best[:, None, None], key, 1 << 30)
    kmin = key.reshape(C, -1).amin(dim=1)
    return kmin // 4, kmin % 4 + 1, best


def level_jobs(tasks):
    """The fill jobs [(a, b, start_type)] of a bisection level: each task
    (a_enc, b_enc, i_mid, start_type, end_type) adds a forward job
    (a[:i_mid], b, start_type) and a reverse job (a[i_mid:] reversed,
    b reversed, end_type)."""
    jobs = []
    for (a_e, b_e, i_mid, st, en) in tasks:
        a_e = np.asarray(a_e, np.uint8)
        b_e = np.asarray(b_e, np.uint8)
        jobs.append((a_e[:i_mid], b_e, st))
        jobs.append((a_e[i_mid:][::-1], b_e[::-1], en))
    return jobs


def stair_route(jobs, stair_threshold=4096):
    """True when a level's jobs go one by one through K7: at most four
    jobs, the longest of ``stair_threshold`` rows or more."""
    return (len(jobs) <= 4
            and max(len(x) for x, _, _ in jobs) >= stair_threshold)


def batched_crossings(tasks, params=ScoringParams(), device="cuda",
                      stair_threshold=4096):
    """Crossing points of a whole bisection level in one batched fill.

    ``tasks``: list of (a_enc, b_enc, i_mid, start_type, end_type), whose
    jobs are ``level_jobs(tasks)``. Under ``stair_route`` they go one by
    one through K7, which fills one job on the whole card; otherwise all
    jobs go through one K6 launch. Returns [(j, t, score)] per task, equal
    to ``crossing_on_row``'s."""
    if not tasks:
        return []
    jobs = level_jobs(tasks)
    dev = torch.device(device)
    if stair_route(jobs, stair_threshold):
        from cse305_parallel_sequence_alignment_torch.ops.longstair import (
            stair_lastrow_device,
        )
        rows = [stair_lastrow_device(
            torch.from_numpy(np.ascontiguousarray(x)).to(dev),
            torch.from_numpy(np.ascontiguousarray(y)).to(dev), t, params)
            for x, y, t in jobs]
        W = max(r.shape[1] for r in rows)
        rows = torch.stack([torch.nn.functional.pad(
            r, (0, W - r.shape[1]), value=NEG_INF) for r in rows])
    else:
        rows = long_fill(*_job_bucket(jobs, dev), params, want_row=True)
    n_vec = torch.tensor([len(t[1]) for t in tasks], dtype=torch.int64,
                         device=dev)
    jb, tb, best = (x.cpu().tolist() for x in
                    combine_rows(rows, n_vec, params.h))
    return list(zip(jb, tb, best))
