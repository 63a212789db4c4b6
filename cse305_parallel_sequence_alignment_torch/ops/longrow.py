"""Long fills of any width (K6), their last rows and the crossing search.

``long_fill`` (K6) is the port of the TPU kernel ``_longrow_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_longrow.py:79): the
Gotoh score sweep of a bucket of jobs, each with its own start type,
returning either the finals (B, 3) float32 (T1, T2, T3) at (la, lb), the
contract of ``pallas_long_score_batch``, or with ``want_row`` the whole
row la of each job, (B, 3, n+1), the contract of
``_longrow_lastrow_fins`` and ``pallas_long_lastrow``, with -inf in the
columns past the job's own lb. Its plain version is K1's row sweep
(ops/rowcb.py ``_sweep_plain``, global mode, ``gh`` folded as in K1) with
a last-row capture; the kernel (``csrc/longrow.cu`` ``strip_kernel<C>``)
runs each job as a skewed wavefront of lanes of C columns, in strips
that hand their edge records to the next, in place of the TPU's host
loop over 1024-lane column chunks. ``strip_plan`` picks its geometry.

``batched_crossings`` finds, for a whole bisection level of the balanced
partition at once, where an optimal path crosses each task's middle row:
one K6 launch fills every job's last row (forward and reverse) and the
combine runs on the device (``crossing_combine``). A crossing (j, t)
names the table t of the step by which the path leaves cell (i_mid, j);
the step that enters it may be of any table.

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
from cse305_parallel_sequence_alignment_torch.utils.observability import (
    count,
)

# most columns a thread owns in ``strip_geometry``'s strips
MAX_C = 8

# csrc/longrow.cu strip_kernel<C>: the columns a lane of each instance,
# and the warps a CTA the plan takes (the kernel takes up to 8; 3, 6 and
# 8 were never faster)
PLAN_C = (4, 8, 16, 24, 32)
PLAN_WARPS = (1, 2, 4)
# The kernel's time on an H100, fitted (least squares on the log, rms
# 5.4%) to 150 launches: 10 shapes of 1 to 32 jobs, C 4 to 32, 1, 2 or 4
# warps a CTA (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). A step
# costs STEP_US[0] + STEP_US[1] * C us with at most one warp on each
# scheduler, CROWD more for each further warp on the busiest one; the
# wavefront's path is m steps, RAMP steps a lane of a row and HOP a strip.
STEP_US = (0.1429, 0.01002)
CROWD = 0.2787
RAMP = 1.765
HOP = 2.113


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
    """Plain PyTorch K6: finals (B, 3), or rows la (B, 3, n+1), -inf past
    each job's lb."""
    out = _sweep_plain(a, b, la, lb, st, params, want_dirs=False,
                       want_row=want_row)[1]
    if want_row:
        past = (torch.arange(out.shape[2], device=out.device)[None, :]
                > lb.to(torch.int64)[:, None])
        out = out.masked_fill(past[:, None, :], NEG_INF)
    return out


def strip_geometry(B, ncol, device):
    """(C, threads, nstrips) of B jobs of ``ncol`` columns: strips of
    ``threads * C`` columns, narrow enough that the B * nstrips CTAs are
    about two per SM (the strip width of K8's first design,
    ``ops/halostair.py`` ``halostair_staircase_step``)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    threads = min(256, -(-ncol // 32) * 32)
    C = max(1, min(MAX_C, ncol * B // (2 * sms * threads)))
    return C, threads, -(-ncol // (threads * C))


def plan_cost(B, m, n, C, warps, sms):
    """Modelled us of a K6 launch of B jobs of m rows and n + 1 columns at
    C columns a lane and ``warps`` a CTA. The B x S CTAs spread over the
    SMs, each CTA's warps over an SM's 4 schedulers; a wavefront runs at
    the pace of its slowest strip, so the busiest scheduler sets the step
    time."""
    lanes = -(-(n + 1) // C)
    S = -(-(n + 1) // (32 * warps * C))
    per_sm = -(-B * S // sms)
    crowd = max(1, -(-per_sm * warps // 4))
    step = STEP_US[0] + STEP_US[1] * C
    return (m + RAMP * lanes + HOP * S) * step * (1 + CROWD * (crowd - 1))


def strip_plan(B, m, n, want_row, sms):
    """(C, warps, strips) of a K6 launch of B jobs padded to m rows and
    n + 1 columns: the least ``plan_cost``, ties to the smaller C, then
    fewer warps. A pure function of the launch's shape, its capture mode
    and the card's SM count. The capture mode moves no choice: a
    captured row is 12 bytes a column, written once a job. In effect the
    narrowest lanes whose warps leave no scheduler two, in CTAs of 4
    warps: C = 8 for one 98 kb job, 24 for three, 16 for the partition's
    later levels."""
    del want_row
    C, warps = min(((C, w) for C in PLAN_C for w in PLAN_WARPS),
                   key=lambda g: (plan_cost(B, m, n, *g, sms), g))
    return C, warps, -(-(n + 1) // (32 * warps * C))


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/longrow.cu."""
    fn = _build.cuda_library("longrow").long_fill
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(a, b, la, lb, st, params, want_row, geometry=None):
    """Launch csrc/longrow.cu on a CUDA bucket at ``geometry`` (C, warps,
    strips), ``strip_plan``'s by default; returns its output."""
    B, m = a.shape
    n = b.shape[1]
    dev = a.device
    C, warps, nstrips = geometry or strip_plan(
        B, m, n, want_row, _sms(dev.index or 0))
    f32 = torch.float32
    if want_row:
        out = torch.empty((B, 3, n + 1), dtype=f32, device=dev)
    else:
        out = torch.full((B, 3), NEG_INF, dtype=f32, device=dev)
    # the strips' link lines (16 bytes a row), then the CTA ticket
    link = torch.zeros((B * nstrips * (m + 1) + 1, 4), dtype=torch.int32,
                       device=dev)
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            st.data_ptr(), out.data_ptr(), link.data_ptr(),
            link[-1].data_ptr(), B, m, n, C, warps, nstrips, int(want_row),
            g, h, match, mismatch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"long_fill(C={C}, warps={warps}, strips={nstrips})")
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


def _totals(rows, n_vec, h):
    """(F, R, matched) of assembled last rows: F (C, 3, W) the forward
    rows, R the reverse rows read at the forward column j (reverse column
    n - j), and matched = F + R + (0, h, h), the refund h where a gap runs
    on through the cell."""
    F, R = rows[0::2], rows[1::2]
    C, _, W = F.shape
    jv = torch.arange(W, device=rows.device)[None, :]
    ridx = (n_vec[:, None] - jv).clamp(0, W - 1)
    rrev = R.gather(2, ridx[:, None, :].expand(C, 3, W))
    hoff = torch.tensor([0.0, h, h], dtype=torch.float32,
                        device=rows.device)[None, :, None]
    return F, rrev, F + rrev + hoff


def _argbest(tot, n_vec):
    """(j, t, best) of each crossing's totals (C, 3, W), columns past
    n_vec masked: ties to the smallest j, then T1, T2, T3 (key j*4 + t)."""
    C, _, W = tot.shape
    dev = tot.device
    jv = torch.arange(W, device=dev)[None, :]
    tot = torch.where((jv <= n_vec[:, None])[:, None, :], tot,
                      torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
    best = tot.amax(dim=(1, 2))
    key = jv[:, None, :] * 4 + torch.arange(3, device=dev)[None, :, None]
    key = torch.where(tot >= best[:, None, None], key, 1 << 30)
    kmin = key.reshape(C, -1).amin(dim=1)
    return kmin // 4, kmin % 4 + 1, best


def combine_rows(rows, n_vec, h):
    """Matched crossing combine on the device over assembled last rows
    (the JAX package's ``_combine_rows``).

    ``rows``: (2C, 3, W) with row 2c the forward fill of crossing c and
    row 2c+1 its reverse fill; ``n_vec``: (C,) int64 widths. The argmax
    over (j, t) of T1+TR1, T2+TR2+h, T3+TR3+h (the gap-open refund when a
    gap is split), ties to the smallest j, then T1, T2, T3. It sees only
    paths that enter and leave (i_mid, j) by steps of one table, so its
    best can lie below the optimum (``crossing_combine``). Returns (j, t,
    best) tensors of shape (C,)."""
    return _argbest(_totals(rows, n_vec, h)[2], n_vec)


def crossing_combine(rows, n_vec, h, forced):
    """Where an optimal path crosses each task's middle row.

    The total of (j, t) is the best path that leaves (i_mid, j) by a step
    of table t, whatever table the step into it: max(T_t + TR_t + h_t,
    max_{s != t} T_s + TR_t), the refund h_t = h for a gap that runs on
    through the cell. ``forced`` (C,) int64 is, for a forward fill of no
    rows, its positive start type (the path's first step out of the
    corner j = 0 is of that table), else 0. The crossing is
    ``combine_rows``'s where its best is the optimum, else the argmax of
    these totals, ties as there. Returns (j, t, best) tensors of shape
    (C,)."""
    F, rrev, matched = _totals(rows, n_vec, h)
    jm, tm, bm = _argbest(matched, n_vec)
    other = torch.stack([torch.maximum(F[:, 1], F[:, 2]),
                         torch.maximum(F[:, 0], F[:, 2]),
                         torch.maximum(F[:, 0], F[:, 1])], 1)
    tot = torch.maximum(matched, other + rrev)
    # a forward fill of no rows: at the corner only the forced step leaves
    at = forced > 0
    t0 = (forced - 1).clamp(0, 2)[:, None]
    corner = torch.full_like(tot[:, :, 0], NEG_INF)
    corner.scatter_(1, t0, rrev[:, :, 0].gather(1, t0))
    tot[:, :, 0] = torch.where(at[:, None], corner, tot[:, :, 0])
    j, t, best = _argbest(tot, n_vec)
    matched = bm >= best
    return (torch.where(matched, jm, j), torch.where(matched, tm, t),
            best)


def task_forced(tasks):
    """``crossing_combine``'s ``forced`` of a level's tasks: the start type
    of a task whose forward fill has no rows, if positive, else 0."""
    return [st if (i_mid == 0 and st > 0) else 0
            for (_, _, i_mid, st, _) in tasks]


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


def unique_jobs(tasks):
    """``level_jobs(tasks)`` without repeats, and for each of those jobs
    its index in the list: a job that two tasks share (the same arrays,
    split row, direction and boundary type) is filled once."""
    jobs, index, seen = [], [], {}
    for k, job in enumerate(level_jobs(tasks)):
        a_e, b_e, i_mid, st, en = tasks[k // 2]
        key = (id(a_e), id(b_e), i_mid, k % 2, en if k % 2 else st)
        if key not in seen:
            seen[key] = len(jobs)
            jobs.append(job)
        index.append(seen[key])
    return jobs, index


def batched_crossings(tasks, params=ScoringParams(), device="cuda"):
    """Crossing points of a whole bisection level in one batched fill.

    ``tasks``: list of (a_enc, b_enc, i_mid, start_type, end_type), whose
    jobs are ``unique_jobs(tasks)``: one K6 launch fills all of them
    (counted as one ``crossing_launches`` and ``strip_jobs`` jobs of the
    active recorder, their cells as ``crossing_cells``). Returns [(j, t,
    score)] per task, equal to ``crossing_on_row``'s."""
    if not tasks:
        return []
    jobs, index = unique_jobs(tasks)
    dev = torch.device(device)
    count("crossing_launches")
    count("strip_jobs", len(jobs))
    count("crossing_cells", sum(len(x) * len(y) for x, y, _ in jobs))
    rows = long_fill(*_job_bucket(jobs, dev), params, want_row=True)
    if len(jobs) < len(index):
        rows = rows[torch.tensor(index, device=dev)]
    n_vec = torch.tensor([len(t[1]) for t in tasks], dtype=torch.int64,
                         device=dev)
    forced = torch.tensor(task_forced(tasks), dtype=torch.int64, device=dev)
    jb, tb, best = (x.cpu().tolist() for x in
                    crossing_combine(rows, n_vec, params.h, forced))
    return list(zip(jb, tb, best))
