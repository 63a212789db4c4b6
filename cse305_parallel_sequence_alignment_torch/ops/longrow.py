"""Long fills of any width (K6) and their last rows.

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

The balanced partition's crossing search (parallel/partition.py) fills
a bisection level's jobs, padded by ``job_bucket``, in one K6 launch.

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


def job_bucket(jobs, device):
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
    contract of ``pallas_long_lastrow``): the last row of the partition's
    "rowscan" crossing search (parallel/partition.py)."""
    a_enc = np.asarray(a_enc, np.uint8).reshape(-1)
    b_enc = np.asarray(b_enc, np.uint8).reshape(-1)
    if a_enc.shape[0] == 0:
        return _row0_closed(b_enc.shape[0], params.g, params.h, start_type)
    rows = long_fill(*job_bucket([(a_enc, b_enc, start_type)], device),
                     params, want_row=True)
    return rows[0].cpu().numpy()
