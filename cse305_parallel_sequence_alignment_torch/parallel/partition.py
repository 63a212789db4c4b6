"""Balanced-partition alignment of one long pair (reference P5, corrected).

The port of the JAX package's ``parallel/partition.py``: crossing points
of one optimal path, found from forward + reverse last rows, split the DP
grid into p row-balanced segments by hierarchical bisection (Myers/Miller
style, so every point lies on one optimal path):

  1. fill forward to the middle row, keep that row of T1/T2/T3;
  2. fill the reversed problem to the same row;
  3. the path crosses the row at argmax_j,t of T1+TR1, T2+TR2+h,
     T3+TR3+h (gap-open refund h when a gap is split);
  4. recurse into the two sub-rectangles until p segments exist.

The segments are then solved as one mixed-type ``align_batch`` of the
port's ``BatchAligner`` (K1 fill and K2 walk, or the route of its
``backend``) in ``traceback_mode="full"`` and their chains stitched.

The crossing search is ``batched_crossings``, one call a bisection level
on every route; the level's last rows come from one K6 launch
(``ops/longrow.py``) or job by job from a ``lastrow_fn``. A crossing
(j, t) names the table t of the step by which the path leaves cell
(i_mid, j); the step that enters it may be of any table.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    AlignmentResult,
    LazyChain,
    ScoringParams,
    chain_arrays,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BACKENDS,
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops.longrow import (
    job_bucket,
    long_fill,
    long_lastrow,
)
from cse305_parallel_sequence_alignment_torch.parallel.longseq import (
    longseq_lastrow,
)
from cse305_parallel_sequence_alignment_torch.utils.observability import (
    PhaseTimer,
    count,
)

FILL_BACKENDS = ("auto", "longrow", "rowscan", "sharded")
PHASES = ("crossing_ms", "segments_ms", "stitch_ms")
COUNTERS = ("crossing_levels", "crossing_cells", "crossing_launches",
            "strip_jobs", "segment_cells")
_ZEROS = {**dict.fromkeys(PHASES, 0.0), **dict.fromkeys(COUNTERS, 0)}
_CALLS = itertools.count()  # the call id of the profiler ranges


def _enc(s):
    return encode_seq(s) if isinstance(s, (str, bytes)) else \
        np.asarray(s, np.uint8)


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
    b reversed, end_type: the reversal keeps A's and B's roles, so the
    types map to themselves)."""
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


def _k6_lastrow(a_enc, b_enc, params, start_type, device):
    """``long_lastrow``, counted as one K6 launch of one job."""
    count("crossing_launches")
    count("strip_jobs")
    return long_lastrow(a_enc, b_enc, params, start_type, device)


def batched_crossings(tasks, params=ScoringParams(), device="cuda",
                      lastrow_fn=None):
    """Crossing points of a whole bisection level, on every route.

    ``tasks``: list of (a_enc, b_enc, i_mid, start_type, end_type), whose
    jobs are ``unique_jobs(tasks)`` (their cells count as
    ``crossing_cells``). One K6 launch fills all of them (one
    ``crossing_launches``, ``strip_jobs`` jobs), or ``lastrow_fn(a, b,
    params, start_type) -> (3, n+1)`` gives each job's last row, padded
    with -inf; one ``crossing_combine`` on ``device`` reads the rows.
    Returns [(j, t, score)] per task."""
    if not tasks:
        return []
    jobs, index = unique_jobs(tasks)
    dev = torch.device(device)
    count("crossing_cells", sum(len(x) * len(y) for x, y, _ in jobs))
    if lastrow_fn is None:
        count("crossing_launches")
        count("strip_jobs", len(jobs))
        rows = long_fill(*job_bucket(jobs, dev), params, want_row=True)
    else:
        width = max(len(y) for _, y, _ in jobs) + 1
        rows = torch.full((len(jobs), 3, width), NEG_INF)
        for k, (x, y, t) in enumerate(jobs):
            rows[k, :, : len(y) + 1] = torch.as_tensor(
                lastrow_fn(x, y, params, t))
        rows = rows.to(dev)
    if len(jobs) < len(index):
        rows = rows[torch.tensor(index, device=dev)]
    n_vec = torch.tensor([len(t[1]) for t in tasks], dtype=torch.int64,
                         device=dev)
    forced = torch.tensor(task_forced(tasks), dtype=torch.int64, device=dev)
    jb, tb, best = (x.cpu().tolist() for x in
                    crossing_combine(rows, n_vec, params.h, forced))
    return list(zip(jb, tb, best))


def crossing_on_row(a_enc, b_enc, i_mid, params, start_type, end_type,
                    device="cuda", lastrow_fn=None):
    """Best crossing cell (j, t) on row ``i_mid`` of an optimal path: the
    one task's ``batched_crossings``. Returns (j, t, total_score)."""
    return batched_crossings([(a_enc, b_enc, i_mid, start_type, end_type)],
                             params, device, lastrow_fn)[0]


def balanced_partition(a, b, p, params=ScoringParams(), start_type=-1,
                       end_type=-1, crossings_fn=None, device="cuda",
                       lastrow_fn=None):
    """p+1 crossing points [(i, j, t)] splitting the DP grid into p
    row-balanced segments; interior points carry positive table types.

    The first point is (0, 0, start_type) and the last (m, n, -end_type),
    so segments consume them as the reference's optimal_alignment does
    (start = point.t, end = -next_point.t; main_alignment.cpp:250-251).
    The bisection runs level by level, each level one call of
    ``crossings_fn``, by default ``batched_crossings`` with ``lastrow_fn``
    (K6's ``long_lastrow`` on ``device`` if None).
    The points lie on an optimal path that ends in the table the free end
    picks (``bisect``)."""
    return bisect(a, b, p, params, start_type, end_type, crossings_fn,
                  device, lastrow_fn)[0]


def bisect(a, b, p, params=ScoringParams(), start_type=-1, end_type=-1,
           crossings_fn=None, device="cuda", lastrow_fn=None):
    """``balanced_partition``'s points and the end type the segments end
    with.

    A free end (-1) picks, of the optimal end tables, the first in the
    order T1, T2, T3. So the first level also fills its reverse job with
    the end forced to T1 (end type 1); where that path is optimal, its
    crossing is taken and every later level ends its reverse fill in T1,
    and the end type returned is 1. Otherwise the end stays free (-1):
    the path then ends in T2 or T3."""
    a_enc, b_enc = _enc(a), _enc(b)
    m, n = a_enc.shape[0], b_enc.shape[0]
    crossings_fn = crossings_fn or functools.partial(
        batched_crossings, params=params, device=device,
        lastrow_fn=lastrow_fn or functools.partial(_k6_lastrow, device=device))

    points = {0: (0, 0, start_type), p: (m, n, -end_type)}
    end, pick_end = end_type, end_type == -1
    frontier = [(0, p)]
    while frontier:
        tasks, keys, nxt = [], [], []
        for (k_lo, k_hi) in frontier:
            if k_hi - k_lo < 2:
                continue
            k_mid = (k_lo + k_hi) // 2
            i_lo, j_lo, t_lo = points[k_lo]
            i_hi, j_hi, t_hi = points[k_hi]
            # target global row for this split: proportional in index
            i_mid = i_lo + (i_hi - i_lo) * (k_mid - k_lo) // (k_hi - k_lo)
            sub_a = a_enc[i_lo:i_hi]
            sub_b = b_enc[j_lo:j_hi]
            st = t_lo if k_lo > 0 else start_type
            en = (-t_hi) if k_hi < p else end
            if sub_a.shape[0] == 0:
                # zero rows: pure gap-in-A run; any j split works
                points[k_mid] = (i_lo, (j_lo + j_hi) // 2, 2)
            elif sub_b.shape[0] == 0:
                # zero columns: pure gap-in-B run; split the row range
                points[k_mid] = (i_mid, j_lo, 3)
            else:
                tasks.append((sub_a, sub_b, i_mid - i_lo, st, en))
                keys.append((k_mid, i_mid, j_lo))
            nxt.append((k_lo, k_mid))
            nxt.append((k_mid, k_hi))
        # the first level's one task again, its path ending in T1; its
        # forward job is the same and filled once
        pick_end = pick_end and len(tasks) == 1 and frontier == [(0, p)]
        if pick_end:
            tasks.append(tasks[0][:4] + (1,))
        if tasks:
            # the active recorder counts the levels that fill
            count("crossing_levels")
            results = crossings_fn(tasks)
            if pick_end:
                t1 = results.pop()
                if t1[2] == results[0][2]:
                    results[0], end = t1, 1
                pick_end = False
            for (k_mid, i_mid, j_lo), (j_rel, t, _) in zip(keys, results):
                points[k_mid] = (i_mid, j_lo + j_rel, t)
        frontier = nxt
    return [points[k] for k in range(p + 1)], end


@dataclasses.dataclass
class PartitionedAligner:
    """Global aligner with balanced-partition decomposition.

    Finds p crossing points, solves the p segments as anchored
    subproblems in one batch on ``device``, and stitches the chains: the
    corrected end-to-end version of the reference's
    main_alignment_function with the partition layer enabled
    (main_alignment.cpp:353-410 + partial.cpp).

    ``fill_backend`` picks where ``batched_crossings`` takes a level's
    last rows (the same points on each): "auto" and "longrow" one K6
    launch; "rowscan" K6's ``long_lastrow`` job by job; "sharded"
    ``longseq_lastrow`` job by job over ``mesh`` (default: every card of
    ``device``; the kernel K8 on CUDA), as the JAX package does.
    ``backend`` is the segment solves' ``BatchAligner`` backend (its
    values and routes; the crossing search does not depend on it).
    ``long_threshold`` is the JAX package's grid size (cells) past which
    its "auto" search takes the long fill on a TPU and below which it
    takes its XLA row scan; both give the same crossing points, and on
    the port both sides of it run the K6 search. It is validated (an
    int >= 0) and kept.
    ``last_phases`` holds the totals of the latest ``align`` (a fresh
    ``PhaseTimer`` a call): the host-clock milliseconds of the crossing
    search, the segment solves and the stitch (``PHASES``, each ends with
    its results on the host), and ``COUNTERS``: the bisection levels that
    filled, the cells their fills cover (forward and reverse), the K6
    launches (``crossing_launches``: one a level, or one a job on
    "rowscan") and the jobs they fill (``strip_jobs``), and the segments'
    cells. Under a ``torch.profiler`` each phase is the range
    ``seqalign.<phase>``, ``align_batch``'s own ranges inside
    ``seqalign.segments``.
    """

    params: ScoringParams = ScoringParams()
    p: int = 4  # 0 = auto: pick from mem_budget (O(m*n/p) per segment)
    parity_swap: bool = True
    # coarse buckets: segment shapes vary from pair to pair
    bucket_quantum: int = 512
    # per-segment direction-matrix budget (bytes) used when p == 0
    mem_budget: int = 1 << 30
    fill_backend: str = "auto"
    long_threshold: int = 16 * 1024 * 1024
    backend: str = "auto"
    device: str = "cuda"
    # the seq mesh of fill_backend="sharded" (parallel/mesh.py)
    mesh: object = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: pick from "
                             f"{BACKENDS}")
        if self.fill_backend not in FILL_BACKENDS:
            raise ValueError(f"fill_backend {self.fill_backend!r}: pick "
                             f"from {FILL_BACKENDS}")
        if (not isinstance(self.long_threshold, int)
                or isinstance(self.long_threshold, bool)
                or self.long_threshold < 0):
            raise ValueError(f"long_threshold {self.long_threshold!r}: an "
                             f"int >= 0 (grid cells)")
        self.last_phases = dict(_ZEROS)

    def _crossings_fn(self):
        """The level function of ``fill_backend``."""
        lastrow_fn = {
            "rowscan": functools.partial(_k6_lastrow, device=self.device),
            "sharded": functools.partial(longseq_lastrow, mesh=self.mesh,
                                         device=self.device),
        }.get(self.fill_backend)
        return functools.partial(batched_crossings, params=self.params,
                                 device=self.device, lastrow_fn=lastrow_fn)

    def _pick_p(self, m, n):
        """Segment count: explicit, or the smallest power of two whose
        per-segment traceback matrix (skew layout, ~(m/p + n/p) * (n/p)
        bytes) fits the budget."""
        if self.p > 0:
            return self.p
        p = 1
        while p < 4096:
            seg_m, seg_n = -(-m // p), -(-n // p)
            if (seg_m + seg_n + 1) * (seg_n + 1) <= self.mem_budget:
                return max(p, 1)
            p *= 2
        return p

    def _oriented(self, a, b):
        a_enc, b_enc = _enc(a), _enc(b)
        if self.parity_swap and a_enc.shape[0] > b_enc.shape[0]:
            a_enc, b_enc = b_enc, a_enc
        return a_enc, b_enc

    def partition(self, a, b):
        """The crossing points of (a, b) after the parity swap."""
        a_enc, b_enc = self._oriented(a, b)
        return self._bisect(a_enc, b_enc)[0]

    def _bisect(self, a_enc, b_enc, end_type=-1):
        return bisect(a_enc, b_enc, self._pick_p(len(a_enc), len(b_enc)),
                      self.params, end_type=end_type,
                      crossings_fn=self._crossings_fn(), device=self.device)

    def align(self, a, b) -> AlignmentResult:
        timer = PhaseTimer(_ZEROS, call=next(_CALLS))
        self.last_phases = timer.totals
        with timer:
            a_enc, b_enc = self._oriented(a, b)
            res, end = self._solve(a_enc, b_enc, -1, timer)
            if end == -1 and res.end_table == 3:
                # T1 ends no optimal path: one that ends in T2 comes first
                alt, _ = self._solve(a_enc, b_enc, 2, timer)
                if alt.score == res.score:
                    res = alt
        return res

    def _solve(self, a_enc, b_enc, end_type, timer):
        """The stitched result of one bisection with ``end_type``, and the
        end type its segments ended with."""
        with timer.span("crossing"):
            points, end = self._bisect(a_enc, b_enc, end_type)
        with timer.span("segments"):
            results = self._segments(a_enc, b_enc, points, end, timer)
        with timer.span("stitch"):
            tt, ii, jj = (np.concatenate(x) for x in zip(
                *(chain_arrays(r.chain) for r in results)))
            chain = LazyChain(tt, ii, jj)
            # score: evaluate the stitched alignment (exact, no refund
            # algebra)
            score = score_chain(a_enc, b_enc, chain, self.params)
            row_a, row_b = walker.render(a_enc, b_enc, tt, ii, jj)
        return AlignmentResult(score=score, chain=chain, aligned_a=row_a,
                               aligned_b=row_b,
                               end_table=results[-1].end_table), end

    def _segments(self, a_enc, b_enc, points, end_type, timer):
        """The segments' results: one mixed-type batch with per-pair
        boundary types, offsets into the whole grid, and the forced edge
        runs needed to stitch."""
        segments = []
        for k in range(len(points) - 1):
            (i0, j0, t0), (i1, j1, t1) = points[k], points[k + 1]
            st = t0 if k > 0 else -1
            en = -t1 if k < len(points) - 2 else end_type
            segments.append((i0, j0, a_enc[i0:i1], b_enc[j0:j1], st, en))
        timer.add("segment_cells", sum(len(s[2]) * len(s[3])
                                       for s in segments))
        aligner = BatchAligner(params=self.params, parity_swap=False,
                               bucket_quantum=self.bucket_quantum,
                               backend=self.backend, device=self.device)
        return aligner.align_batch(
            [(s[2], s[3]) for s in segments],
            offsets=[(s[0], s[1]) for s in segments],
            traceback_mode="full",
            start_types=[s[4] for s in segments],
            end_types=[s[5] for s in segments])


def score_chain(a_enc, b_enc, chain, params=ScoringParams()):
    """Score an explicit alignment chain under the affine model (the
    independent evaluator of stitched alignments): the column-by-column
    sum of a loop over the chain (a match or mismatch, or -g and -h where
    a gap opens), in its order, on arrays."""
    g, h, match, mismatch = params.astuple()
    tt, ii, jj = (np.asarray(x, np.int64) for x in chain_arrays(chain))
    if tt.shape[0] == 0:
        return 0.0
    a, b = np.asarray(a_enc), np.asarray(b_enc)
    diag = np.nonzero(tt == 1)[0]
    terms = np.zeros((tt.shape[0], 2), np.float64)
    terms[:, 0] = -g
    terms[diag, 0] = np.where(a[ii[diag] - 1] == b[jj[diag] - 1], match,
                              mismatch)
    opens = (tt != 1) & (tt != np.concatenate([[0], tt[:-1]]))
    terms[:, 1] = np.where(opens, -h, 0.0)
    # add.accumulate adds in order, as the loop does
    return float(np.add.accumulate(terms.reshape(-1))[-1])
