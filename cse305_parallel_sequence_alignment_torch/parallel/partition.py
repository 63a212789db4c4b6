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
``backend``) in ``traceback_mode="full"`` and their chains stitched. The
last rows come from K6 (``ops/longrow.py``) or, for the few wide jobs of
the top levels, K7 (``ops/longstair.py``); with ``fill_backend=
"sharded"`` from the column-sharded pipeline over a mesh
(``parallel/longseq.py`` ``longseq_lastrow``, kernel K8), task by task.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

from cse305_parallel_sequence_alignment_torch.core import (
    AlignmentResult,
    ScoringParams,
    encode_seq,
    format_alignment,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BACKENDS,
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops.longrow import (
    batched_crossings,
    long_lastrow,
)
from cse305_parallel_sequence_alignment_torch.parallel.longseq import (
    longseq_lastrow,
)

FILL_BACKENDS = ("auto", "longrow", "rowscan", "sharded")
PHASES = ("crossing_s", "segments_s", "stitch_s")


def _enc(s):
    return encode_seq(s) if isinstance(s, (str, bytes)) else \
        np.asarray(s, np.uint8)


def crossing_on_row(a_enc, b_enc, i_mid, params, start_type, end_type,
                    device="cuda", lastrow_fn=None):
    """Best crossing cell (j, t) on row ``i_mid`` of an optimal path, from
    the forward and reverse last rows of ``lastrow_fn(a, b, params,
    start_type) -> (3, n+1)``, by default K6 on ``device``. Returns (j, t,
    total_score)."""
    h = params.h
    if lastrow_fn is None:
        lastrow_fn = functools.partial(long_lastrow, device=device)
    fwd = lastrow_fn(a_enc[:i_mid], b_enc, params, start_type)
    # the reversed problem keeps A's and B's roles, so types map to
    # themselves
    rev = lastrow_fn(a_enc[i_mid:][::-1], b_enc[::-1], params, end_type)
    # rev row is indexed by reversed j: TR[i_mid][j] = rev[:, n - j]
    rev_al = rev[:, ::-1]
    stacked = np.stack([fwd[0] + rev_al[0], fwd[1] + rev_al[1] + h,
                        fwd[2] + rev_al[2] + h])  # (3, n+1)
    best = np.max(stacked)
    # deterministic tie-break: smallest j, then table order T1, T2, T3
    cand_t, cand_j = np.nonzero(stacked == best)
    order = np.lexsort((cand_t, cand_j))
    return int(cand_j[order[0]]), int(cand_t[order[0]]) + 1, float(best)


def balanced_partition(a, b, p, params=ScoringParams(), start_type=-1,
                       end_type=-1, crossings_fn=None, device="cuda",
                       lastrow_fn=None):
    """p+1 crossing points [(i, j, t)] splitting the DP grid into p
    row-balanced segments; interior points carry positive table types.

    The first point is (0, 0, start_type) and the last (m, n, -end_type),
    so segments consume them as the reference's optimal_alignment does
    (start = point.t, end = -next_point.t; main_alignment.cpp:250-251).
    The bisection runs level by level: with ``crossings_fn``
    (``batched_crossings``) each level is one batched device fill,
    otherwise ``crossing_on_row`` runs task by task with ``lastrow_fn``."""
    a_enc, b_enc = _enc(a), _enc(b)
    m, n = a_enc.shape[0], b_enc.shape[0]

    points = {0: (0, 0, start_type), p: (m, n, -end_type)}
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
            en = (-t_hi) if k_hi < p else end_type
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
        if tasks:
            if crossings_fn is not None:
                results = crossings_fn(tasks)
            else:
                results = [
                    crossing_on_row(sa, sb, im, params, st, en, device,
                                    lastrow_fn)
                    for (sa, sb, im, st, en) in tasks]
            for (k_mid, i_mid, j_lo), (j_rel, t, _) in zip(keys, results):
                points[k_mid] = (i_mid, j_lo + j_rel, t)
        frontier = nxt
    return [points[k] for k in range(p + 1)]


@dataclasses.dataclass
class PartitionedAligner:
    """Global aligner with balanced-partition decomposition.

    Finds p crossing points, solves the p segments as anchored
    subproblems in one batch on ``device``, and stitches the chains: the
    corrected end-to-end version of the reference's
    main_alignment_function with the partition layer enabled
    (main_alignment.cpp:353-410 + partial.cpp).

    ``fill_backend`` picks the crossing search: "auto" and "longrow" run
    the level-batched ``batched_crossings``; "rowscan" runs the serial
    ``crossing_on_row`` through the K6 last row (the same points);
    "sharded" runs the serial ``crossing_on_row`` through
    ``longseq_lastrow`` over ``mesh`` (default: every card of ``device``;
    the kernel K8 on CUDA), as the JAX package does.
    ``backend`` is the segment solves' ``BatchAligner`` backend (its
    values and routes; the crossing search does not depend on it).
    ``last_phases`` holds the host-clock seconds of the latest ``align``:
    the crossing search, the segment solves and the stitch (each ends
    with its results on the host).
    """

    params: ScoringParams = ScoringParams()
    p: int = 4  # 0 = auto: pick from mem_budget (O(m*n/p) per segment)
    parity_swap: bool = True
    # coarse buckets: segment shapes vary from pair to pair
    bucket_quantum: int = 512
    # per-segment direction-matrix budget (bytes) used when p == 0
    mem_budget: int = 1 << 30
    fill_backend: str = "auto"
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
        self.last_phases = dict.fromkeys(PHASES, 0.0)

    def _crossings_fn(self):
        if self.fill_backend in ("rowscan", "sharded"):
            return None
        return functools.partial(batched_crossings, params=self.params,
                                 device=self.device)

    def _lastrow_fn(self):
        if self.fill_backend != "sharded":
            return None
        return functools.partial(longseq_lastrow, mesh=self.mesh,
                                 device=self.device)

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
        return balanced_partition(
            a_enc, b_enc, self._pick_p(len(a_enc), len(b_enc)), self.params,
            crossings_fn=self._crossings_fn(), device=self.device,
            lastrow_fn=self._lastrow_fn())

    def align(self, a, b) -> AlignmentResult:
        clock = [time.perf_counter()]
        a_enc, b_enc = self._oriented(a, b)
        points = self.partition(a_enc, b_enc)
        clock.append(time.perf_counter())
        # one mixed-type batch: per-pair boundary types, offsets into the
        # whole grid, and the forced edge runs needed to stitch
        segments = []
        for k in range(len(points) - 1):
            (i0, j0, t0), (i1, j1, t1) = points[k], points[k + 1]
            st = t0 if k > 0 else -1
            en = -t1 if k < len(points) - 2 else -1
            segments.append((i0, j0, a_enc[i0:i1], b_enc[j0:j1], st, en))
        aligner = BatchAligner(params=self.params, parity_swap=False,
                               bucket_quantum=self.bucket_quantum,
                               backend=self.backend, device=self.device)
        results = aligner.align_batch(
            [(s[2], s[3]) for s in segments],
            offsets=[(s[0], s[1]) for s in segments],
            traceback_mode="full",
            start_types=[s[4] for s in segments],
            end_types=[s[5] for s in segments])
        clock.append(time.perf_counter())
        full_chain = []
        for res in results:
            full_chain.extend(res.chain)
        # score: evaluate the stitched alignment (exact, no refund algebra)
        score = score_chain(a_enc, b_enc, full_chain, self.params)
        row_a, row_b = format_alignment(bytes(a_enc), bytes(b_enc),
                                        full_chain)
        clock.append(time.perf_counter())
        self.last_phases = dict(zip(PHASES, np.diff(clock).tolist()))
        return AlignmentResult(score=score, chain=full_chain,
                               aligned_a=row_a, aligned_b=row_b,
                               end_table=results[-1].end_table)


def score_chain(a_enc, b_enc, chain, params=ScoringParams()):
    """Score an explicit alignment chain under the affine model (the
    independent evaluator of stitched alignments)."""
    g, h, match, mismatch = params.astuple()
    score = 0.0
    prev_t = None
    for (i, j, t) in chain:
        if t == 1:
            score += match if a_enc[i - 1] == b_enc[j - 1] else mismatch
        else:
            score -= g
            if t != prev_t:
                score -= h
        prev_t = t
    return score
