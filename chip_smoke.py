#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from ``cse305_parallel_sequence_alignment_torch/
csrc`` (one compiler process per source, all at once) and drives its
main paths, global full alignment of many pairs (match/mismatch and
under a substitution matrix), the balanced partition of one long pair,
the column-sharded long-pair pipeline, the ``BatchAligner`` backends,
banded global alignment of the long pair, local (Smith-Waterman),
semi-global and overlap alignment of many pairs, the data-sharded
aligners, the score-fill probes (K3'', P-trim, P-dual, K2'), the
row-step attribution probes (P-perm, P-stripes, P-knock, P-ablate,
P-lane0, P-sweep, P-attrib2) and the op-cost micro-probes (P-micro,
P-micro2):

1. card, torch and CUDA versions; the kernels' build time; ptxas's
   registers, stack and spills of each K1/K4d fill instance and of each
   register-row K8 and K12d instance (none may spill), each row-step probe
   kernel and each micro-probe kernel;
2. each kernel against its plain PyTorch version on the card, bit for
   bit, both timed with CUDA events: K1 dirs16+runs fill (csrc/
   rowfill.cu, its geometry, registers and occupancy printed; the sweep
   it replaced timed beside), K3 anti-diagonal score fill and K2
   run-length walk on 8 ragged pairs up to 2 kb with every start type,
   on 4 x 300 x 9 kb, and on 256 x 2 kb; K1 and K2 on its pitched dirs
   at a partition segment (2 x 3,584 x 26,624) and 4 x 14 kb (clusters
   of 8 CTAs a pair) and 300 x 70 kb (past 8 CTAs' reach: the
   global-scratch sweep, the K1-wide row) (``[k1-shapes]``); K1, K3,
   K6, K3', K1', K5 and K2s again at g=0.3,
   h=1.7 (the ``[numerics]`` line); K6 long fill on 8 jobs of 3-5 k x
   17-20 k with mixed start types, finals and last rows; K7 on one
   6,000 x 20,000 job for 3 start types;
3. the golden cases (tests/golden/cases.jsonl) through
   ``BatchAligner(device="cuda")``: 34 pipeline rows byte-equal, 152
   subproblem chains and finals equal;
4. the global path at real size, with every launch counter set to 0
   first: ``align_batch`` on 256 random pairs x 2 kb (one warm-up, 3
   timed runs, phase split), ``score_batch`` agreeing with it, and 16
   pairs of 12-16 kb in ``traceback_mode="full"`` whose chains re-score
   to their scores;
4a. K4d and K4s against their plain versions, bit for bit: 8 ragged
    protein pairs with all six start types and one chunk of the matrix
    path's largest bucket, timed (the codes checked against the table
    once before, not in the timed window); K4d under ``dna_matrix(1, 0)``
    equal to K1 at 256 x 2 kb (``[matrix-kernels]``);
4b. the matrix path, counters set to 0 again: ``BatchAligner(matrix=
    BLOSUM62)`` (g=1, h=11) ``align_batch`` on 4,096 protein pairs of
    250-450 residues (seed 31; three of four B are A with 15%
    substitutions and 2% single-residue indels, the fourth unrelated), one
    warm-up and 3 timed runs, and ``score_batch``; gates outside the
    window: ``score_batch`` = ``align_batch``, every full-traceback chain
    re-scoring to its score under the table, the first 64 pairs equal to
    ``BatchAligner(device="cpu")`` (``[matrix]``);
5. the partition path at the dataset's scale, counters set to 0 again,
   ``PartitionedAligner(p=0).align`` alone: a 97,409-nt random pair with
   1% edits and 13,309 x 97,409 random; then, outside the launch
   window, stitched score = chain re-score = the whole pair's K6 score
   through ``score_batch``, rows that give back the sequences; walls,
   levels, segments;
6. K6 and K7 against their plain versions, bit for bit, at the shapes
   step 5 gave them (each bisection level's one K6 launch, in rows and in
   finals mode, and its largest job through K7 at B = 1), which set
   their times in the kernels line;
6e. the long-pair pipeline, counters set to 0 again: ``longseq_score``
    of step 5's 97 kb pair on a mesh of the card and on a mesh of four
    entries of it (R = 256), ``longseq_lastrow`` of the 13 kb x 97 kb
    pair, and that pair through ``PartitionedAligner(p=4,
    fill_backend="sharded")``; gates: the finals = the whole pair's K6
    finals, the row = K6's last row, the partition = step 5's, every fill
    through the kernel route (``[longseq]``); then K8 against its plain
    version, bit for bit, on the first, a middle and the row-la call of
    each entry of the four-entry run (recorded from a second run, which
    must give the same finals), each timed, the middle one also at other
    geometries; a middle call of the one-card run (98,010 columns, "K8
    one entry") likewise; the kernel at
    a grid of (C, threads) at both widths, with the fit of the geometry
    rule's model; and on every call of a 3 k x 12 k pair at g=0.3, h=1.7
    and of a 300 x 5,000 pair for each start type
    (``[longseq-kernels]``);
6a. K3' row-sweep score fill, K1' row uint8 dirs fill, K5 skew dirs fill
    and K2s single-step walk (row and skew layouts) against their plain
    versions, bit for bit: 8 ragged pairs up to 2 kb with every start
    type, 4 x 300 x 9 kb (global scratch), and 256 x 2 kb (seed 7, timed);
    K1' equal to K1's word & 0x3F (``[backend-kernels]``);
6b. the backends path, counters set to 0 again: ``align_batch`` under
    ``backend="rowdirs"`` (K1' + K2s) and ``"wavefront"`` (K5 + K2s) on
    step 4's 256 x 2 kb pairs (one warm-up, 2 timed runs each),
    ``score_batch`` under ``"pallas_rowscan"`` (K3'), and
    ``PartitionedAligner(p=0, backend="wavefront").align`` of step 5's
    13,309 x 97,409 pair; gates: every pair equal to the fused route's
    result, the K3' scores equal to K3's, the partition equal to the
    fused one (``[backends]``); then, outside the window, that partition
    again with its route recording what it hands K5 and K2s (the same
    result), and K5 and K2s (skew) against their plain versions, bit for
    bit, on each recorded chunk of 3.3 k x 24-27 k segments
    (``[segment-kernels]``);
6f. K3'' two-carry score fill, P-trim and P-dual against their plain
    versions, bit for bit, at 256 x 2 kb (seed 7, start type -1, every
    la = m: timed) at the default parameters and at g=0.3, h=1.7, the
    three equal there (P-dual also on 255 pairs), K3'' = K3' at the
    default parameters, and K3'' on 8 ragged pairs with every start type
    (``[rowscan2-kernels]``); K2' at G = 1 and 8 against its plain
    version and K2 on the K1 dirs of step 4's pairs, in two chunks of 128
    (``[group-walk]``);
6h. every instantiation of the row-step probe kernels (P-perm, P-stripes,
    P-knock, P-ablate and its floors, P-lane0) against its plain twin,
    bit for bit (NaN equal to NaN), on each probe's reduced bucket (its
    first 16 pairs of 2 kb), then timed at the probe's full shape; the
    kernels line takes one variant of each, with its twin timed at full
    size (``[rowprobe-kernels]``); likewise P-sweep's 36 cases (B x W x C
    x U) and P-attrib2's modes and floors, with K3 (``[rowprobe2-kernels]``);
6i. every case of the micro-probes (16 op classes of P-micro, 15 cases
    of P-micro2) against its plain twin, bit for bit, at 64 steps on 16
    lines, then timed at the full shape and the lower step count
    (``[micro-kernels]``);
6g. the probes path, counters set to 0 again: each module of
    ``probes/`` (``ab_rowscan2``, ``trim_rowscan``, ``dual_stream``,
    ``walk_ab``, ``perm_layout``, ``stripes``, ``knockout``, ``ablate``,
    ``lane0``, ``sweep``, ``attrib2``, ``micro``) at full size, one round,
    its JSON lines on ``[probes]`` lines; gates: every ``cells_equal``,
    ``exact`` and ``equals_k3p`` true, every ``mismatched_pairs`` 0, the
    pipeline's finals finite;
6c. K12d, K12s and K2 in band layout against their plain versions, bit
    for bit: 256 related pairs x 2 kb at bands (64, 64) and (256, 256), 8
    ragged pairs with every start type, a band too wide for shared
    memory (the shared-memory body), and the banded path's own launch,
    every row of the 97 kb pair at W = 1,329; each band's K12d also at
    every C and on the shared-memory body, and K2 on the pitched dirs
    (``[banded-kernels]``);
6d. the banded path, counters set to 0 again: ``api.align(mode="banded",
    band=64)`` on step 5's 97 kb pair and its copy (W = 1,329), one
    warm-up and 2 timed runs, then ``BandedAligner`` for the phase split
    and ``score``; gates: the runs equal, ``score`` = ``align``, rows that
    give back the pair, the full-traceback chain re-scoring to the score,
    and the score equal to the whole pair's K6 score unless the chain
    touched the band's edge (``[banded]``);
7. K9s/K9d local fills and K9w local walk against their plain versions,
   bit for bit: 8 ragged pairs up to 2 kb (repetitive tie pairs, an
   all-mismatch pair, m > n), and 256 x 2 kb of step 8's data, timed;
8. the local path at BASELINE config 3's size, counters set to 0 again:
   ``LocalBatchAligner.align_batch`` on 4096 pairs of 2,048 nt (seed 11;
   even pairs share a 1,024-nt core with 3% substitutions and 1% indels,
   odd pairs are unrelated), one warm-up and 3 timed runs with the phase
   split and chunk count, and ``score_batch``; then, outside the window,
   ``score_batch`` = ``align_batch``, chains re-scoring to their scores,
   CIGARs consuming their spans, and the first 64 pairs equal to the
   plain versions' results on the card;
8a. the data-sharded aligners, counters set to 0 again:
    ``ShardedBatchAligner`` ``align_batch`` and ``score_batch`` on step
    4's 256 x 2 kb pairs over a mesh of the card and of two entries of
    it, ``ShardedLocalBatchAligner`` scores of step 8's pairs over two
    entries; each equal to the unsharded aligner's (``[sharded]``);
9. K10s/K10d semi-global and K11s/K11d overlap fills against their plain
   versions, bit for bit, at the default and a non-dyadic parameter set,
   on ragged pairs with an empty side, m > n and 1,100 columns; then
   timed at the main paths' chunk shapes;
10. the semi-global path, counters set to 0 again:
    ``SemiGlobalBatchAligner.align_batch`` on 16,384 reads of 250 nt
    each in a 1,024-nt reference window (seed 23; three of four reads
    are taken from their window at a random offset with 1% substitutions
    and 0.2% single-base indels, the fourth is random), one warm-up and
    3 timed runs, and ``score_batch``; gates outside the window:
    ``score_batch`` = ``align_batch`` (score, table, end column), chains
    re-scoring to their scores, CIGARs consuming the whole read, the
    first 64 pairs equal to the plain versions' results on the card;
11. the overlap path likewise: ``OverlapBatchAligner`` on 4,096 pairs of
    2,000 nt (seed 29; a quarter put a suffix of A on a prefix of B over
    500-1,500 nt with 2% edits, a quarter a prefix of A on a suffix of
    B, half are unrelated); gates as step 10, with every end on the last
    row or the last column;
12. the CLI ``align``, ``partition``, ``local``, ``semiglobal`` and
    ``overlap`` in subprocesses; ``longscore --devices 1`` (K6) on the
    97 kb pair, whose score must be the one step 6e's finals give, and
    ``longscore`` with one more device than the host has cards, which
    must fail naming their count; and ``perf`` at its defaults, its
    longseq rows included (every row parses and has no error; printed on
    ``[perf]`` lines);
13. every kernel of each path launched in step 4, 4b, 5, 6b, 6d, 6e, 6g,
    8, 8a, 10 or 11.

Prints a JSON line of the kernels (times, bounds, launches), the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failure raises; the script exits non-zero at once when no CUDA device is
available.
"""

from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "cse305_parallel_sequence_alignment_torch"
ACGT = np.frombuffer(b"ACGT", np.uint8)
AMINO = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)

# H100 SXM datasheet peaks: float32 outside the tensor
# cores, and HBM3
FP32_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# float operations and compares per DP cell, counted from csrc/: the row
# score sweep (K6, K7: 14 in pass 1, 3 in pass 2) and the dirs sweeps (K1,
# K10d, K11d: the sweep plus the three argmax3 of the direction codes)
SWEEP_OPS = 17
DIRS_OPS = 29
# per interior cell of csrc/local.cu: K9s 16 (max3 + add + clamp, two
# 3-candidate gap maxima, the base compare, the best compare), K9d 26
# (plus the start test and three argmax3)
SW_OPS = 16
SW_DIRS_OPS = 26
# per interior cell of csrc/diag.cu (K3, K10s, K11s): the base compare,
# max3 + add, and two gap maxima of a max, two subtractions and a max
DIAG_OPS = 12
# K5 (csrc/diag.cu with DIRS): K3's cell with the six gap candidates
# rounded one by one (two more subtractions) and three argmax3 of three
# compares each
SKEW_DIRS_OPS = 23
# per cell of csrc/halostair.cu (K8): pass 1 the base compare, T1's add,
# T3's three subtractions and max, max(T1, T3), omega's multiply,
# subtraction and add, the running max; pass 2 the max with the block
# prefix, T2's multiply and subtraction, H's max
HALOSTAIR_OPS = 15
# per in-band cell of csrc/banded.cu, counted as above: K12s 16 (max3 +
# add, two gap maxima of a max and two subtractions, omega's three
# operations, two running maxima, the base compare, T2's three in pass 2),
# K12d 31 (plus three argmax3 and the three h terms of the codes)
BAND_OPS = 16
BAND_DIRS_OPS = 31
# NCBI BLAST's defaults for BLOSUM62: gap existence 11, extension 1 (a gap
# of k costs h + g*k here)
MATRIX_PARAMS = dict(g=1.0, h=11.0)
NON_DYADIC = dict(g=0.3, h=1.7, match=1.0, mismatch=-0.7)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops at the fp32 peak and
    bytes at the HBM rate."""
    t_ops = ops / FP32_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def u16(x):
    """uint16 bits as int32 (few PyTorch kernels take uint16)."""
    import torch
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def max_err(x, y):
    """Largest |x - y|, with equal entries (-inf included) as 0."""
    import torch
    if x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y):
        return 0.0  # without widening: a dirs array may be gigabytes
    x, y = x.to(torch.float64), y.to(torch.float64)
    d = torch.where(x == y, torch.zeros_like(x), (x - y).abs())
    return float(d.max()) if d.numel() else 0.0


def max_err_u8(x, y):
    """Largest |x - y| of two uint8 tensors, without widening equal ones
    (a 256 x 2 kb dirs array is 2 GB)."""
    import torch
    if torch.equal(x, y):
        return 0.0
    return float((x.to(torch.int16) - y.to(torch.int16)).abs().max())


def timed(fn, reps, warm=True):
    """(result, ms per call) by CUDA events, after one warm-up call unless
    ``warm`` is false."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1) / reps


# ptxas's (registers, stack, spill stores, spill loads) of each
# csrc/rowfill.cu instance, filled in by main's build phase
ROWFILL_USAGE = {}


def fill_desc(B, n, k1=0):
    """K1/K4d's geometry for a (B, n) bucket (ops/rowcb.py
    ``fill_geometry``) with its instance's registers and CUDA's occupancy,
    or the width rule's global-scratch route."""
    from cse305_parallel_sequence_alignment_torch.ops import rowcb
    geo = rowcb.fill_geometry(B, n, k1)
    if geo is None:
        return "past 8 CTAs' reach: csrc/rowcb.cu sweep, global scratch"
    C, threads, k = geo
    kern = f"fill_kernel<{C},{int(k1 > 0)},{int(k > 1)}>"
    regs, _, st, ld = ROWFILL_USAGE.get(kern, (None, 0, 0, 0))
    per_sm, clusters = rowcb.fill_occupancy(C, threads, k, k1)
    return (f"C={C}, threads={threads}, k={k} ({kern}: {regs} registers, "
            f"{st}/{ld} bytes spilled; {per_sm} CTAs an SM"
            + (f", {clusters} clusters at once" if k > 1 else "") + ")")


def bucket(rng, la, lb, m, n):
    B = len(la)
    a = np.full((B, m), 254, np.uint8)
    b = np.full((B, n), 255, np.uint8)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    return a, b


def phase_kernels(report):
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import (
        device_walk,
        rowcb,
    )

    params = ScoringParams()
    rng = np.random.default_rng(11)
    ragged = dict(
        la=np.array([2048, 1, 700, 2048, 1500, 33, 1999, 0], np.int32),
        lb=np.array([2048, 2000, 1024, 5, 1501, 2048, 2047, 9], np.int32),
        st=np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32))
    a, b = bucket(rng, ragged["la"], ragged["lb"], 2048, 2048)
    cases = [("ragged 8 x <=2 kb", a, b, ragged["la"], ragged["lb"],
              ragged["st"])]
    # rows wider than shared memory: the global-scratch row buffers
    wide = dict(la=np.array([300, 299, 150, 1], np.int32),
                lb=np.array([9000, 8999, 4500, 9000], np.int32),
                st=np.array([-1, -3, 2, -2], np.int32))
    a, b = bucket(rng, wide["la"], wide["lb"], 300, 9000)
    cases.append(("wide 4 x 300 x 9 kb (global scratch)", a, b,
                  wide["la"], wide["lb"], wide["st"]))
    rng7 = np.random.default_rng(7)
    B, L = 256, 2048
    a = ACGT[rng7.integers(0, 4, (B, L))]
    b = ACGT[rng7.integers(0, 4, (B, L))]
    full = np.full(B, L, np.int32)
    cases.append(("256 x 2 kb", a, b, full, full,
                  np.full(B, -1, np.int32)))
    dev = torch.device("cuda")
    for name, a, b, la, lb, st in cases:
        ta, tb_, tla, tlb, tst = (torch.from_numpy(np.ascontiguousarray(x))
                                  .to(dev) for x in (a, b, la, lb, st))
        big = name.startswith("256")
        reps = 3 if big else 1
        (d_k, f_k), ms1 = timed(
            lambda: rowcb.rowcb_fill(ta, tb_, tla, tlb, tst, params), reps)
        (d_p, f_p), pms1 = timed(
            lambda: rowcb.rowcb_fill_plain(ta, tb_, tla, tlb, tst, params),
            1)
        e1 = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
        s_k, ms3 = timed(
            lambda: rowcb.score_fill(ta, tb_, tla, tlb, tst, params), reps)
        # K3 is the anti-diagonal sweep of csrc/diag.cu
        s_p, pms3 = timed(
            lambda: rowcb.score_fill_plain(ta, tb_, tla, tlb, tst, params),
            1)
        e3 = max(max_err(s_k, s_p), max_err(s_k, f_k))
        t0 = torch.from_numpy(rng.integers(1, 4, len(la)).astype(np.int32)
                              ).to(dev)
        max_steps = int(la.max() + lb.max()) + 1
        (w_k, u_k), ms2 = timed(
            lambda: device_walk.rle_walk(d_k, tla, tlb, t0, max_steps),
            reps)
        (w_p, u_p), pms2 = timed(
            lambda: device_walk.rle_walk_plain(d_k, tla, tlb, t0,
                                               max_steps), 1)
        e2 = max(max_err(u16(w_k), u16(w_p)), max_err(u_k, u_p))
        old_ms, alt = None, ""
        if big:  # the sweep K1 ran on before csrc/rowfill.cu, same call
            _, old_ms = timed(lambda: rowcb._launch(
                ta, tb_, tla, tlb, tst, params, "global"), reps)
            for geo in ((4, 544, 1), (16, 160, 1)):  # the other C
                _, ams = timed(lambda: rowcb._fill(
                    ta, tb_, tla, tlb, tst, params, None, geo), reps)
                alt += f"; at {geo} {ams:.3f} ms"
        print(f"[kernels] {name}: K1 err {e1} {ms1:.3f} ms (plain "
              f"{pms1:.1f} ms; {fill_desc(len(la), b.shape[1])}"
              + (f"{alt}; before: csrc/rowcb.cu {old_ms:.3f} ms" if big
                 else "")
              + f"); K3 err {e3} {ms3:.3f} ms (plain "
              f"{pms3:.1f} ms); K2 err {e2} rounds {int(u_k[0])} "
              f"{ms2:.3f} ms (plain {pms2:.1f} ms)", flush=True)
        if e1 or e2 or e3:
            raise RuntimeError(f"kernel disagrees with its plain version "
                               f"on {name}: K1 {e1} K3 {e3} K2 {e2}")
        cells = float((la.astype(np.int64) * lb).sum())
        ins = nbytes(ta, tb_, tla, tlb, tst)
        # K2 reads one dirs cell per round taken
        taken = int((u16(w_k) != 0).sum())
        bounds = {"K1": bound(DIRS_OPS * cells, ins + nbytes(d_k, f_k)),
                  "K3": bound(DIAG_OPS * cells, ins + nbytes(s_k)),
                  "K2": bound(0, 2 * taken + nbytes(tla, tlb, t0, w_k,
                                                    u_k))}
        for key, err, ms, pms in (("K1", e1, ms1, pms1),
                                  ("K3", e3, ms3, pms3),
                                  ("K2", e2, ms2, pms2)):
            rep = report[key]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if big:
                rep["ms"], rep["plain_ms"] = ms, pms
                rep["bound_ms"], rep["bound_by"] = bounds[key]
        del d_k, d_p
        torch.cuda.empty_cache()
    phase_k1_shapes(report, params)


def phase_k1_shapes(report, params):
    """K1 at the shapes past one CTA, bit for bit against its plain
    version: a partition segment (2 pairs of about 3,584 x 26,624, start
    types -1 and 1) and 4 x 14 kb (half of them related, runs past the
    255 cap), each in clusters of 8 CTAs, with K2 on their pitched dirs
    and, timed beside, the fewest CTAs that hold a row and the sweep K1
    ran on before; and 300 x 70 kb, past 8 CTAs' reach (the width rule's
    global-scratch sweep, counted in ``wide_launches``, which sets the
    K1-wide row)."""
    import torch

    from cse305_parallel_sequence_alignment_torch.ops import (
        device_walk,
        rowcb,
    )

    rng = np.random.default_rng(17)
    seg = dict(la=np.array([3584, 3401], np.int32),
               lb=np.array([26624, 25001], np.int32),
               st=np.array([-1, 1], np.int32))
    a, b = bucket(rng, seg["la"], seg["lb"], 3584, 26624)
    cases = [("partition segment 2 x 3,584 x 26,624", a, b, seg)]
    L = 14000
    a = ACGT[rng.integers(0, 4, (4, L))]
    b = ACGT[rng.integers(0, 4, (4, L))]
    for k in (1, 3):  # related: b is a with 0.2% substitutions
        b[k] = a[k]
        flip = rng.integers(0, L, L // 500)
        b[k, flip] = ACGT[rng.integers(0, 4, len(flip))]
    full = np.full(4, L, np.int32)
    cases.append(("4 x 14 kb", a, b, dict(la=full, lb=full,
                                          st=np.full(4, -1, np.int32))))
    wide = dict(la=np.array([300, 299], np.int32),
                lb=np.array([70000, 69000], np.int32),
                st=np.array([-1, -3], np.int32))
    a, b = bucket(rng, wide["la"], wide["lb"], 300, 70000)
    cases.append(("300 x 70 kb", a, b, wide))
    dev = torch.device("cuda")
    for name, a, b, lens in cases:
        la, lb, st = lens["la"], lens["lb"], lens["st"]
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (a, b, la, lb, st)]
        before = rowcb.rowcb_fill.wide_launches
        (d_k, f_k), ms = timed(lambda: rowcb.rowcb_fill(*args, params), 1)
        is_wide = rowcb.rowcb_fill.wide_launches > before
        (d_p, f_p), pms = timed(lambda: rowcb.rowcb_fill_plain(
            *args, params), 1, warm=False)
        e1 = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
        del d_p
        torch.cuda.empty_cache()
        old, e2, walked = "", 0.0, ""
        if not is_wide:  # K2 on the pitched dirs (the wide route's are not)
            t0 = torch.from_numpy(rng.integers(1, 4, len(la)).astype(
                np.int32)).to(dev)
            steps = int(la.max() + lb.max()) + 1
            w_k, u_k = device_walk.rle_walk(d_k, args[2], args[3], t0, steps)
            w_p, u_p = device_walk.rle_walk_plain(d_k, args[2], args[3], t0,
                                                  steps)
            e2 = max(max_err(u16(w_k), u16(w_p)), max_err(u_k, u_p))
            walked = (f"; K2 on its dirs (pitch "
                      f"{device_walk.row_pitch(d_k)}) err {e2} rounds "
                      f"{int(u_k[0])}")
            _, old_ms = timed(lambda: rowcb._launch(*args, params, "global"),
                              1)
            # the fewest CTAs that hold the row, beside the chosen spread
            k_min = -(-(b.shape[1] + 1) // rowcb.CTA_REACH)
            few = (16, 32 * -(-(b.shape[1] + 1) // (32 * 16 * k_min)),
                   k_min)
            _, few_ms = timed(lambda: rowcb._fill(*args, params, None,
                                                  few), 1)
            old = (f"; the fewest CTAs {few}: {few_ms:.3f} ms; before: "
                   f"csrc/rowcb.cu {old_ms:.3f} ms")
        cells = float((la.astype(np.int64) * lb).sum())
        bnd = bound(DIRS_OPS * cells, nbytes(*args, d_k, f_k))
        print(f"[k1-shapes] {name}: K1 err {e1} {ms:.3f} ms "
              f"({cells / ms / 1e6:.1f} GCUPS; bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}; plain {pms:.1f} ms; "
              f"{fill_desc(len(la), b.shape[1])}{old}){walked}",
              flush=True)
        if e1 or e2 or is_wide != name.startswith("300"):
            raise RuntimeError(f"K1 at {name}: err {e1}, K2 {e2}, wide "
                               f"route {is_wide}")
        key = "K1-wide" if is_wide else "K1"
        rep = report[key]
        rep["max_abs_err"] = max(rep["max_abs_err"], e1)
        report["K2"]["max_abs_err"] = max(report["K2"]["max_abs_err"], e2)
        if is_wide:
            rep["ms"], rep["plain_ms"] = ms, pms
            rep["bound_ms"], rep["bound_by"] = bnd
        del d_k
        torch.cuda.empty_cache()


def phase_numerics(report):
    """K1 and K3 against their plain versions at a non-dyadic parameter
    set, on the ragged pairs of every start type: the folded gh and the
    anti-diagonal T2 must give the plain versions' bits on the card."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import longrow, rowcb

    params = ScoringParams(**NON_DYADIC)
    rng = np.random.default_rng(13)
    la = np.array([2048, 1, 700, 2048, 1500, 33, 1999, 0], np.int32)
    lb = np.array([2048, 2000, 1100, 5, 1501, 2048, 2047, 9], np.int32)
    st = np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32)
    a, b = bucket(rng, la, lb, 2048, 2048)
    args = [torch.from_numpy(x).cuda() for x in (a, b, la, lb, st)]
    d_k, f_k = rowcb.rowcb_fill(*args, params)
    d_p, f_p = rowcb.rowcb_fill_plain(*args, params)
    e1 = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
    e3 = max_err(rowcb.score_fill(*args, params),
                 rowcb.score_fill_plain(*args, params))
    e6 = max_err(longrow.long_fill(*args, params),
                 longrow.long_fill_plain(*args, params))
    del d_k, d_p
    errs = backend_kernel_errs(args, params)
    print(f"[numerics] {NON_DYADIC}, 8 ragged pairs up to 2 kb, all six "
          f"start types: K1 err {e1}, K3 err {e3}, K6 err {e6}, "
          + ", ".join(f"{k} err {v}" for k, v in errs.items())
          + " (kernel vs plain)", flush=True)
    errs.update(K1=e1, K3=e3, K6=e6)
    if any(errs.values()):
        raise RuntimeError("a global kernel disagrees with its plain "
                           "version at non-dyadic parameters")
    for key, err in errs.items():
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
    torch.cuda.empty_cache()


def backend_kernel_errs(args, params, times=None):
    """K3', K1' (uint8), K5 and K2s in both layouts against their plain
    versions on the card, on one bucket; with a ``times`` dict, each
    kernel (3 runs after a warm-up) and its plain version (one run) are
    timed into it as (ms, plain ms, bound)."""
    import torch

    from cse305_parallel_sequence_alignment_torch.models.batch import (
        _end_choice,
    )
    from cse305_parallel_sequence_alignment_torch.ops import (
        device_walk,
        diag,
        rowcb,
    )

    a, b, la, lb, st = args
    reps, warm = (3, True) if times is not None else (1, False)
    cells = float((la.to(torch.int64) * lb).sum())
    ins = nbytes(*args)
    out = {}

    def check(key, kernel, plain, cmp, bound_of):
        got, ms = timed(kernel, reps, warm)
        want, pms = timed(plain, 1, warm=False)
        out[key] = cmp(got, want)
        if times is not None:
            times[key] = (ms, pms, bound_of(got))
        return got

    check("K3'", lambda: rowcb.rowscan_score_fill(*args, params),
          lambda: rowcb.rowscan_score_fill_plain(*args, params), max_err,
          lambda f: bound(SWEEP_OPS * cells, ins + nbytes(f)))
    d1, f1 = check(
        "K1'", lambda: rowcb.rowdirs_fill(*args, params),
        lambda: rowcb.rowdirs_fill_plain(*args, params),
        lambda x, y: max(max_err_u8(x[0], y[0]), max_err(x[1], y[1])),
        lambda r: bound(DIRS_OPS * cells, ins + nbytes(*r)))
    d5, f5 = check(
        "K5", lambda: diag.skew_dirs_fill(*args, params),
        lambda: diag.skew_dirs_fill_plain(*args, params),
        lambda x, y: max(max_err_u8(x[0], y[0]), max_err(x[1], y[1])),
        lambda r: bound(SKEW_DIRS_OPS * cells, ins + nbytes(*r)))
    # K5's finals are K3's; K3' and K1' share K1's finals where the two
    # omega orders agree (not at non-dyadic g, h for K1')
    out["K5"] = max(out["K5"], max_err(f5, rowcb.score_fill(*args, params)))
    steps = int(la.max()) + int(lb.max()) + 1
    for key, dirs, fin, layout in (("K2s", d1, f1, "row"),
                                   ("K2s-skew", d5, f5, "skew")):
        tb, _ = _end_choice(fin, torch.full_like(la, -1), params.h)
        check(key,
              lambda: device_walk.step_walk(dirs, la, lb, tb, steps, layout),
              lambda: device_walk.step_walk_plain(dirs, la, lb, tb, steps,
                                                  layout),
              lambda x, y: max(max_err_u8(x[0], y[0]), max_err(x[1], y[1])),
              # one dirs byte read a step taken
              lambda r: bound(0, int((r[0] != 0).sum())
                              + nbytes(la, lb, tb, *r)))
    del d1, d5
    torch.cuda.empty_cache()
    return out


def phase_backend_kernels(report):
    """K3', K1', K5 and K2s (row and skew layouts) against their plain
    versions on the card, bit for bit: 8 ragged pairs up to 2 kb with
    every start type, rows too wide for shared memory (4 x 300 x 9 kb),
    and 256 x 2 kb (seed 7, timed: the kernels line); K1' is K1's word &
    0x3F on every cell at the default parameters."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import rowcb

    params = ScoringParams()
    rng = np.random.default_rng(19)
    la = np.array([2048, 1, 700, 2048, 1500, 33, 1999, 0], np.int32)
    lb = np.array([2048, 2000, 1024, 5, 1501, 2048, 2047, 9], np.int32)
    st = np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32)
    a, b = bucket(rng, la, lb, 2048, 2048)
    cases = [("ragged 8 x <=2 kb", (a, b, la, lb, st))]
    wla = np.array([300, 299, 150, 1], np.int32)
    wlb = np.array([9000, 8999, 4500, 9000], np.int32)
    a, b = bucket(rng, wla, wlb, 300, 9000)
    cases.append(("wide 4 x 300 x 9 kb (global scratch)",
                  (a, b, wla, wlb, np.array([-1, -3, 2, -2], np.int32))))
    rng7 = np.random.default_rng(7)
    B, L = 256, 2048
    full = np.full(B, L, np.int32)
    cases.append(("256 x 2 kb", (ACGT[rng7.integers(0, 4, (B, L))],
                                 ACGT[rng7.integers(0, 4, (B, L))], full,
                                 full, np.full(B, -1, np.int32))))
    for name, arrays in cases:
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in arrays]
        big = name.startswith("256")
        times = {} if big else None
        errs = backend_kernel_errs(args, params, times)
        d8, _ = rowcb.rowdirs_fill(*args, params)
        d16, _ = rowcb.rowcb_fill(*args, params)
        codes = max_err_u8(d8, (u16(d16) & 0x3F).to(torch.uint8))
        del d8, d16
        torch.cuda.empty_cache()
        line = ", ".join(f"{k} err {v}" for k, v in errs.items())
        if big:
            line += "; " + ", ".join(
                f"{k} {ms:.3f} ms (plain {pms:.1f} ms)"
                for k, (ms, pms, _) in times.items())
        print(f"[backend-kernels] {name}: {line}; K1' = K1 & 0x3F: err "
              f"{codes}", flush=True)
        if any(errs.values()) or codes:
            raise RuntimeError(f"a backend kernel disagrees with its plain "
                               f"version on {name}: {errs}, K1' vs K1 "
                               f"{codes}")
        for key, err in errs.items():
            rep = report[key]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if big:
                rep["ms"], rep["plain_ms"], (rep["bound_ms"],
                                             rep["bound_by"]) = times[key]
        if big:
            cells = float(B) * L * L
            rates = {k: round(cells / times[k][0] / 1e6, 1)
                     for k in ("K3'", "K1'", "K5")}
            print(f"[backend-kernels] 256 x 2 kb: GCUPS {rates}; bounds "
                  f"{ {k: round(v[2][0], 4) for k, v in times.items()} } ms",
                  flush=True)


def phase_long_kernels(report):
    """K6 and K7 against their plain versions, bit for bit, with mixed
    start types at widths far past shared memory, in both of K6's capture
    modes. The shapes of the partition path are checked and timed by
    ``phase_long_main``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import (
        longrow,
        longstair,
    )

    params = ScoringParams()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    B = 8
    la = rng.integers(3000, 5001, B).astype(np.int32)
    lb = rng.integers(17000, 20001, B).astype(np.int32)
    st = np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32)
    a, b = bucket(rng, la, lb, int(la.max()), int(lb.max()))
    args = [torch.from_numpy(x).to(dev) for x in (a, b, la, lb, st)]
    cells = float((la.astype(np.int64) * lb).sum())
    for want_row in (False, True):
        out_k, ms = timed(
            lambda: longrow.long_fill(*args, params, want_row), 3)
        out_p, pms = timed(
            lambda: longrow.long_fill_plain(*args, params, want_row), 1,
            warm=False)
        err = max_err(out_k, out_p)
        mode = "rows" if want_row else "finals"
        print(f"[kernels] K6 {mode} 8 x 3-5 k x 17-20 k: err {err} "
              f"{ms:.3f} ms (plain {pms:.1f} ms), "
              f"{cells / ms / 1e6:.1f} GCUPS", flush=True)
        if err:
            raise RuntimeError(f"K6 {mode} disagrees with its plain version")
        report["K6"]["max_abs_err"] = max(report["K6"]["max_abs_err"], err)

    x = torch.from_numpy(ACGT[rng.integers(0, 4, 6000)]).to(dev)
    y = torch.from_numpy(ACGT[rng.integers(0, 4, 20000)]).to(dev)
    for t in (-1, -2, 3):
        row_k, ms = timed(
            lambda: longstair.stair_lastrow_device(x, y, t, params), 3)
        row_p, pms = timed(
            lambda: longstair.stair_lastrow_plain(x, y, t, params), 1,
            warm=False)
        err = max_err(row_k, row_p)
        print(f"[kernels] K7 6,000 x 20,000 start {t}: err {err} "
              f"{ms:.3f} ms (plain {pms:.1f} ms)", flush=True)
        if err:
            raise RuntimeError("K7 disagrees with its plain version")
        report["K7"]["max_abs_err"] = max(report["K7"]["max_abs_err"], err)


def level_tasks(ea, eb, p, params):
    """The tasks of each bisection level of (ea, eb) into p segments,
    recorded from a run of the level-batched crossing search."""
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        balanced_partition,
        batched_crossings,
    )
    levels = []

    def record(tasks):
        levels.append(tasks)
        return batched_crossings(tasks, params)

    balanced_partition(ea, eb, p, params, crossings_fn=record)
    return levels


def phase_long_main(report, runs):
    """K6 and K7 against their plain versions, bit for bit, at the shapes
    the partition path gave them: every bisection level of both pairs as
    the one K6 launch ``batched_crossings`` makes of its jobs (unequal
    widths, padded to the widest), in rows and in finals mode, and the
    level's largest job through K7, the kernel at B = 1. One plain fill a
    level gives all three: the plain finals are its rows at (la, lb), and
    a job's own row is its row of the bucket up to its lb. The kernels
    line takes the largest K6 bucket and K7 job."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import (
        longrow,
        longstair,
    )
    from cse305_parallel_sequence_alignment_torch.parallel import partition

    params = ScoringParams()
    dev = torch.device("cuda")
    largest = {"K6": 0.0, "K7": 0.0}
    for run in runs:
        levels = level_tasks(run["ea"], run["eb"], run["p"], params)
        for lvl, tasks in enumerate(levels, 1):
            jobs = partition.unique_jobs(tasks)[0]
            bucket = longrow.job_bucket(jobs, dev)
            la, lb = (v.cpu().numpy().astype(np.int64) for v in bucket[2:4])
            B = len(jobs)
            rows_p, pms = timed(lambda: longrow.long_fill_plain(
                *bucket, params, True), 1, warm=False)
            rows_k, ms = timed(lambda: longrow.long_fill(
                *bucket, params, True), 3)
            fins_k, ms_f = timed(lambda: longrow.long_fill(
                *bucket, params), 3)
            fins_p = rows_p[torch.arange(B, device=dev), :, bucket[3].long()]
            k = int(np.argmax(la * lb))
            x, y = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for v in jobs[k][:2])
            t = jobs[k][2]
            row7, ms7 = timed(lambda: longstair.stair_lastrow_device(
                x, y, t, params), 3)
            errs = {"rows": max_err(rows_k, rows_p),
                    "finals": max_err(fins_k, fins_p),
                    "K7": max_err(row7, rows_p[k, :, : int(lb[k]) + 1])}
            cells = float((la * lb).sum())
            print(f"[long-main] {run['name']} level {lvl}: K6 bucket {B} x "
                  f"{la.min()}-{la.max()} x {lb.min()}-{lb.max()} rows "
                  f"{ms:.3f} ms, finals {ms_f:.3f} ms (plain {pms:.1f} ms), "
                  f"{cells / ms / 1e6:.1f} GCUPS; K7 job {la[k]} x {lb[k]} "
                  f"{ms7:.3f} ms, {la[k] * lb[k] / ms7 / 1e6:.1f} GCUPS; "
                  f"errs {errs}", flush=True)
            if any(errs.values()):
                raise RuntimeError(f"K6/K7 disagree with their plain version "
                                   f"at {run['name']} level {lvl}: {errs}")
            for key, err, c, t_ms, ins, out in (
                    ("K6", max(errs["rows"], errs["finals"]), cells, ms,
                     nbytes(*bucket), rows_k),
                    ("K7", errs["K7"], float(la[k] * lb[k]), ms7,
                     nbytes(x, y), row7)):
                rep = report[key]
                rep["max_abs_err"] = max(rep["max_abs_err"], err)
                if c > largest[key]:
                    largest[key] = c
                    rep["ms"], rep["plain_ms"] = t_ms, pms
                    rep["bound_ms"], rep["bound_by"] = bound(
                        SWEEP_OPS * c, ins + nbytes(out))
            del rows_k, rows_p, fins_k, row7
        torch.cuda.empty_cache()
    if not all(largest.values()):
        raise RuntimeError(f"a long kernel had no partition shape: {largest}")


def phase_golden():
    from cse305_parallel_sequence_alignment_torch.core import (
        NEG_INF,
        ScoringParams,
    )
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )

    recs = [json.loads(line) for line in
            (ROOT / "tests" / "golden" / "cases.jsonl").read_text()
            .splitlines()]
    pipe = [r for r in recs if r["kind"] == "pipeline"]
    sub = [r for r in recs if r["kind"] == "subproblem"]
    ok = 0
    for gh in sorted({(r["g"], r["h"]) for r in pipe}):
        group = [r for r in pipe if (r["g"], r["h"]) == gh]
        al = BatchAligner(params=ScoringParams(g=gh[0], h=gh[1]))
        res = al.align_batch([(r["A"], r["B"]) for r in group])
        for r, got in zip(group, res):
            if (got.aligned_a, got.aligned_b) != (r["out_a"], r["out_b"]):
                raise RuntimeError(f"golden pipeline row differs: {r}")
            ok += 1
    for gh in sorted({(r["g"], r["h"]) for r in sub}):
        group = [r for r in sub if (r["g"], r["h"]) == gh]
        params = ScoringParams(g=gh[0], h=gh[1])
        res = BatchAligner(params=params).align_batch(
            [(r["A"], r["B"]) for r in group],
            start_types=[r["start"] for r in group],
            end_types=[r["end"] for r in group])
        finals = {}
        for st in sorted({r["start"] for r in group}):
            idx = [k for k, r in enumerate(group) if r["start"] == st]
            pairs = [(group[k]["A"], group[k]["B"]) for k in idx]
            cols = [BatchAligner(params=params, start_type=st,
                                 end_type=e).score_batch(pairs)[0]
                    for e in (1, 2, 3)]
            for w, k in enumerate(idx):
                finals[k] = [float(c[w]) for c in cols]
        for k, (r, got) in enumerate(zip(group, res)):
            chain = "".join(f"({i},{j},{t})" for (i, j, t) in got.chain)
            want = [NEG_INF if v == "-inf" else float(v)
                    for v in r["final"]]
            if chain != r["chain"] or finals[k] != want:
                raise RuntimeError(f"golden subproblem differs: {r}")
            ok += 1
    print(f"[golden] {ok}/{len(recs)} cases equal through "
          f"BatchAligner(device='cuda')", flush=True)
    if ok != len(recs):
        raise RuntimeError("golden cases missing")


def mutate(rng, s, rate):
    """Copy of s with substitutions and short indels at ``rate`` each."""
    out, k = [], 0
    while k < len(s):
        u = rng.random()
        if u < rate:
            out.append(ACGT[rng.integers(0, 4)])
        elif u < 2 * rate:
            pass  # deletion
        elif u < 3 * rate:
            out.extend(ACGT[rng.integers(0, 4, 3)])  # insertion
            out.append(s[k])
        else:
            out.append(s[k])
        k += 1
    return np.asarray(out, np.uint8)


def global_pairs(B=256, L=2048, seed=7):
    """The global path's pairs: B random ACGT pairs of L nt."""
    rng = np.random.default_rng(seed)
    return [(ACGT[rng.integers(0, 4, L)].tobytes().decode(),
             ACGT[rng.integers(0, 4, L)].tobytes().decode())
            for _ in range(B)]


def phase_main_path():
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        score_chain,
    )

    pairs = global_pairs()
    B = len(pairs)
    al = BatchAligner()
    al.align_batch(pairs)  # warm-up
    walls, phases = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align_batch(pairs)
        walls.append(time.perf_counter() - t0)
        phases.append(dict(al.last_phases))
    for r in res:
        if r.aligned_a is None or len(r.aligned_a) != len(r.aligned_b):
            raise RuntimeError("align_batch returned a malformed row")
    med = sorted(range(3), key=lambda k: walls[k])[1]
    split = ", ".join(f"{k} {v:.2f}" for k, v in phases[med].items())
    print(f"[main] align_batch 256 x 2 kb: walls "
          f"{[round(w * 1e3, 2) for w in walls]} ms, "
          f"{B / walls[med]:.1f} pairs/s (median run); phases {split}",
          flush=True)
    scores, tables = al.score_batch(pairs)
    got = np.array([r.score for r in res], np.float32)
    tabs = np.array([r.end_table for r in res], np.int32)
    if not (np.array_equal(scores, got) and np.array_equal(tables, tabs)):
        raise RuntimeError("score_batch disagrees with align_batch")
    print(f"[main] score_batch equals align_batch on {B} pairs "
          f"(mean score {float(scores.mean()):.3f})", flush=True)

    rng = np.random.default_rng(5)
    long_pairs = []
    for k in range(16):
        a = ACGT[rng.integers(0, 4, int(rng.integers(12000, 16001)))]
        if k % 2:  # related pair: long diagonal runs past the 255 cap
            b = mutate(rng, a, 0.002)[:16000]
            b = b if len(b) >= 12000 else np.concatenate([b, a[:12000 - len(b)]])
        else:
            b = ACGT[rng.integers(0, 4, int(rng.integers(12000, 16001)))]
        long_pairs.append((a, b))
    t0 = time.perf_counter()
    res = al.align_batch(long_pairs, traceback_mode="full")
    dt = time.perf_counter() - t0
    params = ScoringParams()
    for (a, b), r in zip(long_pairs, res):
        ea, eb = (a, b) if len(a) <= len(b) else (b, a)  # parity swap
        cs = score_chain(ea, eb, r.chain, params)
        if cs != r.score:
            raise RuntimeError(f"chain re-scores to {cs}, score {r.score}")
    print(f"[main] 16 pairs of 12-16 kb, full traceback: chains re-score "
          f"to their scores; {dt:.2f} s; scores "
          f"{[r.score for r in res]}", flush=True)


def phase_partition(report, runs):
    """Both dataset-scale pairs through ``PartitionedAligner(p=0)``, and
    nothing else, so that the launch window holds only ``align``; each
    pair's run (with its K6/K7 launches) is appended to ``runs``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )

    rng = np.random.default_rng(97)
    base = ACGT[rng.integers(0, 4, 97409)]
    pairs = [("97,409 nt vs a copy with 1% edits", base,
              mutate(rng, base, 0.0033)),
             ("13,309 x 97,409 random", ACGT[rng.integers(0, 4, 13309)],
              ACGT[rng.integers(0, 4, 97409)])]
    al = PartitionedAligner(p=0)
    for name, a, b in pairs:
        ea, eb = (a, b) if len(a) <= len(b) else (b, a)  # parity swap
        before = {k: report[k]["fn"].launches for k in ("K6", "K7")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align(a, b)
        t_align = time.perf_counter() - t0
        per = {k: report[k]["fn"].launches - before[k] for k in before}
        for k in per:
            report[k].setdefault("per_partition", {})[name] = per[k]
        runs.append(dict(name=name, a=a, b=b, ea=ea, eb=eb, res=res,
                         p=al._pick_p(len(ea), len(eb)), t_align=t_align,
                         phases=dict(al.last_phases), per=per))


def check_partition(runs):
    """Each partition's stitched score = its chain re-score = the whole
    pair's K6 score through ``score_batch``; rows give back the pair."""
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.ops import longrow
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        score_chain,
    )

    for run in runs:
        name, ea, eb, res, p = (run[k] for k in ("name", "ea", "eb", "res",
                                                 "p"))
        t0 = time.perf_counter()
        whole, _ = BatchAligner().score_batch([(run["a"], run["b"])])
        t_whole = time.perf_counter() - t0
        run["whole"] = float(whole[0])
        # the whole pair's K6 finals, which the long-pair pipeline must give
        run["k6_finals"] = longrow.long_fill(*longrow.job_bucket(
            [(ea, eb, -1)], "cuda"), ScoringParams())[0].cpu().numpy()
        cs = score_chain(ea, eb, res.chain, ScoringParams())
        if not res.score == cs == float(whole[0]):
            raise RuntimeError(f"{name}: stitched score {res.score}, chain "
                               f"re-score {cs}, whole-pair K6 {whole[0]}")
        if (res.aligned_a.replace("-", "") != ea.tobytes().decode()
                or res.aligned_b.replace("-", "") != eb.tobytes().decode()):
            raise RuntimeError(f"{name}: rows do not give back the pair")
        phases = ", ".join(f"{k} {v:.3f}" for k, v in run["phases"].items())
        print(f"[partition] {name} ({len(ea)} x {len(eb)}): p={p}, "
              f"{(p - 1).bit_length()} levels, {p} segments; align "
              f"{run['t_align']:.3f} s ({phases}); whole-pair K6 "
              f"score_batch {t_whole:.3f} s; score {res.score} = chain "
              f"re-score = whole-pair K6 score; launches in align "
              f"{run['per']}", flush=True)


def result_key(r):
    return (r.score, list(r.chain), r.aligned_a, r.aligned_b, r.end_table)


def backends_reference(runs):
    """What the backends path must give, from the fused routes and
    outside its launch window: ``align_batch`` and ``score_batch`` of the
    global path's 256 x 2 kb pairs, and the fused partition of the
    13,309 x 97,409 pair (``runs``)."""
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )

    pairs = global_pairs()
    al = BatchAligner()
    return dict(pairs=pairs, align=[result_key(r)
                                    for r in al.align_batch(pairs)],
                score=al.score_batch(pairs),
                part=next(r for r in runs if r["name"].startswith("13")))


def phase_backends_main(ref, out):
    """The backend routes alone, for the launch window: ``align_batch``
    under "rowdirs" (K1' + K2s row) and "wavefront" (K5 + K2s skew) on the
    global path's pairs (one warm-up, 2 timed runs each), ``score_batch``
    under "pallas_rowscan" (K3'), and ``PartitionedAligner(p=0,
    backend="wavefront").align`` of the 13,309 x 97,409 pair."""
    import torch

    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )

    pairs = ref["pairs"]
    for be in ("rowdirs", "wavefront"):
        al = BatchAligner(backend=be)
        al.align_batch(pairs)  # warm-up
        walls, phases = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = al.align_batch(pairs)
            walls.append(time.perf_counter() - t0)
            phases.append(dict(al.last_phases))
        out[be] = dict(res=res, walls=walls, phases=phases)
    al = BatchAligner(backend="pallas_rowscan")
    al.score_batch(pairs)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["rowscan"] = al.score_batch(pairs)
    out["t_rowscan"] = time.perf_counter() - t0
    run = ref["part"]
    pa = PartitionedAligner(p=0, backend="wavefront")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["part"] = pa.align(run["a"], run["b"])
    out["t_part"] = time.perf_counter() - t0
    out["part_phases"] = dict(pa.last_phases)


def check_backends(ref, out):
    """Gates of the backends path: every pair of both routes equal to the
    fused route's result (score, chain, both rows, end table: integer
    parameters, so all three routes compare exact values), the K3' scores
    equal to K3's, the wavefront partition equal to the fused one."""
    for be in ("rowdirs", "wavefront"):
        got = [result_key(r) for r in out[be]["res"]]
        bad = [k for k, (x, y) in enumerate(zip(got, ref["align"])) if x != y]
        if bad or len(got) != len(ref["align"]):
            raise RuntimeError(f"{be}: pairs {bad[:8]} differ from the "
                               f"fused route")
        walls, phases = out[be]["walls"], out[be]["phases"]
        med = int(np.argmin(walls))
        split = ", ".join(f"{k} {v:.2f}" for k, v in phases[med].items())
        print(f"[backends] align_batch(backend={be!r}) 256 x 2 kb: walls "
              f"{[round(w * 1e3, 2) for w in walls]} ms, "
              f"{len(got) / walls[med]:.1f} pairs/s (faster run); phases "
              f"{split}; all {len(got)} equal to the fused route", flush=True)
    s, t = out["rowscan"]
    if not (np.array_equal(s, ref["score"][0])
            and np.array_equal(t, ref["score"][1])):
        raise RuntimeError("pallas_rowscan score_batch differs from K3's")
    print(f"[backends] score_batch(backend='pallas_rowscan') 256 x 2 kb: "
          f"{out['t_rowscan'] * 1e3:.2f} ms, scores and tables equal to "
          f"K3's", flush=True)
    run, part = ref["part"], out["part"]
    if result_key(part) != result_key(run["res"]):
        raise RuntimeError("the wavefront partition differs from the fused "
                           "one")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in out["part_phases"].items())
    print(f"[backends] PartitionedAligner(p=0, backend='wavefront') "
          f"{run['name']}: {out['t_part']:.3f} s ({phases}); score "
          f"{part.score}, chain and rows equal to the fused partition's "
          f"({run['t_align']:.3f} s)", flush=True)


def phase_segment_kernels(report, ref, out):
    """K5 and K2s (skew) against their plain versions, bit for bit, on the
    very tensors that the wavefront partition's segment solves hand them:
    the 13,309 x 97,409 pair again through ``PartitionedAligner(p=0,
    backend="wavefront")``, outside the launch window, with the route's
    fill and walk recording their inputs (that run must give the window's
    result); then each recorded chunk through both versions of both
    kernels, the kernels timed once after a warm-up."""
    import unittest.mock

    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models import batch
    from cse305_parallel_sequence_alignment_torch.ops import device_walk, diag
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )

    params = ScoringParams()
    route = batch._ROUTES["wavefront"]
    fills, walks = [], []

    def fill(*args):
        fills.append([x.clone() for x in args[:5]])
        return route.fill(*args)

    def walk(dirs, la, lb, tables, max_steps):
        walks.append((la.clone(), lb.clone(), tables.clone(), max_steps))
        return route.walk(dirs, la, lb, tables, max_steps)

    t_start = time.perf_counter()
    run = ref["part"]
    with unittest.mock.patch.dict(
            batch._ROUTES, wavefront=route._replace(fill=fill, walk=walk)):
        res = PartitionedAligner(p=0, backend="wavefront").align(run["a"],
                                                                  run["b"])
    if result_key(res) != result_key(out["part"]):
        raise RuntimeError("the recorded wavefront partition differs from "
                           "the launch window's")
    if not fills or len(fills) != len(walks):
        raise RuntimeError(f"recorded {len(fills)} fills, {len(walks)} walks")
    for k, (args, (la, lb, tb, steps)) in enumerate(zip(fills, walks)):
        (d_k, f_k), ms5 = timed(lambda: diag.skew_dirs_fill(*args, params), 1)
        (d_p, f_p), pms5 = timed(
            lambda: diag.skew_dirs_fill_plain(*args, params), 1, warm=False)
        e5 = max(max_err_u8(d_k, d_p), max_err(f_k, f_p))
        del d_p
        w_k, ms2 = timed(lambda: device_walk.step_walk(d_k, la, lb, tb, steps,
                                                       "skew"), 1)
        w_p, pms2 = timed(lambda: device_walk.step_walk_plain(
            d_k, la, lb, tb, steps, "skew"), 1, warm=False)
        e2 = max(max_err_u8(w_k[0], w_p[0]), max_err(w_k[1], w_p[1]))
        B, m = args[0].shape
        n = args[1].shape[1]
        cells = float((args[2].to(torch.int64) * args[3]).sum())
        print(f"[segment-kernels] wavefront partition chunk {k}: {B} x {m} x "
              f"{n} (la {args[2].tolist()}, lb {args[3].tolist()}, start "
              f"types {args[4].tolist()}, dirs {nbytes(d_k) / 1e9:.2f} GB): "
              f"K5 err {e5} {ms5:.3f} ms (plain {pms5:.1f} ms), "
              f"{cells / ms5 / 1e6:.1f} GCUPS; K2s-skew err {e2}, "
              f"{int(w_k[1][0])} steps, {ms2:.3f} ms (plain {pms2:.1f} ms)",
              flush=True)
        if e5 or e2:
            raise RuntimeError(f"K5 {e5} or K2s-skew {e2} disagrees with its "
                               f"plain version at partition chunk {k}")
        for key, err in (("K5", e5), ("K2s-skew", e2)):
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
        del d_k, w_k, w_p
        torch.cuda.empty_cache()
    print(f"[segment-kernels] {len(fills)} chunks of the wavefront partition "
          f"held bit for bit in {time.perf_counter() - t_start:.1f} s",
          flush=True)


LONGSEQ_ROWS = 256  # rows a pipeline step on the long-pair path
# the long-pair path's column-sharded meshes: one card, and four entries of
# it (device-to-device halos between distinct cards need more cards)
LONGSEQ_MESHES = (("1 card", ("cuda:0",)), ("4 x cuda:0", ("cuda:0",) * 4))


def phase_longseq_main(runs, out):
    """The column-sharded pipeline alone, for the launch window:
    ``longseq_score`` of the 97 kb pair on one card and on four entries of
    it, ``longseq_lastrow`` of the 13 kb x 97 kb pair, and that pair
    through ``PartitionedAligner(p=4, fill_backend="sharded")``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.ops import halostair
    from cse305_parallel_sequence_alignment_torch.parallel import longseq
    from cse305_parallel_sequence_alignment_torch.parallel.mesh import Mesh
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )

    longseq.ROUTES.update(kernel=0, xla=0)
    long, tall = runs

    def timed_run(fn):
        before = halostair.halostair_step.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0, \
            halostair.halostair_step.launches - before

    for name, devs in LONGSEQ_MESHES:
        out[name] = timed_run(lambda: longseq.longseq_score(
            long["ea"], long["eb"], mesh=Mesh(devs), row_chunk=LONGSEQ_ROWS))
    out["lastrow"] = timed_run(lambda: longseq.longseq_lastrow(
        tall["ea"], tall["eb"], mesh=Mesh(["cuda:0"]),
        row_chunk=LONGSEQ_ROWS))
    al = PartitionedAligner(p=4, fill_backend="sharded")
    out["partition"] = timed_run(lambda: al.align(tall["a"], tall["b"]))
    out["partition_phases"] = dict(al.last_phases)
    out["routes"] = dict(longseq.ROUTES)


def check_longseq(runs, out):
    """Gates of the long-pair pipeline: both meshes' finals = the 97 kb
    pair's whole-pair K6 finals; the last row = K6's; the sharded
    partition = the fused one; every fill through the kernel route."""
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import longrow
    from cse305_parallel_sequence_alignment_torch.parallel.longseq import (
        longseq_pipeline_stats,
    )

    long, tall = runs
    m, n = len(long["ea"]), len(long["eb"])
    for name, devs in LONGSEQ_MESHES:
        fin, dt, calls = out[name]
        if not np.array_equal(fin, long["k6_finals"]):
            raise RuntimeError(f"longseq_score on {name}: {fin}, whole-pair "
                               f"K6 {long['k6_finals']}")
        stats = longseq_pipeline_stats(m, n, len(devs), LONGSEQ_ROWS)
        print(f"[longseq] longseq_score {m} x {n} on {name}: finals {fin} = "
              f"whole-pair K6 finals; {dt:.3f} s, {m * n / dt / 1e9:.3f} "
              f"GCUPS; R {LONGSEQ_ROWS}, {calls} K8 calls "
              f"({dt / calls * 1e3:.3f} ms a call, host clock); pipeline "
              f"{json.dumps(stats)}", flush=True)
    row, dt, calls = out["lastrow"]
    want = longrow.long_lastrow(tall["ea"], tall["eb"], ScoringParams())
    if not np.array_equal(row, want):
        raise RuntimeError("longseq_lastrow differs from K6's last row")
    m, n = len(tall["ea"]), len(tall["eb"])
    print(f"[longseq] longseq_lastrow {m} x {n} on 1 card: (3, {n + 1}) = "
          f"K6's last row; {dt:.3f} s, {m * n / dt / 1e9:.3f} GCUPS; R "
          f"{LONGSEQ_ROWS}, {calls} K8 calls", flush=True)
    res, dt, calls = out["partition"]
    if result_key(res) != result_key(tall["res"]):
        raise RuntimeError("the sharded partition differs from the fused one")
    phases = ", ".join(f"{k} {v:.3f}" for k, v in
                       out["partition_phases"].items())
    print(f"[longseq] PartitionedAligner(p=4, fill_backend='sharded') {m} x "
          f"{n}: = the fused partition (score {res.score}); {dt:.3f} s "
          f"({phases}); {calls} K8 calls (R 64, its default)", flush=True)
    if out["routes"]["xla"] or not out["routes"]["kernel"]:
        raise RuntimeError(f"longseq routes {out['routes']}")


def record_k8(pred):
    """(calls, patch): while ``patch`` is active, the pipeline's K8 calls
    whose (cs, base) satisfy ``pred`` are recorded, inputs cloned before
    the call (it advances state and fin in place)."""
    import unittest.mock

    from cse305_parallel_sequence_alignment_torch.parallel import longseq

    calls, real = [], longseq.halostair_step

    def rec(a, b, halo, state, fin, cs, base, la, st, params):
        if pred(cs, base):
            calls.append((a.clone(), b.clone(), halo.clone(), state.clone(),
                          fin.clone(), cs, base, la, st, params))
        return real(a, b, halo, state, fin, cs, base, la, st, params)
    return calls, unittest.mock.patch.object(longseq, "halostair_step", rec)


def check_k8(call, reps=0):
    """Largest difference of K8 and its plain version on one recorded
    call (halo, state and fin), and with ``reps`` the kernel's and the
    plain version's ms."""
    from cse305_parallel_sequence_alignment_torch.ops import halostair

    a, b, halo, state, fin, *rest = call
    s_k, f_k, s_p, f_p = state.clone(), fin.clone(), state.clone(), fin.clone()
    h_k = halostair.halostair_step(a, b, halo, s_k, f_k, *rest)
    h_p, pms = timed(lambda: halostair.halostair_step_plain(
        a, b, halo, s_p, f_p, *rest), 1, warm=False)
    err = max(max_err(h_k, h_p), max_err(s_k, s_p), max_err(f_k, f_p))
    ms = None
    if reps:  # on scratch carries, which the repeats advance
        s_t, f_t = state.clone(), fin.clone()
        _, ms = timed(lambda: halostair.halostair_step(a, b, halo, s_t, f_t,
                                                       *rest), reps)
    return err, ms, pms


def k8_alternatives(call, reps=3):
    """K8 on one recorded call at the geometry rule's choice, at the
    modelled best of each other C and at narrower and wider strips of the
    rule's C: {label: ms}; every alternative's outputs held bit for bit to
    the rule's (scratch carries, which the repeats advance)."""
    from cse305_parallel_sequence_alignment_torch.ops import halostair

    a, b, halo, state, fin, *rest = call
    nc, R = len(b), len(a)
    geos = {halostair.halostair_geometry(nc, R)}
    for C in halostair.ROWS_C:
        cands = sorted((halostair.geometry_cost(nc, R, c, t), c, t)
                       for c, t in halostair.halostair_geometries(nc)
                       if c == C)
        for k in {0, len(cands) // 2, len(cands) - 1} if cands else ():
            c, t = cands[k][1:]
            geos.add((c, t, halostair.strips_of(nc, c, t)))
    want = None
    times = {}
    for geo in sorted(geos, key=lambda g: g != halostair.halostair_geometry(
            nc, R)):
        s_k, f_k = state.clone(), fin.clone()
        h_k = halostair._launch(a, b, halo, s_k, f_k, *rest, geometry=geo)
        got = (h_k, s_k, f_k)
        if want is None:
            want = got
        err = max(max_err(x, y) for x, y in zip(got, want))
        if err:
            raise RuntimeError(f"K8 at {geo} differs from the rule's "
                               f"geometry by {err}")
        s_t, f_t = state.clone(), fin.clone()
        _, times[f"C={geo[0]} threads={geo[1]} strips={geo[2]}"] = timed(
            lambda: halostair._launch(a, b, halo, s_t, f_t, *rest,
                                      geometry=geo), reps)
    return times


def k8_sweep(R=LONGSEQ_ROWS, widths=(24503, 98010)):
    """``rows_kernel`` over R rows at the pipeline's block widths (a
    middle entry of four, and one entry) at a grid of (C, threads), each
    timed; a least squares fit of ``halostair.geometry_cost``'s model,
    (R + S - 1) x (a + b x warps) + (S - 1) x hand-off, for each C,
    printed beside ``ops/halostair.py``'s ``ROW_US`` and ``LINK_US``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import halostair

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    p = ScoringParams()
    a = torch.from_numpy(ACGT[rng.integers(0, 4, R)]).to(dev)
    halo = torch.full((R + 1, 4), float("-inf"), device=dev)
    pts = {C: [] for C in halostair.ROWS_C}
    for nc in widths:
        b = torch.from_numpy(ACGT[rng.integers(0, 4, nc)]).to(dev)
        state, fin, _ = halostair.halostair_init(0, nc, -1, p, dev)
        line = []
        for C in halostair.ROWS_C:
            for threads in range(128, halostair.ROWS_THREADS[C] + 1, 64):
                S = halostair.strips_of(nc, C, threads)
                _, ms = timed(lambda: halostair._launch(
                    a, b, halo, state, fin, 0, 0, 10 ** 9, -1, p,
                    geometry=(C, threads, S)), 3)
                pts[C].append((threads // 32, S, ms * 1e3))
                line.append(f"({C}, {threads}, {S}) {ms:.4f}")
        print(f"[longseq-kernels] K8 sweep, {nc} columns x {R} rows, ms: "
              + "; ".join(line), flush=True)
    fits = {}
    for C, rows in pts.items():
        A = np.array([[R + S - 1, (R + S - 1) * w, S - 1]
                      for w, S, _ in rows], float)
        y = np.array([t for *_, t in rows])
        fits[C] = [round(float(v), 4) for v in np.linalg.lstsq(
            A, y, rcond=None)[0]]
    print(f"[longseq-kernels] K8 sweep fit, us (a, b, hand-off) by C: "
          f"{fits}; in use ROW_US {halostair.ROW_US}, LINK_US "
          f"{halostair.LINK_US}", flush=True)


def phase_longseq_kernels(report, runs, out):
    """K8 against its plain version, bit for bit, on the tensors the long
    pipeline hands it: the 97 kb run on four entries again, outside the
    launch window, recording the first, a middle and the row-la call of
    each entry (that run must give the window's finals), each timed; then
    every call of a 3 k x 12 k pair at g=0.3, h=1.7 and of a 300 x 5,000
    pair for each start type, on four entries of the card."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import halostair
    from cse305_parallel_sequence_alignment_torch.parallel import longseq
    from cse305_parallel_sequence_alignment_torch.parallel.mesh import Mesh

    t_start = time.perf_counter()
    long = runs[0]
    m = len(long["ea"])
    C = -(-m // LONGSEQ_ROWS)
    picked = {0, (C // 2) * LONGSEQ_ROWS, (C - 1) * LONGSEQ_ROWS}
    four = Mesh(LONGSEQ_MESHES[1][1])
    calls, patch = record_k8(lambda cs, base: base in picked)
    with patch:
        fin = longseq.longseq_score(long["ea"], long["eb"], mesh=four,
                                    row_chunk=LONGSEQ_ROWS)
    if not np.array_equal(fin, out[LONGSEQ_MESHES[1][0]][0]):
        raise RuntimeError("the recorded pipeline run differs from the "
                           "launch window's")
    rep = report["K8"]
    for call in calls:
        a, b, halo, state, fin_in, cs, base, la = call[:8]
        err, ms, pms = check_k8(call, reps=3)
        rows, nc = min(len(a), la - base), len(b)
        print(f"[longseq-kernels] 97 kb pipeline, entry at column {cs}, rows "
              f"{base + 1}-{base + rows} x {nc} columns: err {err} "
              f"{ms:.3f} ms (plain {pms:.1f} ms), "
              f"{rows * nc / ms / 1e6:.2f} GCUPS", flush=True)
        if err:
            raise RuntimeError(f"K8 disagrees with its plain version at "
                               f"column {cs}, base {base}")
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        if base == (C // 2) * LONGSEQ_ROWS and cs > 0 and "ms" not in rep:
            alts = k8_alternatives(call)
            print(f"[longseq-kernels] K8 at {nc} columns x {rows} rows "
                  f"(rule {halostair.halostair_geometry(nc, len(a))}): "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in alts.items()),
                  flush=True)
            rep["ms"], rep["plain_ms"] = ms, pms
            # each input read once, each output written once: a, b, the
            # halo in and out, the carries (2 x nc) and the capture
            # (3 x nc) in and out
            moved = nbytes(a, b) + 2 * nbytes(halo) + 2 * nbytes(state) \
                + 2 * nbytes(fin_in)
            rep["bound_ms"], rep["bound_by"] = bound(
                HALOSTAIR_OPS * rows * nc, moved)
    checked = len(calls)
    # one entry: a middle call over the whole 98 k columns
    calls1, patch = record_k8(
        lambda cs, base: base == (C // 2) * LONGSEQ_ROWS)
    with patch:
        fin = longseq.longseq_score(long["ea"], long["eb"],
                                    mesh=Mesh(LONGSEQ_MESHES[0][1]),
                                    row_chunk=LONGSEQ_ROWS)
    if not np.array_equal(fin, out[LONGSEQ_MESHES[0][0]][0]):
        raise RuntimeError("the recorded one-card run differs from the "
                           "launch window's")
    for call in calls1:
        a, b, halo, state, fin_in, cs, base, la = call[:8]
        err, ms, pms = check_k8(call, reps=3)
        rows, nc = min(len(a), la - base), len(b)
        moved = nbytes(a, b) + 2 * nbytes(halo) + 2 * nbytes(state) \
            + 2 * nbytes(fin_in)
        bnd = bound(HALOSTAIR_OPS * rows * nc, moved)
        alts = k8_alternatives(call)
        print(f"[longseq-kernels] K8 one entry: 97 kb pipeline on one card, "
              f"rows {base + 1}-{base + rows} x {nc} columns: err {err} "
              f"{ms:.3f} ms (plain {pms:.1f} ms; bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}; rule {halostair.halostair_geometry(nc, len(a))}), "
              f"{rows * nc / ms / 1e6:.2f} GCUPS; "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in alts.items()),
              flush=True)
        if err:
            raise RuntimeError(f"K8 disagrees with its plain version on one "
                               f"entry, base {base}")
    checked += len(calls1)
    k8_sweep()
    rng = np.random.default_rng(19)
    small = [(NON_DYADIC, -1, 3000, 12000, LONGSEQ_ROWS)] + [
        ({}, st, 300, 5000, 64) for st in (-1, -2, -3, 1, 2, 3)]
    for kw, st, sm, sn, rc in small:
        params = ScoringParams(**kw)
        x, y = ACGT[rng.integers(0, 4, sm)], ACGT[rng.integers(0, 4, sn)]
        calls, patch = record_k8(lambda cs, base: True)
        with patch:
            longseq.longseq_lastrow(x, y, params, st, mesh=four, row_chunk=rc)
        errs = [check_k8(call)[0] for call in calls]
        print(f"[longseq-kernels] {sm} x {sn} start {st} {params}: "
              f"{len(calls)} K8 calls on four entries, max err {max(errs)}",
              flush=True)
        if max(errs):
            raise RuntimeError(f"K8 disagrees with its plain version on "
                               f"{sm} x {sn}, start {st}")
        checked += len(calls)
        torch.cuda.empty_cache()
    print(f"[longseq-kernels] {checked} K8 calls held bit for bit in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def phase_sharded_main(local_pairs, out):
    """The data-sharded aligners alone, for the launch window:
    ``ShardedBatchAligner`` ``align_batch`` and ``score_batch`` on the
    global path's 256 x 2 kb pairs over one card and over two entries of
    it; ``ShardedLocalBatchAligner`` scores of the local path's pairs over
    two entries."""
    import torch

    from cse305_parallel_sequence_alignment_torch.parallel.batch_shard import (
        ShardedBatchAligner,
        ShardedLocalBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.parallel.mesh import Mesh

    pairs = global_pairs()
    for name, devs in (("1 card", ["cuda:0"]), ("2 x cuda:0", ["cuda:0"] * 2)):
        al = ShardedBatchAligner(mesh=Mesh(devs, ("data",)))
        al.align_batch(pairs)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align_batch(pairs)
        dt = time.perf_counter() - t0
        out[name] = (res, al.score_batch(pairs), dt, dict(al.last_phases))
    loc = ShardedLocalBatchAligner(mesh=Mesh(["cuda:0"] * 2, ("data",)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["local"] = (loc.score_batch(local_pairs), time.perf_counter() - t0)


def check_sharded(local_scores, out):
    """Every sharded result = the unsharded aligner's on the card."""
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )

    pairs = global_pairs()
    al = BatchAligner()
    want = [result_key(r) for r in al.align_batch(pairs)]
    want_scores = al.score_batch(pairs)
    for name in ("1 card", "2 x cuda:0"):
        res, scores, dt, phases = out[name]
        if [result_key(r) for r in res] != want or not all(
                np.array_equal(x, y) for x, y in zip(scores, want_scores)):
            raise RuntimeError(f"ShardedBatchAligner on {name} differs from "
                               f"BatchAligner")
        split = ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
        print(f"[sharded] ShardedBatchAligner on {name}: align_batch 256 x "
              f"2 kb {dt * 1e3:.2f} ms, {len(pairs) / dt:.1f} pairs/s "
              f"(phases, summed over entries: {split}); align_batch and "
              f"score_batch = BatchAligner's", flush=True)
    scores, dt = out["local"]
    if not all(np.array_equal(x, y) for x, y in zip(scores, local_scores)):
        raise RuntimeError("ShardedLocalBatchAligner scores differ")
    print(f"[sharded] ShardedLocalBatchAligner on 2 x cuda:0: score_batch "
          f"{len(scores[0])} x 2 kb {dt:.3f} s = LocalBatchAligner's",
          flush=True)


PERF_MODES = {"global_score", "global_score_rowscan_kernel", "local_score",
              "global_dirs", "semiglobal_dirs", "overlap_dirs",
              "banded_score_W129", "banded_score_W513", "banded_dirs_W129",
              "banded_dirs_W513", "longrow_score", "global_align_e2e",
              "longseq_score", "longseq_score_1dev",
              "longseq_score_1dev_kernel"}


def phase_perf():
    """The ``perf`` command in a subprocess at its defaults, its longseq
    rows included: every row parses, carries no error, names the card;
    each is printed on a ``[perf]`` line."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", PKG, "perf"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"perf failed (rc {out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    for r in rows:
        print(f"[perf] {json.dumps(r)}", flush=True)
    modes = {r["mode"] for r in rows}
    if modes != PERF_MODES or any("error" in r or r["backend"] != "cuda"
                                  for r in rows):
        raise RuntimeError(f"perf rows: modes {sorted(modes)}")
    print(f"[perf] {len(rows)} rows in {time.perf_counter() - t0:.1f} s, "
          f"none with an error", flush=True)


def phase_cli():
    out = subprocess.run(
        [sys.executable, "-m", PKG, "align", "--a", "AGGA", "--b", "AGTGC"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or lines[-2:] != ["AG-GA", "AGTGC"]:
        raise RuntimeError(f"CLI align failed (rc {out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr}")
    print("[cli] align --a AGGA --b AGTGC -> AG-GA / AGTGC", flush=True)

    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )
    rng = np.random.default_rng(41)
    a, b = (ACGT[rng.integers(0, 4, n)].tobytes().decode()
            for n in (3000, 4000))
    out = subprocess.run(
        [sys.executable, "-m", PKG, "partition", "--a", a, "--b", b,
         "--p", "4"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    want = PartitionedAligner(p=4).align(a, b)
    if out.returncode != 0 or out.stdout.splitlines()[-2:] != [
            want.aligned_a, want.aligned_b]:
        raise RuntimeError(f"CLI partition failed (rc {out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    print("[cli] partition --a (3,000 nt) --b (4,000 nt) --p 4 -> the rows "
          "of PartitionedAligner(p=4)", flush=True)

    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalBatchAligner,
    )
    a, b = "GGGACGTACGTGGGTTAGACCA", "TTTACGTACCGTTTTAGACA"
    out = subprocess.run(
        [sys.executable, "-m", PKG, "local", "--a", a, "--b", b], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    r = LocalBatchAligner().align_batch([(a, b)])[0]
    want = {"score": r.score, "cigar": r.cigar,
            "cigar_extended": r.cigar_extended,
            "query_span": [r.start_a, r.end_a],
            "target_span": [r.start_b, r.end_b]}
    if out.returncode != 0 or json.loads(out.stdout.splitlines()[-1]) != want:
        raise RuntimeError(f"CLI local failed (rc {out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr[-4000:]}")
    print(f"[cli] local --a {a} --b {b} -> {json.dumps(want)}", flush=True)

    from cse305_parallel_sequence_alignment_torch.models.overlap import (
        OverlapBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
        SemiGlobalBatchAligner,
    )
    for cmd, a, b, cls, fields in (
            ("semiglobal", "ACGTTGCA", "TTTTACGATGCATTTT",
             SemiGlobalBatchAligner,
             ("score", "cigar", "cigar_extended", "target_span")),
            ("overlap", "GGGGGACGTACGT", "ACGTACGTCCCCCC",
             OverlapBatchAligner, ("score", "cigar", "a_span", "b_span"))):
        out = subprocess.run(
            [sys.executable, "-m", PKG, cmd, "--a", a, "--b", b], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        r = cls().align_batch([(a, b)])[0]
        want = {f: (list(getattr(r, f)) if f.endswith("span")
                    else getattr(r, f)) for f in fields}
        if out.returncode != 0 or \
                json.loads(out.stdout.splitlines()[-1]) != want:
            raise RuntimeError(f"CLI {cmd} failed (rc {out.returncode}):\n"
                               f"{out.stdout}\n{out.stderr[-4000:]}")
        print(f"[cli] {cmd} --a {a} --b {b} -> {json.dumps(want)}",
              flush=True)


def phase_cli_longscore(runs, out):
    """``longscore --devices 1`` on the 97 kb pair (K6) scores what the
    long-pair pipeline's finals give; ``--devices`` past the host's cards
    fails naming their count (the CLI never repeats a card)."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import (
        end_table_choice,
    )

    long = runs[0]
    a, b = long["ea"].tobytes().decode(), long["eb"].tobytes().decode()
    table, score = end_table_choice(
        *(float(x) for x in out[LONGSEQ_MESHES[0][0]][0]), -1, 2.0)
    res = subprocess.run(
        [sys.executable, "-m", PKG, "longscore", "--a", a, "--b", b,
         "--devices", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    got = json.loads(res.stdout.splitlines()[-1]) if res.returncode == 0 \
        else None
    if got is None or (got["score"], got["end_table"]) != (score, table):
        raise RuntimeError(f"CLI longscore failed or differs (rc "
                           f"{res.returncode}): {res.stdout[-2000:]}\n"
                           f"{res.stderr[-4000:]}")
    print(f"[cli] longscore --devices 1 (K6) on {len(a)} x {len(b)} -> score "
          f"{got['score']}, table {got['end_table']} = the pipeline's finals; "
          f"{got['seconds']} s", flush=True)
    cards = torch.cuda.device_count()
    res = subprocess.run(
        [sys.executable, "-m", PKG, "longscore", "--a", "ACGT", "--b", "ACG",
         "--devices", str(cards + 1)], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    last = (res.stderr.strip().splitlines() or [""])[-1]
    if res.returncode == 0 or f"has {cards} card" not in last:
        raise RuntimeError(f"CLI longscore --devices {cards + 1} did not "
                           f"refuse: rc {res.returncode}, {last}")
    print(f"[cli] longscore --devices {cards + 1} on {cards} card(s) -> "
          f"{last}", flush=True)


def mutate_core(rng, core, sub, indel, alphabet=ACGT):
    """Copy of ``core`` with substitutions at rate ``sub`` (always another
    letter of ``alphabet``) and single-letter insertions and deletions at
    ``indel`` each half."""
    k = len(alphabet)
    lut = np.zeros(256, np.int64)
    lut[alphabet] = np.arange(k)
    codes = lut[core]
    n = len(core)
    subs = rng.random(n) < sub
    codes[subs] = (codes[subs] + rng.integers(1, k, int(subs.sum()))) % k
    ev = rng.random(n) < indel
    dels = ev & (rng.random(n) < 0.5)
    ins = ev & ~dels
    keep = alphabet[codes]
    out = np.insert(keep, np.nonzero(ins)[0],
                    alphabet[rng.integers(0, k, int(ins.sum()))])
    shift = np.cumsum(ins) - ins  # insertions placed before each base
    return np.delete(out, np.nonzero(dels)[0] + shift[dels])


def local_data(count=4096, L=2048, core=1024, seed=11):
    """BASELINE config 3's pairs: even pairs share a ``core``-nt segment,
    B's copy with 3% substitutions and 1% single-base indels, each at a
    random offset in random flanks; odd pairs are unrelated."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        a = ACGT[rng.integers(0, 4, L)]
        b = ACGT[rng.integers(0, 4, L)]
        if k % 2 == 0:
            c = ACGT[rng.integers(0, 4, core)]
            mc = mutate_core(rng, c, 0.03, 0.01)[:L]
            oa = int(rng.integers(0, L - core + 1))
            ob = int(rng.integers(0, L - len(mc) + 1))
            a[oa: oa + core] = c
            b[ob: ob + len(mc)] = mc
        pairs.append((a, b))
    return pairs


def chain_rescore(ea, eb, chain, params):
    """Score of a local, semi-global or overlap chain: its match/mismatch
    columns, h + g a gap run (a run of one gap table) and g each further
    gap point; exact for integer parameters."""
    if not len(chain):
        return 0.0
    c = np.asarray(list(chain), np.int64)
    i, j, t = c[:, 0], c[:, 1], c[:, 2]
    diag = t == 1
    f = np.where(ea[i[diag] - 1] == eb[j[diag] - 1], params.match,
                 params.mismatch).sum()
    opens = ~diag & np.r_[True, t[1:] != t[:-1]]
    gaps = int((~diag).sum())
    return float(f - opens.sum() * (params.g + params.h)
                 - (gaps - opens.sum()) * params.g)


def code_bucket(pairs):
    """(a, b, la, lb) numpy bucket of code-array pairs, padded to the
    longest member."""
    la = np.array([len(x) for x, _ in pairs], np.int32)
    lb = np.array([len(y) for _, y in pairs], np.int32)
    a = np.full((len(pairs), max(1, la.max())), 254, np.uint8)
    b = np.full((len(pairs), max(1, lb.max())), 255, np.uint8)
    for k, (x, y) in enumerate(pairs):
        a[k, : la[k]] = x
        b[k, : lb[k]] = y
    return a, b, la, lb


def path_chunks(al, pairs):
    """The first ``align_batch`` chunk and the first ``score_batch``
    chunk of the largest bucket of ``pairs``, padded to the bucket shape
    (both axes rounded up to ``bucket_quantum``) and cut as the aligner
    ``al`` cuts them: two (a, b, la, lb) numpy buckets."""
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        _bucket_arrays,
    )

    enc_a, enc_b, buckets = al._prep(pairs)
    key, idxs = max(buckets.items(), key=lambda kv: len(kv[1]))
    step = al.chunk_size(key, len(idxs))
    matrix = getattr(al, "matrix", None)
    return (_bucket_arrays(enc_a, enc_b, idxs[:step], key, matrix),
            _bucket_arrays(enc_a, enc_b, idxs[:al.max_batch], key, matrix))


def bucket_name(arrays):
    a, b, _, _ = arrays
    return f"{a.shape[0]} x {a.shape[1]:,} x {b.shape[1]:,}"


def phase_local_kernels(report, data):
    """K9s, K9d and K9w against their plain versions on the card, bit for
    bit: 8 ragged pairs up to 2 kb, then the local path's own chunks
    (K9d and K9w at an ``align_batch`` chunk, K9s at a ``score_batch``
    chunk), timed with CUDA events."""
    import torch

    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.models.local_oracle import (
        LOCAL_PARAMS,
    )
    from cse305_parallel_sequence_alignment_torch.ops import (
        device_walk,
        local,
    )

    rng = np.random.default_rng(12)

    def rnd(n):
        return ACGT[rng.integers(0, 4, n)]

    def text(s):
        return np.frombuffer(s.encode(), np.uint8)

    core = rnd(1200)
    ragged = [
        (rnd(2048), rnd(2048)),
        (text("AC" * 1024), text("ACA" * 682)),           # ties everywhere
        (text("ACA" * 600), text("AC" * 1000)),
        (text("A" * 1500), text("C" * 2048)),             # all mismatch
        (np.concatenate([rnd(500), core, rnd(348)]),      # m > n
         np.concatenate([rnd(50), mutate_core(rng, core, 0.03, 0.01)])),
        (rnd(1), rnd(2048)),
        (rnd(37), rnd(900)),
        (rnd(2048), rnd(1999)),
    ]
    ragged = code_bucket(ragged)
    dirs_chunk, score_chunk = path_chunks(LocalBatchAligner(), data)
    cases = [("ragged 8 x <=2 kb", ragged, ragged, False),
             (f"local path chunks: K9d/K9w {bucket_name(dirs_chunk)}, K9s "
              f"{bucket_name(score_chunk)}", dirs_chunk, score_chunk, True)]
    dev = torch.device("cuda")
    for name, dbucket, sbucket, big in cases:
        la, lb = dbucket[2], dbucket[3]
        args = [torch.from_numpy(x).to(dev) for x in dbucket]
        sargs = [torch.from_numpy(x).to(dev) for x in sbucket]
        reps = 3 if big else 1
        (bd_k, d_k), msd = timed(lambda: local.sw_dirs(*args, LOCAL_PARAMS),
                                 reps)
        (bd_p, d_p), pmsd = timed(lambda: local.sw_fill_plain(
            *args, LOCAL_PARAMS, want_dirs=True), 1, warm=False)
        ed = max(max_err(bd_k, bd_p), max_err_u8(d_k, d_p))
        bs_k, mss = timed(lambda: local.sw_score(*sargs, LOCAL_PARAMS), reps)
        bs_p, pmss = timed(lambda: local.sw_fill_plain(
            *sargs, LOCAL_PARAMS, want_dirs=False)[0], 1, warm=False)
        # K9s and K9d agree on the pairs both chunks hold
        es = max(max_err(bs_k, bs_p), max_err(bs_k[: len(la)], bd_k))
        ei = bd_k[:, 1].to(torch.int32)
        ej = bd_k[:, 2].to(torch.int32)
        steps = int(la.max()) + int(lb.max())
        (w_k, u_k), msw = timed(
            lambda: device_walk.local_walk(d_k, ei, ej, steps), reps)
        (w_p, u_p), pmsw = timed(
            lambda: device_walk.local_walk_plain(d_k, ei, ej, steps), 1,
            warm=False)
        ew = max(max_err_u8(w_k, w_p), max_err(u_k, u_p))
        best = bd_k.cpu().numpy()
        print(f"[local-kernels] {name}: K9d err {ed} {msd:.3f} ms (plain "
              f"{pmsd:.1f} ms); K9s err {es} {mss:.3f} ms (plain "
              f"{pmss:.1f} ms); K9w err {ew} steps {int(u_k[0])} "
              f"{msw:.3f} ms (plain {pmsw:.1f} ms); zero-score pairs "
              f"{int((best[:, 0] <= 0).sum())}", flush=True)
        if ed or es or ew:
            raise RuntimeError(f"a local kernel disagrees with its plain "
                               f"version on {name}: K9d {ed} K9s {es} K9w "
                               f"{ew}")
        if not big and best[3].tolist() != [0.0, 0.0, 0.0]:
            raise RuntimeError(f"all-mismatch pair's best {best[3]}")
        cells = float((la.astype(np.int64) * lb).sum())
        s_cells = float((sbucket[2].astype(np.int64) * sbucket[3]).sum())
        taken = int((w_k != 0).sum())  # one dirs byte read per step
        bounds = {"K9d": bound(SW_DIRS_OPS * cells,
                               nbytes(*args, d_k, bd_k)),
                  "K9s": bound(SW_OPS * s_cells, nbytes(*sargs, bs_k)),
                  "K9w": bound(0, taken + nbytes(ei, ej, w_k, u_k))}
        for key, err, ms, pms in (("K9d", ed, msd, pmsd),
                                  ("K9s", es, mss, pmss),
                                  ("K9w", ew, msw, pmsw)):
            rep = report[key]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if big:
                rep["ms"], rep["plain_ms"] = ms, pms
                rep["bound_ms"], rep["bound_by"] = bounds[key]
        if big:
            print(f"[local-kernels] {name}: K9d {cells / msd / 1e6:.1f} "
                  f"GCUPS, K9s {s_cells / mss / 1e6:.1f} GCUPS; bounds "
                  f"{ {k: round(v[0], 4) for k, v in bounds.items()} } ms",
                  flush=True)
        del d_k, d_p, args, sargs
        torch.cuda.empty_cache()


def phase_local_main(data, out):
    """The local path alone, for the launch window: ``align_batch`` on
    all of ``data`` (one warm-up, 3 timed runs) and ``score_batch``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalBatchAligner,
    )

    al = LocalBatchAligner()
    al.align_batch(data)  # warm-up
    walls, phases = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align_batch(data)
        walls.append(time.perf_counter() - t0)
        phases.append(dict(al.last_phases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = al.score_batch(data)
    t_score = time.perf_counter() - t0
    out.update(res=res, walls=walls, phases=phases, chunks=al.last_chunks,
               scores=scores, t_score=t_score)


def check_local(data, out):
    """Gates of the local path; a run that fails one reports no speed."""
    import torch

    from cse305_parallel_sequence_alignment_torch.models.local_oracle import (
        LOCAL_PARAMS,
    )
    from cse305_parallel_sequence_alignment_torch.native import walker
    from cse305_parallel_sequence_alignment_torch.ops.cigar import (
        cigar_consumed,
    )
    from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
        local_walk_plain,
    )
    from cse305_parallel_sequence_alignment_torch.ops.local import (
        sw_fill_plain,
    )

    res = out["res"]
    scores, ei, ej = out["scores"]
    if not (np.array_equal(scores, [r.score for r in res])
            and np.array_equal(ei, [r.end_a for r in res])
            and np.array_equal(ej, [r.end_b for r in res])):
        raise RuntimeError("score_batch disagrees with align_batch")
    for k, ((a, b), r) in enumerate(zip(data, res)):
        if chain_rescore(a, b, r.chain, LOCAL_PARAMS) != r.score:
            raise RuntimeError(f"pair {k}: chain re-scores to "
                               f"{chain_rescore(a, b, r.chain, LOCAL_PARAMS)}"
                               f", score {r.score}")
        span = ((r.end_a - r.start_a + 1, r.end_b - r.start_b + 1)
                if r.chain else (0, 0))
        if cigar_consumed(r.cigar) != span or \
                cigar_consumed(r.cigar_extended) != span:
            raise RuntimeError(f"pair {k}: CIGAR {r.cigar} does not consume "
                               f"its spans {span}")
    # the first 64 pairs through the plain versions on the card
    dev = torch.device("cuda")
    a, b, la, lb = code_bucket(data[:64])
    best, dirs = sw_fill_plain(*[torch.from_numpy(x).to(dev)
                                 for x in (a, b, la, lb)], LOCAL_PARAMS,
                               want_dirs=True)
    pi = best[:, 1].to(torch.int32)
    pj = best[:, 2].to(torch.int32)
    ops, used = local_walk_plain(dirs, pi, pj, int(la.max()) + int(lb.max()))
    del dirs
    best = best.cpu().numpy()
    tt, ii, jj, lens, _, _, cig, ext = walker.local_build(
        ops.cpu().numpy()[: int(used[0])].T, best[:, 1].astype(np.int64),
        best[:, 2].astype(np.int64), a, b)
    for r in range(len(lens)):
        L = int(lens[r])
        want = (float(best[r, 0]), int(best[r, 1]), int(best[r, 2]),
                list(zip(ii[r, :L].tolist(), jj[r, :L].tolist(),
                         tt[r, :L].tolist())),
                cig[r], ext[r])
        got = res[r]
        if want != (got.score, got.end_a, got.end_b, list(got.chain),
                    got.cigar, got.cigar_extended):
            raise RuntimeError(f"pair {r}: align_batch differs from the "
                               f"plain versions on the card")
    torch.cuda.empty_cache()
    walls, phases = out["walls"], out["phases"]
    med = sorted(range(3), key=lambda k: walls[k])[1]
    cells = float(sum(len(x) * len(y) for x, y in data))
    split = ", ".join(f"{k} {v:.2f}" for k, v in phases[med].items())
    lens = np.array([len(r.chain) for r in res])
    print(f"[local] align_batch {len(data)} x 2 kb (BASELINE config 3): "
          f"walls {[round(w * 1e3, 2) for w in walls]} ms, "
          f"{len(data) / walls[med]:.1f} pairs/s, "
          f"{cells / walls[med] / 1e9:.1f} cell GCUPS (median run); phases "
          f"{split}; {out['chunks']} chunks under dirs_budget; score_batch "
          f"{out['t_score'] * 1e3:.2f} ms, "
          f"{cells / out['t_score'] / 1e9:.1f} GCUPS", flush=True)
    print(f"[local] gates held: score_batch = align_batch, {len(res)} chains "
          f"re-score to their scores, CIGARs consume their spans, first 64 "
          f"pairs = plain versions on the card; chain length mean "
          f"{lens.mean():.1f} (even pairs {lens[0::2].mean():.1f}, odd "
          f"{lens[1::2].mean():.1f}), max {lens.max()}; mean score "
          f"{float(np.mean(scores)):.3f}", flush=True)


def sg_data(count=16384, read=250, window=1024, seed=23):
    """Reads placed into reference windows: three of every four reads are
    taken from their window at a random offset, with 1% substitutions
    and 0.2% single-base indels; the fourth is random (unplaced)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        b = ACGT[rng.integers(0, 4, window)]
        if k % 4 == 3:
            a = ACGT[rng.integers(0, 4, read)]
        else:
            o = int(rng.integers(0, window - read - 8))
            a = mutate_core(rng, b[o: o + read + 8], 0.01, 0.002)[:read]
        pairs.append((a, b))
    return pairs


def ov_data(count=4096, L=2000, seed=29):
    """Read pairs: a quarter put a suffix of A on a prefix of B over
    500-1,500 nt with 2% edits (1.5% substitutions, 0.5% single-base
    indels), a quarter a prefix of A on a suffix of B, half unrelated."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        a = ACGT[rng.integers(0, 4, L)]
        b = ACGT[rng.integers(0, 4, L)]
        n = int(rng.integers(500, 1501))
        if k % 4 == 0:    # suffix of A, then B's own tail
            core = mutate_core(rng, a[L - n:], 0.015, 0.005)
            b = np.concatenate([core, b])[:L]
        elif k % 4 == 1:  # B's own head, then a prefix of A
            core = mutate_core(rng, a[:n], 0.015, 0.005)
            b = np.concatenate([b, core])[-L:]
        pairs.append((a, b))
    return pairs


def phase_free_kernels(report, sgd, ovd):
    """K10s/K10d and K11s/K11d against their plain versions on the card,
    bit for bit: ragged pairs with an empty side, m > n and 1,100
    columns at the default and a non-dyadic parameter set; then each
    main path's own chunks (the dirs fill at an ``align_batch`` chunk,
    the score fill at a ``score_batch`` chunk), timed with CUDA
    events."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.overlap import (
        OverlapBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
        FREE_END_PARAMS,
        SemiGlobalBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.ops import diag, rowcb

    rng = np.random.default_rng(17)

    def rnd(n):
        return ACGT[rng.integers(0, 4, n)]

    core = rnd(400)
    ragged = [(rnd(250), rnd(1100)), (rnd(0), rnd(300)), (rnd(120), rnd(0)),
              (rnd(0), rnd(0)), (np.concatenate([rnd(700), core]),  # m > n
                                 np.concatenate([core, rnd(100)])),
              (core, np.concatenate([rnd(600), core, rnd(99)])),
              (rnd(1), rnd(1)), (rnd(999), rnd(1024))]
    ragged = code_bucket(ragged)
    kinds = {"semiglobal": ("K10s", diag.semiglobal_score, "K10d",
                            rowcb.semiglobal_dirs,
                            rowcb.semiglobal_dirs_plain,
                            SemiGlobalBatchAligner, sgd),
             "overlap": ("K11s", diag.overlap_score, "K11d",
                         rowcb.overlap_dirs, rowcb.overlap_dirs_plain,
                         OverlapBatchAligner, ovd)}
    dev = torch.device("cuda")
    for mode, (ks, score, kd, dirs_fill, dirs_plain, cls,
               data) in kinds.items():
        dirs_chunk, score_chunk = path_chunks(cls(), data)
        cases = [("ragged 8 x <=1.1 k", ragged, ragged, False,
                  FREE_END_PARAMS),
                 ("ragged 8 x <=1.1 k, non-dyadic", ragged, ragged, False,
                  ScoringParams(**NON_DYADIC)),
                 (f"path chunks: {kd} {bucket_name(dirs_chunk)}, {ks} "
                  f"{bucket_name(score_chunk)}", dirs_chunk, score_chunk,
                  True, FREE_END_PARAMS)]
        for name, dbucket, sbucket, big, params in cases:
            la, lb = dbucket[2], dbucket[3]
            args = [torch.from_numpy(x).to(dev) for x in dbucket]
            sargs = [torch.from_numpy(x).to(dev) for x in sbucket]
            zeros = torch.zeros_like(sargs[2])
            reps = 3 if big else 1
            (d_k, f_k), msd = timed(lambda: dirs_fill(*args, params), reps)
            (d_p, f_p), pmsd = timed(lambda: dirs_plain(*args, params), 1,
                                     warm=False)
            ed = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
            s_k, mss = timed(lambda: score(*sargs, params), reps)
            s_p, pmss = timed(lambda: diag.diag_fill_plain(
                *sargs, zeros, params, mode), 1, warm=False)
            es = max_err(s_k, s_p)
            print(f"[{mode}-kernels] {name}: {kd} err {ed} {msd:.3f} ms "
                  f"(plain {pmsd:.1f} ms); {ks} err {es} {mss:.3f} ms "
                  f"(plain {pmss:.1f} ms)", flush=True)
            if ed or es:
                raise RuntimeError(f"{kd}/{ks} disagree with their plain "
                                   f"versions on {name}: {ed} {es}")
            for key, err in ((kd, ed), (ks, es)):
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"],
                                                 err)
            if big:
                cells = float((la.astype(np.int64) * lb).sum())
                s_cells = float((sbucket[2].astype(np.int64)
                                 * sbucket[3]).sum())
                bounds = {kd: bound(DIRS_OPS * cells,
                                    nbytes(*args, d_k, f_k)),
                          ks: bound(DIAG_OPS * s_cells,
                                    nbytes(*sargs, s_k))}
                for key, ms, pms in ((kd, msd, pmsd), (ks, mss, pmss)):
                    rep = report[key]
                    rep["ms"], rep["plain_ms"] = ms, pms
                    rep["bound_ms"], rep["bound_by"] = bounds[key]
                print(f"[{mode}-kernels] {name}: {kd} "
                      f"{cells / msd / 1e6:.1f} GCUPS, {ks} "
                      f"{s_cells / mss / 1e6:.1f} GCUPS; bounds "
                      f"{ {k: round(v[0], 4) for k, v in bounds.items()} } "
                      f"ms", flush=True)
            del d_k, d_p, args, sargs
            torch.cuda.empty_cache()


def phase_free_main(cls, data, out):
    """One free-end path alone, for the launch window: ``align_batch`` on
    all of ``data`` (one warm-up, 3 timed runs) and ``score_batch``."""
    import torch

    al = cls()
    al.align_batch(data)  # warm-up
    walls, phases = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align_batch(data)
        walls.append(time.perf_counter() - t0)
        phases.append(dict(al.last_phases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = al.score_batch(data)
    t_score = time.perf_counter() - t0
    out.update(res=res, walls=walls, phases=phases, chunks=al.last_chunks,
               scores=scores, t_score=t_score, params=al.params)


def check_free(mode, data, out):
    """Gates of a free-end path; a run that fails one reports no speed."""
    import torch

    from cse305_parallel_sequence_alignment_torch.native import walker
    from cse305_parallel_sequence_alignment_torch.ops.cigar import (
        cigar_consumed,
    )
    from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
        rle_walk_plain,
    )
    from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
        overlap_dirs_plain,
        semiglobal_dirs_plain,
    )

    res, params = out["res"], out["params"]
    sg = mode == "semiglobal"
    # the end cell of a chain: row la and the last B column (semi-global),
    # the last A row and B column consumed (overlap)
    if sg:
        s_sc, s_t, s_j = out["scores"]
        got = (np.array([r.score for r in res]),
               np.array([r.end_table for r in res]),
               np.array([r.target_span[1] for r in res]))
        same = all(np.array_equal(x, y) for x, y in zip((s_sc, s_t, s_j),
                                                        got))
    else:
        s_sc, s_t, s_i, s_j = out["scores"]
        got = (np.array([r.score for r in res]),
               np.array([r.end_table for r in res]),
               np.array([r.a_span[1] for r in res]),
               np.array([r.b_span[1] for r in res]))
        same = all(np.array_equal(x, y) for x, y in zip((s_sc, s_t, s_i,
                                                         s_j), got))
    if not same:
        raise RuntimeError(f"{mode}: score_batch disagrees with align_batch")
    for k, ((a, b), r) in enumerate(zip(data, res)):
        if chain_rescore(a, b, r.chain, params) != r.score:
            raise RuntimeError(f"{mode} pair {k}: chain re-scores to "
                               f"{chain_rescore(a, b, r.chain, params)}, "
                               f"score {r.score}")
        if sg and cigar_consumed(r.cigar)[0] != len(a):
            raise RuntimeError(f"pair {k}: CIGAR {r.cigar} does not consume "
                               f"the whole read")
        if not sg and not (r.a_span[1] == len(a) or r.b_span[1] == len(b)):
            raise RuntimeError(f"pair {k}: end {r.a_span[1], r.b_span[1]} "
                               f"is on neither the last row nor column")
    # the first 64 pairs through the plain versions on the card
    dev = torch.device("cuda")
    a, b, la, lb = code_bucket(data[:64])
    plain = semiglobal_dirs_plain if sg else overlap_dirs_plain
    dirs, best = plain(*[torch.from_numpy(x).to(dev)
                         for x in (a, b, la, lb)], params)
    et, ei, ej = (best[:, k].to(torch.int32) for k in (1, 2, 3))
    ent, used = rle_walk_plain(dirs, ei, ej, et,
                               int(la.max()) + int(lb.max()) + 1)
    del dirs
    best = best.cpu().numpy()
    tt, ii, jj, lens, spans, cig, ext = walker.free_end_build(
        ent.cpu().numpy()[: int(used[0])].T, best[:, 2].astype(np.int64),
        best[:, 3].astype(np.int64), best[:, 1].astype(np.int32), a, b,
        mode)
    for r in range(len(lens)):
        L = int(lens[r])
        want = (float(best[r, 0]), int(best[r, 1]),
                list(zip(ii[r, :L].tolist(), jj[r, :L].tolist(),
                         tt[r, :L].tolist())), cig[r])
        g = res[r]
        if want != (g.score, g.end_table, list(g.chain), g.cigar) or (
                sg and g.cigar_extended != ext[r]):
            raise RuntimeError(f"{mode} pair {r}: align_batch differs from "
                               f"the plain versions on the card")
    torch.cuda.empty_cache()
    walls, phases = out["walls"], out["phases"]
    med = sorted(range(3), key=lambda k: walls[k])[1]
    cells = float(sum(len(x) * len(y) for x, y in data))
    split = ", ".join(f"{k} {v:.2f}" for k, v in phases[med].items())
    lens = np.array([len(r.chain) for r in res])
    print(f"[{mode}] align_batch {len(data)} pairs: walls "
          f"{[round(w * 1e3, 2) for w in walls]} ms, "
          f"{len(data) / walls[med]:.1f} pairs/s, "
          f"{cells / walls[med] / 1e9:.2f} cell GCUPS (median run); phases "
          f"{split}; {out['chunks']} chunks; score_batch "
          f"{out['t_score'] * 1e3:.2f} ms, "
          f"{cells / out['t_score'] / 1e9:.2f} GCUPS", flush=True)
    print(f"[{mode}] gates held: score_batch = align_batch (score, table, "
          f"end cell), {len(res)} chains re-score to their scores, "
          + ("CIGARs consume the whole read" if sg else
             "every end on the last row or column")
          + f", first 64 pairs = plain versions on the card; chain length "
          f"mean {lens.mean():.1f}, max {lens.max()}; mean score "
          f"{float(np.mean(s_sc)):.3f}", flush=True)


def protein_data(count=4096, seed=31):
    """Candidate protein pairs for homology verification: A has 250-450
    residues of the 20 standard amino acids; for three of every four
    pairs B is A with 15% substitutions and 2% single-residue indels, for
    the fourth B is unrelated, 250-450 residues."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        a = AMINO[rng.integers(0, 20, int(rng.integers(250, 451)))]
        if k % 4 == 3:
            b = AMINO[rng.integers(0, 20, int(rng.integers(250, 451)))]
        else:
            b = mutate_core(rng, a, 0.15, 0.02, AMINO)
        pairs.append((a, b))
    return pairs


def table_rescore(ea, eb, chain, matrix, params):
    """Score of a full global chain under a substitution matrix: its
    diagonal points' table scores, h + g for a gap run's first point and
    g each further one; exact for integer scores."""
    c = np.asarray(list(chain), np.int64)
    i, j, t = c[:, 0], c[:, 1], c[:, 2]
    diag = t == 1
    table = matrix.table()
    f = table[matrix.encode(ea[i[diag] - 1].tobytes()),
              matrix.encode(eb[j[diag] - 1].tobytes())].astype(np.float64)
    opens = int((~diag & np.r_[True, t[1:] != t[:-1]]).sum())
    gaps = int((~diag).sum())
    return float(f.sum() - opens * (params.g + params.h)
                 - (gaps - opens) * params.g)


def phase_matrix_kernels(report, mdata):
    """K4d and K4s against their plain versions on the card, bit for bit:
    8 ragged protein pairs with all six start types, then one chunk of the
    matrix path's largest bucket (K4d at an ``align_batch`` chunk, K4s at
    a ``score_batch`` chunk), timed; and K4d under ``dna_matrix(1, 0)``
    against K1 at 256 x 2 kb, where the two must agree on every cell."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
        _bucket_arrays,
    )
    from cse305_parallel_sequence_alignment_torch.ops import rowcb
    from cse305_parallel_sequence_alignment_torch.utils.matrices import (
        BLOSUM62,
        dna_matrix,
    )

    params = ScoringParams(**MATRIX_PARAMS)
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    lens = [(450, 450), (1, 300), (300, 1), (0, 5), (449, 250), (250, 449),
            (333, 334), (400, 420)]
    enc = [(AMINO[rng.integers(0, 20, x)], AMINO[rng.integers(0, 20, y)])
           for x, y in lens]
    ragged = _bucket_arrays([x for x, _ in enc], [y for _, y in enc],
                            range(len(enc)), (450, 450), BLOSUM62)
    # rows wider than shared memory: the global-scratch row buffers
    wide_enc = [(AMINO[rng.integers(0, 20, x)], AMINO[rng.integers(0, 20, y)])
                for x, y in ((300, 9000), (120, 8999))]
    wide = _bucket_arrays([x for x, _ in wide_enc], [y for _, y in wide_enc],
                          range(2), (300, 9000), BLOSUM62)
    dirs_chunk, score_chunk = path_chunks(
        BatchAligner(params=params, matrix=BLOSUM62), mdata)
    table = torch.from_numpy(BLOSUM62.table()).to(dev)
    cases = [("ragged 8 x <=450, six start types", ragged, ragged,
              np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32), False),
             ("wide 2 x 300 x 9 k (global scratch)", wide, wide,
              np.array([-1, -3], np.int32), False),
             (f"matrix path chunks: K4d {bucket_name(dirs_chunk)}, K4s "
              f"{bucket_name(score_chunk)}", dirs_chunk, score_chunk, None,
              True)]
    for name, dbucket, sbucket, st, big in cases:
        la, lb = dbucket[2], dbucket[3]
        if st is None:
            st = np.full(len(la), -1, np.int32)
        args = [torch.from_numpy(x).to(dev) for x in (*dbucket, st)]
        sargs = args if not big else [
            torch.from_numpy(x).to(dev) for x in
            (*sbucket, np.full(len(sbucket[2]), -1, np.int32))]
        reps = 3 if big else 1
        # the codes are checked once, here, and not in the timed window:
        # the check reads their maximum from the card (a host round trip)
        rowcb.check_table(table, args[0], args[1])
        rowcb.check_table(table, sargs[0], sargs[1])
        (d_k, f_k), msd = timed(lambda: rowcb.rowcb_fill(
            *args, params, table, checked=True), reps)
        (d_p, f_p), pmsd = timed(lambda: rowcb.matrix_dirs_plain(
            *args, table, params), 1, warm=False)
        ed = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
        s_k, mss = timed(lambda: rowcb.submat_score_fill(
            *sargs, table, params, checked=True), reps)
        s_p, pmss = timed(lambda: rowcb.submat_score_fill_plain(
            *sargs, table, params), 1, warm=False)
        # K4s and K4d agree on the pairs both chunks hold
        es = max(max_err(s_k, s_p), max_err(s_k[: len(la)], f_k))
        old = ""
        if big:  # the sweep K4d ran on before csrc/rowfill.cu, same call
            _, old_ms = timed(lambda: rowcb._launch(
                *args, params, "global", table), reps)
            old = f"; before: csrc/rowcb.cu {old_ms:.3f} ms"
        print(f"[matrix-kernels] {name}: K4d err {ed} {msd:.3f} ms (plain "
              f"{pmsd:.1f} ms; "
              f"{fill_desc(len(la), dbucket[1].shape[1], table.shape[0])}"
              f"{old}); K4s err {es} {mss:.3f} ms (plain "
              f"{pmss:.1f} ms)", flush=True)
        if ed or es:
            raise RuntimeError(f"a matrix kernel disagrees with its plain "
                               f"version on {name}: K4d {ed} K4s {es}")
        for key, err in (("K4d", ed), ("K4s", es)):
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
        if big:
            cells = float((la.astype(np.int64) * lb).sum())
            s_cells = float((sbucket[2].astype(np.int64) * sbucket[3]).sum())
            bounds = {"K4d": bound(DIRS_OPS * cells,
                                   nbytes(*args, table, d_k, f_k)),
                      "K4s": bound(SWEEP_OPS * s_cells,
                                   nbytes(*sargs, table, s_k))}
            for key, ms, pms in (("K4d", msd, pmsd), ("K4s", mss, pmss)):
                rep = report[key]
                rep["ms"], rep["plain_ms"] = ms, pms
                rep["bound_ms"], rep["bound_by"] = bounds[key]
            print(f"[matrix-kernels] {name}: K4d {cells / msd / 1e6:.1f} "
                  f"GCUPS, K4s {s_cells / mss / 1e6:.1f} GCUPS; bounds "
                  f"{ {k: round(v[0], 4) for k, v in bounds.items()} } ms",
                  flush=True)
        del d_k, d_p, args, sargs
        torch.cuda.empty_cache()

    # the table path and the match/mismatch path agree under dna(1, 0)
    dna = dna_matrix(1.0, 0.0)
    rng7 = np.random.default_rng(7)
    B, L = 256, 2048
    codes = rng7.integers(0, 4, (B, L)).astype(np.uint8)
    codes_b = rng7.integers(0, 4, (B, L)).astype(np.uint8)
    full = np.full(B, L, np.int32)
    st = np.full(B, -1, np.int32)
    t1 = [torch.from_numpy(x).to(dev) for x in (ACGT[codes], ACGT[codes_b],
                                                full, full, st)]
    t4 = [torch.from_numpy(x).to(dev) for x in (codes, codes_b, full, full,
                                                st)]
    dtab = torch.from_numpy(dna.table()).to(dev)
    ident = ScoringParams()
    (d1, f1), ms1 = timed(lambda: rowcb.rowcb_fill(*t1, ident), 3)
    (d4, f4), ms4 = timed(lambda: rowcb.rowcb_fill(*t4, ident, dtab), 3)
    e = max(max_err(u16(d1), u16(d4)), max_err(f1, f4))
    cells = float(B * L * L)
    print(f"[matrix-kernels] dna_matrix(1, 0) 256 x 2 kb: K4d vs K1 err {e}; "
          f"K1 {ms1:.3f} ms ({cells / ms1 / 1e6:.1f} GCUPS), K4d "
          f"{ms4:.3f} ms ({cells / ms4 / 1e6:.1f} GCUPS)", flush=True)
    if e:
        raise RuntimeError("K4d under dna_matrix(1, 0) differs from K1")
    del d1, d4
    torch.cuda.empty_cache()


def phase_matrix_main(mdata, out):
    """The matrix path alone, for the launch window: ``align_batch`` on
    all of ``mdata`` (one warm-up, 3 timed runs) and ``score_batch``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.utils.matrices import (
        BLOSUM62,
    )

    al = BatchAligner(params=ScoringParams(**MATRIX_PARAMS), matrix=BLOSUM62)
    al.align_batch(mdata)  # warm-up
    walls, phases = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = al.align_batch(mdata)
        walls.append(time.perf_counter() - t0)
        phases.append(dict(al.last_phases))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = al.score_batch(mdata)
    t_score = time.perf_counter() - t0
    out.update(al=al, res=res, walls=walls, phases=phases, scores=scores,
               t_score=t_score)


def check_matrix(mdata, out):
    """Gates of the matrix path; a run that fails one reports no speed."""
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )

    al, res = out["al"], out["res"]
    scores, tables = out["scores"]
    if not (np.array_equal(scores, [r.score for r in res])
            and np.array_equal(tables, [r.end_table for r in res])):
        raise RuntimeError("matrix: score_batch disagrees with align_batch")
    full = al.align_batch(mdata, traceback_mode="full")
    for k, ((a, b), r) in enumerate(zip(mdata, full)):
        ea, eb = (a, b) if len(a) <= len(b) else (b, a)  # parity swap
        cs = table_rescore(ea, eb, r.chain, al.matrix, al.params)
        if cs != r.score or r.score != res[k].score:
            raise RuntimeError(f"matrix pair {k}: chain re-scores to {cs}, "
                               f"score {r.score}")
    cpu = BatchAligner(params=al.params, matrix=al.matrix, device="cpu")
    for k, (g, w) in enumerate(zip(res[:64], cpu.align_batch(mdata[:64]))):
        if (g.score, g.end_table, list(g.chain), g.aligned_a,
                g.aligned_b) != (w.score, w.end_table, list(w.chain),
                                 w.aligned_a, w.aligned_b):
            raise RuntimeError(f"matrix pair {k}: align_batch differs from "
                               f"BatchAligner(device='cpu')")
    walls, phases = out["walls"], out["phases"]
    med = sorted(range(3), key=lambda k: walls[k])[1]
    cells = float(sum(len(x) * len(y) for x, y in mdata))
    split = ", ".join(f"{k} {v:.2f}" for k, v in phases[med].items())
    print(f"[matrix] align_batch {len(mdata)} protein pairs of 250-450, "
          f"BLOSUM62 g=1 h=11: walls {[round(w * 1e3, 2) for w in walls]} "
          f"ms, {len(mdata) / walls[med]:.1f} pairs/s, "
          f"{cells / walls[med] / 1e9:.2f} cell GCUPS (median run); phases "
          f"{split}; score_batch {out['t_score'] * 1e3:.2f} ms, "
          f"{cells / out['t_score'] / 1e9:.2f} GCUPS", flush=True)
    related = np.array([r.score for r in res[0::4]])
    print(f"[matrix] gates held: score_batch = align_batch, {len(res)} full "
          f"chains re-score to their scores under the table, first 64 pairs "
          f"= BatchAligner(device='cpu'); mean score "
          f"{float(scores.mean()):.2f} (related pairs {related.mean():.2f}, "
          f"unrelated "
          f"{float(scores[3::4].mean()):.2f})", flush=True)


def band_cells(la, lb, w_lo, w_hi):
    """In-band cells of each pair's rectangle, summed (rows 1..la)."""
    total = 0
    for x, y in zip(la.tolist(), lb.tolist()):
        i = np.arange(1, x + 1)
        lo = np.maximum(1, i - w_lo)
        hi = np.minimum(y, i + w_hi)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return float(total)


def band_alternatives(args, w_lo, w_hi, params, d_k, f_k, reps):
    """K12d's ``band_rows_kernel`` at each C the band admits, and the PR
    5 ``band_kernel<true>``, on the same tensors: {label: ms}, each one's
    dirs and finals held bit for bit to ``d_k``, ``f_k``."""
    import torch

    from cse305_parallel_sequence_alignment_torch.ops import banded

    W = w_lo + w_hi + 1
    runs = {f"C={C} threads={banded.band_threads(W, C)}": functools.partial(
        banded._rows_fill, *args, w_lo, w_hi, params,
        (C, banded.band_threads(W, C))) for C in banded.ROWS_C
        if banded.band_threads(W, C) <= banded.ROWS_THREADS[C]}
    runs["band_kernel"] = functools.partial(banded._launch, *args,
                                                 w_lo, w_hi, params, True)
    times = {}
    for label, fn in runs.items():
        (d, f), times[label] = timed(fn, reps)
        err = max(max_err(u16(d), u16(d_k)), max_err(f, f_k))
        if err:
            raise RuntimeError(f"K12d {label} differs from the rule's "
                               f"geometry by {err}")
        del d
        torch.cuda.empty_cache()
    return times


def phase_banded_kernels(report, runs):
    """K12s, K12d and K2 in band layout against their plain versions on
    the card, bit for bit: 256 related pairs x 2 kb at bands (64, 64)
    and (256, 256), 8 ragged pairs with every start type, a band too wide
    for shared memory, and the banded path's own launch, the whole 97 kb pair at W =
    2 * (64 + |m - n|) + 1 on the tensors ``api.align(mode="banded",
    band=64)`` gives the kernels, which sets the kernels line."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import (
        ScoringParams,
        end_table_choice,
    )
    from cse305_parallel_sequence_alignment_torch.models.banded import (
        BandedAligner,
    )
    from cse305_parallel_sequence_alignment_torch.ops import (
        banded,
        device_walk,
    )

    params = ScoringParams()
    dev = torch.device("cuda")
    rng = np.random.default_rng(53)
    B, L = 256, 2048
    a = ACGT[rng.integers(0, 4, (B, L))]
    b = np.stack([np.resize(mutate_core(rng, x, 0.01, 0.005), L) for x in a])
    full = np.full(B, L, np.int32)
    la = np.array([2048, 1, 700, 2048, 1500, 33, 1999, 0], np.int32)
    lb = np.clip(la + np.array([0, 64, -64, -3, 17, 40, 49, 9]), 0,
                 None).astype(np.int32)
    ra, rb = bucket(rng, la, lb, 2048, int(lb.max()))
    starts = np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32)
    wa, wb = bucket(rng, [3000, 2500], [12000, 11000], 3000, 12000)
    wla = np.array([3000, 2500], np.int32)
    wlb = np.array([12000, 11000], np.int32)

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for v in arrays]

    run = runs[0]
    w = 64 + abs(len(run["a"]) - len(run["b"]))
    rel = on_card(a, b, full, full, np.full(B, -1, np.int32))
    cases = [("256 x 2 kb related, band (64, 64)", rel, 64, 64, False),
             ("256 x 2 kb related, band (256, 256)", rel, 256, 256, False),
             ("ragged 8 x <=2 kb, six start types, band (64, 64)",
              on_card(ra, rb, la, lb, starts), 64, 64, False),
             ("wide band (0, 9000), 2 x 3 k x 12 k (global scratch)",
              on_card(wa, wb, wla, wlb, np.full(2, -1, np.int32)), 0, 9000,
              False),
             # the path's own tensors: api.align(mode="banded", band=64)
             # builds this aligner and launches on its bucket of one
             (f"banded path {len(run['a']):,} x {len(run['b']):,}, band "
              f"({w}, {w}), every row",
              BandedAligner(w_lo=w, w_hi=w)._bucket(run["a"], run["b"]), w,
              w, True)]
    for name, args, w_lo, w_hi, big in cases:
        reps = 3 if big else 1
        (d_k, f_k), msd = timed(
            lambda: banded.banded_dirs(*args, w_lo, w_hi, params), reps)
        (d_p, f_p), pmsd = timed(lambda: banded.banded_fill_plain(
            *args, w_lo, w_hi, params, True), 1, warm=False)
        ed = max(max_err(u16(d_k), u16(d_p)), max_err(f_k, f_p))
        del d_p
        s_k, mss = timed(
            lambda: banded.banded_score(*args, w_lo, w_hi, params), reps)
        s_p, pmss = timed(lambda: banded.banded_fill_plain(
            *args, w_lo, w_hi, params, False)[1], 1, warm=False)
        es = max(max_err(s_k, s_p), max_err(s_k, f_k))
        t0 = torch.tensor([end_table_choice(*f, -1, params.h)[0]
                           for f in f_k.cpu().tolist()], dtype=torch.int32,
                          device=dev)
        steps = int(args[2].max()) + int(args[3].max()) + 1
        (w_k, u_k), msw = timed(lambda: device_walk.rle_walk(
            d_k, args[2], args[3], t0, steps, band_lo=w_lo), reps)
        (w_p, u_p), pmsw = timed(lambda: device_walk.rle_walk_plain(
            d_k, args[2], args[3], t0, steps, w_lo), 1, warm=False)
        ew = max(max_err(u16(w_k), u16(w_p)), max_err(u_k, u_p))
        W = w_lo + w_hi + 1
        geo = banded.band_geometry(len(args[2]), W)
        alts = "" if geo is None else "; " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in band_alternatives(
                args, w_lo, w_hi, params, d_k, f_k, reps).items())
        print(f"[banded-kernels] {name}: K12d err {ed} {msd:.3f} ms (plain "
              f"{pmsd:.1f} ms; W {W}, "
              f"{'rule ' + str(geo) if geo else 'band_kernel, global scratch'}"
              f"{alts}); K12s err {es} {mss:.3f} ms (plain "
              f"{pmss:.1f} ms); K2 band err {ew} rounds {int(u_k[0])} "
              f"{msw:.3f} ms (plain {pmsw:.1f} ms; dirs pitch "
              f"{device_walk.row_pitch(d_k)})", flush=True)
        if ed or es or ew:
            raise RuntimeError(f"a banded kernel disagrees with its plain "
                               f"version on {name}: K12d {ed} K12s {es} K2 "
                               f"band {ew}")
        for key, err in (("K12d", ed), ("K12s", es), ("K2b", ew)):
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
        if big:
            cells = band_cells(args[2], args[3], w_lo, w_hi)
            ins = nbytes(*args)
            taken = int((u16(w_k) != 0).sum())  # one dirs cell per round
            bounds = {"K12d": bound(BAND_DIRS_OPS * cells,
                                    ins + nbytes(d_k, f_k)),
                      "K12s": bound(BAND_OPS * cells, ins + nbytes(s_k)),
                      "K2b": bound(0, 2 * taken + nbytes(args[2], args[3],
                                                         t0, w_k, u_k))}
            for key, ms, pms in (("K12d", msd, pmsd), ("K12s", mss, pmss),
                                 ("K2b", msw, pmsw)):
                rep = report[key]
                rep["ms"], rep["plain_ms"] = ms, pms
                rep["bound_ms"], rep["bound_by"] = bounds[key]
            print(f"[banded-kernels] {name}: {cells:.0f} band cells, K12d "
                  f"{cells / msd / 1e6:.1f} GCUPS, K12s "
                  f"{cells / mss / 1e6:.1f} GCUPS; bounds "
                  f"{ {k: round(v[0], 4) for k, v in bounds.items()} } ms",
                  flush=True)
        del d_k
        torch.cuda.empty_cache()


def phase_banded_main(runs, out):
    """The banded path alone, for the launch window: ``api.align(mode=
    "banded", band=64)`` on the 97,409-nt pair and its edited copy (one
    warm-up, 2 timed runs), then the same alignment through a
    ``BandedAligner`` for its phase split, and its ``score``."""
    import torch

    from cse305_parallel_sequence_alignment_torch import api
    from cse305_parallel_sequence_alignment_torch.models.banded import (
        BandedAligner,
    )

    run = runs[0]
    a, b = run["a"], run["b"]
    api.align(a, b, mode="banded", band=64)  # warm-up
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.align(a, b, mode="banded", band=64)
        walls.append(time.perf_counter() - t0)
    w = 64 + abs(len(a) - len(b))
    al = BandedAligner(w_lo=w, w_hi=w)
    again = al.align(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = al.score(a, b)
    t_score = time.perf_counter() - t0
    out.update(res=res, again=again, walls=walls, phases=al.last_phases,
               score=score, t_score=t_score, w=w)


def check_banded(report, runs, out):
    """Gates of the banded path: both runs equal, ``score`` = ``align``,
    rows that give back the pair, the chain re-scoring to the score (its
    ``traceback_mode="full"`` twin, whose tail it is: the parity chain
    drops its first point), and, unless the chain touched the band's
    edge, the banded score = the whole pair's K6 score."""
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.banded import (
        BandedAligner,
    )
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        score_chain,
    )

    run, res, again = runs[0], out["res"], out["again"]
    a, b, w = run["a"], run["b"], out["w"]
    if (res.score, list(res.chain)) != (again.score, list(again.chain)) or \
            out["score"] != res.score:
        raise RuntimeError("banded: api.align, BandedAligner.align and "
                           "BandedAligner.score disagree")
    if (res.aligned_a.replace("-", "") != a.tobytes().decode()
            or res.aligned_b.replace("-", "") != b.tobytes().decode()):
        raise RuntimeError("banded: rows do not give back the pair")
    full = BandedAligner(w_lo=w, w_hi=w, traceback_mode="full").align(a, b)
    chain, tail = list(full.chain), list(res.chain)
    cs = score_chain(a, b, chain, ScoringParams())
    if not cs == full.score == res.score or \
            chain[len(chain) - len(tail):] != tail:
        raise RuntimeError(f"banded: the full chain re-scores to {cs}, "
                           f"score {res.score}, or the chain is not its "
                           f"tail")
    if not res.edge_touched and res.score != run["whole"]:
        raise RuntimeError(f"banded score {res.score} differs from the "
                           f"whole-pair K6 score {run['whole']}")
    phases = ", ".join(f"{k} {v:.2f}" for k, v in out["phases"].items())
    walls = [round(x * 1e3, 1) for x in out["walls"]]
    ms = {k: round(report[k]["ms"], 3) for k in ("K12d", "K12s", "K2b")}
    print(f"[banded] api.align(mode='banded', band=64) {len(a):,} x "
          f"{len(b):,}, W = {2 * w + 1}: walls {walls} ms; BandedAligner "
          f"phases {phases}; score {out['t_score'] * 1e3:.1f} ms; kernels "
          f"at this shape (one CTA) {ms} ms", flush=True)
    gate = ("edge_touched, so the K6 comparison is waived" if
            res.edge_touched else
            f"score {res.score} = whole-pair K6 score {run['whole']}")
    print(f"[banded] gates held: {gate}; align = score; the full chain "
          f"re-scores to the score and ends in the chain; rows give back "
          f"the pair; chain length {len(res.chain)}", flush=True)


# per cell of csrc/rowscan2.cu (K3'', P-dual): pass 1 the base compare,
# T1's add, T3's two subtractions and max, m13's max; pass 2 omega's
# multiply, subtraction and add, the running max; pass 3 those four
# again, T2's subtraction, H's max
RS2_OPS = 16


def seed7_bucket(B=256, L=2048):
    """256 random pairs of 2 kb (seed 7) as (a, b, la, lb, st) on the
    card, every la = lb = L and start type -1."""
    import torch
    rng = np.random.default_rng(7)
    full = np.full(B, L, np.int32)
    arrays = (ACGT[rng.integers(0, 4, (B, L))],
              ACGT[rng.integers(0, 4, (B, L))], full, full,
              np.full(B, -1, np.int32))
    return [torch.from_numpy(np.ascontiguousarray(x)).cuda()
            for x in arrays]


def phase_rowscan2_kernels(report):
    """K3'', P-trim and P-dual against their plain versions on the card,
    bit for bit, at 256 x 2 kb (seed 7; start type -1, every la = m, the
    probes' shape) at the default parameters (timed: the kernels line)
    and at g=0.3, h=1.7; the three equal there (P-dual also on 255 pairs,
    odd B), K3'' = K3' at the default parameters, and K3'' on 8 ragged
    pairs with every start type at both parameter sets."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowscan2

    args = seed7_bucket()
    a, b, la, lb, st = args
    B, L = a.shape
    cells = float(B) * L * L
    psets = (("default", ScoringParams()),
             ("g=0.3, h=1.7", ScoringParams(**NON_DYADIC)))
    for pname, params in psets:
        res = {}
        for key, kern, plain, ops, ins in (
                ("K3''", lambda: rowscan2.rowscan2_score_fill(*args, params),
                 lambda: rowscan2.rowscan2_score_fill_plain(*args, params),
                 RS2_OPS, args),
                ("P-trim", lambda: rowcb.trim_rowscan_fill(a, b, lb, params),
                 lambda: rowcb.trim_rowscan_fill_plain(a, b, lb, params),
                 SWEEP_OPS, (a, b, lb)),
                ("P-dual",
                 lambda: rowscan2.dual_rowscan2_fill(a, b, lb, params),
                 lambda: rowscan2.dual_rowscan2_fill_plain(a, b, lb, params),
                 RS2_OPS, (a, b, lb))):
            got, ms = timed(kern, 3)
            want, pms = timed(plain, 1, warm=False)
            err = max_err(got, want)
            res[key] = (got, err, ms, pms)
            rep = report[key]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if pname == "default":
                rep["ms"], rep["plain_ms"] = ms, pms
                rep["bound_ms"], rep["bound_by"] = bound(
                    ops * cells, nbytes(*ins) + nbytes(got))
        k3 = res["K3''"][0]
        odd = rowscan2.dual_rowscan2_fill(a[:255], b[:255], lb[:255], params)
        same = max(max_err(res["P-trim"][0], k3), max_err(res["P-dual"][0], k3),
                   max_err(odd, k3[:255]))
        apart = int((rowcb.rowscan_score_fill(*args, params) != k3).sum())
        print(f"[rowscan2-kernels] 256 x 2 kb, {pname}: " + "; ".join(
            f"{k} err {e} {ms:.3f} ms ({cells / ms / 1e6:.1f} GCUPS; plain "
            f"{pms:.1f} ms)" for k, (_, e, ms, pms) in res.items())
            + f"; P-trim/P-dual vs K3'' err {same}; finals where K3' "
            f"parts from K3'': {apart}", flush=True)
        if any(r[1] for r in res.values()) or same or (
                pname == "default" and apart):
            raise RuntimeError(f"a K3'' kernel disagrees at {pname}: "
                               f"{ {k: r[1] for k, r in res.items()} }, "
                               f"P-trim/P-dual {same}, K3' {apart}")
    rng = np.random.default_rng(19)
    rla = np.array([2048, 1, 700, 2048, 1500, 33, 1999, 0], np.int32)
    rlb = np.array([2048, 2000, 1024, 5, 1501, 2048, 2047, 9], np.int32)
    rst = np.array([-1, -2, -3, 1, 2, 3, -1, -2], np.int32)
    ra, rb = bucket(rng, rla, rlb, 2048, 2048)
    rargs = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
             for x in (ra, rb, rla, rlb, rst)]
    for pname, params in psets:
        err = max_err(rowscan2.rowscan2_score_fill(*rargs, params),
                      rowscan2.rowscan2_score_fill_plain(*rargs, params))
        print(f"[rowscan2-kernels] ragged 8 x <=2 kb, every start type, "
              f"{pname}: K3'' err {err}", flush=True)
        if err:
            raise RuntimeError(f"K3'' disagrees on the ragged pairs: {err}")
        report["K3''"]["max_abs_err"] = max(report["K3''"]["max_abs_err"],
                                           err)


def phase_group_walk(report):
    """K2' at G = 1 and 8 against its plain version and against K2, on
    the K1 dirs of the global path's pairs (256 x 2 kb, seed 7) in the
    path's two chunks of 128, end tables chosen from K1's finals as the
    path chooses them; timed on the first chunk (the kernels line)."""
    import torch

    from cse305_parallel_sequence_alignment_torch.core import (
        ScoringParams,
        encode_seq,
    )
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        _end_choice,
    )
    from cse305_parallel_sequence_alignment_torch.ops import (
        device_walk,
        rowcb,
    )
    from cse305_parallel_sequence_alignment_torch.probes.walk_ab import (
        mismatched_pairs,
    )

    params = ScoringParams()
    pairs = global_pairs()
    enc = [np.stack([encode_seq(p[k]) for p in pairs]) for k in (0, 1)]
    for c0 in (0, 128):
        a, b = (torch.from_numpy(np.ascontiguousarray(x[c0: c0 + 128]))
                .cuda() for x in enc)
        B, L = a.shape
        la = torch.full((B,), L, dtype=torch.int32, device="cuda")
        st = torch.full_like(la, -1)
        dirs, fin = rowcb.rowcb_fill(a, b, la, la, st, params)
        tb, _ = _end_choice(fin, st, params.h)
        steps = 2 * L + 1
        k2, _ = device_walk.rle_walk(dirs, la, la, tb, steps)
        want, pms = timed(lambda: device_walk.group_walk_rle_plain(
            dirs, la, la, tb, steps), 1, warm=False)
        errs = {}
        for G in (1, 8):
            (ent, used), ms = timed(lambda: device_walk.group_walk_rle(
                dirs, la, la, tb, steps, G=G), 3 if c0 == 0 else 1)
            err = max(max_err(ent, want[0]), max_err(used, want[1]))
            bad = mismatched_pairs(k2, ent, used)
            errs[G] = (err, bad, ms)
            rep = report["K2'"]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if c0 == 0 and G == 8:
                rep["ms"], rep["plain_ms"] = ms, pms
                # one dirs cell read a round taken
                rep["bound_ms"], rep["bound_by"] = bound(
                    0, 2 * int(used.sum()) + nbytes(la, la, tb, ent, used))
        print(f"[group-walk] chunk {c0 // 128} (128 x 2 kb): rounds mean "
              f"{float(want[1].float().mean()):.2f}, max "
              f"{int(want[1].max())}; " + "; ".join(
                  f"G={G} err {e} pairs apart from K2 {bad} {ms:.3f} ms"
                  for G, (e, bad, ms) in errs.items())
              + f"; plain {pms:.1f} ms", flush=True)
        if any(e or bad for e, bad, _ in errs.values()):
            raise RuntimeError(f"K2' disagrees on chunk {c0 // 128}: {errs}")
        del dirs
        torch.cuda.empty_cache()


# per cell of csrc/rowprobe.cu's full row step (replica_kernel): pass 1
# two maxima, the base compare, T1's add, T3's two subtractions and max,
# max(T1, T3); pass 2 omega's multiply, add and subtraction, the running
# max; pass 3 those four again, T2's multiply and subtraction
RP_OPS = 18
# the row-step probes' report keys: (probe module, the variant whose times
# the kernels line takes, its operations a cell: chain K = 8 is 8 adds
# and 8 maxima, live K = 16 over 4 arrays 16 adds, 16 maxima and the
# fourth array's add)
ROWPROBES = {"P-perm": ("perm_layout", "contiguous_u4", RP_OPS),
             "P-stripes": ("stripes", "B256_S1_u4", RP_OPS),
             "P-knock": ("knockout", "full_u4", RP_OPS),
             "P-ablate": ("ablate", "full", RP_OPS),
             "P-floor": ("ablate", "chain_K8", 16),
             "P-lane0": ("lane0", "A_u4", RP_OPS)}
ROWPROBES2 = {"P-sweep": ("sweep", "B256_W2176_C16_u4", RP_OPS),
              "P-attrib2": ("attrib2", "full_b32", RP_OPS),
              "P-floor2": ("attrib2", "live_K16_L4", 33)}
FLOOR_KEYS = ("P-floor", "P-floor2")
FLOOR_NAMES = ("chain", "indep", "live")  # the floors' variant names
# the micro-probes' report keys: (probe, the case whose times the kernels
# line takes, its operations an element a step: 12 adds and the halving;
# 16 chains of a multiply, an add and a max, then a multiply and a max)
MICROS = {"P-micro": ("micro", "add x+y", 13),
          "P-micro2": ("micro2", "elementwise chain (256,2176) 2op", 50)}


def max_err_nan(x, y):
    """``max_err`` with NaN equal to NaN, and inf where only one is NaN."""
    import torch
    nx, ny = torch.isnan(x), torch.isnan(y)
    if not torch.equal(nx, ny):
        return float("inf")
    return max_err(torch.where(nx, 0.0, x), torch.where(ny, 0.0, y))


def phase_rowprobe_kernels(report, table=ROWPROBES, tag="rowprobe-kernels"):
    """Every instantiation of csrc/rowprobe.cu that the probe modules of
    ``table`` run against its plain twin on the card, bit for bit (NaN
    equal to NaN), on each probe's reduced bucket (its first 16 pairs,
    every row), then timed at the probe's full shape (mean of 3 after a
    warm-up); the kernels line takes the variant ``table`` names for each
    key, its plain twin timed once at full size."""
    import importlib

    import torch

    done = {}
    for module in dict.fromkeys(m for m, _, _ in table.values()):
        mod = importlib.import_module(f"{PKG}.probes.{module}")
        t0 = time.perf_counter()
        rows, _, variants, twins = mod.cases(torch.device("cuda"))
        want, res = {}, {}
        for name, v in variants.items():
            if v.twin not in want:
                want[v.twin] = twins[v.twin]()
            err = max_err_nan(v.reduced(), want[v.twin])
            _, ms = timed(v.run, 3)
            res[name] = (err, ms)
            done[(module, name)] = v, ms
            floor = name.startswith(FLOOR_NAMES)
            rep = report[next(k for k, (md, _, _) in table.items()
                              if md == module and (k in FLOOR_KEYS) == floor)]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
        del want
        print(f"[{tag}] {module} ({rows} rows): " + "; ".join(
            f"{n} err {e} {ms:.3f} ms" for n, (e, ms) in res.items())
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        bad = {n: e for n, (e, _) in res.items() if e}
        if bad:
            raise RuntimeError(f"row-step probe kernels of {module} disagree "
                               f"with their twins: {bad}")
    for key, (module, name, ops) in table.items():
        v, ms = done[(module, name)]
        _, pms = timed(v.plain, 1, warm=False)
        rep = report[key]
        rep["ms"], rep["plain_ms"] = ms, pms
        rep["bound_ms"], rep["bound_by"] = bound(ops * v.cells, v.nbytes)
        print(f"[{tag}] {key} ({module} {name}): {ms:.3f} ms, "
              f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}), plain "
              f"{pms:.1f} ms", flush=True)


def phase_micro_kernels(report):
    """Every case of csrc/micro.cu's two probes against its plain twin on
    the card, bit for bit, at 64 steps on the first 16 lines of its
    shape, then timed at the full shape and the scripts' lower step count
    (mean of 3 after a warm-up); the kernels line takes the case
    ``MICROS`` names, its twin timed once at that size."""
    import torch

    from cse305_parallel_sequence_alignment_torch.probes import micro as pm

    t0 = time.perf_counter()
    res, done = {}, {}
    for c in pm.cases(torch.device("cuda")):
        rx, ry = pm.reduced(c)
        args = (c.op, c.ops, pm.CHECK_STEPS, c.shift, c.axis)
        err = max_err_nan(c.fn(rx, ry, *args), c.plain(rx, ry, *args))
        full = (c.x, c.y, c.op, c.ops, c.steps[0], c.shift, c.axis)
        _, ms = timed(lambda: c.fn(*full), 3)
        res[(c.which, c.name)] = (err, ms)
        done[(c.which, c.name)] = (c, full, ms)
        key = next(k for k, (w, _, _) in MICROS.items() if w == c.which)
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
    for which in ("micro", "micro2"):
        print(f"[micro-kernels] {which}: " + "; ".join(
            f"{n} err {e} {ms:.3f} ms" for (w, n), (e, ms) in res.items()
            if w == which) + f" ({time.perf_counter() - t0:.1f} s)",
            flush=True)
    bad = {n: e for n, (e, _) in res.items() if e}
    if bad:
        raise RuntimeError(f"micro-probe kernels disagree with their twins: "
                           f"{bad}")
    for key, (which, name, ops) in MICROS.items():
        c, full, ms = done[(which, name)]
        _, pms = timed(lambda: c.plain(*full), 1, warm=False)
        rep = report[key]
        rep["ms"], rep["plain_ms"] = ms, pms
        R, W = c.x.shape
        out = R * W * 4 if which == "micro" else 4
        rep["bound_ms"], rep["bound_by"] = bound(
            ops * c.steps[0] * R * W, 2 * R * W * 4 + out)
        print(f"[micro-kernels] {key} ({name}, {c.steps[0]} steps): "
              f"{ms:.3f} ms, bound {rep['bound_ms']:.4f} ms "
              f"({rep['bound_by']}), plain {pms:.1f} ms", flush=True)


def phase_probes(out):
    """Each probe module once at full size, one A/B round, as a user runs
    it (its ``main``); the lines are kept in ``out`` and printed on
    ``[probes]`` lines."""
    import contextlib
    import importlib
    import io

    from cse305_parallel_sequence_alignment_torch.probes import MODULES

    for name in MODULES:
        mod = importlib.import_module(f"{PKG}.probes.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--rounds", "1", "--reps", "3"])
        rows = [json.loads(line) for line in buf.getvalue().splitlines()]
        out[name] = rows
        for r in rows:
            print(f"[probes] {name} {json.dumps(r)}", flush=True)
        print(f"[probes] {name}: {len(rows)} lines in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def check_probes(out):
    """Every probe line that carries a result flag holds it."""
    for name, rows in out.items():
        for r in rows:
            if r.get("cells_equal") is False or r.get("exact") is False or \
                    r.get("equals_k3p") is False or \
                    r.get("mismatched_pairs", 0) or \
                    r.get("finite") is False:
                raise RuntimeError(f"probe {name} found a disagreement: {r}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    t_start = time.perf_counter()

    def stamp(what):
        print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    sys.path.insert(0, str(ROOT))
    from cse305_parallel_sequence_alignment_torch.models.overlap import (
        OverlapBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
        SemiGlobalBatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.ops import (
        _build,
        banded,
        device_walk,
        diag,
        halostair,
        local,
        longrow,
        longstair,
        micro,
        rowcb,
        rowprobe,
        rowscan2,
    )

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()

    def build(load, *args):
        load(*args)
        return time.perf_counter() - t0

    with ThreadPoolExecutor() as pool:  # one compiler process per source
        builds = {k: pool.submit(build, _build.cuda_library, k)
                  for k in _build.KERNELS}
        builds["tsalib"] = pool.submit(build, _build.host_library)
        ptxas = {k: pool.submit(_build.resource_usage, k)
                 for k in ("rowfill", "halostair", "banded", "longrow",
                           "rowprobe", "micro")}
        done = {k: b.result() for k, b in builds.items()}
        print(f"[build] kernels {_build.KERNELS} and host library built and "
              f"loaded in {time.perf_counter() - t0:.1f} s (each done at: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in done.items()) + ")",
              flush=True)
        for src_name, usage in ptxas.items():
            for kernel, (regs, stack, st, ld) in sorted(
                    usage.result().items()):
                print(f"[ptxas] {src_name}.cu {kernel}: {regs} registers, "
                      f"{stack} bytes stack, {st}/{ld} bytes spilled "
                      f"(stores/loads)", flush=True)
        ROWFILL_USAGE.update(ptxas["rowfill"].result())
        spilled = {k: v for k, v in ROWFILL_USAGE.items() if v[2] or v[3]}
        if len(ROWFILL_USAGE) != 8 or spilled:
            raise RuntimeError(f"csrc/rowfill.cu: 8 instances without a "
                               f"spill expected, got {ROWFILL_USAGE}")
        # the register-row bodies of K8 and K12d (three instances each)
        # and of K6/K7 (five)
        for src_name, kern, count in (("halostair", "rows_kernel", 3),
                                      ("banded", "band_rows_kernel", 3),
                                      ("longrow", "strip_kernel", 5)):
            usage = {k: v for k, v in ptxas[src_name].result().items()
                     if k.startswith(kern + "<")}
            if (len(usage) != count
                    or any(v[2] or v[3] for v in usage.values())):
                raise RuntimeError(f"csrc/{src_name}.cu: {count} {kern} "
                                   f"instances without a spill expected, "
                                   f"got {usage}")

    src = f"{PKG}/csrc"
    report = {
        "K1": dict(name="rowcb_fill (K1 dirs16+runs fill)", route="cuda",
                   source=f"{src}/rowfill.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_rowcb.py:126",
                   fn=rowcb.rowcb_fill),
        "K1-wide": dict(name="rowcb_fill past 8 CTAs' reach (K1 "
                             "global-scratch sweep)", route="cuda",
                        source=f"{src}/rowcb.cu",
                        replaces="cse305_parallel_sequence_alignment_tpu/"
                                 "ops/pallas_rowcb.py:126",
                        fn=rowcb.rowcb_fill, counter="wide_launches"),
        "K3": dict(name="score_fill (K3 anti-diagonal score fill)",
                   route="cuda", source=f"{src}/diag.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_fill.py:216",
                   fn=rowcb.score_fill),
        "K2": dict(name="rle_walk (K2 run-length walk)", route="cuda",
                   source=f"{src}/walk.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "device_walk.py:124",
                   fn=device_walk.rle_walk),
        "K6": dict(name="long_fill (K6 column-strip long fill)",
                   route="cuda", source=f"{src}/longrow.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_longrow.py:79",
                   fn=longrow.long_fill),
        "K7": dict(name="stair_lastrow_device (K7 one-job last row)",
                   route="cuda", source=f"{src}/longrow.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_longstair.py:81",
                   fn=longstair.stair_lastrow_device),
        "K9s": dict(name="sw_score (K9s local score fill)", route="cuda",
                    source=f"{src}/local.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_local.py:118",
                    fn=local.sw_score),
        "K9d": dict(name="sw_dirs (K9d local dirs fill)", route="cuda",
                    source=f"{src}/local.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_local.py:209",
                    fn=local.sw_dirs),
        "K9w": dict(name="local_walk (K9w local walk)", route="cuda",
                    source=f"{src}/local.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "device_walk.py:35",
                    fn=device_walk.local_walk),
        "K10s": dict(name="semiglobal_score (K10s semi-global score fill)",
                     route="cuda", source=f"{src}/diag.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_semiglobal.py:100",
                     fn=diag.semiglobal_score),
        "K10d": dict(name="semiglobal_dirs (K10d semi-global dirs fill)",
                     route="cuda", source=f"{src}/rowcb.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_semiglobal.py:195",
                     fn=rowcb.semiglobal_dirs),
        "K11s": dict(name="overlap_score (K11s overlap score fill)",
                     route="cuda", source=f"{src}/diag.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "overlap.py:124",
                     fn=diag.overlap_score),
        "K11d": dict(name="overlap_dirs (K11d overlap dirs fill)",
                     route="cuda", source=f"{src}/rowcb.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_overlap.py:54",
                     fn=rowcb.overlap_dirs),
        "K4s": dict(name="submat_score_fill (K4s substitution-matrix score "
                         "fill)", route="cuda", source=f"{src}/rowcb.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_fill.py:1110",
                    fn=rowcb.submat_score_fill),
        "K4d": dict(name="rowcb_fill with a table (K4d substitution-matrix "
                         "dirs fill)", route="cuda",
                    source=f"{src}/rowfill.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_rowcb.py:244",
                    fn=rowcb.rowcb_fill, counter="table_launches"),
        "K12s": dict(name="banded_score (K12s band score fill)",
                     route="cuda", source=f"{src}/banded.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_banded.py:42",
                     fn=banded.banded_score),
        "K12d": dict(name="banded_dirs (K12d band dirs16+runs fill)",
                     route="cuda", source=f"{src}/banded.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_banded.py:161",
                     fn=banded.banded_dirs),
        "K2b": dict(name="rle_walk with band_lo (K2 run-length walk, band "
                         "layout)", route="cuda", source=f"{src}/walk.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "device_walk.py:163",
                    fn=device_walk.rle_walk, counter="band_launches"),
        "K3'": dict(name="rowscan_score_fill (K3' row-sweep score fill)",
                    route="cuda", source=f"{src}/rowcb.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_fill.py:750",
                    fn=rowcb.rowscan_score_fill),
        "K1'": dict(name="rowdirs_fill (K1' row-layout uint8 dirs fill)",
                    route="cuda", source=f"{src}/rowcb.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_fill.py:508",
                    fn=rowcb.rowdirs_fill),
        "K5": dict(name="skew_dirs_fill (K5 anti-diagonal skew dirs fill)",
                   route="cuda", source=f"{src}/diag.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_fill.py:310",
                   fn=diag.skew_dirs_fill),
        "K2s": dict(name="step_walk (K2s single-step walk, row layout)",
                    route="cuda", source=f"{src}/walk.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "device_walk.py:35",
                    fn=device_walk.step_walk),
        "K2s-skew": dict(name="step_walk (K2s single-step walk, skew "
                              "layout)", route="cuda",
                         source=f"{src}/walk.cu",
                         replaces="cse305_parallel_sequence_alignment_tpu/"
                                  "ops/device_walk.py:35",
                         fn=device_walk.step_walk, counter="skew_launches"),
        "K8": dict(name="halostair_step (K8 column-sharded pipeline step)",
                   route="cuda", source=f"{src}/halostair.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_halostair.py:93",
                   fn=halostair.halostair_step),
        "K3''": dict(name="rowscan2_score_fill (K3'' two-carry row-sweep "
                          "score fill)", route="cuda",
                     source=f"{src}/rowscan2.cu",
                     replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                              "pallas_fill.py:896",
                     fn=rowscan2.rowscan2_score_fill),
        "K2'": dict(name="group_walk_rle (K2' grouped run-length walk)",
                    route="cuda", source=f"{src}/walk.cu",
                    replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                             "pallas_walk.py:41",
                    fn=device_walk.group_walk_rle),
        "P-trim": dict(name="trim_rowscan_fill (P-trim uniform-la K3')",
                       route="cuda", source=f"{src}/rowcb.cu",
                       replaces="scripts/kern_rowscan2.py:42",
                       fn=rowcb.trim_rowscan_fill),
        "P-dual": dict(name="dual_rowscan2_fill (P-dual two-pair K3'')",
                       route="cuda", source=f"{src}/rowscan2.cu",
                       replaces="scripts/probes/dual_halostair_r4.py:68",
                       fn=rowscan2.dual_rowscan2_fill),
        "P-perm": dict(name="perm_finals (P-perm K3' finals, contiguous or "
                            "strided layout)", route="cuda",
                       source=f"{src}/rowprobe.cu",
                       replaces="scripts/probes/attrib3_r5.py:108",
                       fn=rowprobe.perm_finals),
        "P-stripes": dict(name="stripes_fill (P-stripes S pairs a CTA)",
                          route="cuda", source=f"{src}/rowprobe.cu",
                          replaces="scripts/kern_stripes.py:33",
                          fn=rowprobe.stripes_fill),
        "P-knock": dict(name="knock_fill (P-knock K3' step, pieces knocked "
                             "out)", route="cuda",
                        source=f"{src}/rowprobe.cu",
                        replaces="scripts/kern_attrib.py:37",
                        fn=rowprobe.knock_fill),
        "P-ablate": dict(name="ablate_finals (P-ablate K3' step, a part "
                              "ablated)", route="cuda",
                         source=f"{src}/rowprobe.cu",
                         replaces="scripts/probes/attrib_r5.py:65",
                         fn=rowprobe.ablate_finals),
        "P-floor": dict(name="ablate_finals chain/indep (P-ablate raw "
                             "max-chain floors)", route="cuda",
                        source=f"{src}/rowprobe.cu",
                        replaces="scripts/probes/attrib_r5.py:65",
                        fn=rowprobe.ablate_finals,
                        counter="floor_launches"),
        "P-lane0": dict(name="lane0_fill (P-lane0 column-0 T3 variants)",
                        route="cuda", source=f"{src}/rowprobe.cu",
                        replaces="scripts/kern_scalar.py:37",
                        fn=rowprobe.lane0_fill),
        "P-sweep": dict(name="sweep_fill (P-sweep row step, C columns a "
                             "thread)", route="cuda",
                        source=f"{src}/rowprobe.cu",
                        replaces="scripts/kern_sweep.py:76",
                        fn=rowprobe.sweep_fill),
        "P-attrib2": dict(name="ablate_finals attrib2 modes (P-attrib2 "
                               "prefix parts, exchanges, two CTAs an SM)",
                          route="cuda", source=f"{src}/rowprobe.cu",
                          replaces="scripts/probes/attrib2_r5.py:190",
                          fn=rowprobe.ablate_finals,
                          counter="attrib2_launches"),
        "P-floor2": dict(name="ablate_finals live/chain_i32/chain_i16 "
                              "(P-attrib2 live-array and integer floors)",
                         route="cuda", source=f"{src}/rowprobe.cu",
                         replaces="scripts/probes/attrib2_r5.py:190",
                         fn=rowprobe.ablate_finals,
                         counter="floor2_launches"),
        "P-micro": dict(name="micro_loop (P-micro op-cost loop)",
                        route="cuda", source=f"{src}/micro.cu",
                        replaces="scripts/kern_probe.py:45",
                        fn=micro.micro_loop),
        "P-micro2": dict(name="micro_loop_max (P-micro2 op-cost loop, "
                              "full max)", route="cuda",
                         source=f"{src}/micro.cu",
                         replaces="scripts/kern_probe2.py:40",
                         fn=micro.micro_loop_max),
    }
    for rep in report.values():
        # no single PyTorch call computes a Gotoh or SW fill or walk
        rep.update(max_abs_err=0.0, launches=0, library_ms=None)
        rep.setdefault("counter", "launches")
    phase_kernels(report)
    stamp("kernels")
    phase_numerics(report)
    stamp("numerics")
    phase_long_kernels(report)
    stamp("long kernels")
    phase_golden()
    stamp("golden")

    def run_path(name, drive, kernels):
        """Drive one main path with every counter at 0 first; each of
        ``kernels`` must have launched in it."""
        for rep in report.values():
            setattr(rep["fn"], rep["counter"], 0)
        drive()
        torch.cuda.synchronize()
        counts = {k: getattr(rep["fn"], rep["counter"])
                  for k, rep in report.items()}
        print(f"[counters] {name} path launches {counts}", flush=True)
        missing = [k for k in kernels if counts[k] < 1]
        if missing:
            raise RuntimeError(f"{missing} never ran on the {name} path")
        for k, rep in report.items():
            rep["launches"] += counts[k]

    run_path("global", phase_main_path, ("K1", "K2", "K3"))
    stamp("global path")
    mdata = protein_data()
    phase_matrix_kernels(report, mdata)
    matrix_out = {}
    run_path("matrix", lambda: phase_matrix_main(mdata, matrix_out),
             ("K4s", "K4d", "K2"))
    check_matrix(mdata, matrix_out)
    stamp("matrix")
    del mdata, matrix_out
    runs = []
    run_path("partition", lambda: phase_partition(report, runs),
             ("K1", "K2", "K6", "K7"))
    check_partition(runs)
    stamp("partition")
    phase_long_main(report, runs)
    stamp("long kernels at the partition's shapes")
    ls_out = {}
    run_path("longseq", lambda: phase_longseq_main(runs, ls_out), ("K8",))
    check_longseq(runs, ls_out)
    stamp("longseq path")
    phase_longseq_kernels(report, runs, ls_out)
    stamp("longseq kernels")
    phase_backend_kernels(report)
    stamp("backend kernels")
    bref, bout = backends_reference(runs), {}
    run_path("backends", lambda: phase_backends_main(bref, bout),
             ("K3'", "K1'", "K5", "K2s", "K2s-skew"))
    check_backends(bref, bout)
    stamp("backends path")
    phase_segment_kernels(report, bref, bout)
    stamp("backend kernels at the partition's segments")
    del bref, bout
    phase_rowscan2_kernels(report)
    stamp("rowscan2 kernels")
    phase_group_walk(report)
    stamp("group walk")
    phase_rowprobe_kernels(report)
    stamp("rowprobe kernels")
    phase_rowprobe_kernels(report, ROWPROBES2, "rowprobe2-kernels")
    stamp("rowprobe2 kernels")
    phase_micro_kernels(report)
    stamp("micro kernels")
    probe_out = {}
    run_path("probes", lambda: phase_probes(probe_out),
             ("K3''", "K2'", "P-trim", "P-dual") + tuple(ROWPROBES)
             + tuple(ROWPROBES2) + tuple(MICROS))
    check_probes(probe_out)
    stamp("probes")
    phase_banded_kernels(report, runs)
    banded_out = {}
    run_path("banded", lambda: phase_banded_main(runs, banded_out),
             ("K12s", "K12d", "K2b"))
    check_banded(report, runs, banded_out)
    stamp("banded")
    del banded_out
    data = local_data()
    phase_local_kernels(report, data)
    local_out = {}
    run_path("local", lambda: phase_local_main(data, local_out),
             ("K9s", "K9d", "K9w"))
    check_local(data, local_out)
    stamp("local")
    sharded_out = {}
    run_path("sharded", lambda: phase_sharded_main(data, sharded_out),
             ("K1", "K2", "K3", "K9s"))
    check_sharded(local_out["scores"], sharded_out)
    stamp("sharded path")
    del data, local_out, sharded_out
    sgd, ovd = sg_data(), ov_data()
    phase_free_kernels(report, sgd, ovd)
    stamp("free-end kernels")
    for mode, cls, d, kernels in (
            ("semiglobal", SemiGlobalBatchAligner, sgd,
             ("K10d", "K10s", "K2")),
            ("overlap", OverlapBatchAligner, ovd, ("K11d", "K11s", "K2"))):
        free_out = {}
        run_path(mode, lambda: phase_free_main(cls, d, free_out), kernels)
        check_free(mode, d, free_out)
        stamp(f"{mode} path")
    phase_cli()
    phase_cli_longscore(runs, ls_out)
    stamp("cli")
    phase_perf()
    stamp("perf")

    print(json.dumps({"kernels": [
        {k: rep[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for rep in report.values()]}))
    print(json.dumps({"launches_per_partition": {
        k: report[k]["per_partition"] for k in ("K6", "K7")}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
