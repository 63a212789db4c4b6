#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from ``cse305_parallel_sequence_alignment_torch/
csrc`` and drives its main path, global full alignment of many pairs:

1. card, torch and CUDA versions; the kernels' build time;
2. each kernel (K1 dirs16+runs fill, K3 score fill, K2 run-length walk)
   against its plain PyTorch version on the card, bit for bit, on 8
   ragged pairs up to 2 kb with every start type, on rows too wide for
   shared memory, and on 256 x 2 kb; both timed with CUDA events;
3. the golden cases (tests/golden/cases.jsonl) through
   ``BatchAligner(device="cuda")``: 34 pipeline rows byte-equal, 152
   subproblem chains and finals equal;
4. the main path at real size, with every launch counter set to 0
   first: ``align_batch`` on 256 random pairs x 2 kb (one warm-up, 3
   timed runs, phase split), ``score_batch`` agreeing with it, and 16
   pairs of 12-16 kb in ``traceback_mode="full"`` whose chains re-score
   to their scores;
5. the CLI ``align`` in a subprocess;
6. every kernel launched by step 4.

Prints a JSON line of the kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises; the script
exits non-zero at once when no CUDA device is available.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PKG = "cse305_parallel_sequence_alignment_torch"
ACGT = np.frombuffer(b"ACGT", np.uint8)


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
    x, y = x.to(torch.float64), y.to(torch.float64)
    d = torch.where(x == y, torch.zeros_like(x), (x - y).abs())
    return float(d.max()) if d.numel() else 0.0


def timed(fn, reps):
    """(result, ms per call) by CUDA events after one warm-up call."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1) / reps


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
        print(f"[kernels] {name}: K1 err {e1} {ms1:.3f} ms (plain "
              f"{pms1:.1f} ms); K3 err {e3} {ms3:.3f} ms (plain "
              f"{pms3:.1f} ms); K2 err {e2} rounds {int(u_k[0])} "
              f"{ms2:.3f} ms (plain {pms2:.1f} ms)", flush=True)
        if e1 or e2 or e3:
            raise RuntimeError(f"kernel disagrees with its plain version "
                               f"on {name}: K1 {e1} K3 {e3} K2 {e2}")
        for key, err, ms, pms in (("K1", e1, ms1, pms1),
                                  ("K3", e3, ms3, pms3),
                                  ("K2", e2, ms2, pms2)):
            rep = report[key]
            rep["max_abs_err"] = max(rep["max_abs_err"], err)
            if big:
                rep["ms"], rep["plain_ms"] = ms, pms
        del d_k, d_p
        torch.cuda.empty_cache()


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


def score_chain(a_enc, b_enc, chain, params):
    """Affine score of an explicit chain (independent evaluator)."""
    g, h, match, mismatch = params.astuple()
    score, prev_t = 0.0, None
    for (i, j, t) in chain:
        if t == 1:
            score += match if a_enc[i - 1] == b_enc[j - 1] else mismatch
        else:
            score -= g
            if t != prev_t:
                score -= h
        prev_t = t
    return score


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


def phase_main_path():
    import torch

    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )

    rng = np.random.default_rng(7)
    B, L = 256, 2048
    pairs = [(ACGT[rng.integers(0, 4, L)].tobytes().decode(),
              ACGT[rng.integers(0, 4, L)].tobytes().decode())
             for _ in range(B)]
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


def phase_cli():
    out = subprocess.run(
        [sys.executable, "-m", PKG, "align", "--a", "AGGA", "--b", "AGTGC"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or lines[-2:] != ["AG-GA", "AGTGC"]:
        raise RuntimeError(f"CLI align failed (rc {out.returncode}):\n"
                           f"{out.stdout}\n{out.stderr}")
    print("[cli] align --a AGGA --b AGTGC -> AG-GA / AGTGC", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    from cse305_parallel_sequence_alignment_torch.ops import (
        _build,
        device_walk,
        rowcb,
    )

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.cuda_library("rowcb")
    _build.cuda_library("walk")
    _build.host_library()
    print(f"[build] kernels and host library built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    src = f"{PKG}/csrc"
    report = {
        "K1": dict(name="rowcb_fill (K1 dirs16+runs fill)", route="cuda",
                   source=f"{src}/rowcb.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_rowcb.py:126",
                   fn=rowcb.rowcb_fill),
        "K3": dict(name="score_fill (K3 score fill)", route="cuda",
                   source=f"{src}/rowcb.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "pallas_fill.py:216",
                   fn=rowcb.score_fill),
        "K2": dict(name="rle_walk (K2 run-length walk)", route="cuda",
                   source=f"{src}/walk.cu",
                   replaces="cse305_parallel_sequence_alignment_tpu/ops/"
                            "device_walk.py:124",
                   fn=device_walk.rle_walk),
    }
    for rep in report.values():
        rep["max_abs_err"] = 0.0
    phase_kernels(report)
    phase_golden()

    for rep in report.values():
        rep["fn"].launches = 0
    phase_main_path()
    torch.cuda.synchronize()
    for rep in report.values():
        rep["launches"] = rep.pop("fn").launches
    phase_cli()
    counts = {k: rep["launches"] for k, rep in report.items()}
    print(f"[counters] main-path launches {counts}", flush=True)
    if min(counts.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never ran: {counts}")

    print(json.dumps({"kernels": [
        {k: rep[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms")}
        for rep in report.values()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
