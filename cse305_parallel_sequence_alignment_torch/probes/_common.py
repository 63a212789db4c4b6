"""What the probes share: arguments, JSON lines, the seed-7 bucket,
timing (CUDA events on a card, the host clock on the CPU) and the
row-step attribution probes' rounds."""

from __future__ import annotations

import argparse
import collections
import functools
import json
import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.ops import (
    _build,
    rowcb,
    rowprobe,
)


def parse(argv, doc, rounds=3, extra=None):
    """The probes' arguments: ``--device`` ("cuda" unless "cpu" is asked
    for), ``--small`` (a few narrow pairs: for the CPU tests), ``--rounds``
    (interleaved A/B rounds) and ``--reps`` (timed calls a measurement);
    ``extra(parser)`` adds a probe's own."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--rounds", type=int, default=rounds)
    ap.add_argument("--reps", type=int, default=6)
    if extra:
        extra(ap)
    args = ap.parse_args(argv)
    args.dev = _build.resolve_device(args.device, "probe")
    return args


def emit(**row):
    print(json.dumps(row), flush=True)


def emit_device(dev):
    """The first line: where the numbers below were taken."""
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    emit(kind="device", device=name, torch=torch.__version__,
         cuda=torch.version.cuda)


def bucket(dev, B, m, n, seed=7):
    """The TPU probes' bucket: codes 65-68 from ``default_rng(seed)``, A
    then B, every la = m and lb = n, on ``dev``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, size=(B, m)).astype(np.uint8)
    b = rng.integers(65, 69, size=(B, n)).astype(np.uint8)
    la = np.full(B, m, np.int32)
    lb = np.full(B, n, np.int32)
    return [torch.from_numpy(x).to(dev) for x in (a, b, la, lb)], rng


def timed(fn, dev, reps, warm=2):
    """{"ms": mean of ``reps`` calls by CUDA events} after ``warm`` calls
    on a card; {"host_ms": ...} by the host clock on the CPU."""
    for _ in range(warm):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        return {"ms": t0.elapsed_time(t1) / reps}
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return {"host_ms": (time.perf_counter() - t0) / reps * 1e3}


def rate(cells, t):
    """``t`` with GCUPS added when it was taken on a card."""
    if "ms" in t:
        return dict(t, gcups=cells / t["ms"] / 1e6)
    return dict(t)


REDUCED = 16  # pairs of the reduced bucket the kernels are checked on


def same(x, y):
    """Equal tensors, NaN equal to NaN."""
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny]))


# one variant of an attribution probe: ``run`` (its call at full size),
# ``plain`` (the plain twin's call on the same inputs), ``reduced`` (its
# call on the reduced bucket) and ``twin`` (the key of the twin's call
# there), the names of its ``full`` step and its K3' ``pin``, its DP
# ``cells`` and the bytes its call must move (``nbytes``), and ``k3p``:
# None, or a call that says whether its full-size result equals K3''s;
# ``info``, fields its lines carry (shapes, threads, occupancy) or None
Variant = collections.namedtuple(
    "Variant", "run plain reduced twin full pin cells nbytes k3p info",
    defaults=(None,))


def run_attribution(args, rows, pins, variants, twins):
    """The row-step attribution probes' lines. First each variant's result
    on the reduced bucket against its plain twin's (each twin runs once),
    ``exact``, and, where it computes K3''s function, whether its
    full-size result equals K3''s, ``equals_k3p``. Then interleaved
    rounds: in each, every K3' pin (``pins``, name -> (call, cells)) and
    then every variant (a full step before the variants that name it),
    each timed; a line each with the time and, on a card, GCUPS,
    microseconds a row (``rows`` a call) and the ratios to the full step
    (``vs_full``) and to K3' (``vs_k3p``), and the variant's flags."""
    want, flags = {}, {}
    for name, v in variants.items():
        if v.twin not in want:
            want[v.twin] = twins[v.twin]()
        flags[name] = {"exact": same(v.reduced(), want[v.twin])}
        if v.k3p is not None:
            flags[name]["equals_k3p"] = bool(v.k3p())
    del want

    def row(cells, t):
        out = rate(cells, t)
        if "ms" in t:
            out["us_per_row"] = t["ms"] * 1e3 / rows
        return out

    for rnd in range(args.rounds):
        times = {}
        for name, (call, cells) in pins.items():
            times[name] = timed(call, args.dev, args.reps)
            emit(kind="round", round=rnd, name=name, rows=rows,
                 **row(cells, times[name]))
        for name, v in variants.items():
            t = times[name] = timed(v.run, args.dev, args.reps)
            extra = {}
            if "ms" in t:
                extra = dict(vs_full=t["ms"] / times[v.full]["ms"],
                             vs_k3p=t["ms"] / times[v.pin]["ms"])
            emit(kind="round", round=rnd, name=name, rows=rows,
                 **row(v.cells, t), **extra, **flags[name], **(v.info or {}))


def ext_codes(dev, B, W, seed=7):
    """The stripes and lane-0 probes' b_ext: codes 60-69 over every
    column, (B, W) uint8 from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(60, 70, size=(B, W)).astype(np.uint8)).to(dev)


def k3p_rows(b_ext, rows):
    """(call, max3) of K3' on ``b_ext``'s pairs with A's character 65 at
    ``rows`` rows: its finals' max at column W - 1, each pair's last-row
    max3 there, which the fixed-A probes compute."""
    B, W = b_ext.shape
    dev = b_ext.device
    a = torch.full((B, rows), 65, dtype=torch.uint8, device=dev)
    b = b_ext[:, 1:].contiguous()
    la = torch.full((B,), rows, dtype=torch.int32, device=dev)
    lb = torch.full((B,), W - 1, dtype=torch.int32, device=dev)
    st = torch.full_like(la, -1)
    call = functools.partial(rowcb.rowscan_score_fill, a, b, la, lb, st,
                             rowprobe.PROBE_PARAMS)
    return call, call().max(dim=1).values
