"""What the probes share: arguments, JSON lines, the seed-7 bucket and
timing (CUDA events on a card, the host clock on the CPU)."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.ops import _build


def parse(argv, doc, rounds=3):
    """The probes' arguments: ``--device`` ("cuda" unless "cpu" is asked
    for), ``--small`` (a few narrow pairs: for the CPU tests), ``--rounds``
    (interleaved A/B rounds) and ``--reps`` (timed calls a measurement)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--rounds", type=int, default=rounds)
    ap.add_argument("--reps", type=int, default=6)
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
