"""Device readings from ``torch.profiler``: what ran on the card, how long
it was busy, and what the host was doing while it was idle.

``device_window`` profiles whole passes with the card's activity only
(little overhead): busy time is the union of the card's kernel, copy and
set intervals, the window the host clock around the passes. ``idle_gaps``
profiles a few calls with the host's Python stack as well, and charges
each idle stretch of the card to the innermost frame of the program that
the main thread was in at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time

import torch

PROGRAM = "cse305_parallel_sequence_alignment_torch"


@dataclasses.dataclass
class DeviceWindow:
    busy_s: float
    window_s: float
    passes: int
    kernels: dict  # short name -> seconds on the card

    def top(self, k=10):
        return sorted(self.kernels.items(), key=lambda kv: -kv[1])[:k]


def short_name(name, width=64):
    """A kernel's name without ``void`` and its argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = k
            break
    return name[:cut][:width]


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0]


def _union(intervals):
    """Sorted, merged [start, end] intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_window(run_passes, passes):
    """Profile ``run_passes(passes)`` with the card's activity only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_passes(passes)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e - s for s, e in _union([(s, e) for _, s, e in events]))
    kernels = {}
    for name, s, e in events:
        key = short_name(name)
        kernels[key] = kernels.get(key, 0.0) + (e - s) * 1e-9
    return DeviceWindow(busy_s=busy * 1e-9, window_s=window, passes=passes,
                        kernels=kernels)


def _frame_key(name):
    """``<file>:<function>`` of a Python call event, from the program's
    package down, or None for a frame outside the program."""
    m = re.match(r"(.*)\((\d+)\): (.*)", name)
    if not m or PROGRAM not in m.group(1):
        return None
    path = m.group(1)
    return (path[path.rfind(PROGRAM):] + ":" + m.group(3))[:64]


def _self_segments(roots):
    """[(start, end, key)] of the main thread's time, each stretch labelled
    with the innermost program frame open in it (``host outside the
    program`` where none is)."""
    segs = []

    def visit(ev, key):
        k = _frame_key(ev.name) if ev.tag.name == "PyCall" else None
        key = k or key
        t = ev.start_time_ns
        for ch in sorted(ev.children, key=lambda c: c.start_time_ns):
            if ch.start_time_ns > t:
                segs.append((t, ch.start_time_ns, key))
            visit(ch, key)
            t = max(t, ch.end_time_ns)
        if ev.end_time_ns > t:
            segs.append((t, ev.end_time_ns, key))

    for r in roots:
        visit(r, "host outside the program")
    segs.sort()
    return segs


def idle_gaps(run_calls, k=10):
    """The ``k`` longest idle totals of the card, [(host frame, seconds)],
    over ``run_calls()`` profiled with the Python stack."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        torch.cuda.synchronize()
        run_calls()
        torch.cuda.synchronize()
    roots = prof.profiler.kineto_results.experimental_event_tree()
    by_tid = {}
    for r in roots:
        by_tid.setdefault(r.start_tid, []).append(r)
    main = max(by_tid.values(),
               key=lambda rs: sum(r.end_time_ns - r.start_time_ns for r in rs))
    segs = _self_segments(main)
    if not segs:
        return []
    starts = [s for s, _, _ in segs]
    lo, hi = segs[0][0], max(e for _, e, _ in segs)
    busy = _union([(s, e) for _, s, e in _device_events(prof)])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    totals = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        at = bisect.bisect_right(starts, (s + e) // 2) - 1
        key = segs[max(at, 0)][2]
        totals[key] = totals.get(key, 0.0) + (e - s) * 1e-9
    return sorted(totals.items(), key=lambda kv: -kv[1])[:k]
