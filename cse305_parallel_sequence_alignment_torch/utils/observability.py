"""The port's tracing and throughput accounting.

- ``gcups``: the port's copy of the JAX package's ``gcups``.
- ``Marks``: timestamps on an aligner's device (CUDA events on a card,
  the host clock on the CPU), for phases that end on the card.
- ``PhaseTimer``: the JAX package's ``PhaseTimer`` (``totals`` and
  ``counts`` a name) with two additions. ``span(name, **ids)`` adds its
  host-clock milliseconds to ``totals[name + "_ms"]`` and, only while a
  ``torch.profiler`` is recording, opens the range ``seqalign.<name>``
  with the ids in its args, so that the range sits on the profiler's
  timeline beside the card's kernels and copies. ``count(name, n)`` adds
  ``n`` to the innermost recorder active in this thread (``with timer:``),
  so an op counts into the call it serves without being handed the
  recorder; with none active it does nothing.

An operator sees the ranges in any ``torch.profiler`` trace, for example
one written with ``export_chrome_trace``; with the card's activity on,
kineto also draws each range that launched work on the card as a
``gpu_user_annotation`` over that work. The ids are the range's input:
an ``ExecutionTraceObserver`` records them, a chrome trace does not (there
chunk c is the c-th range of its name inside its ``seqalign.align_batch``).
Nothing here reads the environment, logs or exports.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_ACTIVE = threading.local()


def gcups(cells: int, seconds: float) -> float:
    """Billions of DP cell updates per second."""
    return cells / seconds / 1e9 if seconds > 0 else float("inf")


class Marks:
    """Timestamps on the aligner's device: CUDA events on a card (read
    once the host waited for the last one), the host clock on the CPU,
    where every call returns finished."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self):
        if self.cuda:
            self.marks[-1].synchronize()

    def ms(self, k):
        a, b = self.marks[k], self.marks[k + 1]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def since(self, earlier):
        """ms from ``earlier``'s last mark to this one's first, both on
        the same stream and both waited for."""
        a, b = earlier.marks[-1], self.marks[0]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _stack():
    if not hasattr(_ACTIVE, "stack"):
        _ACTIVE.stack = []
    return _ACTIVE.stack


class PhaseTimer:
    """Totals a name: milliseconds of spans (``<name>_ms``), milliseconds
    read off another clock (``add``) and counts (``count``); ``counts``
    holds how many times each name was added to. ``totals`` starts as a
    copy of ``zeros``; ``ids`` go into every span's profiler range."""

    def __init__(self, zeros=None, **ids):
        self.totals: dict = dict(zeros or {})
        self.counts: dict[str, int] = {}
        self.ids = ids

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()

    def add(self, name, value):
        self.totals[name] = self.totals.get(name, 0) + value
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def span(self, name, **ids):
        rng = None
        if torch.autograd._profiler_enabled():
            args = ",".join(f"{k}={v}" for k, v in {**self.ids,
                                                      **ids}.items())
            rng = torch.profiler.record_function(f"seqalign.{name}", args)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name + "_ms", (time.perf_counter() - t0) * 1e3)
            if rng is not None:
                rng.__exit__(None, None, None)


def active():
    """The innermost recorder active in this thread, or a detached one
    whose totals nobody reads."""
    stack = _stack()
    return stack[-1] if stack else PhaseTimer()


def count(name, n=1):
    """Add ``n`` to ``name`` of the innermost active recorder, if any."""
    stack = _stack()
    if stack:
        stack[-1].add(name, n)
