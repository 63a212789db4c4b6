"""P-micro and P-micro2: what one vector operation of each class costs in
a dependent loop on the card, by the difference of two step counts.

The H100 counterpart of the TPU probes scripts/kern_probe.py (``--which
micro``: 16 classes on x (64, 2,176) with y = 1e-6 * normal, seed 0,
4,096 and 20,480 steps, ``micro_loop``) and scripts/kern_probe2.py
(``--which micro2``: the elementwise chain, lane- and axis-0 shifts, the
full prefix max along either axis and the pack/unpack round trip, each at
its own shape with y = 1e-3 * normal, seed 0 for each case, 512 and 2,560
steps, ``micro_loop_max``); both by default. For each case the kernel is
timed at the two step counts (CUDA events, ``lo_ms`` and ``hi_ms``), and
``ns_per_op`` is the scripts' quotient (t_hi - t_lo) / ((S_hi - S_lo) *
ops), which drops the launch and the output. ``exact`` says whether the
kernel equals its plain twin on the first 16 lines (rows, or columns for
the axis-0 classes) at 64 steps. With ``--device cpu`` the twins run,
their host-clock times are ``lo_host_ms`` and ``hi_host_ms``, and there is
no rate.

    python -m cse305_parallel_sequence_alignment_torch.probes.micro
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.ops import micro
from cse305_parallel_sequence_alignment_torch.probes._common import (
    emit,
    emit_device,
    parse,
    same,
    timed,
)

# (name, op, ops a step, shift): scripts/kern_probe.py:153-170, on (64,
# 2,176)
PROBE1 = (
    ("add x+y", "add", 12, 0), ("mul x*y", "mul", 12, 0),
    ("max blend (2 ops)", "maxblend", 12, 0),
    ("where (2 ops)", "where", 12, 0),
    ("concat s=1 +y", "shift", 12, 1), ("concat s=8 +y", "shift", 12, 8),
    ("concat s=64 +y", "shift", 12, 64),
    ("concat s=128 +y", "shift", 12, 128),
    ("concat s=1024 +y", "shift", 12, 1024),
    ("roll s=1 +y", "roll", 12, 1), ("roll s=64 +y", "roll", 12, 64),
    ("roll s=128 +y", "roll", 12, 128),
    ("roll masked s=1 +y", "rollmask", 12, 1),
    ("FULL prefix concat", "prefix", 1, 0),
    ("FULL prefix hybrid", "prefix_hybrid", 1, 0),
    ("FULL prefix rollmask", "prefix_rollmask", 1, 0))
SHAPE1, STEPS1, Y1 = (64, 2176), (4096, 20480), 1e-6
# (name, op, ops a step, shift, axis, shape): scripts/kern_probe2.py:128-156
PROBE2 = (
    ("elementwise chain (256,2176) 2op", "chain", 16, 0, 1, (256, 2176)),
    ("elementwise chain (64,2176) 2op", "chain", 16, 0, 1, (64, 2176)),
    ("elementwise chain (2176,256) 2op", "chain", 16, 0, 1, (2176, 256)),
    ("lane concat s=1 (256,2176)", "shift", 12, 1, 1, (256, 2176)),
    ("lane concat s=64 (256,2176)", "shift", 12, 64, 1, (256, 2176)),
    ("lane concat s=128 (256,2176)", "shift", 12, 128, 1, (256, 2176)),
    ("sublane concat s=1 (2176,256)", "shift", 12, 1, 0, (2176, 256)),
    ("sublane concat s=8 (2176,256)", "shift", 12, 8, 0, (2176, 256)),
    ("sublane concat s=64 (2176,256)", "shift", 12, 64, 0, (2176, 256)),
    ("sublane roll s=1 (2176,256)", "roll", 12, 1, 0, (2176, 256)),
    ("FULL prefix lane (256,2176)", "prefix", 1, 0, 1, (256, 2176)),
    ("FULL prefix lane (64,2176)", "prefix", 1, 0, 1, (64, 2176)),
    ("FULL prefix sublane (2176,256)", "prefix", 1, 0, 0, (2176, 256)),
    ("FULL prefix sublane (2176,64)", "prefix", 1, 0, 0, (2176, 64)),
    ("pack3/unpack3 roundtrip (256,6528)", "pack", 4, 0, 1, (256, 6528)))
STEPS2, Y2 = (512, 2560), 1e-3
CHECK_LINES, CHECK_STEPS = 16, 64  # the reduced size of the exact check

# one case: the probe it belongs to ("micro" or "micro2"), its kernel's
# wrapper and twin, x and y, and the call's op, ops, shift and axis
Case = collections.namedtuple("Case", "which name fn plain x y op ops shift "
                                      "axis steps")


def data(shape, scale, dev):
    """x = normal, y = ``scale`` * normal (float32), from
    ``default_rng(0)``, as the scripts draw them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32) * scale
    return (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for v in (x, y))


def small_shape(shape):
    """A shape of the ``--small`` size: 2,176 to 272, the others / 16."""
    return tuple(272 * (d // 2176) if d % 2176 == 0 else max(4, d // 16)
                 for d in shape)


def cases(dev, which=("micro", "micro2"), small=False):
    """The probe's cases on ``dev``."""
    out = []
    if "micro" in which:
        shape = (4, 1152) if small else SHAPE1
        x, y = data(shape, Y1, dev)
        steps = (2, 4) if small else STEPS1
        for name, op, ops, s in PROBE1:
            out.append(Case("micro", name, micro.micro_loop,
                            micro.micro_loop_plain, x, y, op, ops, s, 1,
                            steps))
    if "micro2" in which:
        steps = (2, 4) if small else STEPS2
        for name, op, ops, s, axis, shape in PROBE2:
            x, y = data(small_shape(shape) if small else shape, Y2, dev)
            out.append(Case("micro2", name, micro.micro_loop_max,
                            micro.micro_loop_max_plain, x, y, op, ops, s,
                            axis, steps))
    return out


def reduced(c):
    """(x, y) of the exact check: the first 16 lines along the op's
    axis."""
    if c.axis == 0:
        return (v[:, :CHECK_LINES].contiguous() for v in (c.x, c.y))
    return (v[:CHECK_LINES].contiguous() for v in (c.x, c.y))


def check(c):
    """The kernel against its twin at the reduced size (tolerance 0)."""
    rx, ry = reduced(c)
    got = c.fn(rx, ry, c.op, c.ops, CHECK_STEPS, c.shift, c.axis)
    want = c.plain(rx, ry, c.op, c.ops, CHECK_STEPS, c.shift, c.axis)
    return same(got, want)


def ns_per_op(c, lo, hi):
    """The scripts' difference quotient, in ns, from two times in ms."""
    s_lo, s_hi = c.steps
    return (hi - lo) / ((s_hi - s_lo) * c.ops) * 1e6


def measure(c, dev, reps):
    """The case's line: its times at both step counts, the quotient on a
    card, and ``exact``."""
    t = [timed(functools.partial(c.fn, c.x, c.y, c.op, c.ops, s, c.shift,
                                 c.axis), dev, reps, warm=1)
         for s in c.steps]
    row = dict(kind=c.which, name=c.name, op=c.op, ops=c.ops, shift=c.shift,
               axis=c.axis, shape=list(c.x.shape), lo_steps=c.steps[0],
               hi_steps=c.steps[1])
    if "ms" in t[0]:
        row.update(lo_ms=t[0]["ms"], hi_ms=t[1]["ms"],
                   ns_per_op=ns_per_op(c, t[0]["ms"], t[1]["ms"]))
    else:
        row.update(lo_host_ms=t[0]["host_ms"], hi_host_ms=t[1]["host_ms"])
    row["exact"] = check(c)
    return row


def main(argv=None):
    args = parse(argv, __doc__, rounds=1, extra=lambda ap: ap.add_argument(
        "--which", choices=("micro", "micro2", "both"), default="both"))
    which = ("micro", "micro2") if args.which == "both" else (args.which,)
    emit_device(args.dev)
    for c in cases(args.dev, which, args.small):
        for rnd in range(args.rounds):
            emit(round=rnd, **measure(c, args.dev, args.reps))


if __name__ == "__main__":
    main()
