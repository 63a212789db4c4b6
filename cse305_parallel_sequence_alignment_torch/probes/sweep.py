"""P-sweep: pairs, row width, columns a thread and unroll of the K3' row
step with A's character fixed, beside K3', in one process.

The H100 counterpart of the TPU probe scripts/kern_sweep.py, which asked
whether the row time tracks the working set a program holds: 2,048 rows
of the row step with A's character 65 over every column of a b_ext of
codes 60-69 (seed 7, drawn for each case as the script draws it) for the
script's twelve cases (:109-115: B pairs of 8 to 256 against row widths
512, 1,088 and 2,176 at unroll 4; 8 x 2,176 at unroll 16; 64 x 2,176 at
unroll 1), each at 4, 8 and 16 columns a thread (``sweep_fill``). On the
H100 the working set is registers: 3C floats and C codes a thread, and
so the CTAs an SM holds; B below and above the card's SMs shows the
waves. In interleaved rounds with K3' (``rowscan_score_fill``, A all 65)
at each B and width. Each line carries the case, the threads a CTA, on a
card the CTAs an SM holds (``ctas_per_sm``, CUDA's occupancy calculator)
and the waves of CTAs that makes (``waves``), whether the kernel equals
its plain twin on the first 16 pairs (``exact``) and whether each pair's
last-row max3 at the last column is the max of K3''s finals there
(``equals_k3p``); ``vs_full`` is the ratio to the same case at C = 4.

    python -m cse305_parallel_sequence_alignment_torch.probes.sweep
"""

from __future__ import annotations

import functools
import math

import torch

from cse305_parallel_sequence_alignment_torch.ops import rowprobe
from cse305_parallel_sequence_alignment_torch.probes._common import (
    REDUCED,
    Variant,
    emit_device,
    ext_codes,
    k3p_rows,
    parse,
    run_attribution,
)

# (pairs, row width, unroll): scripts/kern_sweep.py:109-115
GRID = ((64, 2176, 4), (32, 2176, 4), (16, 2176, 4), (8, 2176, 4),
        (64, 1088, 4), (64, 512, 4), (128, 2176, 4), (256, 2176, 4),
        (8, 512, 4), (16, 1088, 4), (8, 2176, 16), (64, 2176, 1))
COLUMNS = (4, 8, 16)
ROWS = rowprobe.ROWS


def name_of(B, W, C, U):
    return f"B{B}_W{W}_C{C}_u{U}"


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``; ``small``
    cuts the rows to 16, the widths 8.5 times and the pairs 8 times."""
    rows = 16 if small else ROWS
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else None)
    pins, want, variants, twins = {}, {}, {}, {}
    for B0, W0, U in GRID:
        B, W = (max(1, B0 // 8), W0 * 2 // 17) if small else (B0, W0)
        b_ext = ext_codes(dev, B, W)
        pin = f"K3' B{B} W{W}"
        if pin not in pins:
            call, want[pin] = k3p_rows(b_ext, rows)
            pins[pin] = (call, B * rows * (W - 1))
        r = min(B, REDUCED)
        rext = b_ext[:r].contiguous()
        twin = f"W{W}_B{r}"
        twins.setdefault(twin, functools.partial(
            rowprobe.sweep_fill_plain, rext, rows))
        for C in COLUMNS:
            run = functools.partial(rowprobe.sweep_fill, b_ext, C, U, rows)
            info = dict(B=B, W=W, C=C, unroll=U,
                        threads=rowprobe.threads_for(W, 1, C))
            if sms:
                ctas = rowprobe.occupancy(W, ("charcol",), unroll=U,
                                          columns=C)
                info.update(ctas_per_sm=ctas,
                            waves=math.ceil(B / (sms * ctas)))
            variants[name_of(B, W, C, U)] = Variant(
                run=run,
                plain=functools.partial(rowprobe.sweep_fill_plain, b_ext,
                                        rows),
                reduced=functools.partial(rowprobe.sweep_fill, rext, C, U,
                                          rows),
                twin=twin, full=name_of(B, W, 4, U), pin=pin,
                cells=B * rows * (W - 1), nbytes=5 * B * W,
                k3p=lambda run=run, pin=pin: torch.equal(run()[:, -1],
                                                         want[pin]),
                info=info)
    return rows, pins, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
