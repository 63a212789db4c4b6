"""P-attrib2: the prefix max's parts, the exchange mechanism, two CTAs an
SM, the liveness cliff and integer width of the K3' row step, beside K3'
and K3, in one process.

The H100 counterpart of the TPU probe scripts/probes/attrib2_r5.py: 256
pairs of 2048 x 2048 (codes 65-68, seed 11, start type -1, every la = m)
through ``ablate_finals`` under each mode of ``rowprobe.ATTRIB2`` (the
full step; the prefix max's strides under 128 alone, ``pm_unaligned``,
or from 128 up alone, ``pm_aligned``; the scan wholly through shared
memory, ``pm_roll``, or the halo, ``shift_roll``, which the TPU probe
lowered through ``pltpu.roll``; the full step at two CTAs an SM,
``full_b32``, where the TPU probe halved the pairs a program) and the
floors of ``rowprobe.FLOORS2`` (``live``: 16 dependent operations a row
over L = 2, 4, 6, 8 live arrays; ``chain_i32``, ``chain_i16``: 16
dependent integer operations), in interleaved rounds with K3'
(``rowscan_score_fill``, ``pin``) and the anti-diagonal K3
(``score_fill``, ``diag``). Each line says whether the kernel equals its
plain twin on the first 16 pairs (``exact``), and for the steps that
compute K3''s function (``full``, ``pm_roll``, ``shift_roll``,
``full_b32``, ``diag``) whether the finals equal K3''s (``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.attrib2
"""

from __future__ import annotations

import functools

import torch

from cse305_parallel_sequence_alignment_torch.ops import diag, rowcb, rowprobe
from cse305_parallel_sequence_alignment_torch.probes._common import (
    REDUCED,
    Variant,
    bucket,
    emit_device,
    parse,
    run_attribution,
)

GRID = tuple((mode, 0, 0) for mode in rowprobe.ATTRIB2) + tuple(
    (mode, K, L) for mode, KLs in rowprobe.FLOORS2.items() for K, L in KLs)
K3P_MODES = ("full", "pm_roll", "shift_roll", "full_b32")


def name_of(mode, K, L):
    if not K:
        return mode
    return f"{mode}_K{K}_L{L}" if L else f"{mode}_K{K}"


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    B, m, n = (4, 32, 300) if small else (256, 2048, 2048)
    (a, b, la, lb), _ = bucket(dev, B, m, n, seed=11)
    ra, rb, rla, rlb = (x[:REDUCED].contiguous() for x in (a, b, la, lb))
    st = torch.full_like(la, -1)
    params = rowprobe.PROBE_PARAMS
    k3p = functools.partial(rowcb.rowscan_score_fill, a, b, la, lb, st,
                            params)
    want = k3p()
    cells = B * m * n
    variants, twins = {}, {}
    for mode, K, L in GRID:
        name = name_of(mode, K, L)
        run = functools.partial(rowprobe.ablate_finals, a, b, lb, mode, K, L)
        variants[name] = Variant(
            run=run,
            plain=functools.partial(rowprobe.ablate_finals_plain, a, b, lb,
                                    mode, K, L),
            reduced=functools.partial(rowprobe.ablate_finals, ra, rb, rlb,
                                      mode, K, L),
            twin=name, full="full", pin="pin", cells=cells,
            nbytes=(4 + 12) * B if K else B * (m + n + 4 + 12),
            k3p=(lambda run=run: torch.equal(run(), want))
            if mode in K3P_MODES else None)
        twins[name] = functools.partial(rowprobe.ablate_finals_plain, ra, rb,
                                        rlb, mode, K, L)
    rst = st[:REDUCED].contiguous()
    run = functools.partial(diag.score_fill, a, b, la, lb, st, params)
    variants["diag"] = Variant(
        run=run,
        plain=functools.partial(diag.score_fill_plain, a, b, la, lb, st,
                                params),
        reduced=functools.partial(diag.score_fill, ra, rb, rla, rlb, rst,
                                  params),
        twin="diag", full="full", pin="pin", cells=cells,
        nbytes=B * (m + n + 4 + 4 + 4 + 12),
        k3p=lambda: torch.equal(run(), want))
    twins["diag"] = functools.partial(diag.score_fill_plain, ra, rb, rla,
                                      rlb, rst, params)
    return m, {"pin": (k3p, cells)}, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
