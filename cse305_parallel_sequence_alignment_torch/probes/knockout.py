"""P-knock: the K3' row step with pieces knocked out (wrong math, the
same structure otherwise), beside K3', in one process.

The H100 counterpart of the TPU probe scripts/kern_attrib.py: 64 pairs of
2048 x 2048 (codes 65-68, seed 7; b at columns 1-2,048 of a 2,176-column
b_ext, PAD_B elsewhere) through ``knock_fill`` for the probe's ten cases
(:128-138): the full step at unroll 4, 8 and 16; A's character fixed
(``charcol``), and the broadcast compare too (``bcast``); no prefix max;
the prefix max over a 128-column window only (``prefix7``); no shifts;
no prefix max and no shifts; all four out. In interleaved rounds with K3'
(``rowscan_score_fill``). Each line says whether the kernel equals its
plain twin on the first 16 pairs (``exact``), and for the full step
whether its row at column 2,048 is the max of K3''s finals
(``equals_k3p``).

    python -m cse305_parallel_sequence_alignment_torch.probes.knockout
"""

from __future__ import annotations

import functools

import torch

from cse305_parallel_sequence_alignment_torch.core import PAD_B
from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowprobe
from cse305_parallel_sequence_alignment_torch.probes._common import (
    REDUCED,
    Variant,
    bucket,
    emit_device,
    parse,
    run_attribution,
)

GRID = {"full_u4": ((), 4), "full_u8": ((), 8), "full_u16": ((), 16),
        "charcol": (("charcol",), 4),
        "charcol_bcast": (("charcol", "bcast"), 4),
        "prefix": (("prefix",), 4), "prefix7": (("prefix7",), 4),
        "shift1": (("shift1",), 4),
        "prefix_shift1": (("prefix", "shift1"), 4),
        "minimal": (("charcol", "bcast", "prefix", "shift1"), 4)}
NL = 2176  # the probe's row width, ceil((N + 1) / 128) * 128


def cases(dev, small=False):
    """(rows, pins, variants, twins) of the probe on ``dev``."""
    B, M, N, W = (4, 32, 200, 256) if small else (64, 2048, 2048, NL)
    (a, b, la, lb), _ = bucket(dev, B, M, N, seed=7)
    b_ext = torch.full((B, W), PAD_B, dtype=torch.uint8, device=dev)
    b_ext[:, 1: N + 1] = b
    ra, rext = (x[:REDUCED].contiguous() for x in (a, b_ext))
    k3p = functools.partial(rowcb.rowscan_score_fill, a, b, la, lb,
                            torch.full_like(la, -1), rowprobe.PROBE_PARAMS)
    want = k3p().max(dim=1).values
    cells = B * M * N
    variants, twins = {}, {}
    for name, (knock, u) in GRID.items():
        run = functools.partial(rowprobe.knock_fill, a, b_ext, knock, u)
        key = "full" if not knock else name
        variants[name] = Variant(
            run=run,
            plain=functools.partial(rowprobe.knock_fill_plain, a, b_ext,
                                    knock),
            reduced=functools.partial(rowprobe.knock_fill, ra, rext, knock,
                                      u),
            twin=key, full="full_u4", pin="K3'", cells=cells,
            nbytes=B * (M + W + 4 * W),
            k3p=(lambda run=run: torch.equal(run()[:, N], want))
            if not knock else None)
        twins[key] = functools.partial(rowprobe.knock_fill_plain, ra, rext,
                                       knock)
    return M, {"K3'": (k3p, cells)}, variants, twins


def main(argv=None):
    args = parse(argv, __doc__)
    emit_device(args.dev)
    run_attribution(args, *cases(args.dev, args.small))


if __name__ == "__main__":
    main()
