"""The readings that set the check's limits, on the card at a cell's own
size: the program's compared numbers over many seeds (the lower reading)
and the control's (the upper one).

    python3 seqbench/control.py --workload <name> --seeds 1 2 ... \\
        [--control-seeds 1 2 3]

The program runs one short window a seed (one whole pass, whose answers
are all checked), as ``run.py`` does. The control is the plain reference
put in the program's place and swept in the next precision below the
configuration's (``LOWER``): its scores and end tables are judged by the
same comparison. One JSON line per seed and side.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
LOWER = {"float32": "bfloat16"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import check
    import generate
    import harness
    import manifest

    for seed in args.seeds:
        r = harness.run(args.workload, seed, 0.0, False,
                        log=lambda line: None)
        print(json.dumps({"side": "program", "seed": seed,
                          "correct": r["correct"], "window": r["window"],
                          "compared": {k: v["value"] for k, v in
                                       r["compared"].items()}}), flush=True)
    cell = manifest.Cell(manifest.load(), args.workload)
    dtype = LOWER[cell.config["precision"]]
    for seed in args.control_seeds:
        passage = generate.make_pass(cell.traffic, cell.config, seed)
        n = check.judge_control(cell.entry.LIMITS, cell.config, passage,
                                "cuda", dtype)
        print(json.dumps({"side": "control", "dtype": dtype,
                          "seed": seed, "checked": passage.pairs,
                          "compared": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
