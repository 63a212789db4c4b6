"""The spread of a cell's metrics over two sets of runs, by the rules a
bound is held to.

    python3 seqbench/spread.py 'runs/set1_*.out' 'runs/set2_*.out'

Each file holds one run's standard output; its last line is the result.
For each metric and set: the median, the range (max - min) as a share of
the median, and the same range leaving out the run farthest from the
median where that narrows it; beside them the interquartile range of
``statistics.quantiles(values, n=4)``. Then the bounds those readings
allow: at least twice the mean of the two sets' trimmed ranges (a bound
under it is too tight), at most eight times the widest reading of all
runs together (a bound over it is too loose), by either spread.
"""

from __future__ import annotations

import glob
import json
import statistics
import sys


def value_range(values):
    return (max(values) - min(values)) / statistics.median(values)


def trimmed_range(values):
    """The range without the run farthest from the median, where that
    narrows it."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda k: abs(values[k] - med))
    rest = values[:far] + values[far + 1:]
    return min(value_range(values),
               (max(rest) - min(rest)) / statistics.median(values))


def iqr(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def results(pattern):
    out = []
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            lines = f.read().strip().splitlines()
        if lines:
            out.append(json.loads(lines[-1]))
    return out


def main(argv):
    sets = [results(p) for p in argv]
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        rows, trims, every = [], [], []
        for k, s in enumerate(sets):
            v = [r["metrics"][name]["value"] for r in s if name in
                 r["metrics"]]
            if len(v) < 3:
                continue
            trims.append(trimmed_range(v))
            every += v
            rows.append(f"set{k + 1} n={len(v)} median={statistics.median(v)!r}"
                        f" min={min(v)!r} max={max(v)!r}"
                        f" range={100 * value_range(v):.3f}%"
                        f" trimmed={100 * trims[-1]:.3f}%"
                        f" iqr={100 * iqr(v):.3f}%")
        if rows:
            print(f"{name}: " + "; ".join(rows) +
                  f"; bound at least {200 * statistics.mean(trims):.3f}%"
                  f", at most {800 * value_range(every):.3f}% (range)"
                  f" / {800 * iqr(every):.3f}% (iqr) of all runs")
    print("correct:", [r["correct"] for s in sets for r in s])


if __name__ == "__main__":
    main(sys.argv[1:])
