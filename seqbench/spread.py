"""The spread of a cell's metrics over two sets of runs, by the rules a
bound is held to.

    python3 seqbench/spread.py 'runs/set1_*.out' 'runs/set2_*.out'

Each file holds one run's standard output; its last line is the result.
For each metric and set: the median; the interquartile range of
``statistics.quantiles(values, n=4)`` as a share of the median, of all
runs and leaving out the run farthest from the median (the spread a
bound is held to); beside them the range (max - min) as a share of the
median, also of all runs and trimmed so where that narrows it. Then the
bounds those readings allow: at least twice the mean of the two sets'
trimmed spreads (a bound under it is too tight), at most eight times the
widest reading of all runs together (a bound over it is too loose), by
either spread.
"""

from __future__ import annotations

import glob
import json
import statistics
import sys


def value_range(values):
    return (max(values) - min(values)) / statistics.median(values)


def without_farthest(values):
    """The values less the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda k: abs(values[k] - med))
    return values[:far] + values[far + 1:]


def trimmed_range(values):
    """The range without the run farthest from the median, where that
    narrows it."""
    rest = without_farthest(values)
    return min(value_range(values),
               (max(rest) - min(rest)) / statistics.median(values))


def iqr(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed_iqr(values):
    """The interquartile range without the run farthest from the median,
    over the median of all runs."""
    q = statistics.quantiles(without_farthest(values), n=4)
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
        rows, trims, trim_iqrs, every = [], [], [], []
        for k, s in enumerate(sets):
            v = [r["metrics"][name]["value"] for r in s if name in
                 r["metrics"]]
            if len(v) < 3:
                continue
            trims.append(trimmed_range(v))
            trim_iqrs.append(trimmed_iqr(v))
            every += v
            rows.append(f"set{k + 1} n={len(v)} median={statistics.median(v)!r}"
                        f" min={min(v)!r} max={max(v)!r}"
                        f" iqr={100 * iqr(v):.3f}%"
                        f" trimmed_iqr={100 * trim_iqrs[-1]:.3f}%"
                        f" range={100 * value_range(v):.3f}%"
                        f" trimmed_range={100 * trims[-1]:.3f}%")
        if rows:
            print(f"{name}: " + "; ".join(rows) +
                  f"; bound at least {200 * statistics.mean(trim_iqrs):.3f}%"
                  f" (iqr) / {200 * statistics.mean(trims):.3f}% (range)"
                  f", at most {800 * iqr(every):.3f}% (iqr)"
                  f" / {800 * value_range(every):.3f}% (range) of all runs")
    print("correct:", [r["correct"] for s in sets for r in s])


if __name__ == "__main__":
    main(sys.argv[1:])
