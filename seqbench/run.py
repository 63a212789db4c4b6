"""Run one cell of the benchmark once and print its result line.

    python3 seqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
then ``window`` and last ``compared``, each number the check compared
beside its limit); the last lines of standard error repeat the compared
numbers. The run fails, printing no result, without the card(s) the
cell asks for, or if JAX or the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

T_START = time.perf_counter()
HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def seconds_since_process_start():
    """Seconds since this process started, by its start time in
    ``/proc/self/stat`` (the top of this script where that is not
    readable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache stays at a fixed place inside the checkout
    cache = ROOT / ".seqbench_cache"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch

    import harness
    import manifest

    cell = manifest.Cell(manifest.load(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this host "
              f"has {have}", file=sys.stderr)
        return 2
    t_start = time.perf_counter() - seconds_since_process_start()
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=t_start)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
