"""One run of one cell: set-up, the timed window, the traced segments, the
check, and the result line.

Set-up makes the pass from the seed (``generate.py``), builds the entry
the traffic file names (``entries/<entry>.py``), runs one whole pass, which
builds and loads every kernel the pass uses, and calls ``gc.collect()``.
The window then runs whole passes, one caller in a closed loop, until
``seconds`` have elapsed, and finishes the pass it is in. Outputs are
dropped call by call, except those of the window's first pass, which the
check compares with the plain reference once the window has closed, the
memory peak has been read and the program's state is freed.

With ``trace`` the run goes on after the window: whole passes profiled
with the card's activity (busy and idle time, kernel times), then calls
of one pass profiled with the host's Python stack (what the host did
while the card was idle). Per-layer metrics read those and the window's
program spans.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import check
import generate
import hostinfo
import manifest
import devtrace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "cse305_parallel_sequence_alignment_tpu")
TRACE_SECONDS = 3.0  # at least this much of whole passes in the device trace
STACK_SECONDS = 1.0  # calls of one pass under the Python stack tracer


@dataclasses.dataclass
class Readings:
    """What the metric readers read (``metrics/<name>.py``)."""

    passage: generate.Pass
    swap: bool
    setup_s: float
    elapsed_s: float  # the window, host clock
    passes: int
    pairs: int  # answers asked for in the window
    spans: dict  # program phase totals over the window
    device: tracing.DeviceWindow | None = None


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run(cell_name, seed, seconds, trace, device="cuda", t_start=None,
        scale=1.0, max_items=None, log=None):
    """The result dict of one run and its compared numbers.

    ``scale``/``max_items`` shrink the pass (CPU tests only)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    cell = manifest.Cell(manifest.load(), cell_name)
    config, traffic = cell.config, cell.traffic
    check.Scoring(config)  # refuses a configuration the reference lacks
    on_card = device != "cpu"
    log(f"host before {hostinfo.cpu()} card {hostinfo.card() if on_card else 'none'}")

    marks = {"to_run": time.perf_counter() - t_start}
    if on_card:
        torch.empty(1, device=device)  # the CUDA context
    marks["cuda_context"] = time.perf_counter() - t_start
    passage = generate.make_pass(traffic, config, seed, scale, max_items)
    marks["pass_made"] = time.perf_counter() - t_start
    entry = cell.entry.Entry(config, device)

    def one_pass():
        for call in passage.calls:
            entry(call)

    one_pass()  # warm: builds and loads every kernel of the pass
    if on_card:
        torch.cuda.synchronize()
    marks["warm_pass"] = time.perf_counter() - t_start
    gc.collect()
    setup_s = time.perf_counter() - t_start

    entry.spans.clear()
    kept, missing, passes, pass_s = None, 0, 0, []
    t0 = time.perf_counter()
    while True:
        p0 = time.perf_counter()
        outs = [] if passes == 0 else None
        for call in passage.calls:
            out = entry(call)
            missing += len(call) - entry.answered(out)
            if outs is not None:
                outs.append(out)
            del out
        if outs is not None:
            kept = outs
        passes += 1
        pass_s.append(time.perf_counter() - p0)
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0

    readings = Readings(passage=passage,
                        swap=bool(config["parity_swap"]), setup_s=setup_s,
                        elapsed_s=elapsed, passes=passes,
                        pairs=passes * passage.pairs,
                        spans=dict(entry.spans))
    breakdown = None
    if trace:
        if not on_card:
            raise RuntimeError("a traced run reads the card's trace")
        per_pass = elapsed / passes
        n_traced = max(1, math.ceil(TRACE_SECONDS / per_pass))
        readings.device = tracing.device_window(
            lambda n: [one_pass() for _ in range(n)], n_traced)

        def some_calls():
            c0 = time.perf_counter()
            for call in passage.calls:
                entry(call)
                if time.perf_counter() - c0 >= STACK_SECONDS:
                    break

        breakdown = {"device_ops": readings.device.top(10),
                     "idle_gaps": tracing.idle_gaps(some_calls, 10)}

    metrics = {}
    for m in cell.end_to_end if not trace else cell.per_layer:
        value = manifest.reader(m["name"])(readings)
        if value is None:
            if not trace:
                raise RuntimeError(f"no reading of {m['name']} in {cell_name}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if readings.device is not None:
        dev["busy_s"] = readings.device.busy_s
        dev["window_s"] = readings.device.window_s
    log(f"host after {hostinfo.cpu()} card {hostinfo.card() if on_card else 'none'}")

    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    limits = cell.entry.LIMITS
    numbers, checked = check.judge(cell.entry.Entry, limits, config,
                                   passage, kept, device)
    check_s = time.perf_counter() - t_check
    correct = missing == 0 and all(v <= limits[k]
                                   for k, v in numbers.items())
    result = {"correct": bool(correct), "attempted": readings.pairs,
              "failed": int(missing), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = {"seconds": elapsed, "passes": passes,
                        "calls": passes * len(passage.calls), "checked": checked,
                        "check_s": check_s, "setup_marks_s": marks,
                        "pass_s": pass_s, "spans": readings.spans}
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in numbers.items()}
    return result

