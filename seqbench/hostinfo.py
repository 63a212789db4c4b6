"""What a run ran on: the host's CPUs and load, the card's clocks and
power. Printed on standard error before the result, so that a noisy run
can be read against its host. ``proc_cpu_s`` is this process's user
and system seconds so far: from the line before set-up makes the pass to
the line after the window, it grows by what the pass, the warm pass and
the window burnt on every thread."""

from __future__ import annotations

import os
import subprocess

SMI_FIELDS = ("name", "clocks.sm", "clocks.mem", "power.draw",
              "power.limit", "temperature.gpu")


def _read(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def cpu():
    quota = _read("/sys/fs/cgroup/cpu.max")
    if quota is None:
        q = _read("/sys/fs/cgroup/cpu/cpu.cfs_quota_us")
        p = _read("/sys/fs/cgroup/cpu/cpu.cfs_period_us")
        quota = None if q is None else f"{q} {p}"
    mhz = [float(line.split(":")[1]) for line in
           (_read("/proc/cpuinfo") or "").splitlines()
           if line.startswith("cpu MHz")]
    return {"cpu_count": os.cpu_count(),
            "cpu_mhz": round(sum(mhz) / len(mhz)) if mhz else None,
            "affinity": len(os.sched_getaffinity(0)),
            "cpu_max": quota,
            "loadavg": [round(x, 2) for x in os.getloadavg()],
            "proc_cpu_s": round(sum(os.times()[:2]), 3)}


def card():
    """nvidia-smi's reading of each card, or the reason there is none."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(SMI_FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return [{"error": type(exc).__name__}]
    return [dict(zip(SMI_FIELDS, (x.strip() for x in line.split(","))))
            for line in proc.stdout.splitlines() if line.strip()]
