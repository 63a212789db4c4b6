"""Multi-process helpers (the port of the JAX package's
``parallel/multihost.py``, on ``torch.distributed``).

- ``init_distributed``: joins this process to a process group, or does
  nothing for a single process. It reads the JAX package's environment
  names (``COORDINATOR_ADDRESS`` as host:port, ``NUM_PROCESSES``,
  ``PROCESS_ID``) when not given them, uses gloo on the CPU and NCCL on
  CUDA, and fails fast: a coordinator that cannot be reached within the
  timeout raises ``RuntimeError`` naming it, instead of hanging workers.
- ``process_info``: (rank, world size), (0, 1) without a process group.
- ``host_shard``: the contiguous block of a work list that a process
  owns, which every process computes alike.

The meshes of ``parallel/mesh.py`` hold the devices one process drives;
a process group joins such processes.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None,
                     initialization_timeout=None):
    """Initialise the default process group, or no-op when
    single-process; returns whether a group was joined.

    ``coordinator_address`` is the host:port of rank 0's store;
    ``local_device_ids``, when given, names the card this process uses
    first; ``initialization_timeout`` is in seconds (default 300). The
    group runs NCCL when a card is present, else gloo."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process: nothing to do
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if local_device_ids and backend == "nccl":
        torch.cuda.set_device(int(local_device_ids[0]))
    timeout = datetime.timedelta(seconds=initialization_timeout or 300)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
    except Exception as e:  # noqa: BLE001 - re-raise with context
        raise RuntimeError(
            f"torch.distributed.init_process_group failed (coordinator="
            f"{coordinator_address}, num_processes={num_processes}, "
            f"process_id={process_id}, backend={backend}): {e}") from e
    return True


def process_info():
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(count, process_index=None, process_count=None):
    """Indices of the work items this process owns (contiguous blocks,
    the deterministic split every process can compute locally)."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    base = count // process_count
    extra = count % process_count
    start = process_index * base + min(process_index, extra)
    size = base + (1 if process_index < extra else 0)
    return range(start, start + size)
