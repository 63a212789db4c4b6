"""Port multi-process helpers (``parallel/multihost.py``) == the JAX
package's, on ``torch.distributed`` with gloo.

Two worker processes join a localhost process group, see the group's
rank and size, take disjoint shards of a work list and all-reduce across
each other (the counterpart of tests/test_multihost2p.py); a worker
pointed at a coordinator nobody serves raises within its timeout. Every
subprocess runs under its own time limit.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from cse305_parallel_sequence_alignment_torch.parallel import multihost
from cse305_parallel_sequence_alignment_tpu.parallel import (
    multihost as jax_multihost,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV_NAMES = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")

WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from cse305_parallel_sequence_alignment_torch.parallel.multihost import (
    host_shard, init_distributed, process_info)
ok = init_distributed(initialization_timeout=60)
rank, world = process_info()
x = torch.tensor([float(rank + 1)])
dist.all_reduce(x)
print(json.dumps({"ok": ok, "rank": rank, "world": world,
                  "shard": list(host_shard(10)), "sum": float(x)}),
      flush=True)
dist.destroy_process_group()
"""

FAIL_FAST = r"""
import sys
sys.path.insert(0, sys.argv[1])
from cse305_parallel_sequence_alignment_torch.parallel.multihost import (
    init_distributed)
try:
    init_distributed(coordinator_address=sys.argv[2], num_processes=2,
                     process_id=1, initialization_timeout=3)
except RuntimeError as e:
    print("RAISED", str(e).splitlines()[0])
    sys.exit(0)
sys.exit(3)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in ENV_NAMES}
    env.update(extra)
    return env


@pytest.mark.parametrize("count,index,procs", [(10, 0, 2), (10, 1, 2),
                                               (7, 2, 3), (3, 4, 5),
                                               (0, 0, 1)])
def test_host_shard_matches_jax(count, index, procs):
    assert multihost.host_shard(count, index, procs) == \
        jax_multihost.host_shard(count, index, procs)


def test_single_process_is_a_no_op(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    assert multihost.init_distributed() is False
    assert multihost.init_distributed(num_processes=1) is False
    assert multihost.process_info() == (0, 1)
    assert list(multihost.host_shard(5)) == [0, 1, 2, 3, 4]


def test_two_process_group_shards_and_all_reduce():
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(ROOT)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(COORDINATOR_ADDRESS=coord, NUM_PROCESSES="2",
                 PROCESS_ID=str(k))) for k in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    by_rank = {o["rank"]: o for o in outs}
    assert sorted(by_rank) == [0, 1]
    assert all(o["ok"] and o["world"] == 2 for o in outs)
    # both ranks' contributions, 1 + 2, reached both
    assert by_rank[0]["sum"] == by_rank[1]["sum"] == 3.0
    s0, s1 = set(by_rank[0]["shard"]), set(by_rank[1]["shard"])
    assert s0.isdisjoint(s1) and s0 | s1 == set(range(10))
    assert by_rank[0]["shard"] == list(jax_multihost.host_shard(10, 0, 2))


def test_unreachable_coordinator_fails_fast():
    coord = f"127.0.0.1:{_free_port()}"  # nothing listens there
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", FAIL_FAST, str(ROOT), coord],
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("RAISED")
    assert coord in out.stdout
    assert time.monotonic() - t0 < 90
