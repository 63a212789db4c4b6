"""Device meshes: a named grid of devices (the JAX package's
``parallel/mesh.py``).

Axis conventions, as in the JAX package:
- ``data``: many-pairs batch parallelism (``parallel/batch_shard.py``);
- ``seq``: long-sequence column sharding (``parallel/longseq.py``).

A ``Mesh`` is a tuple of ``torch.device``s in row-major order with its
axis names and shape. One process drives every device of a mesh (the
JAX package's single-controller model): there is no process group here;
``parallel/multihost.py`` joins processes.

The default is every CUDA device. Without a CUDA device a mesh is built
only when the caller asks for the CPU (``device="cpu"``); it never falls
back to the CPU by itself. A mesh may repeat a device: ``make_seq_mesh(8,
device="cpu")`` is eight entries of the one CPU (the tests' counterpart
of the JAX tests' eight virtual XLA devices), and ``Mesh([torch.device(
"cuda:0")] * 4, ("seq",))`` drives the device-to-device halo path of the
long-pair pipeline on a single card. The helpers repeat only the CPU: on
CUDA they refuse more entries than there are cards.
"""

from __future__ import annotations

import math

import torch


class Mesh:
    """``devices`` (row-major) over axes ``axis_names`` of sizes
    ``shape`` (default: one axis over all devices). ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names=("seq",), shape=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"shape {sizes} does not match axes "
                             f"{self.axis_names}")
        if math.prod(sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of shape {sizes}")
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self):
        return len(self.devices)

    def rows(self):
        """The devices along the last axis, one tuple for each index of
        the others: the ``seq`` entries of each ``data`` index of a 2-D
        mesh, or the one row of a 1-D mesh."""
        step = self.shape[self.axis_names[-1]]
        return [self.devices[k: k + step] for k in range(0, self.size, step)]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def _devices(count, device):
    """``count`` devices of type ``device`` (None: every CUDA card, or one
    CPU entry)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (count or 1)
    if kind != "cuda":
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("a CUDA mesh needs a CUDA card and none is "
                           "available; pass device='cpu' to build a mesh "
                           "of CPU entries")
    count = count or have
    if count > have:
        raise ValueError(f"a mesh of {count} CUDA devices, but this host "
                         f"has {have} card(s); build a Mesh by hand to "
                         f"repeat one")
    return [torch.device("cuda", k) for k in range(count)]


def make_data_mesh(num_devices=None, device="cuda"):
    """1-D mesh over the batch axis."""
    return Mesh(_devices(num_devices, device), ("data",))


def make_seq_mesh(num_devices=None, device="cuda"):
    """1-D mesh over the DP column axis (long-sequence mode)."""
    return Mesh(_devices(num_devices, device), ("seq",))


def make_2d_mesh(data=None, seq=None, device="cuda"):
    """2-D (data, seq) mesh: batches of long-sequence problems. With
    neither size given, every device goes on ``data``."""
    if data is None or seq is None:
        total = len(_devices(None, device))
        if data is None and seq is None:
            data, seq = total, 1
        elif data is None:
            data = max(1, total // seq)
        else:
            seq = max(1, total // data)
    return Mesh(_devices(data * seq, device), ("data", "seq"), (data, seq))
