"""The traffic generator: a traffic file's parameters -> a pass.

A pass is the fixed unit of work a cell repeats: a list of calls, each a
list of (a, b) sequence pairs (ASCII strings). The lengths, which
sequences are paired and how many pairs a call holds are a fixed multiset
taken from the traffic file and the configuration. The seed picks only
the residues and the order of the calls and of the pairs inside a call.
So every seed gives the same lengths and the same cells to count, and,
for a batch of pairs (``align_batch``), the same length buckets and the
same chunks. It does not give the partition (``PartitionedAligner``) the
same work: where a pair's first solve ends in T3 it is solved a second
time, and its segments' widths, and with them their buckets, chunks and
kernels, follow where the optimal path crosses the special rows. Both
follow the residues.

The traffic file's ``calls.kind`` names the kind of traffic, built by
``generators/<kind>.py``'s ``calls(spec, residues, rng, scale,
max_items)``. A value of the form ``{"config": "<key>"}`` anywhere in the
traffic file is read from the configuration. ``scale`` and ``max_items``
shrink a pass for the CPU tests only: lengths times ``scale`` (4 at
least) and every count capped at ``max_items``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import manifest


@dataclasses.dataclass
class Pass:
    calls: list  # [[(a, b), ...], ...]

    @property
    def pairs(self):
        return sum(len(c) for c in self.calls)

    def oriented_lengths(self, swap=True):
        """(la, lb) int64 arrays of every pair, the shorter first when
        ``swap`` (the configuration's parity swap)."""
        la = np.array([len(a) for c in self.calls for a, _ in c], np.int64)
        lb = np.array([len(b) for c in self.calls for _, b in c], np.int64)
        if swap:
            la, lb = np.minimum(la, lb), np.maximum(la, lb)
        return la, lb

    def cells(self, swap=True):
        la, lb = self.oriented_lengths(swap)
        return int((la * lb).sum())


def rng_of(seed):
    """The traffic's numpy generator for ``seed``, any integer."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), 1]))


def resolve(value, config):
    """``{"config": key}`` -> config[key], recursively through dicts and
    lists."""
    if isinstance(value, dict):
        if set(value) == {"config"}:
            return resolve(config[value["config"]], config)
        return {k: resolve(v, config) for k, v in value.items()}
    if isinstance(value, list):
        return [resolve(v, config) for v in value]
    return value


class Residues:
    """Random residues at the configuration's composition."""

    def __init__(self, config):
        self.letters = np.frombuffer(config["alphabet"].encode("ascii"),
                                     np.uint8)
        p = np.asarray(config["residue_frequencies"], np.float64)
        self.p = p / p.sum()

    def draw(self, rng, n):
        return self.letters[rng.choice(len(self.letters), size=n, p=self.p)]


def scaled(lengths, scale):
    return [max(4, round(x * scale)) for x in lengths]


def capped(count, max_items):
    return count if max_items is None else min(count, max_items)


def make_pass(traffic, config, seed, scale=1.0, max_items=None):
    """The pass of ``traffic`` (a parsed traffic file) under ``config``
    for ``seed``."""
    spec = resolve(traffic["calls"], config)
    kind = manifest.module("generators", spec["kind"])
    return Pass(calls=kind.calls(spec, Residues(config), rng_of(seed),
                                 scale, max_items))
