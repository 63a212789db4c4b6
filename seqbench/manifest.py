"""``BENCHMARK.json`` and the files it names, all found by name:

- ``configs/<config>.json`` (the file the manifest gives),
- ``traffic/<mix>.json``, a traffic mix's parameters,
- ``generators/<kind>.py``, the generator of the mix's ``calls.kind``,
- ``entries/<entry>.py``, the program call the mix's ``entry`` names,
- ``reference/<mode>.py``, the plain reference of the config's ``mode``,
- ``metrics/<metric>.py``, a metric's reader.

A cell, a mix, a kind of traffic, an entry, a mode or a metric is added
by adding its file and its entry in ``BENCHMARK.json``; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
_MODULES = {}


def load():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def module(folder, name):
    """The module ``<folder>/<name>.py`` under this folder, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = HERE / folder / f"{name}.py"
        if not path.is_file():
            raise LookupError(f"no {folder}/{name}.py in seqbench/")
        spec = importlib.util.spec_from_file_location(
            "seqbench_" + "_".join(
                s.replace(".", "_").replace("-", "_") for s in key), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


class Cell:
    """One workload of the manifest with what it names."""

    def __init__(self, bench, name):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.workload = w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
        with open(ROOT / cfg["file"]) as f:
            self.config = json.load(f)
        with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
            self.traffic = json.load(f)
        self.entry = module("entries", self.traffic["entry"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]


def reader(metric):
    """The ``read(readings)`` function of ``metrics/<metric>.py``."""
    return module("metrics", metric).read
