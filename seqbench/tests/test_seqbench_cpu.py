"""A small pass of each cell through the whole run on the CPU (the
program's plain twins; the look for a card skipped), judged by the frozen
reference; the same run with the timed path broken underneath, which has
to come out not correct; and the control, the reference in bfloat16, which
has to fail the comparison.

What belongs to one cell or one entry is found by name, so a cell goes in
by files alone: ``cells/<workload>.py`` holds its ``SMALL`` and
``CONTROL`` sizes, ``faults/<entry>.py`` the faults planted in the timed
path of the entry its traffic names (``FAULTS``, and ``KINDS``, the
faults that alter an answer and those that leave answers out)."""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

import check
import generate
import harness
import manifest
from reference import alignment, gotoh

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
GLOBAL = manifest.module("reference", "global")
SEED = 2 ** 31 + 12345
TESTS = pathlib.Path(__file__).resolve().parent
FOLDERS = {"cells": TESTS / "cells", "faults": TESTS / "faults"}
NEEDED_KINDS = ("altered", "left_out")


def by_name(folder, name):
    """The module ``<folder>/<name>.py`` of these tests, loaded by path."""
    path = FOLDERS[folder] / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"add seqbench/tests/{folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"seqbench_tests_{folder}_" + name.replace("-", "_").replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_of(name, bench=BENCH):
    return manifest.Cell(bench, name).traffic["entry"]


def is_size(size):
    """A (scale, max_items) pair that shrinks a pass and leaves some of it."""
    try:
        scale, items = size
    except (TypeError, ValueError):
        return False
    return 0 < scale <= 1 and isinstance(items, int) and items > 0


def missing_files(bench):
    """What each cell of ``bench`` lacks of its test files, one line a
    file, each naming the cell or entry and the file to add."""
    out = []
    for w in bench["workloads"]:
        try:
            sizes = by_name("cells", w["name"])
        except LookupError as e:
            out.append(f"cell {w['name']}: {e}, with SMALL and CONTROL")
            continue
        lacks = [k for k in ("SMALL", "CONTROL")
                 if not is_size(getattr(sizes, k, None))]
        if lacks:
            out.append(f"cell {w['name']}: give seqbench/tests/cells/"
                       f"{w['name']}.py its {' and '.join(lacks)} as "
                       "(0 < scale <= 1, items > 0)")
    for entry in sorted({entry_of(w["name"], bench)
                         for w in bench["workloads"]}):
        try:
            faults = by_name("faults", entry)
        except LookupError as e:
            out.append(f"entry {entry}: {e}, with a fault that alters an "
                       "answer and one that leaves answers out")
            continue
        kinds = getattr(faults, "KINDS", {})
        lacks = [k for k in NEEDED_KINDS
                 if not kinds.get(k) or not set(kinds[k]) <= set(faults.FAULTS)]
        if lacks:
            out.append(f"entry {entry}: give seqbench/tests/faults/{entry}.py "
                       f"faults of each kind in KINDS: {', '.join(lacks)}")
    return out


def fault_cases():
    """(fault, cell) for every fault of the entry each cell's traffic
    names; a cell whose entry has no faults file is the guard's to name."""
    cases = []
    for name in CELLS:
        try:
            faults = by_name("faults", entry_of(name)).FAULTS
        except LookupError:
            continue
        cases += [(fault, name) for fault in faults]
    return cases


def small_run(name, seed=SEED):
    scale, items = by_name("cells", name).SMALL
    return harness.run(name, seed, 0.0, False, device="cpu", scale=scale,
                       max_items=items, log=lambda line: None)


def test_every_cell_and_entry_has_its_test_files():
    assert missing_files(manifest.load()) == []


@pytest.mark.parametrize("folder,text,finding", [
    ("cells", "SMALL = (0.005, 6)\n", "its CONTROL as"),
    ("cells", "SMALL = (0.0, 6)\nCONTROL = (0.1, 4)\n", "its SMALL as"),
    ("faults", None, "add seqbench/tests/faults/"),
    ("faults", "FAULTS = {'x': None}\nKINDS = {'altered': ('x',)}\n",
     "of each kind in KINDS: left_out"),
])
def test_guard_names_what_a_file_lacks(monkeypatch, tmp_path, folder, text,
                                       finding):
    """A cells or faults file that is missing, lacks a size or a kind of
    fault, or holds a size that is no size, is the guard's one finding."""
    name = CELLS[0] if folder == "cells" else entry_of(CELLS[0])
    for path in FOLDERS[folder].glob("*.py"):
        if path.stem != name:
            shutil.copy(path, tmp_path / path.name)
    if text is not None:
        (tmp_path / f"{name}.py").write_text(text)
    monkeypatch.setitem(FOLDERS, folder, tmp_path)
    found = missing_files(manifest.load())
    assert len(found) == 1 and name in found[0] and finding in found[0], found


@pytest.mark.parametrize("name", CELLS)
def test_small_pass_is_correct(name):
    r = small_run(name)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["window"]["checked"] > 0
    cell = manifest.Cell(BENCH, name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(r["compared"]) == set(cell.entry.LIMITS)
    assert list(r)[-1] == "compared"
    assert harness.forbidden_modules() == []


@pytest.mark.parametrize("fault,name", fault_cases())
def test_broken_timed_path_is_not_correct(monkeypatch, fault, name):
    by_name("faults", entry_of(name)).FAULTS[fault](monkeypatch)
    r = small_run(name)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["compared"].values()) \
        or r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_comparison(name):
    cell = manifest.Cell(BENCH, name)
    scale, items = by_name("cells", name).CONTROL
    p = generate.make_pass(cell.traffic, cell.config, 21, scale, items)
    n = check.judge_control(cell.entry.LIMITS, cell.config, p, "cpu",
                            "bfloat16")
    assert n["scores_wrong"] > cell.entry.LIMITS["scores_wrong"]


def test_a_cell_goes_in_by_files_alone(monkeypatch, tmp_path):
    """A copy of the first cell under a new name, in a manifest that adds
    only its workload entry and its name to the ``workloads`` of the
    end-to-end metrics that list the first cell, runs its small pass
    correct and reports its end-to-end metrics, ``gcups`` and ``setup_s``
    among them, once its cells file is there; without that file the
    guard's one finding is the file to add."""
    old = CELLS[0]
    new = f"{old}-files-alone"
    bench = dict(BENCH, workloads=BENCH["workloads"] + [
        dict(next(w for w in BENCH["workloads"] if w["name"] == old),
             name=new)], end_to_end=[
        dict(m, workloads=m["workloads"] + [new])
        if old in m.get("workloads", []) else m
        for m in BENCH["end_to_end"]])
    monkeypatch.setattr(manifest, "load", lambda: bench)
    for path in FOLDERS["cells"].glob("*.py"):
        shutil.copy(path, tmp_path / path.name)
    shutil.copy(FOLDERS["cells"] / f"{old}.py", tmp_path / f"{new}.py")
    monkeypatch.setitem(FOLDERS, "cells", tmp_path)

    assert missing_files(manifest.load()) == []
    r = small_run(new)
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["window"]["checked"] > 0
    assert set(r["metrics"]) == {m["name"] for m in
                                 manifest.Cell(bench, new).end_to_end}
    assert {"gcups", "setup_s"} <= set(r["metrics"])

    (tmp_path / f"{new}.py").unlink()
    assert missing_files(manifest.load()) == [
        f"cell {new}: add seqbench/tests/cells/{new}.py, with SMALL and "
        "CONTROL"]


@pytest.mark.parametrize("change", [{"mode": "local"}, {"start_type": 1},
                                    {"end_type": 2}])
def test_reference_refuses_what_it_does_not_compute(change):
    config = dict(manifest.Cell(BENCH, CELLS[0]).config, **change)
    with pytest.raises(ValueError):
        check.Scoring(config)


def _naive_finals(a, b, table, g, h):
    """The recurrence cell by cell (the module docstring of gotoh.py)."""
    m, n = len(a), len(b)
    neg = -np.inf
    T = np.full((3, m + 1, n + 1), neg)
    T[0, 0, 0] = 0.0
    T[1, 0, 1:] = -h - g * np.arange(1, n + 1)
    T[2, 1:, 0] = -h - g * np.arange(1, m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            T[0, i, j] = table[a[i - 1], b[j - 1]] + T[:, i - 1, j - 1].max()
            T[2, i, j] = max(T[0, i - 1, j] - g - h, T[1, i - 1, j] - g - h,
                             T[2, i - 1, j] - g)
            T[1, i, j] = max(T[0, i, j - 1] - g - h, T[1, i, j - 1] - g,
                             T[2, i, j - 1] - g - h)
    return T[:, m, n]


def test_reference_sweep_is_the_recurrence():
    rng = np.random.default_rng(4)
    table = rng.integers(-4, 6, (5, 5)).astype(float)
    pairs = [(rng.integers(0, 5, int(rng.integers(1, 30))),
              rng.integers(0, 5, int(rng.integers(1, 40)))) for _ in range(12)]
    got = gotoh.finals(pairs, table, 1.0, 3.0, device="cpu", max_elems=64)
    want = np.array([_naive_finals(a, b, table, 1.0, 3.0) for a, b in pairs])
    assert np.array_equal(got, want)


def test_path_score_reads_the_chain():
    table = np.eye(4)
    a, b = np.array([0, 1, 2]), np.array([0, 2])
    # A0-B0, A1-gap, A2-B1: 2 matches, one gap of 1 (open 2, extend 1)
    chain = np.array([[1, 1, 1], [2, 0, 3], [3, 2, 1]])
    assert GLOBAL.path_score(a, b, chain, table, 1.0, 2.0) == -1.0
    bad = chain.copy()
    bad[1, 1] = 1  # the gapped side stored as an index
    assert GLOBAL.path_score(a, b, bad, table, 1.0, 2.0) is None
    assert alignment.render(b"ACG", b"AG", chain) == (b"ACG", b"A-G")
    # the leading run along column 0 implied: gap A0, then A1-B0, A2-B1
    implied = np.array([[2, 1, 1], [3, 2, 1]])
    assert GLOBAL.path_score(a, b, implied, table, 1.0, 2.0) == -2.0
    # a first point after an inner cell is no path from (0, 0)
    assert GLOBAL.path_score(a, b, chain[2:], table, 1.0, 2.0) is None


@pytest.mark.cuda
def test_reference_graph_sweep_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reference replays CUDA graphs "
                    "there")
    rng = np.random.default_rng(6)
    table = rng.integers(-4, 6, (20, 20)).astype(float)
    pairs = [(rng.integers(0, 20, int(rng.integers(1, 300))),
              rng.integers(0, 20, int(rng.integers(1, 3000))))
             for _ in range(40)]
    for dtype in (torch.float32, torch.bfloat16):
        cpu = gotoh.finals(pairs, table, 1.0, 11.0, dtype, "cpu", 1 << 18)
        card = gotoh.finals(pairs, table, 1.0, 11.0, dtype, "cuda", 1 << 18)
        assert np.array_equal(cpu, card)


def test_roofline_arithmetic_matches_the_kernel_table():
    """PERF.md's table: K1 at 256 x 2 kb is bound by bytes at 0.642 ms;
    a 17-operation score fill at the same size by operations, 0.272 ms."""
    import roofline
    import devtrace as tracing

    k1 = manifest.module("metrics", "k1_roofline")
    la = lb = np.full(256, 2048, np.int64)
    t_k1, bound = roofline.least_seconds(29, 2, la, lb)
    assert bound == "bytes" and t_k1 * 1e3 == pytest.approx(0.642, abs=5e-4)
    t, bound = roofline.least_seconds(17, 0, la, lb)
    assert bound == "operations" and t * 1e3 == pytest.approx(0.272, abs=5e-4)

    class R:
        passage = generate.Pass(calls=[[("A" * 2048, "C" * 2048)] * 256])
        swap = True
        device = tracing.DeviceWindow(
            busy_s=1.0, window_s=2.0, passes=2,
            kernels={"fill_kernel<16, false, true>": 4 * t_k1,
                     "fill_kernel<4, true, false>": 1.0,
                     "rle_walk_kernel": 1.0})

    assert k1.read(R) == pytest.approx(50.0)
    R.device.kernels.pop("fill_kernel<16, false, true>")
    assert k1.read(R) is None
    assert tracing.short_name("void (anonymous namespace)::fill_kernel<4, "
                              "true, false>(unsigned char const*)") == \
        "fill_kernel<4, true, false>"
