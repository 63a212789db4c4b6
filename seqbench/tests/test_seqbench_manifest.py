"""BENCHMARK.json keeps to the benchmark's contract: names, units and
lines of the allowed characters, every name found as a file, every cell
reporting set-up, another end-to-end metric and a per-layer metric."""

import json
import re

import pytest

import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (manifest.ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - KEYS[section]
        assert extra <= ({"workloads"} if section in ("end_to_end",
                                                      "per_layer") else set())
        assert KEYS[section] <= set(e)
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert line(e[key])


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        config = json.loads((manifest.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in config
            assert not re.search(r"(_dim|_rank|width|size)$", key)


def test_workloads():
    ws = BENCH["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)
    for w in ws:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (manifest.HERE / "traffic" / f"{w['traffic']}.json").is_file()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(name):
    """The traffic's kind and entry and the configuration's mode name
    files of their own; the entry names the numbers the check compares."""
    cell = manifest.Cell(BENCH, name)
    for folder, key in (("generators", cell.traffic["calls"]["kind"]),
                        ("entries", cell.traffic["entry"]),
                        ("reference", cell.config["mode"])):
        assert (manifest.HERE / folder / f"{key}.py").is_file()
    assert cell.entry.LIMITS and "missing" in cell.entry.LIMITS
    assert all(v >= 0 for v in cell.entry.LIMITS.values())


def test_an_unknown_file_is_a_lookup_error():
    with pytest.raises(LookupError):
        manifest.module("entries", "no-such-entry")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_enough(name):
    cell = manifest.Cell(BENCH, name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_files_are_named_from_names():
    for path in manifest.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert PATH.match(rel), rel
