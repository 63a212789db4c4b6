"""The port's probes (``cse305_parallel_sequence_alignment_torch.probes``)
on the CPU at their ``--small`` size: each prints JSON lines that parse,
names the device first, reports host-clock times (no rate) there, and
finds its kernels' results equal; asked for a card on a host without one,
each raises."""

import importlib
import json

import pytest
import torch

from cse305_parallel_sequence_alignment_torch.probes import MODULES

# the result flags each probe's lines carry
FLAGS = {"ab_rowscan2": "cells_equal", "trim_rowscan": "exact",
         "dual_stream": "cells_equal", "walk_ab": "mismatched_pairs",
         "perm_layout": "exact", "stripes": "exact", "knockout": "exact",
         "ablate": "exact", "lane0": "exact", "sweep": "exact",
         "attrib2": "exact", "micro": "exact"}
KINDS = {"ab_rowscan2": {"check", "round", "columns"},
         "trim_rowscan": {"round"},
         "dual_stream": {"dual", "halostair_d1"},
         "walk_ab": {"fill_dirs16", "walk", "fused_phases", "align_batch"},
         "perm_layout": {"round"}, "stripes": {"round"},
         "knockout": {"round"}, "ablate": {"round"}, "lane0": {"round"},
         "sweep": {"round"}, "attrib2": {"round"},
         "micro": {"micro", "micro2"}}


def probe(name):
    return importlib.import_module(
        f"cse305_parallel_sequence_alignment_torch.probes.{name}")


@pytest.mark.parametrize("name", MODULES)
def test_probe_prints_json_lines_on_cpu(name, capsys):
    probe(name).main(["--device", "cpu", "--small"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert rows[0]["kind"] == "device" and rows[0]["device"] == "cpu"
    assert {r["kind"] for r in rows[1:]} == KINDS[name]
    flag = FLAGS[name]
    flagged = [r[flag] for r in rows if flag in r]
    assert flagged
    assert all(v == 0 if flag == "mismatched_pairs" else v is True
               for v in flagged)
    for r in rows:
        assert "ms" not in r and "gcups" not in r, r


@pytest.mark.parametrize("name", MODULES)
def test_probe_refuses_a_missing_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        probe(name).main(["--small"])
