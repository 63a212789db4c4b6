"""The port's ``perf`` report on the CPU: the JAX report's row modes and
fields, one JSON line a row, no error rows, and ``gcups`` as the JAX
package computes it."""

import io
import json
import pathlib
import subprocess
import sys

import pytest

from cse305_parallel_sequence_alignment_torch.harness import perfreport
from cse305_parallel_sequence_alignment_torch.utils.observability import (
    gcups,
)
from cse305_parallel_sequence_alignment_tpu.utils.observability import (
    gcups as jax_gcups,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = {"global_score", "global_score_rowscan_kernel", "local_score",
         "global_dirs", "semiglobal_dirs", "overlap_dirs",
         "banded_score_W129", "banded_score_W513", "banded_dirs_W129",
         "banded_dirs_W513", "longrow_score", "global_align_e2e"}


@pytest.fixture(scope="module")
def perf_lines():
    out = subprocess.run(
        [sys.executable, "-m", "cse305_parallel_sequence_alignment_torch",
         "perf", "--lengths", "128", "--batches", "2", "--no-longseq",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def test_perf_rows_parse_and_cover_every_mode(perf_lines):
    rows = [json.loads(line) for line in perf_lines]
    assert {r["mode"] for r in rows} == MODES
    assert len(rows) == len(MODES)
    for r in rows:
        assert "error" not in r
        assert r["backend"] == "cpu" and r["seconds"] > 0
        assert ("gcups_band_cells" if r["mode"].startswith("banded")
                else "gcups") in r


def test_perf_rows_shapes_and_dirs_kinds(perf_lines):
    rows = {r["mode"]: r for r in map(json.loads, perf_lines)}
    assert (rows["global_score"]["len"], rows["global_score"]["batch"]) == \
        (128, 2)
    assert (rows["longrow_score"]["len"], rows["longrow_score"]["batch"]) \
        == (1024, 8)
    assert rows["global_dirs"]["dirs"] == "u8"
    for mode in ("semiglobal_dirs", "overlap_dirs", "banded_dirs_W129",
                 "banded_dirs_W513"):
        assert rows[mode]["dirs"] == "u16+runs"
    assert rows["global_align_e2e"]["pairs_per_s"] > 0


def test_run_report_returns_what_it_prints():
    buf = io.StringIO()
    rows = perfreport.run_report(lengths=(64,), batches=(1,), iters=1,
                                 include_longseq=False, stream=buf,
                                 device="cpu")
    assert [json.loads(line) for line in buf.getvalue().splitlines()] == \
        rows


@pytest.mark.parametrize("cells,seconds", [(10 ** 9, 2.0), (5, 0.0),
                                           (123456, 0.25)])
def test_gcups_matches_jax(cells, seconds):
    assert gcups(cells, seconds) == jax_gcups(cells, seconds)
