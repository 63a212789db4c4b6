"""The port's import boundary and its refusal to leave its device.

The port never imports ``jax`` or the JAX package (whose ``__init__``
imports jax unless ``JAX_PLATFORMS`` names the CPU), and an aligner
asked for a CUDA card never computes on the CPU instead.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import sys
import cse305_parallel_sequence_alignment_torch as port
import cse305_parallel_sequence_alignment_torch.__main__
from cse305_parallel_sequence_alignment_torch import api, models
from cse305_parallel_sequence_alignment_torch.models import (
    BandedAligner, BatchAligner, GotohAligner, LocalAlignmentResult,
    LocalBatchAligner, OverlapBatchAligner, OverlapResult,
    SemiGlobalBatchAligner, SemiGlobalResult)
from cse305_parallel_sequence_alignment_torch.models import local_oracle
from cse305_parallel_sequence_alignment_torch.harness import perfreport
from cse305_parallel_sequence_alignment_torch.utils import observability
from cse305_parallel_sequence_alignment_torch.ops import (
    _build, banded, cigar, device_walk, diag, local, longrow, longstair,
    rowcb, traceback)
from cse305_parallel_sequence_alignment_torch.parallel import (
    batch_shard, longseq, mesh, multihost, partition)
from cse305_parallel_sequence_alignment_torch.ops import (
    halostair, micro, rowprobe, rowscan2)
from cse305_parallel_sequence_alignment_torch.probes import (
    _common, ab_rowscan2, dual_stream, trim_rowscan, walk_ab)
from cse305_parallel_sequence_alignment_torch.probes import (
    ablate, knockout, lane0, perm_layout, stripes)
from cse305_parallel_sequence_alignment_torch.probes import (
    attrib2, sweep)
from cse305_parallel_sequence_alignment_torch.probes import micro as pmicro
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.utils import (
    config, fasta, matrices)
res = port.align("AGGA", "AGTGC", device="cpu")
assert (res.aligned_a, res.aligned_b) == ("AG-GA", "AGTGC")
bnd = port.align("AGGA", "AGTGC", mode="banded", device="cpu")
assert (bnd.aligned_a, bnd.aligned_b) == ("AG-GA", "AGTGC")
mat = BatchAligner(matrix=matrices.BLOSUM62, device="cpu").align_batch(
    [("HEAGAWGHEE", "PAWHEAE")])[0]
assert mat.score == 20.0, mat.score
loc = port.align("GGACGTAC", "TTACGTAT", mode="local", device="cpu")
assert (loc.score, loc.cigar) == (10.0, "5M")
sg = port.align("ACGT", "TTACGTT", mode="semiglobal", device="cpu")
assert (sg.score, sg.cigar, sg.target_span) == (4.0, "4M", (3, 6))
ov = port.align("GGACGT", "ACGTCC", mode="overlap", device="cpu")
assert (ov.score, ov.a_span, ov.b_span) == (4.0, (3, 6), (1, 4))
fin = longseq.longseq_score("AGGA", "AGTGC", mesh=mesh.make_seq_mesh(
    2, device="cpu"), backend="kernel")
assert fin.tolist() == [0.0, -1.0, -5.0], fin
sh = batch_shard.ShardedBatchAligner(num_devices=2, device="cpu")
assert sh.align_batch([("AGGA", "AGTGC")])[0].aligned_a == "AG-GA"
assert multihost.process_info() == (0, 1)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                 "cse305_parallel_sequence_alignment_tpu")))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_native_sources_are_the_ports_own():
    """Every source the port builds (CUDA kernels and the host library)
    lies under the port's own directory."""
    from cse305_parallel_sequence_alignment_torch.ops import _build
    pkg = ROOT / "cse305_parallel_sequence_alignment_torch"
    srcs = _build.sources()
    assert len(srcs) == len(_build.KERNELS) + 1
    for src in srcs:
        assert src.resolve().is_relative_to(pkg.resolve()), src
        assert src.is_file(), src


@pytest.mark.parametrize("rel", ["ops/banded.py", "csrc/banded.cu",
                                 "models/banded.py", "utils/matrices.py",
                                 "parallel/mesh.py", "parallel/longseq.py",
                                 "parallel/batch_shard.py",
                                 "parallel/multihost.py", "ops/halostair.py",
                                 "csrc/halostair.cu"])
def test_banded_and_matrix_sources_are_the_ports_own(rel):
    """The banded, matrix and multi-device modules lie under the port and
    name neither jax nor the JAX package."""
    from cse305_parallel_sequence_alignment_torch.ops import _build
    path = ROOT / "cse305_parallel_sequence_alignment_torch" / rel
    assert path.is_file()
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "cse305_parallel_sequence_alignment_tpu." not in text.replace(
        "cse305_parallel_sequence_alignment_tpu/", "")
    if rel.startswith("csrc/"):
        assert path in _build.sources()


@pytest.mark.parametrize("rel", ["ops/rowscan2.py", "csrc/rowscan2.cu",
                                 "ops/rowcb.py", "ops/device_walk.py",
                                 "csrc/rowcb.cu", "csrc/walk.cu",
                                 "probes/__init__.py", "probes/_common.py",
                                 "probes/ab_rowscan2.py",
                                 "probes/trim_rowscan.py",
                                 "probes/dual_stream.py",
                                 "probes/walk_ab.py", "ops/rowprobe.py",
                                 "csrc/rowprobe.cu",
                                 "probes/perm_layout.py",
                                 "probes/stripes.py",
                                 "probes/knockout.py", "probes/ablate.py",
                                 "probes/lane0.py", "ops/micro.py",
                                 "csrc/micro.cu", "probes/sweep.py",
                                 "probes/attrib2.py", "probes/micro.py",
                                 "csrc/rowfill.cu"])
def test_score_fill_probe_sources_are_the_ports_own(rel):
    """K3'', P-trim, P-dual, K2' and the row-step probes (and their probe
    modules) lie under the port and name neither jax nor the JAX package;
    their CUDA sources are built."""
    from cse305_parallel_sequence_alignment_torch.ops import _build
    path = ROOT / "cse305_parallel_sequence_alignment_torch" / rel
    assert path.is_file()
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "cse305_parallel_sequence_alignment_tpu." not in text.replace(
        "cse305_parallel_sequence_alignment_tpu/", "")
    if rel.startswith("csrc/"):
        assert path in _build.sources()


def test_top_level_names_cover_the_jax_package():
    """The JAX package's top-level ``__all__`` is a subset of the port's,
    and every name of the port's resolves (``SubstitutionMatrix`` among
    them)."""
    import cse305_parallel_sequence_alignment_torch as port
    import cse305_parallel_sequence_alignment_tpu as ref
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    from cse305_parallel_sequence_alignment_torch.core import (
        SubstitutionMatrix,
    )
    assert port.SubstitutionMatrix is SubstitutionMatrix


def test_cuda_aligner_refuses_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from cse305_parallel_sequence_alignment_torch import api
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    from cse305_parallel_sequence_alignment_torch.models.gotoh import (
        GotohAligner,
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAligner()
    with pytest.raises(RuntimeError, match="CUDA"):
        GotohAligner().align("AGGA", "AGTGC")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.score_pairs([("AGGA", "AGTGC")])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.align("AGGA", "AGTGC", mode="banded")
    for mode in ("local", "semiglobal", "overlap"):
        with pytest.raises(RuntimeError, match="CUDA"):
            api.align_pairs([("AGGA", "AGTGC")], mode=mode)
    with pytest.raises(ValueError):
        BatchAligner(device="meta")


def _longscore_devices(capsys):
    """``longscore --devices 2`` (the K8 pipeline, plain on the CPU) gives
    the score of ``--devices 1`` (K6) and of the JAX pipeline."""
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    from cse305_parallel_sequence_alignment_tpu.core import end_table_choice
    from cse305_parallel_sequence_alignment_tpu.parallel.longseq import (
        longseq_score,
    )
    a, b = "ACGTTGCAGGATCCA", "ACGTGCAGTTCCAAG"
    out = {}
    for d in ("2", "1"):
        main(["longscore", "--a", a, "--b", b, "--devices", d,
              "--device", "cpu", "--row-chunk", "4"])
        out[d] = json.loads(capsys.readouterr().out.strip())
    assert out["2"]["devices"] == 2
    fin = longseq_score(a, b, row_chunk=4)
    table, score = end_table_choice(*(float(x) for x in fin), -1, 2.0)
    assert out["2"]["score"] == out["1"]["score"] == score
    assert out["2"]["end_table"] == table


def _perf_longseq(capsys):
    """``perf`` with its longseq rows runs on the CPU; the pipeline
    accounting is the JAX report's."""
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    from cse305_parallel_sequence_alignment_tpu.parallel.longseq import (
        longseq_pipeline_stats,
    )
    main(["perf", "--lengths", "128", "--batches", "2", "--device", "cpu"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by_mode = {r["mode"]: r for r in rows}
    ls = by_mode["longseq_score"]
    assert ls["len"] == 512 and ls["devices"] == 1 and ls["gcups"] > 0
    want = longseq_pipeline_stats(512, 512, 1, row_chunk=256)
    assert {k[len("pipeline_"):]: v for k, v in ls.items()
            if k.startswith("pipeline_")} == \
        {k: v for k, v in want.items() if k != "devices"}
    assert by_mode["longseq_score_1dev"]["devices"] == 1
    assert "longseq_score_1dev_kernel" not in by_mode  # a card's rows


def _sharded_fill(capsys):
    """``fill_backend="sharded"`` gives the JAX package's alignment."""
    from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
        make_seq_mesh,
    )
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.parallel import (
        partition as jax_partition,
    )
    a, b = "ACGTTGCAGGATCCATTGACA" * 3, "ACGTGCAGTTCCAAGGTACA" * 3
    got = PartitionedAligner(p=3, fill_backend="sharded", device="cpu",
                             mesh=make_seq_mesh(3, device="cpu")).align(a, b)
    want = jax_partition.PartitionedAligner(
        p=3, fill_backend="sharded").align(a, b)
    assert (got.score, list(got.chain), got.aligned_a, got.aligned_b) == \
        (want.score, list(want.chain), want.aligned_a, want.aligned_b)


@pytest.mark.parametrize("check", [_longscore_devices, _sharded_fill,
                                   _perf_longseq],
                         ids=["longscore-devices", "sharded",
                              "perf-longseq"])
def test_unported_options_name_their_roadmap_item(check, capsys):
    """The options that raised ``NotImplementedError`` until the
    multi-device layer was ported now run, and equal their
    counterparts."""
    check(capsys)


def test_cli_refuses_more_cards_than_the_host_has():
    """The CLI never repeats a card: ``--devices`` past the host's cards
    raises, naming the count (a mesh built in code may repeat one)."""
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    if torch.cuda.is_available():
        want = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"has {want} card"):
            main(["longscore", "--a", "ACGT", "--b", "ACG", "--devices",
                  str(want + 1)])
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["longscore", "--a", "ACGT", "--b", "ACG", "--devices",
                  "2"])
