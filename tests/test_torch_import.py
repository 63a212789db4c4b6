"""The port's import boundary and its refusal to leave its device.

The port never imports ``jax`` or the JAX package (whose ``__init__``
imports jax unless ``JAX_PLATFORMS`` names the CPU), and an aligner
asked for a CUDA card never computes on the CPU instead.
"""

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
from cse305_parallel_sequence_alignment_torch.parallel import partition
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
                                 "models/banded.py", "utils/matrices.py"])
def test_banded_and_matrix_sources_are_the_ports_own(rel):
    """The banded and matrix modules lie under the port and name neither
    jax nor the JAX package."""
    from cse305_parallel_sequence_alignment_torch.ops import _build
    path = ROOT / "cse305_parallel_sequence_alignment_torch" / rel
    assert path.is_file()
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "cse305_parallel_sequence_alignment_tpu." not in text.replace(
        "cse305_parallel_sequence_alignment_tpu/", "")
    if rel.startswith("csrc/"):
        assert path in _build.sources()


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


def _longscore_devices():
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    main(["longscore", "--a", "ACGT", "--b", "ACG", "--devices", "2",
          "--device", "cpu"])


def _perf_longseq():
    from cse305_parallel_sequence_alignment_torch.__main__ import main
    main(["perf", "--lengths", "128", "--batches", "2", "--device", "cpu"])


def _sharded_fill():
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
    )
    PartitionedAligner(fill_backend="sharded", device="cpu")


@pytest.mark.parametrize("make,item", [(_longscore_devices, "item 13"),
                                       (_sharded_fill, "item 13"),
                                       (_perf_longseq, "item 13")],
                         ids=["longscore-devices", "sharded",
                              "perf-longseq"])
def test_unported_options_name_their_roadmap_item(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make()
