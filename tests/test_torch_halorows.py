"""K8's H100 body (csrc/halostair.cu ``rows_kernel``): its geometry rule,
and the pipeline it serves against the JAX package.

On the CPU: ``halostair_geometry``'s invariants (whole warps, coverage,
the last strip holding the last column, the strip and thread limits) and
its choices at the pipeline's call shapes; K8's plain step through
``longseq_score`` at two row counts R and on one and four mesh entries,
equal to the JAX package's pipeline (its Pallas K8 in interpret mode).
On a card (marker ``cuda``): the kernel against ``halostair_step_plain``
at every geometry the rule can choose (C = 4, 8, 16, one strip and many),
every start type, the default parameters and g=0.3, h=1.7, a block with
a left neighbour and a capture inside the call.
Tolerance 0: the kernel runs the plain version's float32 operations in
its order, and max is exact.
"""

import numpy as np
import pytest
import torch
from test_torch_longseq import cpu_mesh, rand_pair
from test_torch_numerics import SETS
from test_torch_rowcb import ACGT

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import halostair
from cse305_parallel_sequence_alignment_torch.parallel import longseq
from cse305_parallel_sequence_alignment_tpu.parallel import (
    longseq as jax_longseq,
)

STARTS = (-1, -2, -3, 1, 2, 3)
# the pipeline's block widths: a middle entry of the 97 kb pair on four
# entries, the pair on one, a 12 kb block, one column
WIDTHS = (24503, 98010, 12001, 1, 5000)


@pytest.mark.parametrize("R", [256, 64])
@pytest.mark.parametrize("nc", WIDTHS)
def test_geometry_invariants(nc, R):
    C, threads, S = halostair.halostair_geometry(nc, R)
    assert C in halostair.ROWS_C
    assert threads % 32 == 0
    assert 32 <= threads <= halostair.ROWS_THREADS[C]
    W = threads * C
    assert S * W >= nc  # the strips cover the block
    assert (S - 1) * W < nc  # and the last one holds column nc - 1
    assert 1 <= S <= halostair.SMS  # every strip has an SM
    # the fewest whole warps for that strip count
    assert S * (threads - 32) * C < nc
    assert (C, threads) in halostair.halostair_geometries(nc)
    cost = halostair.geometry_cost(nc, R, C, threads)
    assert all(cost <= halostair.geometry_cost(nc, R, *g)
               for g in halostair.halostair_geometries(nc))


def test_geometry_choices():
    # a middle call of the 97 kb pipeline on four entries, and on one
    assert halostair.halostair_geometry(24503, 256) == (4, 256, 24)
    assert halostair.halostair_geometry(98010, 256) == (4, 448, 55)
    assert halostair.halostair_geometry(1, 256) == (4, 32, 1)
    # fewer strips than K8's first design, a shared-memory staircase,
    # took there (~96 and 383)
    assert halostair.halostair_geometry(24503, 256)[2] < 96
    assert halostair.halostair_geometry(98010, 256)[2] < 383
    with pytest.raises(ValueError):
        halostair.halostair_geometry(0, 256)


@pytest.mark.parametrize("R", [16, 40])
@pytest.mark.parametrize("D", [1, 4])
def test_pipeline_finals_match_jax(R, D):
    """K8's plain step through ``longseq_score`` at R rows a call on D
    entries: the JAX package's finals (its K8 at R = 32 on eight)."""
    a, b = rand_pair(np.random.default_rng(101), 90, 700)
    want = np.asarray(jax_longseq.longseq_score(a, b, row_chunk=32,
                                                backend="kernel"))
    longseq.ROUTES.update(kernel=0, xla=0)
    got = longseq.longseq_score(a, b, row_chunk=R, backend="kernel",
                                mesh=cpu_mesh(D))
    np.testing.assert_array_equal(got, want)
    assert longseq.ROUTES["kernel"] == 1 and longseq.ROUTES["xla"] == 0


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


NC, RR = 3000, 48
# every C, one strip and many; the 16-warp strips have edge lanes in 15
# warps, the narrow ones a link a strip
GEOMETRIES = [(4, 512, 2), (8, 512, 1), (16, 192, 1), (4, 32, 24),
              (8, 64, 6), (16, 96, 2), (16, 32, 6)]


def step_pair(rng):
    a = torch.from_numpy(ACGT[rng.integers(0, 4, RR)])
    b = torch.from_numpy(ACGT[rng.integers(0, 4, 2 * NC)])
    return a, b


def run_step(launch, a, b, k, la, st, p, dev, halo):
    state, fin, _ = halostair.halostair_init(k * NC, NC, st, p, dev)
    blk = b[k * NC: (k + 1) * NC].contiguous().to(dev)
    hout = launch(a.to(dev), blk, halo.to(dev), state, fin, k * NC, 0, la,
                  st, p)
    return [x.cpu() for x in (hout, state, fin)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("params", [ScoringParams(), SETS["g0.3-h1.7"]])
def test_rows_kernel_matches_plain_on_card(geometry, params):
    dev = card()
    rng = np.random.default_rng(7)
    a, b = step_pair(rng)
    assert geometry[2] == halostair.strips_of(NC, *geometry[:2])
    for st in STARTS:
        # block 0 (column 0, a -inf halo) to the call's last row; block
        # 1 with a record a row from the left and row la inside the call
        for k, la in ((0, RR), (1, 29)):
            halo = (torch.from_numpy(rng.normal(0, 20, (RR + 1, 4)).astype(
                np.float32)) if k else torch.full((RR + 1, 4), NEG_INF))
            want = run_step(halostair.halostair_step_plain, a, b, k, la, st,
                            params, "cpu", halo)
            got = run_step(
                lambda *x: halostair._launch(*x, geometry=geometry), a, b,
                k, la, st, params, dev, halo)
            for x, y in zip(got, want):
                assert torch.equal(x, y), (geometry, st, k)


@pytest.mark.cuda
def test_rule_matches_plain_on_card():
    """``halostair_step`` at the rule's choice (one launch counted), at
    g=0.3, h=1.7 on a block with a left record."""
    dev = card()
    rng = np.random.default_rng(11)
    a, b = step_pair(rng)
    p = SETS["g0.3-h1.7"]
    halo = torch.from_numpy(rng.normal(0, 20, (RR + 1, 4)).astype(
        np.float32))
    want = run_step(halostair.halostair_step_plain, a, b, 1, 40, -1, p,
                    "cpu", halo)
    before = halostair.halostair_step.launches
    got = run_step(halostair.halostair_step, a, b, 1, 40, -1, p, dev, halo)
    assert halostair.halostair_step.launches == before + 1
    for x, z in zip(got, want):
        assert torch.equal(x, z)
