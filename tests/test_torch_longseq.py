"""Port column-sharded long-pair pipeline (``parallel/longseq.py``) == the
JAX package's, on a mesh of eight CPU entries against the JAX functions
on the conftest's eight virtual CPU devices.

The "kernel" backend runs K8's plain version on the CPU (the JAX package
its Pallas kernel in interpret mode); "xla" the plain row body. Shapes and
start types are those of tests/test_longseq.py and tests/test_halostair.py;
``PartitionedAligner(fill_backend="sharded")`` is held against the JAX
one and the port's level-batched search. Tolerance is 0.
"""

import numpy as np
import pytest
import torch
from test_torch_numerics import SETS, jax_nofma

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.parallel import longseq
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    Mesh,
    make_2d_mesh,
    make_seq_mesh,
)
from cse305_parallel_sequence_alignment_torch.parallel.partition import (
    PartitionedAligner,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.parallel import (
    longseq as jax_longseq,
)
from cse305_parallel_sequence_alignment_tpu.parallel import mesh as jax_mesh
from cse305_parallel_sequence_alignment_tpu.parallel import (
    partition as jax_partition,
)

STARTS = (-1, -2, -3, 1, 2, 3)
BACKENDS = ("kernel", "xla")


def rand_pair(rng, m, n):
    return (rng.integers(65, 69, size=(m,)).astype(np.uint8),
            rng.integers(65, 69, size=(n,)).astype(np.uint8))


def cpu_mesh(D=8):
    return make_seq_mesh(D, device="cpu")


def both(fn, a, b, p, backend, D=8, **kw):
    """(port, JAX) results of ``fn`` ("longseq_score" or
    "longseq_lastrow") on D mesh entries."""
    got = getattr(longseq, fn)(a, b, p, mesh=cpu_mesh(D), backend=backend,
                               **kw)
    want = getattr(jax_longseq, fn)(a, b, JaxParams(*p.astuple()),
                                    mesh=jax_mesh.make_seq_mesh(D),
                                    backend=backend, **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", [(30, 40, 8), (96, 128, 16), (57, 100, 9),
                                   (128, 96, 32), (7, 200, 4)])
def test_score_matches_jax(backend, shape):
    m, n, rc = shape
    a, b = rand_pair(np.random.default_rng(m * 1000 + n), m, n)
    got, want = both("longseq_score", a, b, ScoringParams(), backend,
                     row_chunk=rc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("params", [ScoringParams(g=2, h=1),
                                    ScoringParams(g=1, h=0),
                                    ScoringParams(g=3, h=5, match=2,
                                                  mismatch=-1)],
                         ids=["g2h1", "g1h0", "g3h5"])
def test_score_other_params(backend, params):
    a, b = rand_pair(np.random.default_rng(77), 64, 80)
    got, want = both("longseq_score", a, b, params, backend, row_chunk=16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("start_type", STARTS)
def test_lastrow_boundary_types(backend, start_type):
    a, b = rand_pair(np.random.default_rng(88), 40, 56)
    got, want = both("longseq_lastrow", a, b, ScoringParams(), backend,
                     start_type=start_type, row_chunk=8)
    assert got.shape == (3, 57)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fewer_devices(backend):
    a, b = rand_pair(np.random.default_rng(99), 48, 60)
    got, want = both("longseq_lastrow", a, b, ScoringParams(), backend, D=4,
                     row_chunk=12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("shape", [(30, 40), (0, 20), (17, 100), (64, 64),
                                   (20, 0)])
def test_lastrow_matches_jax(backend, shape):
    m, n = shape
    a, b = rand_pair(np.random.default_rng(m + 31 * n), m, n)
    got, want = both("longseq_lastrow", a, b, ScoringParams(), backend,
                     row_chunk=8)
    assert got.shape == (3, n + 1)
    np.testing.assert_array_equal(got, want)
    sgot, swant = both("longseq_score", a, b, ScoringParams(), backend,
                       row_chunk=8)
    np.testing.assert_array_equal(sgot, swant)


@pytest.mark.parametrize("start", [-1, -2, 3])
def test_kernel_route_halostair_shapes(start):
    """tests/test_halostair.py's shapes: JAX's R = 128 against the port's
    R = 128 and R = 50 (three steps a block)."""
    a, b = rand_pair(np.random.default_rng(41), 300, 700)
    want = jax_longseq.longseq_lastrow(a, b, start_type=start, row_chunk=128,
                                       backend="kernel")
    for rc in (128, 50):
        got = longseq.longseq_lastrow(a, b, start_type=start, row_chunk=rc,
                                      backend="kernel", mesh=cpu_mesh())
        np.testing.assert_array_equal(got, np.asarray(want))


def test_kernel_route_equals_xla_route_and_one_device():
    rng = np.random.default_rng(43)
    for (m, n) in [(65, 2100), (257, 1023), (513, 300)]:
        a, b = rand_pair(rng, m, n)
        k8 = longseq.longseq_score(a, b, row_chunk=128, backend="kernel",
                                   mesh=cpu_mesh())
        xla = longseq.longseq_score(a, b, row_chunk=64, backend="xla",
                                    mesh=cpu_mesh())
        one = longseq.longseq_score(a, b, row_chunk=128, backend="kernel",
                                    mesh=cpu_mesh(1))
        want = jax_longseq.longseq_score(a, b, row_chunk=128,
                                         backend="kernel")
        for got in (k8, xla, one):
            np.testing.assert_array_equal(got, want, err_msg=f"{m}x{n}")


def test_params_and_negative_h():
    """g=2, h=3 through the kernel; h < 0 takes the row body on the
    kernel backend, as in the JAX package, and the route counter says
    so."""
    a, b = rand_pair(np.random.default_rng(59), 150, 400)
    got, want = both("longseq_lastrow", a, b, ScoringParams(g=2, h=3),
                     "kernel", row_chunk=128)
    np.testing.assert_array_equal(got, want)
    longseq.ROUTES.update(kernel=0, xla=0)
    got, want = both("longseq_lastrow", a, b, ScoringParams(g=1, h=-1),
                     "kernel", row_chunk=64)
    np.testing.assert_array_equal(got, want)
    assert longseq.ROUTES == {"kernel": 0, "xla": 1}


@pytest.mark.parametrize("backend", BACKENDS)
def test_invariant_to_rows_and_devices(backend):
    """The same bits for every R and D; at g=0.3, h=1.7 for the kernel
    (its prefix max is exact), at the default parameters for the row body
    (whose ghost seed rounds T2 + g*j, as the JAX body does)."""
    p = SETS["g0.3-h1.7"] if backend == "kernel" else ScoringParams()
    a, b = rand_pair(np.random.default_rng(5), 90, 130)
    base = longseq.longseq_lastrow(a, b, p, mesh=cpu_mesh(1), row_chunk=90,
                                   backend=backend)
    for D in (2, 3, 8):
        for rc in (1, 7, 32):
            got = longseq.longseq_lastrow(a, b, p, mesh=cpu_mesh(D),
                                          row_chunk=rc, backend=backend)
            np.testing.assert_array_equal(got, base, err_msg=f"D {D} R {rc}")


def test_auto_takes_the_row_body_on_a_cpu_mesh():
    a, b = rand_pair(np.random.default_rng(6), 20, 30)
    longseq.ROUTES.update(kernel=0, xla=0)
    longseq.longseq_score(a, b, mesh=cpu_mesh(2))
    assert longseq.ROUTES == {"kernel": 0, "xla": 1}
    with pytest.raises(ValueError):
        longseq.longseq_score(a, b, mesh=cpu_mesh(2), backend="pallas")


def test_score_batch_2d_mesh():
    rng = np.random.default_rng(66)
    pairs = []
    for _ in range(6):
        m, n = int(rng.integers(15, 60)), int(rng.integers(15, 80))
        pairs.append(rand_pair(rng, m, n))
    mesh = make_2d_mesh(data=2, seq=4, device="cpu")
    assert mesh.shape == {"data": 2, "seq": 4}
    got = longseq.longseq_score_batch(pairs, mesh=mesh, row_chunk=8)
    want = jax_longseq.longseq_score_batch(
        pairs, mesh=jax_mesh.make_2d_mesh(data=2, seq=4), row_chunk=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError):
        longseq.longseq_score_batch(pairs[:5], mesh=mesh)


def test_pipeline_stats_match_jax():
    for args in ((97409, 98009, 4, 256), (100, 7, 1, 64), (5, 5, 8, 64)):
        assert longseq.longseq_pipeline_stats(*args[:3], row_chunk=args[3]) \
            == jax_longseq.longseq_pipeline_stats(*args[:3],
                                                  row_chunk=args[3])


def test_partition_sharded_matches_jax_and_auto():
    rng = np.random.default_rng(55)
    a = "".join(rng.choice(list("ACGT"), 70))
    b = "".join(rng.choice(list("ACGT"), 90))
    got = PartitionedAligner(p=4, fill_backend="sharded", device="cpu",
                             mesh=cpu_mesh()).align(a, b)
    want = jax_partition.PartitionedAligner(p=4,
                                            fill_backend="sharded").align(a, b)
    auto = PartitionedAligner(p=4, device="cpu").align(a, b)
    for r in (want, auto):
        assert (got.score, list(got.chain), got.aligned_a, got.aligned_b) \
            == (r.score, list(r.chain), r.aligned_a, r.aligned_b)


def test_mesh_helpers():
    assert cpu_mesh(3).devices == (torch.device("cpu"),) * 3
    assert make_seq_mesh(device="cpu").size == 1
    assert make_2d_mesh(seq=2, device="cpu").shape == {"data": 1, "seq": 2}
    m2 = Mesh(["cpu"] * 6, ("data", "seq"), (2, 3))
    assert m2.rows() == [(torch.device("cpu"),) * 3] * 2
    assert cpu_mesh(4).rows() == [(torch.device("cpu"),) * 4]
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 5, ("data", "seq"), (2, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_seq_mesh()


PAIR_G03 = (300, 700)


def _jax_routes_g03():
    """The JAX package's kernel and row-body last rows at g=0.3, h=1.7
    (run by ``jax_nofma``)."""
    a, b = rand_pair(np.random.default_rng(61), *PAIR_G03)
    p = JaxParams(*SETS["g0.3-h1.7"].astuple())
    return {be: np.asarray(jax_longseq.longseq_lastrow(
        a, b, p, row_chunk=128, backend=be)) for be in BACKENDS}


def test_non_dyadic_routes_recorded():
    """At g=0.3, h=1.7 the port's row body equals the JAX one. The JAX
    package's kernel and row-body routes disagree (K8's 2-carry order),
    and its pipeline compiles the kernel body with T3's ``H - g - h``
    folded into ``H - gh``, unlike its stand-alone ``halostair_step``,
    which the port's K8 follows (tests/test_torch_halostair.py): both
    counts of differing cells are pinned."""
    ref = jax_nofma("test_torch_longseq", "_jax_routes_g03")
    a, b = rand_pair(np.random.default_rng(61), *PAIR_G03)
    p = SETS["g0.3-h1.7"]
    got = {be: longseq.longseq_lastrow(a, b, p, row_chunk=128, backend=be,
                                       mesh=cpu_mesh()) for be in BACKENDS}
    np.testing.assert_array_equal(got["xla"], ref["xla"])
    assert int((ref["kernel"] != ref["xla"]).sum()) == JAX_KERNEL_VS_XLA
    assert int((got["kernel"] != ref["kernel"]).sum()) == PORT_VS_JAX_KERNEL


# of the 3 x 701 cells of the last row (jax 0.9.0, XLA:CPU without FMA)
JAX_KERNEL_VS_XLA = 3
PORT_VS_JAX_KERNEL = 25
