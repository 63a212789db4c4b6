"""Substitution-matrix mode of the port (K4s, K4d, ``BatchAligner(
matrix=...)``) against the JAX package.

Inputs come from ``np.random.default_rng(seed)``; the Pallas kernels run
in interpret mode, as tests/test_submat.py runs them on the CPU.
Tolerance is 0: scores are float32 sums of small integers or binary
fractions taken in the same order, dirs are integers. Only the real
cells of a padded bucket are compared (padded cells add the table's pad
score, -1e9).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    ScoringParams,
    SubstitutionMatrix,
    matrix_from_jax,
)
from cse305_parallel_sequence_alignment_torch.models.batch import (
    BatchAligner,
)
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    matrix_dirs_plain,
    rowcb_fill,
    rowcb_fill_plain,
    submat_score_fill,
    submat_score_fill_plain,
)
from cse305_parallel_sequence_alignment_torch.utils.matrices import (
    BLOSUM62,
    BLOSUM62_ALPHABET,
    dna_matrix,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    ScoringParams as JaxParams,
)
from cse305_parallel_sequence_alignment_tpu.core import (
    SubstitutionMatrix as JaxMatrix,
)
from cse305_parallel_sequence_alignment_tpu.models.batch import (
    BatchAligner as JaxBatchAligner,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    pallas_submat_score_batch,
)
from cse305_parallel_sequence_alignment_tpu.ops.pallas_rowcb import (
    pallas_rowcb_mat_dirs_batch,
)
from cse305_parallel_sequence_alignment_tpu.utils.matrices import (
    BLOSUM62 as JAX_BLOSUM62,
)

STARTS = (-1, -2, -3, 1, 2, 3)
# transition (A<->G, C<->T) scored milder than transversion, as
# tests/test_submat.py has it
TSTV = SubstitutionMatrix.from_array("ACGT", np.array(
    [[2, -2, -1, -2], [-2, 2, -2, -1], [-1, -2, 2, -2], [-2, -1, -2, 2]],
    np.float32))
# the fractional matrix of tests/test_submat.py:137
FRAC = SubstitutionMatrix.from_array("ACGT", np.array(
    [[1.5, -0.5, -0.25, -0.5], [-0.5, 1.5, -0.5, -0.25],
     [-0.25, -0.5, 1.5, -0.5], [-0.5, -0.25, -0.5, 1.5]], np.float32))
MATRICES = {"tstv": TSTV, "blosum62": BLOSUM62, "fractional": FRAC}
AMINO = "ARNDCQEGHILKMFPSTWYV"


def jax_matrix(m):
    return JaxMatrix(alphabet=m.alphabet, matrix=m.matrix)


def code_bucket(rng, k, B, bm, bn, min_len=0):
    """Random alphabet codes padded with the pad code k."""
    a = np.full((B, bm), k, np.uint8)
    b = np.full((B, bn), k, np.uint8)
    la = rng.integers(min_len, bm + 1, B).astype(np.int32)
    lb = rng.integers(min_len, bn + 1, B).astype(np.int32)
    la[0], lb[0] = bm, bn  # one pair fills the bucket
    for r in range(B):
        a[r, : la[r]] = rng.integers(0, k, la[r])
        b[r, : lb[r]] = rng.integers(0, k, lb[r])
    return a, b, la, lb


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def protein(rng, n):
    return "".join(rng.choice(list(AMINO), n))


def related(rng, a, sub=0.15, indel=0.04):
    """A copy of ``a`` with substitutions and single-residue indels."""
    out = []
    for ch in a:
        u = rng.random()
        if u < indel / 2:
            continue
        if u < indel:
            out.append(AMINO[rng.integers(0, 20)])
        out.append(AMINO[rng.integers(0, 20)] if rng.random() < sub else ch)
    return "".join(out) or "A"


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.score, g.end_table) == (w.score, w.end_table)
        assert list(g.chain) == list(w.chain)
        assert (g.aligned_a, g.aligned_b) == (w.aligned_a, w.aligned_b)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_submat_score_matches_pallas(name, start):
    """K4s plain == ``pallas_submat_score_batch`` (interpret mode)."""
    mat = MATRICES[name]
    rng = np.random.default_rng(100 + 7 * STARTS.index(start) + len(name))
    a, b, la, lb = code_bucket(rng, mat.k, 5, 40, 56)
    g, h = (0.5, 1.25) if name == "fractional" else (1.0, 2.0)
    want = pallas_submat_score_batch(a, b, la, lb, mat.table(), g=g, h=h,
                                     start_type=start, interpret=True)
    st = np.full(5, start, np.int32)
    table = torch.from_numpy(mat.table())
    got = submat_score_fill(*port(a, b, la, lb, st), table,
                            ScoringParams(g=g, h=h))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_matrix_dirs_matches_pallas(name, start):
    """K4d plain == ``pallas_rowcb_mat_dirs_batch(with_runs=True)`` on
    every real cell, and its finals == K4s's finals."""
    mat = MATRICES[name]
    rng = np.random.default_rng(200 + 7 * STARTS.index(start) + len(name))
    a, b, la, lb = code_bucket(rng, mat.k, 4, 36, 50)
    g, h = (0.5, 1.25) if name == "fractional" else (1.0, 2.0)
    fj, dj = pallas_rowcb_mat_dirs_batch(
        a, b, la, lb, mat.table(), g=g, h=h, start_type=start,
        with_runs=True, interpret=True)
    st = np.full(4, start, np.int32)
    table = torch.from_numpy(mat.table())
    params = ScoringParams(g=g, h=h)
    dirs, fin = rowcb_fill(*port(a, b, la, lb, st), params, table)
    assert dirs.dtype == torch.uint16
    assert tuple(dirs.shape) == (37, 4, 51)
    assert np.array_equal(fin.numpy(), fj)
    dn, dj = dirs.numpy(), np.asarray(dj)
    for k in range(4):
        assert np.array_equal(dn[: la[k] + 1, k, : lb[k] + 1],
                              dj[: la[k] + 1, k, : lb[k] + 1]), k
    assert np.array_equal(
        submat_score_fill(*port(a, b, la, lb, st), table, params).numpy(),
        fin.numpy())


def test_identity_matrix_equals_match_mismatch():
    """Under ``dna_matrix(1, 0)`` the table fill gives K1's dirs on
    every real cell and K1's finals, at every start type, and the
    aligner K1's results."""
    rng = np.random.default_rng(300)
    mat = dna_matrix(1.0, 0.0)
    B = 6
    codes = code_bucket(rng, 4, B, 48, 60)
    a, b, la, lb = codes
    st = np.array(STARTS, np.int32)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a1 = np.where(a < 4, acgt[np.minimum(a, 3)], 254).astype(np.uint8)
    b1 = np.where(b < 4, acgt[np.minimum(b, 3)], 255).astype(np.uint8)
    d_m, f_m = matrix_dirs_plain(*port(a, b, la, lb, st),
                                 torch.from_numpy(mat.table()),
                                 ScoringParams())
    d_1, f_1 = rowcb_fill_plain(*port(a1, b1, la, lb, st), ScoringParams())
    assert torch.equal(f_m, f_1)
    for k in range(B):
        assert np.array_equal(d_m.numpy()[: la[k] + 1, k, : lb[k] + 1],
                              d_1.numpy()[: la[k] + 1, k, : lb[k] + 1]), k
    pairs = [("".join(rng.choice(list("ACGT"), int(rng.integers(1, 50)))),
              "".join(rng.choice(list("ACGT"), int(rng.integers(1, 50)))))
             for _ in range(8)]
    same_results(BatchAligner(matrix=mat, device="cpu").align_batch(pairs),
                 BatchAligner(device="cpu").align_batch(pairs))
    s_m = BatchAligner(matrix=mat, device="cpu").score_batch(pairs)
    s_1 = BatchAligner(device="cpu").score_batch(pairs)
    assert all(np.array_equal(x, y) for x, y in zip(s_m, s_1))


def protein_pairs(seed, count=6, max_len=60):
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        a = protein(rng, int(rng.integers(1, max_len + 1)))
        b = related(rng, a) if k % 2 == 0 else \
            protein(rng, int(rng.integers(1, max_len + 1)))
        pairs.append((a, b) if k % 3 else (b + "W" * 5, a))  # m > n too
    return pairs


@pytest.mark.parametrize("backend", ["pallas", "wavefront"])
def test_aligner_matches_jax_blosum62(backend):
    pairs = protein_pairs(31)
    params = ScoringParams(g=1.0, h=11.0)
    got = BatchAligner(params=params, matrix=BLOSUM62, device="cpu")
    want = JaxBatchAligner(params=JaxParams(g=1.0, h=11.0),
                           matrix=JAX_BLOSUM62, backend=backend)
    same_results(got.align_batch(pairs), want.align_batch(pairs))
    s_p, t_p = got.score_batch(pairs)
    s_j, t_j = want.score_batch(pairs)
    assert np.array_equal(s_p, s_j) and np.array_equal(t_p, t_j)


@pytest.mark.parametrize("mode", ["parity", "full"])
def test_aligner_mixed_types_matches_jax(mode):
    """Per-pair start and end types in one matrix batch, both traceback
    modes, against the JAX fused path."""
    rng = np.random.default_rng(33)
    pairs = [("".join(rng.choice(list("ACGT"), int(rng.integers(5, 40)))),
              "".join(rng.choice(list("ACGT"), int(rng.integers(5, 40)))))
             for _ in range(6)]
    starts, ends = [-1, -2, -3, 1, -1, -2], [-1, -3, 1, -2, 2, 3]
    kw = dict(traceback_mode=mode, start_types=starts, end_types=ends)
    got = BatchAligner(matrix=TSTV, device="cpu").align_batch(pairs, **kw)
    want = JaxBatchAligner(matrix=jax_matrix(TSTV),
                           backend="pallas").align_batch(pairs, **kw)
    for g, w in zip(got, want):
        assert (g.score, g.end_table, list(g.chain)) == \
            (w.score, w.end_table, list(w.chain))


def test_matrix_from_jax_and_errors():
    ported = matrix_from_jax(JAX_BLOSUM62)
    assert ported == BLOSUM62
    assert ported.alphabet == BLOSUM62_ALPHABET
    assert np.array_equal(ported.table(), JAX_BLOSUM62.table())
    # a JAX matrix given to the aligner is carried across
    al = BatchAligner(matrix=JAX_BLOSUM62, device="cpu")
    assert al.matrix == BLOSUM62
    with pytest.raises(ValueError, match="not in alphabet"):
        al.align_batch([("ACDX1", "ACD")])
    with pytest.raises(ValueError, match="not in alphabet"):
        BatchAligner(matrix=TSTV, device="cpu").score_batch([("ACGU", "A")])
    with pytest.raises(ValueError):
        SubstitutionMatrix("ACGT", (1.0, 2.0))
    big = SubstitutionMatrix.dna(alphabet="".join(
        chr(c) for c in range(1, 256)))
    with pytest.raises(ValueError, match="254"):
        BatchAligner(matrix=big, device="cpu")
    a = torch.zeros((1, 3), dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="255"):
        submat_score_fill(a, a, z, z, z, torch.zeros((256, 256)),
                          ScoringParams())


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("fill", ["K4d", "K4s"])
def test_codes_outside_the_table_raise(fill, side):
    """Raw ASCII, or any code past the pad code, is refused before a
    launch (the kernels read the table unchecked)."""
    rng = np.random.default_rng(302)
    codes = code_bucket(rng, TSTV.k, 3, 12, 14)
    a, b, la, lb = [x.copy() for x in codes]
    (a if side == "a" else b)[1, 2] = ord("G")
    st = np.full(3, -1, np.int32)
    table = torch.from_numpy(TSTV.table())
    args = port(a, b, la, lb, st)
    with pytest.raises(ValueError, match="does not index a table of 5"):
        if fill == "K4d":
            rowcb_fill(*args, ScoringParams(), table)
        else:
            submat_score_fill(*args, table, ScoringParams())


@pytest.mark.cuda
def test_matrix_kernels_match_plain_on_card():
    """K4d and K4s against their plain versions on the card, bit for
    bit, with every start type, under BLOSUM62 and the fractional
    matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(301)
    for mat in (BLOSUM62, FRAC):
        a, b, la, lb = code_bucket(rng, mat.k, 6, 300, 420)
        st = np.array(STARTS, np.int32)
        args = [x.cuda() for x in port(a, b, la, lb, st)]
        table = torch.from_numpy(mat.table()).cuda()
        params = ScoringParams(g=1.0, h=11.0)
        d_k, f_k = rowcb_fill(*args, params, table)
        d_p, f_p = matrix_dirs_plain(*args, table, params)
        assert torch.equal(d_k.view(torch.int16), d_p.view(torch.int16))
        assert torch.equal(f_k, f_p)
        s_k = submat_score_fill(*args, table, params)
        assert torch.equal(s_k, submat_score_fill_plain(*args, table,
                                                        params))
        assert torch.equal(s_k, f_k)


@pytest.mark.parametrize("method", ["align_batch", "score_batch"])
def test_aligner_refuses_codes_outside_the_table(method):
    """The aligner checks a chunk's codes on the host, before its fill
    (which then skips the check that reads the codes' maximum from the
    card), and refuses a code past the table as ``rowcb_fill`` does."""
    al = BatchAligner(matrix=TSTV, device="cpu")
    raw = lambda self, s: np.frombuffer(bytes(s), np.uint8)  # noqa: E731
    with mock.patch.object(SubstitutionMatrix, "encode", raw):
        with pytest.raises(ValueError, match="does not index a table of 5"):
            getattr(al, method)([("ACGT", "ACGGT"), ("GATTACA", "GATACA")])
