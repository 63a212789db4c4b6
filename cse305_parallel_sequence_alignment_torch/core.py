"""Core types: scoring parameters, boundary semantics, codec, results.

A jax-free copy of the reference package's ``core.py`` (same names, same
values), so the torch port never imports the JAX package. The DP is
Gotoh's three-matrix affine-gap recurrence (reference
alignment_algorithm/subproblem_alignment.h and .cpp):

- ``T1[i][j]``: best score ending in a match/mismatch column.
- ``T2[i][j]``: ending in a gap in A (consumes B[j] only).
- ``T3[i][j]``: ending in a gap in B (consumes A[i] only).

A gap of length k costs ``h + g*k``. Scores are float32 with true
``-inf`` sentinels; every finite score of integer-valued scoring is a
small exact integer.

Boundary types (reference subproblem_alignment.h:8-13): ``1`` diagonal,
``2`` gap in A, ``3`` gap in B; negative types mean "free choice
anchored at table |t|".
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# float32 -inf: absorbing under +/- like the reference's double -inf.
NEG_INF = float("-inf")

# Direction codes, 2 bits per table: 0 -> predecessor T1, 1 -> T2,
# 2 -> T3 (first match in the order T1, T2, T3; quirk B3).
DIR_T1_SHIFT = 0
DIR_T2_SHIFT = 2
DIR_T3_SHIFT = 4

# Padding codes of the bucketed sequence arrays: they never equal each
# other or a real base, so padded cells only ever score a mismatch.
PAD_A = 254
PAD_B = 255


@dataclasses.dataclass(frozen=True)
class ScoringParams:
    """Affine-gap scoring: similarity maximised, gaps cost ``h + g*k``.

    Defaults mirror the reference harness (test_functions/testing.cpp:134:
    ``g=1, h=2``; match/mismatch from subproblem_alignment.h:83-88).
    """

    g: float = 1.0  # gap extend
    h: float = 2.0  # gap open
    match: float = 1.0
    mismatch: float = 0.0

    def astuple(self):
        return (self.g, self.h, self.match, self.mismatch)

    @classmethod
    def from_numpy(cls, arr):
        """Parameters from ``astuple()`` held as a numpy array (the form
        in which the JAX package's parameters cross into the port)."""
        g, h, match, mismatch = (float(x) for x in np.asarray(arr).ravel())
        return cls(g=g, h=h, match=match, mismatch=mismatch)


@dataclasses.dataclass(frozen=True)
class SubstitutionMatrix:
    """Full KxK substitution scoring over an explicit alphabet (the JAX
    package's ``core.SubstitutionMatrix``, same names and values).

    Generalises the reference's match/mismatch ``f()``
    (subproblem_alignment.h:83-88) to arbitrary per-pair scores.
    ``matrix`` is a row-major tuple of K*K floats. Code K (one past the
    alphabet) is the padding code; ``table()`` appends a pad row and
    column of ``PAD_SCORE``, which only padded cells ever read.
    """

    alphabet: str
    matrix: tuple

    PAD_SCORE = -1e9

    def __post_init__(self):
        k = len(self.alphabet)
        if len(self.matrix) != k * k:
            raise ValueError(
                f"matrix needs {k * k} entries for alphabet "
                f"{self.alphabet!r}, got {len(self.matrix)}")

    @classmethod
    def from_array(cls, alphabet, arr):
        arr = np.asarray(arr, dtype=np.float32)
        return cls(alphabet=alphabet,
                   matrix=tuple(float(x) for x in arr.reshape(-1)))

    @classmethod
    def dna(cls, match=1.0, mismatch=0.0, alphabet="ACGTN"):
        k = len(alphabet)
        arr = np.full((k, k), mismatch, np.float32)
        np.fill_diagonal(arr, match)
        return cls.from_array(alphabet, arr)

    @property
    def k(self):
        return len(self.alphabet)

    @property
    def pad_code(self):
        return self.k

    @functools.cached_property
    def _lut(self):
        """Byte -> code lookup, 255 for a byte outside the alphabet."""
        lut = np.full(256, 255, np.uint8)
        for c, ch in enumerate(self.alphabet.encode("ascii")):
            lut[ch] = c
        return lut

    def encode(self, s):
        """Sequence -> uint8 codes 0..K-1; unknown characters raise."""
        if isinstance(s, str):
            s = s.encode("ascii")
        codes = self._lut[np.frombuffer(bytes(s), np.uint8)]
        if np.any(codes == 255):
            bad = bytes(sorted(set(
                bytes(s)[i] for i in np.nonzero(codes == 255)[0])))
            raise ValueError(f"characters {bad!r} not in alphabet "
                             f"{self.alphabet!r}")
        return codes

    def table(self):
        """(K+1, K+1) float32 lookup with the pad row/column."""
        k = self.k
        t = np.full((k + 1, k + 1), self.PAD_SCORE, np.float32)
        t[:k, :k] = np.asarray(self.matrix, np.float32).reshape(k, k)
        return t


def matrix_from_jax(m):
    """The port's ``SubstitutionMatrix`` of a JAX package one, carried
    across by its ``alphabet`` and ``matrix`` fields (the JAX package is
    not imported)."""
    return SubstitutionMatrix(alphabet=str(m.alphabet),
                              matrix=tuple(float(x) for x in m.matrix))


class LazyChain:
    """Sequence of ``(i, j, t)`` tuples materialised on first access.

    Holds the replay's compact (t, i, j) arrays and builds the tuple list
    only when a consumer reads it; equality, iteration, indexing and
    concatenation behave like the eager list.
    """

    __slots__ = ("_tt", "_ii", "_jj", "_list")

    def __init__(self, tt, ii, jj):
        self._tt, self._ii, self._jj = tt, ii, jj
        self._list = None

    def _mat(self):
        if self._list is None:
            self._list = list(zip(self._ii.tolist(), self._jj.tolist(),
                                  self._tt.tolist()))
            self._tt = self._ii = self._jj = None
        return self._list

    def __len__(self):
        return (len(self._list) if self._list is not None
                else self._tt.shape[0])

    def __bool__(self):
        return len(self) > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, k):
        return self._mat()[k]

    def arrays(self):
        """The chain as (tt, ii, jj) arrays, without building its tuples."""
        if self._list is None:
            return self._tt, self._ii, self._jj
        return chain_arrays(self._list)

    def __eq__(self, other):
        if isinstance(other, LazyChain):
            other = other._mat()
        return self._mat() == other

    def __add__(self, other):
        return self._mat() + list(other)

    def __radd__(self, other):
        return list(other) + self._mat()

    def __repr__(self):
        return repr(self._mat())


def chain_arrays(chain):
    """(tt, ii, jj) int64 arrays of a chain of ``(i, j, t)`` points: a
    ``LazyChain``'s own arrays, or those of any sequence of points."""
    if isinstance(chain, LazyChain):
        return chain.arrays()
    pts = np.asarray(list(chain), np.int64).reshape(-1, 3)
    return pts[:, 2], pts[:, 0], pts[:, 1]


@dataclasses.dataclass
class AlignmentResult:
    """Result of one pairwise alignment.

    ``chain`` is a list of ``(i, j, t)`` tuples in the reference's
    alignment_point convention (1-indexed; gap rows store 0 for the gapped
    side, quirk B2). ``aligned_a``/``aligned_b`` are the two text rows of
    the reference's ``print_seq`` (main_alignment.cpp:32-55).
    """

    score: float
    chain: list | None = None
    aligned_a: str | None = None
    aligned_b: str | None = None
    end_table: int | None = None

    def cigar(self) -> str:
        """SAM CIGAR of the chain (M/I/D; A is the query)."""
        from cse305_parallel_sequence_alignment_torch.ops.cigar import (
            chain_to_cigar,
        )
        return chain_to_cigar(self.chain or [])


def encode_seq(s, dtype=np.uint8):
    """ASCII string/bytes -> uint8 numpy array (0-indexed, no sentinel)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    return np.frombuffer(bytes(s), dtype=dtype).copy()


def decode_seq(arr):
    """uint8 numpy array -> ASCII string."""
    return bytes(np.asarray(arr, dtype=np.uint8)).decode("ascii")


def format_alignment(a, b, chain):
    """The two text rows of the reference's print_seq
    (main_alignment.cpp:32-55) of a chain, with 1-indexed source
    positions (the JAX package's ``models/oracle.py`` function)."""
    a = "-" + (a if isinstance(a, str) else a.decode("ascii"))
    b = "-" + (b if isinstance(b, str) else b.decode("ascii"))
    row_a = "".join(a[i] if t in (1, 3) else "-" for (i, j, t) in chain)
    row_b = "".join(b[j] if t in (1, 2) else "-" for (i, j, t) in chain)
    return row_a, row_b


def boundary_row0(n, start_type, g, h):
    """First-row boundary (i=0, j=0..n) for T1/T2/T3.

    The reference init, quirks included (subproblem_alignment.cpp:
    212-227, 261-272): the corner is T1=0 for start in {1,-1}, T2=0 for
    -2, T3=0 for -3, else -inf; for j>=1 T1=T3=-inf and T2 = -g*j for
    start -2, -inf for start in {1,3}, else (-1, -3 and quirkily +2)
    -h-g*j.
    """
    t1 = np.full(n + 1, NEG_INF, np.float32)
    t2 = np.full(n + 1, NEG_INF, np.float32)
    t3 = np.full(n + 1, NEG_INF, np.float32)
    j = np.arange(1, n + 1, dtype=np.float32)
    if start_type in (1, -1):
        t1[0] = 0.0
    elif start_type == -2:
        t2[0] = 0.0
    elif start_type == -3:
        t3[0] = 0.0
    if start_type == -2:
        t2[1:] = -g * j
    elif start_type not in (1, 3):
        t2[1:] = -h - g * j
    return t1, t2, t3


def boundary_col0(m, start_type, g, h):
    """First-column boundary (j=0, i=1..m) for T1/T2/T3.

    Reference subproblem_alignment.cpp:282-292: T1=T2=-inf; T3 = -g*i for
    start -3, -inf for start in {1,2}, else (-1, -2 and quirkily +3)
    -h-g*i. Index 0 of the returned arrays is row i=1.
    """
    t1 = np.full(m, NEG_INF, np.float32)
    t2 = np.full(m, NEG_INF, np.float32)
    t3 = np.full(m, NEG_INF, np.float32)
    i = np.arange(1, m + 1, dtype=np.float32)
    if start_type == -3:
        t3[:] = -g * i
    elif start_type not in (1, 2):
        t3[:] = -h - g * i
    return t1, t2, t3


def end_table_choice(t1, t2, t3, end_type, h):
    """Pick the table the alignment ends in, reference semantics.

    ``end_type > 0`` forces the table. Otherwise argmax of (T1, T2 + h',
    T3 + h'') with the gap-open refund h' = h iff end_type == -2 (resp.
    -3), tie order T1 >= T2 >= T3 (subproblem_alignment.cpp:112-146).
    Returns (table in {1,2,3}, adjusted best score).
    """
    if end_type > 0:
        return end_type, (t1, t2, t3)[end_type - 1]
    c1 = t1
    c2 = t2 + (h if end_type == -2 else 0.0)
    c3 = t3 + (h if end_type == -3 else 0.0)
    if c1 >= c2 and c1 >= c3:
        return 1, c1
    if c2 >= c1 and c2 >= c3:
        return 2, c2
    return 3, c3
