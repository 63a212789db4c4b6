"""Banded mode of the port (K12s, K12d, K2 in band layout,
``BandedAligner`` and ``api.align(mode="banded")``) against the JAX
package.

The Pallas kernels run in interpret mode, as tests/test_pallas_banded.py
runs them on the CPU, with two rows per grid step (the row blocking does
not change a byte; it only keeps the interpreter fast). Tolerance is 0.
At the non-dyadic parameters the JAX references come from XLA:CPU
without fused multiply-add (``jax_nofma`` of tests/test_torch_numerics.py,
in a subprocess), and each port route is held to its own JAX
counterpart: K12s to ``_banded_kernel``, the aligner to the JAX
aligner's fused route.
"""

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch
from test_torch_numerics import SETS, jax_nofma

from cse305_parallel_sequence_alignment_torch import api
from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.models.banded import (
    BandedAligner,
)
from cse305_parallel_sequence_alignment_torch.ops.banded import (
    banded_dirs,
    banded_fill_plain,
    banded_score,
)
from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
    rle_walk,
    rle_walk_plain,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)
STARTS = (-1, -2, -3, 1, 2, 3)
NON_DYADIC = "g0.3-h1.7"
PARAMS = {"default": ScoringParams(), NON_DYADIC: SETS[NON_DYADIC]}
# (w_lo, w_hi, bucket rows, seed): pair k has start type STARTS[k]
BANDS = {"4-4": (4, 4, 40, 1), "10-6": (10, 6, 48, 2), "0-8": (0, 8, 36, 3)}


def band_bucket(name):
    """Six pairs inside the band, one of them filling the bucket, with
    random bases and lengths; one pair is related to its partner."""
    w_lo, w_hi, bm, seed = BANDS[name]
    rng = np.random.default_rng(seed)
    B = len(STARTS)
    la = rng.integers(0, bm + 1, B)
    la[0] = bm
    lb = np.maximum(la + rng.integers(-w_lo, w_hi + 1, B), 0)
    lb[1] = la[1] + w_hi  # a pair on the band's upper edge
    bn = int(lb.max())
    a = np.full((B, bm), PAD_A, np.uint8)
    b = np.full((B, bn), PAD_B, np.uint8)
    for k in range(B):
        a[k, : la[k]] = ACGT[rng.integers(0, 4, la[k])]
        b[k, : lb[k]] = ACGT[rng.integers(0, 4, lb[k])]
    k = 2  # a related pair: long diagonal runs
    n2 = min(la[k], lb[k])
    b[k, :n2] = a[k, :n2]
    return (a, b, la.astype(np.int32), lb.astype(np.int32),
            np.array(STARTS, np.int32))


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in arrays]


def _dna(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _mutate(rng, s, rate):
    """Substitutions and single-base indels at ``rate`` each."""
    out = []
    for ch in s:
        u = rng.random()
        if u < rate:
            out.append("ACGT"[rng.integers(0, 4)])
        elif u < 2 * rate:
            continue
        elif u < 3 * rate:
            out.extend([_dna(rng, 1), ch])
        else:
            out.append(ch)
    return "".join(out)


def aligner_cases():
    """name -> (a, b, w_lo, w_hi, start_type, end_type, traceback_mode);
    each band reaches (m, n) plus the given margins."""
    rng = np.random.default_rng(41)
    base = _dna(rng, 50)
    cases = {
        "related": (base, _mutate(rng, base, 0.05), 6, 6, -1, -1,
                    "parity"),
        # a 2-base deletion mid-pair in a band of 2: the path runs along
        # the band's lower edge
        "edge": (base, base[:20] + base[22:] + "TT", 2, 2, -1, -1,
                 "parity"),
        "types-full": (_dna(rng, 30), _dna(rng, 36), 3, 2, -2, -3, "full"),
        "m-over-n": (_dna(rng, 40), _dna(rng, 33), 2, 4, 1, 2, "parity"),
    }
    out = {}
    for name, (x, y, lo, hi, s, e, mode) in cases.items():
        d = len(y) - len(x)
        out[name] = (x, y, max(-d, 0) + lo, max(d, 0) + hi, s, e, mode)
    return out


def result_tuple(r):
    return (float(r.score), list(r.chain), r.aligned_a, r.aligned_b,
            int(r.end_table), bool(r.edge_touched))


@contextlib.contextmanager
def _fast_pallas_dirs():
    """Within the block, ``pallas_banded_dirs_batch`` runs two rows per
    grid step; the JAX module is restored on leaving it."""
    from cse305_parallel_sequence_alignment_tpu.ops import pallas_banded
    fast = functools.partial(pallas_banded._pallas_banded_dirs, k_steps=2)
    with mock.patch.object(pallas_banded, "_pallas_banded_dirs", fast):
        yield


def _jax_refs(names, bands):
    with _fast_pallas_dirs():
        return _refs(names, bands)


def _refs(names, bands):
    import jax.numpy as jnp

    from cse305_parallel_sequence_alignment_tpu.core import (
        ScoringParams as JaxParams,
    )
    from cse305_parallel_sequence_alignment_tpu.core import (
        end_table_choice,
    )
    from cse305_parallel_sequence_alignment_tpu.models.banded import (
        BandedAligner as JaxAligner,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.banded import (
        banded_score as xla_banded_score,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.device_walk import (
        _walk_core_rle,
    )
    from cse305_parallel_sequence_alignment_tpu.ops.pallas_banded import (
        pallas_banded_dirs_batch,
        pallas_banded_score_batch,
    )
    out = {}
    for pname in names:
        p = PARAMS[pname]
        kw = dict(zip(("g", "h", "match", "mismatch"), p.astuple()))
        for band in bands:
            w_lo, w_hi = BANDS[band][:2]
            a, b, la, lb, st = band_bucket(band)
            k12s = np.zeros((len(st), 3), np.float32)
            k12d = np.zeros((len(st), 3), np.float32)
            dirs = None
            for s in STARTS:
                fs = pallas_banded_score_batch(a, b, la, lb, w_lo, w_hi,
                                               start_type=s, interpret=True,
                                               **kw)
                fd, dj = pallas_banded_dirs_batch(
                    a, b, la, lb, w_lo, w_hi, start_type=s, with_runs=True,
                    interpret=True, **kw)
                dj = np.asarray(dj)
                dirs = np.zeros_like(dj) if dirs is None else dirs
                rows = st == s
                k12s[rows], k12d[rows] = fs[rows], fd[rows]
                dirs[:, rows] = dj[:, rows]
            xla = np.stack([
                xla_banded_score(a[k, : la[k]], b[k, : lb[k]], w_lo, w_hi,
                                 start_type=int(st[k]), **kw)
                for k in range(len(st))])
            tables = np.array([end_table_choice(*map(float, f), -1,
                                                p.h)[0] for f in k12d],
                              np.int32)
            max_steps = int(la.max() + lb.max()) + 1
            ent, _ = _walk_core_rle(
                jnp.asarray(dirs), jnp.asarray(la), jnp.asarray(lb),
                jnp.asarray(tables), max_steps=max_steps,
                layout=("band", w_lo))
            out[pname, band] = {"k12s": k12s, "k12d": (k12d, dirs),
                                "xla": xla, "tables": tables,
                                "walk": np.asarray(ent)}
        for case, (x, y, w_lo, w_hi, s, e, mode) in aligner_cases().items():
            jp = JaxParams(*p.astuple())
            for backend in ("pallas", "wavefront")[: 2 if pname ==
                                                   "default" else 1]:
                al = JaxAligner(params=jp, w_lo=w_lo, w_hi=w_hi,
                                start_type=s, end_type=e,
                                traceback_mode=mode, backend=backend)
                r = al.align(x, y)
                out[pname, case, backend] = (result_tuple(r),
                                             float(al.score(x, y)))
    return out


def _references():
    """The non-dyadic references (run by ``jax_nofma``)."""
    return _jax_refs([NON_DYADIC], ["10-6"])


@pytest.fixture(scope="module")
def refs():
    # the non-dyadic subprocess runs while this process computes the rest
    with ThreadPoolExecutor(1) as pool:
        nofma = pool.submit(jax_nofma, "test_torch_banded", "_references")
        return {**_jax_refs(["default"], sorted(BANDS)), **nofma.result()}


FILL_GRID = [("default", band) for band in sorted(BANDS)] + [
    (NON_DYADIC, "10-6")]


@pytest.mark.parametrize("pname,band", FILL_GRID)
def test_k12s_matches_pallas(refs, pname, band):
    """K12s plain == ``_banded_kernel``, every pair with its own start
    type in one bucket."""
    w_lo, w_hi = BANDS[band][:2]
    got = banded_score(*port(*band_bucket(band)), w_lo, w_hi,
                       PARAMS[pname])
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 3)
    assert np.array_equal(got.numpy(), refs[pname, band]["k12s"])


@pytest.mark.parametrize("pname,band", FILL_GRID)
def test_k12d_matches_pallas(refs, pname, band):
    """K12d plain == ``_banded_dirs_kernel(with_runs=True)``: the finals
    and every byte of the band dirs (the JAX array's extra lanes and rows
    are zero)."""
    w_lo, w_hi = BANDS[band][:2]
    a, b, la, lb, st = band_bucket(band)
    dirs, fin = banded_dirs(*port(a, b, la, lb, st), w_lo, w_hi,
                            PARAMS[pname])
    fj, dj = refs[pname, band]["k12d"]
    W, m = w_lo + w_hi + 1, a.shape[1]
    assert dirs.dtype == torch.uint16
    assert tuple(dirs.shape) == (m + 1, 6, W)
    assert np.array_equal(fin.numpy(), fj)
    assert np.array_equal(dirs.numpy(), dj[: m + 1, :, :W])
    assert not dj[:, :, W:].any() and not dj[m + 1:].any()
    # K12s and K12d share their finals
    assert np.array_equal(fin.numpy(), refs[pname, band]["k12s"])


@pytest.mark.parametrize("pname,band", FILL_GRID)
def test_band_walk_matches_jax(refs, pname, band):
    """K2 plain in band layout == ``_walk_core_rle(layout=("band",
    w_lo))`` on the same dirs, entry for entry."""
    w_lo = BANDS[band][0]
    a, b, la, lb, st = band_bucket(band)
    dirs, _ = banded_dirs(*port(a, b, la, lb, st), w_lo, BANDS[band][1],
                          PARAMS[pname])
    ref = refs[pname, band]
    t0 = torch.from_numpy(ref["tables"])
    max_steps = int(la.max() + lb.max()) + 1
    ent, used = rle_walk(dirs, *port(la, lb), t0, max_steps, band_lo=w_lo)
    want = ref["walk"]
    u = int(used[0])
    assert u > 0 and not want[u:].any()
    assert np.array_equal(ent.numpy()[:u], want[:u])
    assert not ent.numpy()[u:].any()


def test_pallas_row_blocking_changes_no_byte():
    """The references' two rows per grid step give the default blocking's
    (32 rows) finals and dirs, and the JAX module is left as it was."""
    from cse305_parallel_sequence_alignment_tpu.ops import pallas_banded
    default = pallas_banded._pallas_banded_dirs
    a, b, la, lb, _ = band_bucket("4-4")
    m = a.shape[1]
    kw = dict(start_type=-1, with_runs=True, interpret=True)
    f_32, d_32 = pallas_banded.pallas_banded_dirs_batch(a, b, la, lb, 4, 4,
                                                        **kw)
    with _fast_pallas_dirs():
        f_2, d_2 = pallas_banded.pallas_banded_dirs_batch(a, b, la, lb, 4,
                                                          4, **kw)
    assert pallas_banded._pallas_banded_dirs is default
    assert np.array_equal(np.asarray(f_2), np.asarray(f_32))
    assert np.array_equal(np.asarray(d_2)[: m + 1],
                          np.asarray(d_32)[: m + 1])


def test_xla_and_pallas_banded_scores_agree_at_default_params(refs):
    """At integer parameters the JAX package's XLA ``banded_score`` and
    its Pallas K12s agree, so either holds the port."""
    for band in BANDS:
        assert np.array_equal(refs["default", band]["xla"],
                              refs["default", band]["k12s"])


def test_non_dyadic_routes_recorded(refs):
    """At g=0.3, h=1.7 the Pallas K12s and the XLA fill of the JAX
    package are both computed without FMA; the port follows K12s (the
    test above). This pins whether the two JAX routes agree there (ROADMAP
    queue 3 records the answer)."""
    ref = refs[NON_DYADIC, "10-6"]
    assert np.array_equal(ref["xla"], ref["k12s"])


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("case", sorted(aligner_cases()))
def test_aligner_matches_jax(refs, pname, case):
    """``BandedAligner(device="cpu")``: score, chain, rows, end table and
    ``edge_touched`` of ``align``, and ``score``, against the JAX
    ``BandedAligner`` with ``backend="pallas"`` (and, at the default
    parameters, ``"wavefront"``)."""
    x, y, w_lo, w_hi, s, e, mode = aligner_cases()[case]
    al = BandedAligner(params=PARAMS[pname], w_lo=w_lo, w_hi=w_hi,
                       start_type=s, end_type=e, traceback_mode=mode,
                       device="cpu")
    got = (result_tuple(al.align(x, y)), float(al.score(x, y)))
    assert got == refs[pname, case, "pallas"]
    if pname == "default":
        assert got == refs[pname, case, "wavefront"]
    assert list(al.last_phases) == ["fill_ms", "walk_ms", "d2h_ms",
                                    "replay_ms", "render_ms"]


def test_edge_touched_both_ways(refs):
    """The cases hold a chain on the band's edge and chains off it."""
    flags = {refs["default", c, "pallas"][0][5] for c in aligner_cases()}
    assert flags == {True, False}


def test_api_banded_matches_jax():
    from cse305_parallel_sequence_alignment_tpu import api as jax_api
    rng = np.random.default_rng(43)
    base = _dna(rng, 45)
    for x, y, band in ((base, _mutate(rng, base, 0.08), 3),
                       (_dna(rng, 20), _dna(rng, 29), 2),
                       (base, base[:30], None)):
        kw = {} if band is None else {"band": band}
        got = api.align(x, y, mode="banded", device="cpu", **kw)
        want = jax_api.align(x, y, mode="banded", **kw)
        want.edge_touched = bool(want.edge_touched)
        assert result_tuple(got) == result_tuple(want)
    for fn in (api.align_pairs, api.score_pairs):
        with pytest.raises(ValueError, match="not batchable"):
            fn([("ACGT", "ACG")], mode="banded", device="cpu")


def test_band_that_misses_the_corner_raises():
    with pytest.raises(ValueError, match="misses"):
        BandedAligner(w_lo=2, w_hi=2, device="cpu").align("A" * 10, "A" * 3)
    with pytest.raises(ValueError, match="misses"):
        BandedAligner(w_lo=2, w_hi=2, device="cpu").score("A" * 3, "A" * 9)
    a, b, la, lb, st = band_bucket("4-4")
    with pytest.raises(ValueError, match="misses"):
        banded_dirs(*port(a, b, la, lb, st), 4, 0, ScoringParams())
    ones = port(*[np.ones(1, np.int32)] * 3)
    with pytest.raises(ValueError, match="band_lo"):
        rle_walk(torch.zeros((2, 1, 3), dtype=torch.uint16), *ones, 3,
                 band_lo=-1)


@pytest.mark.cuda
def test_banded_kernels_match_plain_on_card():
    """K12s, K12d and K2 in band layout against their plain versions on
    the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for band in sorted(BANDS):
        w_lo, w_hi = BANDS[band][:2]
        args = [x.cuda() for x in port(*band_bucket(band))]
        for params in PARAMS.values():
            d_k, f_k = banded_dirs(*args, w_lo, w_hi, params)
            d_p, f_p = banded_fill_plain(*args, w_lo, w_hi, params, True)
            assert torch.equal(d_k.view(torch.int16), d_p.view(torch.int16))
            assert torch.equal(f_k, f_p)
            assert torch.equal(banded_score(*args, w_lo, w_hi, params), f_p)
            t0 = torch.ones(6, dtype=torch.int32, device="cuda")
            w_k = rle_walk(d_k, args[2], args[3], t0, 120, band_lo=w_lo)
            w_p = rle_walk_plain(d_k, args[2], args[3], t0, 120, w_lo)
            assert torch.equal(w_k[0].view(torch.int16),
                               w_p[0].view(torch.int16))
            assert torch.equal(w_k[1], w_p[1])
