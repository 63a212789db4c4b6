"""Port P-perm, P-stripes, P-knock, P-ablate and P-lane0 (plain PyTorch)
== the TPU probe kernels they replace.

P-perm is held against the JAX package's own permuted-layout K3',
``_pallas_rowscan(..., perm=True)`` on ``rowscan_prep(..., perm=True)``
(pallas_fill.py:866, :1055), and against ``perm=False``: the check of
scripts/probes/attrib3_r5.py:209-211, whose ``perm_kernel`` lives inside
its ``main``. P-ablate ``full`` is held against ``_pallas_rowscan`` and its
other modes against ``variant_kernel``, which also lives inside a
``main``: ``_variant_kernel`` below transcribes it (scripts/probes/
attrib_r5.py:65-143). The module-level kernels of scripts/kern_stripes.py,
scripts/kern_attrib.py and scripts/kern_scalar.py are loaded as they are,
their globals M, NL (and B) shrunk with ``mock.patch.object``, and run in a
test-local ``pallas_call``. Every Pallas call runs in interpret mode;
inputs come from numpy seeds; tolerance 0, NaN equal to NaN.
"""

import functools
import importlib.util
import pathlib
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    ScoringParams,
)
from cse305_parallel_sequence_alignment_torch.ops import rowcb, rowprobe
from cse305_parallel_sequence_alignment_tpu.ops.pallas_fill import (
    NEG_INF,
    _char_col,
    _col0_t3,
    _emit_row,
    _lane_prefix_max,
    _pack3,
    _pallas_rowscan,
    _row0_t2,
    _shift_right_neg,
    _unpack3,
    rowscan_prep,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, NL = 32, 256  # the scripts' M and NL, cut to size
KNOCKS = {  # scripts/kern_attrib.py:128-138
    "full (baseline)": ((), 4), "full unroll=8": ((), 8),
    "full unroll=16": ((), 16), "- charcol": (("charcol",), 4),
    "- charcol - bcast": (("charcol", "bcast"), 4),
    "- prefix(12 steps)": (("prefix",), 4),
    "prefix 7 sub-128 only": (("prefix7",), 4),
    "- shift1 (2 shifts)": (("shift1",), 4),
    "- prefix - shift1": (("prefix", "shift1"), 4),
    "minimal (all knocked)": (("charcol", "bcast", "prefix", "shift1"), 4)}
STRIPES = [(64, 1, 4), (64, 2, 4), (64, 4, 4), (64, 8, 4), (32, 2, 4),
           (32, 4, 4), (64, 4, 2), (64, 4, 8)]  # kern_stripes.py:121-128,
# total_b cut from 256 and 128
LANES = [("A", 4), ("B", 4), ("C", 4), ("D", 4), ("E", 4), ("B", 8),
         ("C", 8)]  # kern_scalar.py:125-129
GH = [(1.0, 2.0), (2.0, 1.0), (1.0, 0.0)]


def _script(rel):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(rel).stem, ROOT / "scripts" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(x, y):
    return np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)


def t8(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.uint8))


def probe_bucket(B=8, m=24, n=300, seed=11, ragged=False):
    """The P-perm / P-ablate bucket: codes 65-68, a then b, every la = m;
    ``ragged`` draws lb from [n - 60, n]."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, size=(B, m)).astype(np.uint8)
    b = rng.integers(65, 69, size=(B, n)).astype(np.uint8)
    lb = (rng.integers(n - 60, n + 1, size=B) if ragged
          else np.full(B, n)).astype(np.int32)
    return a, b, np.full(B, m, np.int32), lb


def jax_rowscan(a, b, la, lb, params, perm):
    args, meta = rowscan_prep(a, b, la, lb, block_b=8, perm=perm)
    assert meta["uniform_la"] and meta["perm"] == perm
    g, h, match, mismatch = params.astuple()
    out = _pallas_rowscan(*args, g=g, h=h, match=match, mismatch=mismatch,
                          start_type=-1, interpret=True, **meta)
    return np.asarray(out)[: len(la), :3]


# ---------------------------------------------------------------- P-perm


@pytest.mark.parametrize("gh", GH, ids=[f"g{g:g}-h{h:g}" for g, h in GH])
def test_perm_matches_jax_permuted_rowscan(gh):
    """Both layouts' finals = the JAX permuted-layout K3' = its plain
    layout (attrib3_r5.py:209-211), ragged lb, W = 301 over 3 tiles."""
    a, b, la, lb = probe_bucket(ragged=True)
    params = ScoringParams(g=gh[0], h=gh[1], match=1.0, mismatch=0.0)
    want = jax_rowscan(a, b, la, lb, params, perm=True)
    assert same(want, jax_rowscan(a, b, la, lb, params, perm=False))
    for layout in rowprobe.LAYOUTS:
        for unroll in (4, 8):
            got = rowprobe.perm_finals(t8(a), t8(b), torch.from_numpy(lb),
                                       params, layout, unroll)
            assert same(got, want), (layout, unroll)


def test_perm_layouts_equal_k3p_twin_on_ragged_pairs():
    """CONTIGUOUS = STRIDED = K3''s twin (start type -1, la = m)."""
    a, b, la, lb = probe_bucket(B=9, m=40, n=130, seed=12, ragged=True)
    ta, tb, tla, tlb = (torch.from_numpy(np.ascontiguousarray(x))
                        for x in (a, b, la, lb))
    st = torch.full_like(tla, -1)
    k3p = rowcb.rowscan_score_fill(ta, tb, tla, tlb, st, ScoringParams())
    for layout in rowprobe.LAYOUTS:
        assert torch.equal(rowprobe.perm_finals(ta, tb, tlb, layout=layout),
                           k3p)


# ---------------------------------------------------------------- P-ablate


def _variant_kernel(a_ref, bext_ref, lbmask_ref, la_ref, out_ref, *, mode,
                    K, nl, g, h, match, mismatch, start_type, m, unroll=4):
    """scripts/probes/attrib_r5.py:65-143 ``variant_kernel``, its closure
    (nl, g, h, match, mismatch, start_type, m) passed in."""
    bb = bext_ref.shape[0]
    jj = jax.lax.broadcasted_iota(jnp.int32, (bb, nl), 1)
    b_ext = bext_ref[...]
    lbmask = lbmask_ref[...] != 0
    gf, hf = jnp.float32(g), jnp.float32(h)
    neg_inf = jnp.float32(NEG_INF)
    lane0 = jj == 0
    jg = gf * jj.astype(jnp.float32)
    r1 = jnp.where(lane0, jnp.float32(0.0), neg_inf)
    r2 = jnp.where(lane0, neg_inf, _row0_t2(jj, gf, hf, start_type))
    r3 = jnp.full((bb, nl), neg_inf)

    shift = (lambda x: x) if mode in ("noshift", "nochar_noshift") \
        else _shift_right_neg

    def row_step(i, t123):
        p1, p2, p3 = t123
        if mode in ("nochar", "nochar_noshift"):
            a_col = jnp.full((bb, 1), 1, jnp.int32) * (i & 3) + 65
        else:
            a_col = _char_col(a_ref, i - 1)
        if mode == "nofb":
            fb = jnp.float32(1.0) + jnp.float32(0.0) * p1[:, 0:1]
        else:
            fb = jnp.where(b_ext == a_col, jnp.float32(match),
                           jnp.float32(mismatch))
        mp12 = jnp.maximum(p1, p2)
        t1 = fb + shift(jnp.maximum(mp12, p3))
        if mode == "not3":
            t3 = p3 - gf
        else:
            t3 = jnp.maximum(mp12 - gf - hf, p3 - gf)
        if mode != "noboundary":
            t1 = jnp.where(lane0, neg_inf, t1)
            t3 = jnp.where(lane0, _col0_t3(i, gf, hf, start_type), t3)
        m13 = shift(jnp.maximum(t1, t3))
        omega = jg + m13 - gf - hf
        if mode == "nopm":
            pm = omega
        else:
            pm = _lane_prefix_max(omega, nl)
        if mode == "noboundary":
            t2 = pm - jg
        else:
            t2 = jnp.where(lane0, neg_inf, pm - jg)
        return (t1, t2, t3)

    if mode in ("chain", "indep"):
        def body(s, pq):
            t123 = _unpack3(pq, nl)
            p1, p2, p3 = t123
            if mode == "chain":
                x = p1
                for _ in range(K):
                    x = jnp.maximum(x + jnp.float32(0.5), p2)
                p1 = x
            else:
                ys = [p1, p2, p3, p1 + jnp.float32(0.25)]
                for _ in range(K // 4):
                    ys = [y + jnp.float32(0.5) for y in ys]
                p1 = jnp.maximum(jnp.maximum(ys[0], ys[1]),
                                 jnp.maximum(ys[2], ys[3]))
            return _pack3((p1, p2, p3))

        pq = jax.lax.fori_loop(0, m, body, _pack3((r1, r2, r3)))
    else:
        def body(s, pq):
            t123 = _unpack3(pq, nl)
            for u in range(unroll):
                t123 = row_step(s * unroll + u + 1, t123)
            return _pack3(t123)

        pq = jax.lax.fori_loop(0, m // unroll, body, _pack3((r1, r2, r3)))
    t123 = _unpack3(pq, nl)
    finals = [jnp.max(jnp.where(lbmask, t, neg_inf), axis=-1, keepdims=True)
              for t in t123]
    out_ref[...] = _emit_row(finals)


def jax_variant(a, b, la, lb, mode, K=0):
    """``run_variant`` (attrib_r5.py:150-174) in interpret mode."""
    args, meta = rowscan_prep(a, b, la, lb, block_b=8, carries=7)
    a_pad, b_ext, lbmask, la_t = args
    nl, block_b = meta["nl"], meta["block_b"]
    kern = functools.partial(
        _variant_kernel, mode=mode, K=K, nl=nl, g=1.0, h=2.0, match=1.0,
        mismatch=0.0, start_type=-1, m=meta["m"])
    spec = lambda w: pl.BlockSpec((block_b, w), lambda i: (i, 0))  # noqa
    out = pl.pallas_call(
        kern, grid=(a_pad.shape[0] // block_b,),
        in_specs=[spec(a_pad.shape[1]), spec(nl), spec(nl), spec(128)],
        out_specs=spec(128),
        out_shape=jax.ShapeDtypeStruct((a_pad.shape[0], 128), jnp.float32),
        interpret=True)(a_pad, b_ext, lbmask, la_t)
    return np.asarray(out)[: len(la), :3]


def ablate_port(a, b, lb, mode, K=0):
    return rowprobe.ablate_finals(t8(a), t8(b), torch.from_numpy(lb), mode,
                                  K)


def test_ablate_full_matches_jax_rowscan():
    a, b, la, lb = probe_bucket(ragged=True)
    want = jax_rowscan(a, b, la, lb, rowprobe.PROBE_PARAMS, perm=False)
    assert same(ablate_port(a, b, lb, "full"), want)
    assert same(jax_variant(a, b, la, lb, "full"), want)


@pytest.mark.parametrize("mode", [m for m in rowprobe.ABLATE if m != "full"])
def test_ablate_modes_match_variant_kernel(mode):
    """Each row_step mode against the transcribed ``variant_kernel``;
    ``nofb`` is NaN on the JAX side too (its max propagates NaN)."""
    a, b, la, lb = probe_bucket(ragged=True)
    want = jax_variant(a, b, la, lb, mode)
    assert np.isnan(want).any() == (mode == "nofb")
    assert same(ablate_port(a, b, lb, mode), want)


@pytest.mark.parametrize("mode,K", [(k, K) for k, Ks in rowprobe.FLOORS.items()
                                    for K in Ks])
def test_ablate_floors_match_variant_kernel(mode, K):
    a, b, la, lb = probe_bucket(ragged=True)
    assert same(ablate_port(a, b, lb, mode, K),
                jax_variant(a, b, la, lb, mode, K))


# ------------------------------------------------- module-level kernels


def run_module_kernel(mod, globals_, kernel_kw, *arrays):
    """``mod._kernel`` under shrunk globals in an interpret-mode
    ``pallas_call`` over whole arrays: its (8, 128) window."""
    with mock.patch.multiple(mod, **globals_):
        kern = functools.partial(mod._kernel, **kernel_kw)
        out = pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)(*arrays)
        return np.asarray(out)


def ext_codes(B, seed=7):
    """The stripes / lane-0 b_ext: codes 60-69 over every column."""
    return np.random.default_rng(seed).integers(
        60, 70, size=(B, NL)).astype(np.int32)


@pytest.fixture(scope="module")
def kern_stripes():
    return _script("kern_stripes.py")


@pytest.fixture(scope="module")
def kern_attrib():
    return _script("kern_attrib.py")


@pytest.fixture(scope="module")
def kern_scalar():
    return _script("kern_scalar.py")


@pytest.mark.parametrize("total_b,stripes,unroll", STRIPES)
def test_stripes_match_kern_stripes(kern_stripes, total_b, stripes, unroll):
    b_ext = ext_codes(total_b)
    want = run_module_kernel(kern_stripes, dict(M=M, NL=NL), dict(
        total_b=total_b, stripes=stripes, unroll=unroll), b_ext)
    got = rowprobe.stripes_fill(t8(b_ext), stripes, unroll, rows=M)
    assert got.shape == (total_b, NL)
    assert same(got[:8, :128], want)


def knock_inputs(B=16, n=200, seed=7):
    """kern_attrib's layout cut to size: a (B, M), a_pad with PAD_A to
    a 128-multiple + 128, b_ext with PAD_B at column 0 and past n."""
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, size=(B, M)).astype(np.int32)
    b = rng.integers(65, 69, size=(B, n)).astype(np.int32)
    a_pad = np.full((B, 256), PAD_A, np.int32)
    a_pad[:, :M] = a
    b_ext = np.full((B, NL), PAD_B, np.int32)
    b_ext[:, 1: n + 1] = b
    return a, a_pad, b_ext


@pytest.mark.parametrize("case", list(KNOCKS))
def test_knock_matches_kern_attrib(kern_attrib, case):
    knock, unroll = KNOCKS[case]
    a, a_pad, b_ext = knock_inputs()
    want = run_module_kernel(kern_attrib, dict(M=M, NL=NL), dict(
        knock=set(knock), unroll=unroll), a_pad, b_ext)
    got = rowprobe.knock_fill(t8(a), t8(b_ext), knock, unroll)
    assert got.shape == (16, NL)
    assert same(got[:8, :128], want)


@pytest.mark.parametrize("mode,unroll", LANES)
def test_lane0_matches_kern_scalar(kern_scalar, mode, unroll):
    b_ext = ext_codes(16)
    want = run_module_kernel(kern_scalar, dict(M=M, NL=NL, B=16), dict(
        mode=mode, unroll=unroll), b_ext)
    got = rowprobe.lane0_fill(t8(b_ext), mode, unroll, rows=M)
    assert same(got[:8, :128], want)


def test_stripes_equal_lane0_a_c_d_and_k3p():
    """Stripes at every S = lane-0 A = C = D (C's carried column and D's
    open T3 give -h - g*i at g = 1, h = 2); B and E differ; each pair's
    row at column j is K3''s max3 at (M, j) with A all 65."""
    b_ext = t8(ext_codes(16))
    want = rowprobe.lane0_fill(b_ext, "A", rows=M)
    for s in (1, 2, 4, 8):
        assert torch.equal(rowprobe.stripes_fill(b_ext, s, rows=M), want)
    for mode in "CD":
        assert torch.equal(rowprobe.lane0_fill(b_ext, mode, rows=M), want)
    for mode in "BE":
        assert not torch.equal(rowprobe.lane0_fill(b_ext, mode, rows=M),
                               want)
    a = torch.full((16, M), 65, dtype=torch.uint8)
    la = torch.full((16,), M, dtype=torch.int32)
    for j in (1, 77, NL - 1):
        lb = torch.full((16,), j, dtype=torch.int32)
        fin = rowcb.rowscan_score_fill(a, b_ext[:, 1:].contiguous(), la, lb,
                                       torch.full_like(la, -1),
                                       ScoringParams())
        assert torch.equal(fin.max(dim=1).values, want[:, j]), j


# ------------------------------------------------------------ the kernels


def test_instances_are_the_sources():
    """``INSTANCES`` and ``FLOOR_INSTANCES`` list exactly what
    csrc/rowprobe.cu instantiates."""
    text = (ROOT / "cse305_parallel_sequence_alignment_torch" / "csrc"
            / "rowprobe.cu").read_text()
    cname = {"charcol": "kCharcol", "bcast": "kBcast", "shift1": "kShift1",
             "prefix": "kPrefix", "prefix7": "kPrefix7", "nochar": "kNochar",
             "nofb": "kNofb", "not3": "kNot3", "noboundary": "kNoBoundary",
             "aligned": "kAligned", "smemscan": "kSmemScan",
             "smemhalo": "kSmemHalo", "twocta": "kTwoCta"}
    fname = {"indep": "kIndep", "chain": "kChain", "live": "kLive",
             "chain_i32": "kChainI32", "chain_i16": "kChainI16"}
    names = {cname[k]: v for k, v in rowprobe.KNOCK.items()}
    names.update({"kK3p" if k == "K3P" else f"kLane{k}": v
                  for k, v in rowprobe.LANE0.items()})
    names.update(kContig=rowprobe.LAYOUTS["contiguous"],
                 kStrided=rowprobe.LAYOUTS["strided"])
    names.update({fname[k]: v for k, v in rowprobe.FLOOR_MODES.items()})
    for name, v in names.items():
        assert re.search(rf"\b{name} = {v}\b", text), name

    def value(expr):
        return sum(names[t.strip()] if not t.strip().isdigit()
                   else int(t) for t in expr.split("|"))

    rp = {tuple(value(x) for x in m.split(","))
          for m in re.findall(r"^\s*RP\(([^)]*)\)$", text, re.M)}
    fl = {tuple(value(x) for x in m.split(","))
          for m in re.findall(r"^\s*FL\(([^)]*)\)$", text, re.M)}
    assert rp == rowprobe.INSTANCES
    assert fl == rowprobe.FLOOR_INSTANCES


def test_ptxas_report_names_each_instantiation():
    """``_build.parse_ptxas`` names a template kernel by its arguments and
    reads its registers, stack and spills (the report ``resource_usage``
    takes from a ``-Xptxas -v`` compile of csrc/rowprobe.cu)."""
    from cse305_parallel_sequence_alignment_torch.ops import _build
    report = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__bf19588b"
        "_11_rowprobe_cu_4bafdc9314replica_kernelILi0ELi1ELi0ELi8ELi4EEEvPKhS"
        "2_PKiPfiiiiiffff' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN44_GLOBAL__N__bf19588b_11"
        "_rowprobe_cu_4bafdc9314replica_kernelILi0ELi1ELi0ELi8ELi4EEEvPKhS2_P"
        "KiPfiiiiiffff",
        "    1104 bytes stack frame, 5524 bytes spill stores, 6508 bytes "
        "spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers, 1104 bytes "
        "cumulative stack size, 10240 bytes smem",
        "ptxas info    : Function properties for _ZN44_GLOBAL__N__bf19588b_11"
        "_rowprobe_cu_4bafdc9312floor_kernelILb1ELi34EEEvPKiPfiff",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers, used 0 barriers"])
    assert _build.parse_ptxas(report) == {
        "replica_kernel<0,1,0,8,4>": (56, 1104, 5524, 6508),
        "floor_kernel<1,34>": (24, 0, 0, 0)}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, b, _, lb = probe_bucket()
    ta, tb, tlb = t8(a), t8(b), torch.from_numpy(lb)
    with pytest.raises(ValueError, match="knock-out"):
        rowprobe.knock_fill(ta, tb, ("nosuch",))
    with pytest.raises(ValueError, match="no instantiation"):
        rowprobe.knock_fill(ta, tb, ("nofb",), unroll=8)
    with pytest.raises(ValueError, match="no instantiation"):
        rowprobe.stripes_fill(tb, 3)
    with pytest.raises(ValueError, match="mode"):
        rowprobe.ablate_finals(ta, tb, tlb, "nosuch")
    with pytest.raises(ValueError, match="K of"):
        rowprobe.ablate_finals(ta, tb, tlb, "chain", 5)
    with pytest.raises(ValueError, match="lane-0"):
        rowprobe.lane0_fill(tb, "K3P")
    with pytest.raises(ValueError, match="mode E"):
        rowprobe.lane0_fill(tb, "E", rows=b.shape[1] + 1)
    with pytest.raises(ValueError, match="uint8"):
        rowprobe.perm_finals(ta.to(torch.int32), tb, tlb)
    with pytest.raises(ValueError, match="int32"):
        rowprobe.perm_finals(ta, tb, tlb.to(torch.int64))
    assert rowprobe.threads_for(2049) == 544
    assert rowprobe.threads_for(2176, 8) == 544
    with pytest.raises(ValueError, match="columns"):
        rowprobe.threads_for(2177, 4)


@pytest.mark.cuda
def test_rowprobe_kernels_match_plain_on_card():
    """Every instantiation against its plain twin on the card (NaN equal
    to NaN), at 16 pairs x 2 kb and on a ragged width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (2048, 1000):
        a, b, _, lb = probe_bucket(B=16, m=256, n=n, ragged=True)
        cpu = [t8(a), t8(b), torch.from_numpy(lb)]
        cuda = [x.cuda() for x in cpu]
        for layout in rowprobe.LAYOUTS:
            for u in (4, 8):
                assert same(rowprobe.perm_finals(*cuda, layout=layout,
                                                 unroll=u).cpu(),
                            rowprobe.perm_finals(*cpu))
        for mode in rowprobe.ABLATE:
            assert same(rowprobe.ablate_finals(*cuda, mode).cpu(),
                        rowprobe.ablate_finals(*cpu, mode)), mode
        for mode, Ks in rowprobe.FLOORS.items():
            for K in Ks:
                assert same(rowprobe.ablate_finals(*cuda, mode, K).cpu(),
                            rowprobe.ablate_finals(*cpu, mode, K))
        ext = np.random.default_rng(7).integers(60, 70, (16, n + 1))
        ecpu = t8(ext)
        ecuda = ecpu.cuda()
        want = rowprobe.stripes_fill(ecpu, 1, rows=256)
        for _, s, u in STRIPES:
            assert same(rowprobe.stripes_fill(ecuda, s, u, rows=256).cpu(),
                        want)
        for mode, u in LANES:
            assert same(rowprobe.lane0_fill(ecuda, mode, u, rows=256).cpu(),
                        rowprobe.lane0_fill(ecpu, mode, rows=256))
        kext = torch.cat([torch.full((16, 1), PAD_B, dtype=torch.uint8),
                          cpu[1]], dim=1)
        for knock, u in KNOCKS.values():
            assert same(rowprobe.knock_fill(cuda[0], kext.cuda(), knock,
                                            u).cpu(),
                        rowprobe.knock_fill(cpu[0], kext, knock))
