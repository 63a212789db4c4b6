"""Port P-micro and P-micro2 (plain PyTorch) == the TPU micro-probe
kernels they replace.

scripts/kern_probe.py and scripts/kern_probe2.py are loaded as they are,
their ``pl`` swapped for one whose ``pallas_call`` runs in interpret mode
and their globals (NL, S_LO, S_HI) shrunk with ``mock.patch``, and their
own ``_mk`` builds each case's kernel: every op class of kern_probe.py
:153-170 and kern_probe2.py:128-156 at a reduced shape. Inputs come from
numpy seeds as the scripts draw them; tolerance 0, NaN equal to NaN.
"""

import functools
import importlib.util
import pathlib
import re
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cse305_parallel_sequence_alignment_torch.ops import micro
from cse305_parallel_sequence_alignment_torch.probes import micro as probe

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 6  # the scripts' S_LO, cut to size
SHAPE1 = (8, 1152)  # kern_probe.py's (BLOCK_B, NL), cut to size (> 1,024)
# the script's functions for each case of probes/micro.py PROBE1
SCRIPT1 = {"add x+y": ("op_add",), "mul x*y": ("op_mul",),
           "max blend (2 ops)": ("op_max",), "where (2 ops)": ("op_where",),
           "concat s=1 +y": ("op_concat", 1),
           "concat s=8 +y": ("op_concat", 8),
           "concat s=64 +y": ("op_concat", 64),
           "concat s=128 +y": ("op_concat", 128),
           "concat s=1024 +y": ("op_concat", 1024),
           "roll s=1 +y": ("op_roll", 1), "roll s=64 +y": ("op_roll", 64),
           "roll s=128 +y": ("op_roll", 128),
           "roll masked s=1 +y": ("op_roll_masked", 1),
           "FULL prefix concat": ("op_prefix_logshift",),
           "FULL prefix hybrid": ("op_prefix_hybrid",),
           "FULL prefix rollmask": ("op_prefix_rollmask",)}
# the script's function for each (op, axis) of probes/micro.py PROBE2
SCRIPT2 = {("chain", 1): "op_chain", ("shift", 1): "op_lane_concat",
           ("shift", 0): "op_sub_concat", ("roll", 0): "op_sub_roll",
           ("prefix", 1): "op_prefix_lane", ("prefix", 0): "op_prefix_sub",
           ("pack", 1): "op_packunpack"}


def _script(rel):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(rel).stem, ROOT / "scripts" / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpreted(mod, **globals_):
    """``mod`` with its ``pallas_call`` in interpret mode and its globals
    shrunk."""
    fake = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mock.patch.multiple(mod, pl=fake, **globals_)


def same(x, y):
    return np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True)


def op_fn(mod, spec):
    fn = getattr(mod, spec[0])
    return fn(*spec[1:]) if len(spec) > 1 else fn


@pytest.fixture(scope="module")
def kern_probe():
    return _script("kern_probe.py")


@pytest.fixture(scope="module")
def kern_probe2():
    return _script("kern_probe2.py")


@pytest.mark.parametrize("case", probe.PROBE1,
                         ids=[c[0] for c in probe.PROBE1])
def test_micro_matches_kern_probe(kern_probe, case):
    """Each class's loop (the script's ``_mk``) = ``micro_loop`` on the
    window the script stores, x[:8, :128]; inputs as its ``main`` draws
    them (seed 0, y = 1e-6 * normal)."""
    name, op, ops, shift = case
    x, y = probe.data(SHAPE1, probe.Y1, torch.device("cpu"))
    with interpreted(kern_probe, NL=SHAPE1[1], S_LO=STEPS, S_HI=2 * STEPS):
        fn = op_fn(kern_probe, SCRIPT1[name])
        want = kern_probe._mk(fn, ops, kern_probe.S_LO)(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    got = micro.micro_loop(x, y, op, ops, STEPS, shift)
    assert got.shape == SHAPE1
    assert same(got[:8, :128], want)


@pytest.mark.parametrize("case", probe.PROBE2,
                         ids=[c[0] for c in probe.PROBE2])
def test_micro2_matches_kern_probe2(kern_probe2, case):
    """Each case's loop (the script's ``_mk``, its max broadcast to (8,
    128)) = ``micro_loop_max``, at ``small_shape`` (2,176 to 272, 256 to
    16, 64 to 4); inputs as its ``measure`` draws them (seed 0, y = 1e-3
    * normal)."""
    name, op, ops, shift, axis, shape = case
    shape = probe.small_shape(shape)
    x, y = probe.data(shape, probe.Y2, torch.device("cpu"))
    fn = getattr(kern_probe2, SCRIPT2[(op, axis)])
    if op in micro.SHIFTS:
        fn = fn(shift)
    with interpreted(kern_probe2, S_LO=STEPS, S_HI=2 * STEPS):
        want = np.asarray(kern_probe2._mk(fn, ops, kern_probe2.S_LO, shape)(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    assert (want == want[0, 0]).all()
    got = micro.micro_loop_max(x, y, op, ops, STEPS, shift, axis)
    assert got.shape == ()
    assert same(got, want[0, 0])


def test_prefix_classes_compute_what_the_scripts_compute():
    """The filled and masked-roll prefixes are cummax(x) + y; the hybrid's
    cyclic strides under 128 make columns j with j mod 128 < 127 take
    values from the end of the row (kern_probe.py:125)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 384)).astype(np.float32))
    y = torch.zeros_like(x)
    x[:, -1] = 100.0  # the end of each row
    x[:, 0] = -100.0
    full = micro.micro_loop(x, y, "prefix", 1, 1)
    assert torch.equal(full, torch.cummax(x, 1).values * 0.5)
    assert torch.equal(micro.micro_loop(x, y, "prefix_rollmask", 1, 1), full)
    hyb = micro.micro_loop(x, y, "prefix_hybrid", 1, 1)
    cols = torch.arange(384)
    assert torch.equal(hyb[:, cols % 128 < 127], torch.full_like(
        hyb[:, cols % 128 < 127], 50.0))
    assert torch.equal(hyb[:, cols % 128 == 127], full[:, cols % 128 == 127])


def test_micro_instances_are_the_source():
    """``OPS`` and ``INSTANCES`` are what csrc/micro.cu names and
    instantiates."""
    text = (ROOT / "cse305_parallel_sequence_alignment_torch" / "csrc"
            / "micro.cu").read_text()
    cname = {"add": "kAdd", "mul": "kMul", "maxblend": "kMaxBlend",
             "where": "kWhere", "chain": "kChain", "shift": "kShift",
             "roll": "kRoll", "rollmask": "kRollMask", "prefix": "kPrefix",
             "prefix_hybrid": "kPrefixHybrid",
             "prefix_rollmask": "kPrefixRollMask", "pack": "kPack"}
    names = {cname[k]: v for k, v in micro.OPS.items()}
    for name, v in names.items():
        assert re.search(rf"\b{name} = {v}\b", text), name
    found = {tuple(names.get(t.strip(), None) if not t.strip().isdigit()
                   else int(t) for t in m.split(","))
             for m in re.findall(r"^\s*MI\(([^)]*)\)$", text, re.M)}
    assert found == micro.INSTANCES
    # every case of both probes has its instantiation
    for _, op, ops, _ in probe.PROBE1:
        assert (micro.OPS[op], 1, ops, 0) in micro.INSTANCES
    for _, op, ops, _, axis, _ in probe.PROBE2:
        assert (micro.OPS[op], axis, ops, 1) in micro.INSTANCES


def test_micro_wrappers_refuse_what_the_kernels_do_not_take():
    x, y = probe.data((4, 300), 1e-3, torch.device("cpu"))
    with pytest.raises(ValueError, match="op"):
        micro.micro_loop(x, y, "nosuch", 12, 1)
    with pytest.raises(ValueError, match="no instantiation"):
        micro.micro_loop(x, y, "add", 11, 1)
    with pytest.raises(ValueError, match="no instantiation"):
        micro.micro_loop_max(x, y, "roll", 12, 1, 1, axis=1)
    with pytest.raises(ValueError, match="shift"):
        micro.micro_loop(x, y, "shift", 12, 1, 300)
    with pytest.raises(ValueError, match="thirds"):
        micro.micro_loop_max(x[:, :299].contiguous(), y[:, :299].contiguous(),
                             "pack", 4, 1)
    with pytest.raises(ValueError, match="float32"):
        micro.micro_loop(x.double(), y.double(), "add", 12, 1)
    assert micro.line_length((2176, 256), "prefix", 0) == 2176
    assert micro.line_length((256, 6528), "pack", 1) == 2176


@pytest.mark.cuda
def test_micro_kernels_match_plain_on_card():
    """Every case of both probes against its twin on the card, at 64 steps
    on 16 lines of the full shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for c in probe.cases(torch.device("cuda")):
        assert probe.check(c), c.name
