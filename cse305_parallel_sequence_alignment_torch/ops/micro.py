"""Op-cost micro-probes: P-micro and P-micro2, a dependent loop of one
class of vector operation, timed at two step counts so that the launch
and the output drop out of the difference.

Each is the port of a TPU probe kernel:

- ``micro_loop`` (P-micro), the kernel ``_mk`` builds in scripts/
  kern_probe.py:31 (launched at :45): ``steps`` passes of ``ops``
  applications of one op class on x with y, then x = x * 0.5; the whole x
  (R, W) (the TPU kernel stored its window x[:8, :128]);
- ``micro_loop_max`` (P-micro2), the kernel of scripts/kern_probe2.py:26
  (launched at :40): the same loop ending x = max(x * 0.5, -1e30); the
  max of x over every element, a 0-d tensor (the TPU kernel stored it
  broadcast to (8, 128)).

``OPS`` names the classes (csrc/micro.cu lists what each computes), and
``INSTANCES`` the (class, axis, ops a step, end) the kernel is built for.
A shift, roll or prefix runs along ``axis`` (1: each row; 0: each
column); ``shift`` is the s of the shifts and rolls. The filled shifts
fill with -3.0e38 as float32, as the scripts' concatenates do.

The kernels are ``csrc/micro.cu`` (``micro_kernel``, and ``max_kernel``
for the second pass of P-micro2). A CPU tensor goes to the plain PyTorch
twin beside each wrapper; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cse305_parallel_sequence_alignment_torch.ops import _build

# csrc/micro.cu's op classes
OPS = {"add": 0, "mul": 1, "maxblend": 2, "where": 3, "chain": 4,
       "shift": 5, "roll": 6, "rollmask": 7, "prefix": 8,
       "prefix_hybrid": 9, "prefix_rollmask": 10, "pack": 11}
ENDS = {"half": 0, "floor": 1}  # x * 0.5; max(x * 0.5, -1e30)
NEGF = -3.0e38  # the probes' fill
SHIFTS = ("shift", "roll", "rollmask")
PREFIXES = ("prefix", "prefix_hybrid", "prefix_rollmask")
# csrc/micro.cu's instantiations: (op, axis, ops a step, end);
# tests/test_torch_micro.py holds this list equal to the source's
INSTANCES = frozenset(
    [(OPS[op], 1, 12, 0) for op in ("add", "mul", "maxblend", "where")
     + SHIFTS]
    + [(OPS[op], 1, 1, 0) for op in PREFIXES]                    # P-micro
    + [(OPS["chain"], 1, 16, 1), (OPS["shift"], 1, 12, 1),
       (OPS["shift"], 0, 12, 1), (OPS["roll"], 0, 12, 1),
       (OPS["prefix"], 1, 1, 1), (OPS["prefix"], 0, 1, 1),
       (OPS["pack"], 1, 4, 1)])                                  # P-micro2


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _shifted(x, s, cyclic, masked):
    """x moved s places along dim 1: ``torch.roll`` when ``cyclic``,
    else the vacated places filled with -3e38 (``masked``: roll, then the
    same fill)."""
    if cyclic:
        return torch.roll(x, s, 1)
    L = x.shape[1]
    if masked:
        keep = torch.arange(L, device=x.device) >= s
        return torch.where(keep, torch.roll(x, s % L, 1), _f32(NEGF,
                                                                x.device))
    fill = torch.full_like(x[:, :min(s, L)], NEGF)
    return torch.cat([fill, x[:, :L - min(s, L)]], dim=1)


def _apply(op, x, y, s, c099):
    """One application of ``op`` along dim 1."""
    if op == "add":
        return x + y
    if op == "mul":
        return x * y
    if op == "maxblend":
        return torch.maximum(x + y, x * c099)
    if op == "where":
        return torch.where(x > y, x + y, y)
    if op == "chain":
        return torch.maximum(x * c099, y + x)
    if op in SHIFTS:
        return _shifted(x, s, op == "roll", op == "rollmask") + y
    if op in PREFIXES:
        L, sh = x.shape[1], 1
        while sh < L:
            cyclic = op == "prefix_hybrid" and sh < 128
            x = torch.maximum(x, _shifted(x, sh, cyclic,
                                          op == "prefix_rollmask"))
            sh *= 2
        return x + y
    nl = x.shape[1] // 3  # pack
    a = x[:, :nl] + y[:, :nl]
    b = torch.maximum(x[:, nl:2 * nl], a)
    c = x[:, 2 * nl:] + b
    return torch.cat([a, b, c], dim=1)


def _loop_plain(x, y, op, ops, steps, shift, axis, end):
    if axis == 0:
        x, y = x.t(), y.t()
    dev = x.device
    c099, half, floor = (_f32(v, dev) for v in (0.99, 0.5, -1e30))
    for _ in range(steps):
        for _ in range(ops):
            x = _apply(op, x, y, shift, c099)
        x = x * half if end == "half" else torch.maximum(x * half, floor)
    return x.t().contiguous() if axis == 0 else x.contiguous()


def micro_loop_plain(x, y, op, ops, steps, shift=0, axis=1):
    """Plain PyTorch P-micro: x (R, W) after the loop."""
    return _loop_plain(x, y, op, ops, steps, shift, axis, "half")


def micro_loop_max_plain(x, y, op, ops, steps, shift=0, axis=1):
    """Plain PyTorch P-micro2: the max of x after the loop, 0-d."""
    return _loop_plain(x, y, op, ops, steps, shift, axis, "floor").max()


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/micro.cu: micro_run (4 pointers, then R,
    W, steps, s, op, axis, ops, end, stream)."""
    fn = _build.cuda_library("micro").micro_run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return fn


def line_length(shape, op, axis):
    """The length of the line a CTA owns (and exchanges)."""
    R, W = shape
    return W // 3 if op == "pack" else (W if axis == 1 else R)


def _check(x, y, op, ops, steps, shift, axis, end):
    if op not in OPS:
        raise ValueError(f"op {op!r}: pick from {sorted(OPS)}")
    if (OPS[op], axis, ops, ENDS[end]) not in INSTANCES:
        raise ValueError(f"csrc/micro.cu has no instantiation for {op} along "
                         f"axis {axis} at {ops} ops a step, end {end}")
    if x.dtype != torch.float32 or x.dim() != 2 or y.shape != x.shape or \
            y.dtype != x.dtype:
        raise ValueError(f"x and y must be (R, W) float32, got "
                         f"{tuple(x.shape)} {x.dtype}, {tuple(y.shape)} "
                         f"{y.dtype}")
    if y.device != x.device or not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous, on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    L = line_length(x.shape, op, axis)
    if op == "pack" and x.shape[1] % 3:
        raise ValueError(f"pack needs a width of three thirds, got "
                         f"{x.shape[1]}")
    if not 2 <= L <= 4096:
        raise ValueError(f"a line of {L}: csrc/micro.cu takes 2 to 4,096")
    if op in SHIFTS and not 0 < shift < L:
        raise ValueError(f"shift {shift} outside (0, {L})")
    if steps < 0:
        raise ValueError(f"steps {steps} < 0")


def _launch(x, y, op, ops, steps, shift, axis, end):
    R, W = x.shape
    lines = W if axis == 0 and op != "pack" else R
    dev = x.device
    if end == "half":
        out, cta = torch.empty_like(x), None
    else:
        out = torch.empty((1,), dtype=torch.float32, device=dev)
        cta = torch.empty((lines,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                       cta.data_ptr() if cta is not None else None, R, W,
                       steps, shift, OPS[op], axis, ops, ENDS[end],
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"micro_run({op}, axis {axis}, ops {ops}, {end})")
    return out


def micro_loop(x, y, op, ops, steps, shift=0, axis=1):
    """P-micro: x (R, W) after ``steps`` passes of ``ops`` applications of
    ``op`` (with ``shift`` for the shifts and rolls) along ``axis``, each
    pass ending x = x * 0.5."""
    _check(x, y, op, ops, steps, shift, axis, "half")
    if x.device.type == "cpu":
        return micro_loop_plain(x, y, op, ops, steps, shift, axis)
    out = _launch(x, y, op, ops, steps, shift, axis, "half")
    micro_loop.launches += 1
    return out


def micro_loop_max(x, y, op, ops, steps, shift=0, axis=1):
    """P-micro2: the max over x, 0-d, after ``steps`` passes of ``ops``
    applications of ``op`` along ``axis``, each pass ending x = max(x *
    0.5, -1e30)."""
    _check(x, y, op, ops, steps, shift, axis, "floor")
    if x.device.type == "cpu":
        return micro_loop_max_plain(x, y, op, ops, steps, shift, axis)
    out = _launch(x, y, op, ops, steps, shift, axis, "floor")
    micro_loop_max.launches += 1
    return out[0]


micro_loop.launches = 0
micro_loop_max.launches = 0
