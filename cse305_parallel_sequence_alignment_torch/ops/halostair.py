"""One step of the column-sharded long-pair pipeline (K8).

``halostair_step`` is the port of the TPU kernel ``_halostair_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_halostair.py:93,
launched by ``halostair_step`` :243): one macro-step of one mesh entry
of ``parallel/longseq.py``'s pipeline, which advances the rows base+1 ..
base+R of the entry's column block [cs, cs + nc) of the global grid
(column 0 included on the first entry).

Inputs, on one device:
- ``a``: (R,) uint8 codes of the rows base+1 .. base+R (padding past m);
- ``b``: (nc,) uint8 codes of the block's columns (global column j > 0
  holds B[j-1]; column 0 holds any code, its T1 is -inf);
- ``halo_in``: (R+1, 4) float32 records of global column cs-1, one a
  row, ``[max(T1, T3), prefix max of omega, H = max3, -inf]``; row 0 is
  row base, of which only H is read: the diagonal carry H(base, cs-1).
  The first entry gets -inf throughout (there is no column left of 0);
- ``state``: (2, nc) float32, the row carry (H, T3) of row base;
- ``fin``: (3, nc) float32, T1, T2 and T3 of row ``la``, captured when
  it falls into the step's rows.

The step returns ``halo_out``, the same records of the block's last
column (its row 0 is H(base, cs + nc - 1)), which the next mesh entry
reads at the next pipeline step, and advances ``state`` and ``fin`` in
place (the JAX kernel returns them; the pipeline owns them here). Rows
past ``la`` are not computed and their records stay -inf.

The arithmetic is K8's own 2-carry form, in float32, in the order that
XLA runs for the JAX kernel: it folds omega's ``g*j - g - h`` into
``g*j - gh`` with ``gh = g + h`` rounded to float32, and leaves T3's
``H - g - h`` as two subtractions:

    T1 = f(A[i], B[j]) + H(i-1, j-1)
    T3 = max((H(i-1, j) - g) - h, T3(i-1, j) - g)   (column 0: closed form)
    omega = (g*j - gh) + max(T1, T3)(i, j-1)
    T2 = max(prefix max of omega, record's prefix max) - g*j
    H = max(max(T1, T3), T2)

It equals the 3-table recurrence only for h >= 0 (the open from H
dominates the open from T3), which is why the pipeline takes its plain
row body for h < 0.
Every cell is a function of its neighbours and of the exact prefix max,
so the result depends on neither R, the number of mesh entries nor the
strip width.

The kernel (``csrc/halostair.cu`` ``rows_kernel<C>``) keeps each
thread's C columns of the rows in registers, makes one pass and crosses
one barrier a row, and cuts the block into strips (one CTA each, 24 to
55 at the pipeline's widths) that hand each other a record every row;
``halostair_geometry`` picks (C, threads, strips). The plain version
(``halostair_step_plain``) runs the same operations row by row with
``torch.cummax`` for the prefix max. A CPU tensor goes to the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cse305_parallel_sequence_alignment_torch.core import NEG_INF
from cse305_parallel_sequence_alignment_torch.ops import _build
from cse305_parallel_sequence_alignment_torch.ops.rowcb import SMS

# csrc/halostair.cu rows_kernel: columns a thread, and the most threads a
# strip takes at each (its __launch_bounds__)
ROWS_C = (4, 8, 16)
ROWS_THREADS = {4: 512, 8: 512, 16: 256}
# The row step's time on an H100 (us), a + b * warps of the strip, and
# the cost of a strip boundary (us): the least squares fit of
# chip_smoke.py's K8 sweep (256 rows at 24,503 and 98,010 columns, each C
# at 128 to 512 threads; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
ROW_US = {4: (0.71, 0.0137), 8: (0.94, 0.018), 16: (1.01, 0.036)}
LINK_US = 0.22


def _row0(j, start_type, g, h):
    """Row 0 at global columns ``j`` (float32 tensor, j > 0): T2's closed
    form, which is also H there (T1 = T3 = -inf off column 0)."""
    if start_type == -2:
        return -g * j
    if start_type in (1, 3):
        return torch.full_like(j, NEG_INF)
    return -h - g * j


def _corner(start_type):
    """max(T1, T2, T3) of cell (0, 0)."""
    return 0.0 if start_type in (1, -1, -2, -3) else NEG_INF


def halostair_init(cs, nc, start_type, params, device):
    """The carries of row 0 for the block [cs, cs + nc): (state (2, nc),
    fin (3, nc) of -inf, halo0 (4,)), where ``halo0`` is the record of
    row 0 at the left ghost column cs-1, [-inf, -inf, H(0, cs-1), -inf]
    (H -inf on the first block, which has no column left of 0; the corner
    when cs-1 is column 0). The JAX kernel carries that ghost in the MP
    plane of ``rec_prev`` (``halostair_init`` :343-349); here it is row
    0 of the left neighbour's halo."""
    f32 = torch.float32
    g = torch.tensor(params.g, dtype=f32)
    h = torch.tensor(params.h, dtype=f32)
    jf = torch.arange(cs - 1, cs + nc, dtype=f32)
    H = _row0(jf, start_type, g, h)
    if cs <= 1:  # column 0 in this range: the corner
        H[1 - cs] = _corner(start_type)
    if cs == 0:
        H[0] = NEG_INF
    T3 = torch.full((nc,), NEG_INF, dtype=f32)
    if cs == 0 and start_type == -3:
        T3[0] = 0.0
    halo0 = torch.tensor([NEG_INF, NEG_INF, float(H[0]), NEG_INF],
                         dtype=f32)
    state = torch.stack([H[1:], T3])
    fin = torch.full((3, nc), NEG_INF, dtype=f32)
    return state.to(device), fin.to(device), halo0.to(device)


def _col0_t3(i, start_type, g, h):
    """T3 at column 0 of row ``i`` (``core.boundary_col0``)."""
    if start_type == -3:
        return -g * i
    if start_type in (1, 2):
        return torch.full_like(i, NEG_INF)
    return -h - g * i


def _check(a, b, halo_in, state, fin, base, la):
    R, nc = a.shape[0], b.shape[0]
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or a.dim() != 1 \
            or b.dim() != 1:
        raise TypeError("a and b must be 1-D uint8 code tensors")
    for name, v, shape in (("halo_in", halo_in, (R + 1, 4)),
                           ("state", state, (2, nc)), ("fin", fin, (3, nc))):
        if v.dtype != torch.float32 or tuple(v.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(v.shape)} {v.dtype}")
    for v in (a, b, halo_in, state, fin):
        if v.device != a.device:
            raise ValueError("all inputs must be on one device")
        if not v.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if R < 1 or la - base < 1:
        raise ValueError(f"no row to fill: R {R}, base {base}, la {la}")


def halostair_step_plain(a, b, halo_in, state, fin, cs, base, la,
                         start_type, params):
    """Plain PyTorch K8 (see the module docstring)."""
    R, nc = a.shape[0], b.shape[0]
    dev = a.device
    f32 = torch.float32
    g, h, match, mismatch = (torch.tensor(float(x), dtype=f32, device=dev)
                             for x in params.astuple())
    gh = g + h
    jg = g * torch.arange(cs, cs + nc, dtype=f32, device=dev)
    jgc = jg - gh
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    halo_out = torch.full((R + 1, 4), NEG_INF, dtype=f32, device=dev)
    hp, t3p = state[0].clone(), state[1].clone()
    halo_out[0, 2] = hp[-1]
    diag = halo_in[0, 2:3]
    for r in range(1, min(R, la - base) + 1):
        rec = halo_in[r]
        fb = torch.where(b32 == a32[r - 1], match, mismatch)
        t1 = fb + torch.cat([diag, hp[:-1]])
        t3 = torch.maximum((hp - g) - h, t3p - g)
        if cs == 0:
            t3[0] = _col0_t3(torch.tensor(float(base + r), dtype=f32,
                                          device=dev), start_type, g, h)
        m13 = torch.maximum(t1, t3)
        omega = jgc + torch.cat([rec[0:1], m13[:-1]])
        pm = torch.maximum(torch.cummax(omega, 0).values, rec[1])
        t2 = pm - jg
        hn = torch.maximum(m13, t2)
        if base + r == la:
            fin.copy_(torch.stack([t1, t2, t3]))
        halo_out[r, 0], halo_out[r, 1], halo_out[r, 2] = m13[-1], pm[-1], \
            hn[-1]
        hp, t3p, diag = hn, t3, rec[2:3]
    state[0], state[1] = hp, t3p
    return halo_out


def strips_of(nc, C, threads):
    """Strips of ``threads * C`` columns that cover ``nc``."""
    return -(-nc // (threads * C))


def geometry_cost(nc, R, C, threads):
    """Modelled us of a call of R rows at (C, threads): R + S - 1 row
    steps on the critical path, and S - 1 strip boundaries."""
    S = strips_of(nc, C, threads)
    a, b = ROW_US[C]
    return (R + S - 1) * (a + b * threads / 32) + (S - 1) * LINK_US


def halostair_geometries(nc):
    """Every (C, threads) of ``rows_kernel`` worth a look at ``nc``
    columns: for each C and strip count up to the card's SMs (a strip
    each), the fewest whole warps that cover the block in that many
    strips."""
    out = set()
    for C in ROWS_C:
        s_min = strips_of(nc, C, ROWS_THREADS[C])
        s_max = max(s_min, min(SMS, -(-nc // (32 * C))))
        for S in range(s_min, s_max + 1):
            threads = -(-nc // (S * C * 32)) * 32
            if threads <= ROWS_THREADS[C]:
                out.add((C, threads))
    return sorted(out)


@functools.lru_cache(maxsize=256)
def halostair_geometry(nc, R):
    """(C, threads, strips) of ``rows_kernel`` for a call of R rows over
    ``nc`` columns: the least modelled time (``geometry_cost``), ties to
    fewer strips, then the smaller C. A pure function, cached: the
    pipeline asks it once a call."""
    if nc < 1 or R < 1:
        raise ValueError(f"no cells: nc {nc}, R {R}")
    C, threads = min(halostair_geometries(nc), key=lambda g: (
        geometry_cost(nc, R, *g), strips_of(nc, *g), g[0]))
    return C, threads, strips_of(nc, C, threads)


@functools.lru_cache(maxsize=None)
def _entry():
    """ctypes entry point of csrc/halostair.cu ``halostair_step`` (8
    pointers, 10 ints, 4 floats, stream)."""
    fn = _build.cuda_library("halostair").halostair_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def _launch(a, b, halo_in, state, fin, cs, base, la, start_type, params,
            geometry=None):
    """Launch ``rows_kernel`` at ``geometry`` (C, threads, strips),
    ``halostair_geometry``'s by default; returns ``halo_out``. Counts
    nothing (``halostair_step`` does)."""
    R, nc = a.shape[0], b.shape[0]
    dev = a.device
    C, threads, nstrips = geometry or halostair_geometry(nc, R)
    halo_out = torch.full((R + 1, 4), NEG_INF, dtype=torch.float32,
                          device=dev)
    # the strips' link lines (16 bytes a row), then the CTA ticket
    link = torch.zeros((max(nstrips - 1, 1) * (R + 1) + 1, 4),
                       dtype=torch.int32, device=dev)
    rows = min(R, la - base)
    cap = la - base if la - base <= R else 0
    g, h, match, mismatch = params.astuple()
    with torch.cuda.device(dev):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), halo_in.data_ptr(),
            halo_out.data_ptr(), state.data_ptr(), fin.data_ptr(),
            link.data_ptr(), link[-1].data_ptr(), nc, R, rows, cap, cs,
            base, start_type, C, threads, nstrips, g, h, match, mismatch,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"halostair_step(C={C}, threads={threads}, "
                      f"strips={nstrips})")
    return halo_out


def halostair_step(a, b, halo_in, state, fin, cs, base, la, start_type,
                   params):
    """K8: one pipeline step of one mesh entry (see the module
    docstring); returns ``halo_out`` (R+1, 4) and advances ``state`` and
    ``fin`` in place."""
    _check(a, b, halo_in, state, fin, base, la)
    if a.device.type == "cpu":
        return halostair_step_plain(a, b, halo_in, state, fin, cs, base,
                                    la, start_type, params)
    out = _launch(a, b, halo_in, state, fin, cs, base, la, start_type,
                  params)
    halostair_step.launches += 1
    return out


halostair_step.launches = 0
