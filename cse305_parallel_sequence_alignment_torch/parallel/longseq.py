"""Long-sequence mode: one DP grid sharded by columns over a mesh (the
port of the JAX package's ``parallel/longseq.py``).

B's columns are cut into one contiguous block per entry of the ``seq``
axis of a mesh (``parallel/mesh.py``); A is replicated. Rows are
processed in chunks of R, on the staircase schedule of the JAX package:
mesh entry k fills row-chunk c at pipeline step s = c + k, C + D - 1
steps in all, and between steps each entry hands the right-edge records
of its freshly computed rows to entry k+1. One process drives every
entry, as the JAX package's ``shard_map`` program does: the halo of a
step is a tensor moved to the next entry's device with a ``non_blocking``
copy, which PyTorch orders after the producer's work on its stream and
before the consumer's. Each step's halos are fresh tensors held apart
from the previous step's, so entry k reads what entry k-1 wrote at step
s-1, never at step s, also on a mesh that repeats a device.

Two per-entry bodies, the JAX package's two ``backend``s:

- "kernel": K8 (``ops/halostair.py`` ``halostair_step``), one launch a
  step over the entry's whole block, global columns 0..n in D blocks of
  ceil((n+1) / D); exact for h >= 0 only (the 2-carry form), so with
  h < 0 the plain row body runs instead, as in the JAX package;
- "xla": the plain PyTorch row body of the JAX package's
  ``_longseq_local`` (the 3-table recurrence, T2 through a prefix max
  seeded from the left ghost's T2), columns 1..n in D blocks of
  ceil(n / D); it runs on any device, at PyTorch's pace.

"auto" takes the kernel on a CUDA mesh and the row body on a CPU mesh,
as the JAX package takes its Pallas body on a TPU and the XLA scan on a
CPU. ``ROUTES`` counts the fills of each route.
"""

from __future__ import annotations

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    NEG_INF,
    PAD_A,
    PAD_B,
    ScoringParams,
    boundary_col0,
    boundary_row0,
    encode_seq,
)
from cse305_parallel_sequence_alignment_torch.ops.halostair import (
    halostair_init,
    halostair_step,
)
from cse305_parallel_sequence_alignment_torch.parallel.mesh import (
    make_2d_mesh,
    make_seq_mesh,
)

BACKENDS = ("auto", "kernel", "xla")
# whole-pair fills run by each route since the caller last set them to 0
ROUTES = {"kernel": 0, "xla": 0}


def _enc(s):
    return encode_seq(s) if isinstance(s, (str, bytes)) else \
        np.asarray(s, np.uint8).reshape(-1)


def _pipeline(D, C, step):
    """The staircase schedule over D mesh entries and C row-chunks:
    ``step(k, c, halo)`` fills chunk c on entry k from the halo entry k-1
    produced for that chunk at the previous step (None for k = 0) and
    returns the halo for entry k+1, on its device."""
    sent = [None] * D
    for s in range(C + D - 1):
        out = [None] * D
        for k in range(max(0, s - C + 1), min(D, s + 1)):
            out[k] = step(k, s - k, sent[k - 1] if k > 0 else None)
        sent = out


def _kernel_run(a_enc, b_enc, params, start_type, devices, R):
    """K8 pipeline of one pair: (finals (3,), row m (3, n+1))."""
    m, n = a_enc.shape[0], b_enc.shape[0]
    D = len(devices)
    nc = -(-(n + 1) // D)
    C = -(-m // R)
    a_pad = np.full(C * R, PAD_A, np.uint8)
    a_pad[:m] = a_enc
    b_all = np.full(D * nc, PAD_B, np.uint8)
    b_all[1: n + 1] = b_enc
    blocks = []
    for k, dev in enumerate(devices):
        state, fin, _ = halostair_init(k * nc, nc, start_type, params, dev)
        blocks.append((torch.from_numpy(a_pad).to(dev),
                       torch.from_numpy(b_all[k * nc: (k + 1) * nc]).to(dev),
                       state, fin))
    # the first block has no column on its left
    edge = torch.full((R + 1, 4), NEG_INF, dtype=torch.float32,
                      device=devices[0])

    def step(k, c, halo):
        a_k, b_k, state, fin = blocks[k]
        out = halostair_step(a_k[c * R: (c + 1) * R], b_k,
                             edge if k == 0 else halo, state, fin, k * nc,
                             c * R, m, start_type, params)
        return out.to(devices[k + 1], non_blocking=True) if k + 1 < D \
            else None

    _pipeline(D, C, step)
    row = torch.cat([blk[3].cpu() for blk in blocks], dim=1)[:, : n + 1]
    row = row.numpy()
    return row[:, n].copy(), row


def _row0_t2_at(j, g, h, start_type):
    """Row 0's T2 at global columns ``j`` >= 1 (float32 tensor)."""
    if start_type == -2:
        return -g * j
    if start_type in (1, 3):
        return torch.full_like(j, NEG_INF)
    return -h - g * j


def _xla_run(a_pad, b_pad, la, lb, nc, R, devices, params, start_type):
    """The plain row-body pipeline of a batch of pairs padded to (B, C*R)
    and (B, nc*D), true lengths ``la``/``lb`` (host int arrays): (finals
    (B, 3), rows m (3, B, nc*D) at columns 1..nc*D)."""
    B = a_pad.shape[0]
    D = len(devices)
    C = a_pad.shape[1] // R
    f32 = torch.float32
    la_set = set(int(x) for x in la)
    corner = (0.0 if start_type in (1, -1) else NEG_INF,
              0.0 if start_type == -2 else NEG_INF,
              0.0 if start_type == -3 else NEG_INF)
    ents = []
    for k, dev in enumerate(devices):
        g, h, match, mismatch = (torch.tensor(float(x), dtype=f32,
                                              device=dev)
                                 for x in params.astuple())
        jf = (k * nc + 1 + torch.arange(nc, device=dev)).to(f32)
        jg = g * jf
        j_ghost = torch.tensor(float(k * nc), dtype=f32, device=dev)
        neg = torch.full((B, nc), NEG_INF, dtype=f32, device=dev)
        row0 = torch.stack([neg, _row0_t2_at(jf, g, h, start_type).expand(
            B, nc), neg])
        if k == 0:
            ghost = torch.tensor(corner, dtype=f32, device=dev)
        else:
            ghost = torch.stack([
                torch.tensor(NEG_INF, dtype=f32, device=dev),
                _row0_t2_at(j_ghost, g, h, start_type),
                torch.tensor(NEG_INF, dtype=f32, device=dev)])
        ents.append(dict(
            dev=dev, g=g, gh=g + h, h=h, match=match, mismatch=mismatch,
            jg=jg, jg_ghost=g * j_ghost, p=row0,
            gd=ghost[:, None].expand(3, B).clone(),
            a=torch.from_numpy(a_pad).to(dev).to(torch.int32),
            b=torch.from_numpy(np.ascontiguousarray(
                b_pad[:, k * nc: (k + 1) * nc])).to(dev).to(torch.int32),
            la=torch.from_numpy(la.astype(np.int64)).to(dev),
            lb_mask=(k * nc + 1 + torch.arange(nc, device=dev))[None, :]
            == torch.from_numpy(lb.astype(np.int64)).to(dev)[:, None],
            fin=torch.full((B, 3), NEG_INF, dtype=f32, device=dev)))

    def step(k, c, msg):
        e = ents[k]
        dev, g, gh = e["dev"], e["g"], e["gh"]
        i_glob = c * R + 1 + torch.arange(R, device=dev)
        if k == 0:  # column 0: the closed form
            negr = torch.full((B, R), NEG_INF, dtype=f32, device=dev)
            ifl = i_glob.to(f32)
            if start_type == -3:
                col0 = -g * ifl
            elif start_type in (1, 2):
                col0 = torch.full_like(ifl, NEG_INF)
            else:
                col0 = -e["h"] - g * ifl
            ghosts = torch.stack([negr, negr, col0.expand(B, R)])
        else:
            ghosts = msg.permute(2, 0, 1)  # (3, B, R)
        edges = torch.empty((B, R, 3), dtype=f32, device=dev)
        p, gd = e["p"], e["gd"]
        for r in range(R):
            i = c * R + 1 + r
            gc = ghosts[:, :, r]
            ext = torch.cat([gd[:, :, None], p], dim=2)[:, :, :-1]
            fb = torch.where(e["b"] == e["a"][:, c * R + r: c * R + r + 1],
                             e["match"], e["mismatch"])
            t1 = fb + torch.maximum(torch.maximum(ext[0], ext[1]), ext[2])
            t3 = torch.maximum(torch.maximum(p[0] - gh, p[1] - gh),
                               p[2] - g)
            m1 = torch.cat([gc[0][:, None], t1[:, :-1]], dim=1)
            m3 = torch.cat([gc[2][:, None], t3[:, :-1]], dim=1)
            omega = (e["jg"] + torch.maximum(m1, m3)) - gh
            seed = gc[1] + e["jg_ghost"]
            pm = torch.cummax(torch.cat([seed[:, None], omega], dim=1),
                              dim=1).values
            t2 = pm[:, 1:] - e["jg"]
            act = i <= e["la"]
            new = torch.stack([t1, t2, t3])
            p = torch.where(act[None, :, None], new, p)
            gd = torch.where(act[None, :], gc, gd)
            edges[:, r] = p[:, :, -1].T
            if i in la_set:
                cand = torch.where(e["lb_mask"], new, NEG_INF).amax(dim=2)
                e["fin"] = torch.where((e["la"] == i)[:, None], cand.T,
                                       e["fin"])
        e["p"], e["gd"] = p, gd
        return edges.to(devices[k + 1], non_blocking=True) if k + 1 < D \
            else None

    _pipeline(D, C, step)
    fin = torch.stack([e["fin"].cpu() for e in ents]).amax(dim=0)
    rows = torch.cat([e["p"].cpu() for e in ents], dim=2)
    return fin.numpy(), rows.numpy()


def _run(a, b, params, start_type, mesh, row_chunk, backend, device):
    """(finals (3,), last row (3, n+1)) of one pair by ``backend``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: pick from {BACKENDS}")
    a_enc, b_enc = _enc(a), _enc(b)
    m, n = a_enc.shape[0], b_enc.shape[0]
    g, h = params.g, params.h
    if m == 0:  # degenerate: the fill is the closed-form first row
        row = np.stack(boundary_row0(n, start_type, g, h))
        return row[:, n].copy(), row
    if n == 0:  # degenerate: the closed-form first column
        col = np.stack(boundary_col0(m, start_type, g, h))[:, m - 1:]
        return col[:, 0].copy(), col
    mesh = mesh or make_seq_mesh(device=device)
    devices = mesh.devices
    R = min(row_chunk, m)
    if backend == "auto":
        backend = "kernel" if devices[0].type == "cuda" else "xla"
    if backend == "kernel" and h >= 0:
        ROUTES["kernel"] += 1
        return _kernel_run(a_enc, b_enc, params, start_type, devices, R)
    # the row body: also the kernel backend's for h < 0, where the 2-carry
    # form is not the recurrence
    ROUTES["xla"] += 1
    D = len(devices)
    nc = -(-n // D)
    C = -(-m // R)
    a_pad = np.full((1, C * R), PAD_A, np.uint8)
    a_pad[0, :m] = a_enc
    b_pad = np.full((1, nc * D), PAD_B, np.uint8)
    b_pad[0, :n] = b_enc
    fin, rows = _xla_run(a_pad, b_pad, np.array([m]), np.array([n]), nc, R,
                         devices, params, start_type)
    col0 = np.stack(boundary_col0(m, start_type, g, h))[:, m - 1:]
    return fin[0], np.concatenate([col0, rows[:, 0, :n]], axis=1)


def longseq_pipeline_stats(m, n, devices, row_chunk=64):
    """Static accounting of one sharded fill (the JAX package's function,
    same keys and values): C + D - 1 pipeline steps, each handing one
    (R, 3) float32 halo to the right neighbour; devices idle during the
    D - 1 ramp steps, so C / S bounds the pipeline's efficiency."""
    D = max(1, int(devices))
    R = min(row_chunk, max(m, 1))
    C = -(-m // R)
    S = C + D - 1
    nc = -(-n // D)
    return {
        "devices": D,
        "rows_per_step": R,
        "chunks": C,
        "pipeline_steps": S,
        "cols_per_device": nc,
        "bytes_per_ppermute_per_device": R * 3 * 4,
        "total_halo_bytes": S * D * R * 3 * 4,
        "ramp_fraction": round((D - 1) / S, 4),
        "efficiency_bound": round(C / S, 4),
        "dispatches": 1,
    }


def longseq_score(a, b, params=ScoringParams(), start_type=-1, mesh=None,
                  row_chunk=64, backend="auto", device="cuda"):
    """Sharded score-only fill of one (possibly huge) pair: the (3,)
    float32 finals (T1, T2, T3) at (m, n). Columns are sharded over the
    ``seq`` axis of ``mesh`` (default: ``make_seq_mesh(device=device)``,
    every card); ``row_chunk`` rows a pipeline step; ``backend`` "auto",
    "kernel" or "xla" (see the module docstring)."""
    return _run(a, b, params, start_type, mesh, row_chunk, backend,
                device)[0]


def longseq_lastrow(a, b, params=ScoringParams(), start_type=-1, mesh=None,
                    row_chunk=64, backend="auto", device="cuda"):
    """Sharded fill returning the whole last row: (3, n+1) float32 T1,
    T2, T3 at row m, columns 0..n (the partition layer's crossing-search
    primitive across devices)."""
    return _run(a, b, params, start_type, mesh, row_chunk, backend,
                device)[1]


def longseq_score_batch(pairs, params=ScoringParams(), start_type=-1,
                        mesh=None, row_chunk=64, device="cuda"):
    """Many long pairs over a 2-D (data, seq) mesh: pairs split over
    ``data``, each pair's columns over ``seq``, through the row body (as
    the JAX package runs its batch). Pairs are padded to the longest in
    the call; their true lengths drive the capture. The batch must divide
    the data axis. Returns (B, 3) finals."""
    enc_a = [_enc(a) for a, _ in pairs]
    enc_b = [_enc(b) for _, b in pairs]
    B = len(pairs)
    m = max(x.shape[0] for x in enc_a)
    n = max(x.shape[0] for x in enc_b)
    if mesh is None:
        total = make_seq_mesh(device=device).size
        mesh = make_2d_mesh(seq=max(1, total // max(1, B)), device=device)
    Dd, D = mesh.shape["data"], mesh.shape["seq"]
    if B % Dd:
        raise ValueError(f"batch {B} must divide data axis {Dd}")
    nc = -(-n // D)
    R = min(row_chunk, max(m, 1))
    C = -(-m // R)
    a_pad = np.full((B, C * R), PAD_A, np.uint8)
    b_pad = np.full((B, nc * D), PAD_B, np.uint8)
    la = np.array([x.shape[0] for x in enc_a], np.int64)
    lb = np.array([x.shape[0] for x in enc_b], np.int64)
    for k in range(B):
        a_pad[k, : la[k]] = enc_a[k]
        b_pad[k, : lb[k]] = enc_b[k]
    ROUTES["xla"] += 1
    out = np.zeros((B, 3), np.float32)
    per = B // Dd
    for d, devs in enumerate(mesh.rows()):
        rows = slice(d * per, (d + 1) * per)
        out[rows] = _xla_run(a_pad[rows], b_pad[rows], la[rows], lb[rows],
                             nc, R, devs, params, start_type)[0]
    return out
