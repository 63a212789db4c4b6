"""Global Gotoh finals in plain PyTorch, one DP row at a time.

The recurrence of the CSE305 reference (subproblem_alignment.cpp), start
and end types -1: T1[0][0] = 0, T2[0][j] = -h - g*j, T3[i][0] = -h - g*i,
every other edge cell -inf, and for i, j >= 1

    T1[i][j] = s(A[i], B[j]) + max(T1, T2, T3)[i-1][j-1]
    T3[i][j] = max(T1[i-1][j] - g - h, T2[i-1][j] - g - h, T3[i-1][j] - g)
    T2[i][j] = max(T1[i][j-1] - g - h, T2[i][j-1] - g, T3[i][j-1] - g - h)

T2's dependence along the row unrolls to
T2[i][j] = max_{k<j}(max(T1, T3)[i][k] + g*k) - g*j - h, one cummax.
Pairs are sorted by rows and swept together in groups, each pair's finals
read at its own last row and column. ``dtype`` is the precision of the
sweep: float32 as the configuration states, or a lower one for the
control.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = float("-inf")


def _groups(order, rows, cols, max_elems):
    group, width = [], 0
    for k in order:
        w = max(width, cols[k] + 1)
        if group and w * (len(group) + 1) > max_elems:
            yield group
            group, w = [], cols[k] + 1
        group.append(k)
        width = w
    if group:
        yield group


@torch.inference_mode()
def finals(pairs, table, g, h, dtype=torch.float32, device="cuda",
           max_elems=1 << 24):
    """(T1, T2, T3) at (m, n) of each pair, a (P, 3) float64 array.

    ``pairs``: [(a, b)] of int code arrays (0..K-1), A the rows;
    ``table``: (K, K) substitution scores."""
    dev = torch.device(device)
    K = len(table)
    tbl = torch.zeros((K + 1, K + 1), dtype=torch.float64)
    tbl[:K, :K] = torch.as_tensor(np.asarray(table, np.float64))
    tbl = tbl.to(dev, dtype)
    rows = [len(a) for a, _ in pairs]
    cols = [len(b) for _, b in pairs]
    out = np.empty((len(pairs), 3), np.float64)
    order = sorted(range(len(pairs)), key=lambda k: (rows[k], cols[k]))
    for group in _groups(order, rows, cols, max_elems):
        out[group] = _sweep([pairs[k] for k in group], tbl, K, g, h, dtype,
                            dev)
    return out


SCAN = 1024  # cummax in blocks of this many columns, then across blocks
GRAPH_ROWS = 64  # rows a CUDA graph replays on the card


def cummax_rows(ubig, W):
    """Inclusive running max along each row of ``ubig`` (B, C*W), a scan
    inside each W-column block and then the blocks' carries."""
    B, L = ubig.shape
    cm = torch.cummax(ubig.view(B, L // W, W), 2).values
    if L > W:
        carry = torch.cummax(cm[:, :-1, -1], 1).values
        torch.maximum(cm[:, 1:, :], carry[:, :, None], out=cm[:, 1:, :])
    return cm.view(B, L)


def _sweep(pairs, tbl, K, g, h, dtype, dev):
    B = len(pairs)
    M = max(len(a) for a, _ in pairs)
    N = max(len(b) for _, b in pairs)
    on_card = dev.type == "cuda"
    R = GRAPH_ROWS if on_card else 2
    Mp = -(-M // R) * R
    A = np.full((B, Mp), K, np.int64)
    Bc = np.full((B, N), K, np.int64)
    for r, (a, b) in enumerate(pairs):
        A[r, : len(a)] = a
        Bc[r, : len(b)] = b
    A = torch.from_numpy(A).to(dev)
    Bc = torch.from_numpy(Bc).to(dev)
    ncol = torch.tensor([len(b) for _, b in pairs], device=dev)
    mrow = torch.tensor([len(a) - 1 for a, _ in pairs], device=dev)
    rows = torch.arange(B, device=dev)
    W = min(SCAN, N + 1)
    L = -(-(N + 1) // W) * W
    jg = (g * torch.arange(N + 1, dtype=torch.float64)).to(dev, dtype)
    gh = torch.tensor(g + h, dtype=dtype, device=dev)
    gg = torch.tensor(g, dtype=dtype, device=dev)
    hh = torch.tensor(h, dtype=dtype, device=dev)

    def full():
        return torch.full((B, N + 1), NEG, dtype=dtype, device=dev)

    cur, nxt = [full() for _ in range(3)], [full() for _ in range(3)]
    d = full()
    ubig = torch.full((B, L), NEG, dtype=dtype, device=dev)
    u = ubig[:, : N + 1]
    hist = torch.empty((Mp, B, 3), dtype=dtype, device=dev)
    ri = torch.zeros((1,), dtype=torch.int64, device=dev)  # row i - 1

    def reset():
        for t in cur:
            t.fill_(NEG)
        cur[0][:, 0] = 0.0
        cur[1].copy_(-hh - jg)
        cur[1][:, 0] = NEG
        ri.zero_()

    def step(p, q):
        p1, p2, p3 = p
        q1, q2, q3 = q
        torch.maximum(p1, p2, out=d)
        torch.maximum(d, p3, out=d)
        f = tbl.index_select(0, A.index_select(1, ri).view(B)).gather(1, Bc)
        torch.add(d[:, :-1], f, out=q1[:, 1:])
        q1[:, 0] = NEG
        torch.maximum(p1[:, 1:], p2[:, 1:], out=u[:, 1:])
        torch.sub(u[:, 1:], gh, out=u[:, 1:])
        torch.maximum(u[:, 1:], p3[:, 1:] - gg, out=q3[:, 1:])
        q3[:, 0] = -hh - gg * (ri + 1).to(dtype)
        torch.maximum(q1, q3, out=u)
        u.add_(jg)
        c = cummax_rows(ubig, W)
        torch.sub(c[:, :N], jg[1:], out=q2[:, 1:])
        q2[:, 1:].sub_(hh)
        hist.index_copy_(0, ri, torch.stack(
            [q1[rows, ncol], q2[rows, ncol], q3[rows, ncol]], 1)[None])
        ri.add_(1)

    def rows_of_graph():
        for _ in range(R // 2):
            step(cur, nxt)
            step(nxt, cur)

    reset()
    if on_card:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            rows_of_graph()  # warm up before the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            rows_of_graph()
        reset()
        for _ in range(Mp // R):
            graph.replay()
    else:
        for _ in range(Mp // R):
            rows_of_graph()
    return hist[mrow, rows].double().cpu().numpy()
