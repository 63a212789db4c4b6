"""Bucketed many-pairs aligner: the throughput mode (reference P6).

Pairs are length-bucketed, padded and filled together on the device, one
CTA per pair. ``align_batch`` runs, per chunk of a bucket: the K1 fill
emitting dirs16+runs (ops/rowcb.py), the end-table choice, the K2
run-length walk (ops/device_walk.py), and a copy of only the used walk
rounds to pinned host memory; the host then replays and renders with the
native library. Two chunks are in flight: the device fills and walks
chunk c+1 while the host replays chunk c. ``score_batch`` runs the K3
score fill only, or the K6 long fill (ops/longrow.py) for buckets wider
than ``long_threshold``.

With a substitution ``matrix`` (``core.SubstitutionMatrix``) sequences
are bucketed as alphabet codes padded with the matrix's pad code, and
the fills read f(A[i], B[j]) from its table: K4d (``rowcb_fill`` with a
table) in ``align_batch``, followed by the same end choice, K2 walk and
replay, and K4s (``submat_score_fill``) in ``score_batch`` at every
bucket width, as the JAX package routes the matrix branch before its
long-fill threshold.

``backend`` takes the JAX package's values, with their meaning on an
accelerator, and never changes by itself:

- "auto" and "pallas" (the default): the routes above;
- "pallas_rowscan": ``score_batch`` runs K3', the global row-sweep score
  fill (``rowscan_score_fill``), at every bucket width; ``align_batch``
  the fused route;
- "wavefront": ``score_batch`` runs K3 at every width; ``align_batch``
  runs K5, the anti-diagonal fill storing skew uint8 dirs
  (``skew_dirs_fill``), the end choice and K2s, the single-step walk
  (``step_walk``, layout "skew"), then ``replay_steps`` on the host;
- "rowdirs": ``score_batch`` as "pallas"; ``align_batch`` runs K1', the
  row sweep storing uint8 codes (``rowdirs_fill``), and K2s in layout
  "row". The JAX package reaches this route only when its fused dispatch
  raises; the port names it instead of falling back to it.

Each backend is one ``_Route`` record of ``_ROUTES`` (score fill, dirs
fill, walk, host replay, dirs bytes a pair). The non-fused routes take
per-pair start types, so a mixed-type chunk is one launch; their chunks
follow their own dirs bytes. A substitution
matrix runs only on "auto"/"pallas" and raises on any other backend.

The aligner's ``device`` is explicit ("cuda" by default, or "cpu" for
the plain PyTorch versions of the kernels); it is never switched.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import typing

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    PAD_A,
    PAD_B,
    AlignmentResult,
    LazyChain,
    ScoringParams,
    SubstitutionMatrix,
    encode_seq,
    matrix_from_jax,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops.device_walk import (
    replay_steps,
    rle_walk,
    step_walk,
)
from cse305_parallel_sequence_alignment_torch.ops.diag import skew_dirs_fill
from cse305_parallel_sequence_alignment_torch.ops.longrow import long_fill
from cse305_parallel_sequence_alignment_torch.ops.rowcb import (
    rowcb_fill,
    rowdirs_fill,
    rowscan_score_fill,
    score_fill,
    submat_score_fill,
)


def _replay_rle(entries, used, la, lb, tables, mode, offsets, chunk):
    """Host replay of the first ``used`` rounds of K2's entries."""
    return walker.replay_rle(entries[:used].T, la, lb, tables, mode,
                             offsets=offsets, chunk=chunk)


class _Route(typing.NamedTuple):
    """What one ``backend`` runs. ``score_batch``: the ``score`` fill,
    and whether buckets wider than ``long_threshold`` go to K6 instead
    (``long``). ``align_batch``: the dirs ``fill`` (a, b, la, lb, st,
    params, table) -> (dirs, finals), the device ``walk`` (dirs, la, lb,
    tables, max_steps) -> (rounds (max_steps, B), used), the host
    ``replay`` (rounds, used, la, lb, tables, mode, offsets, chunk) ->
    (tt, ii, jj, lens), the ``dirs_bytes`` of one pair of a (bm, bn)
    bucket, and ``ship``: 1/ship of the rounds (256 at least) go to the
    host with the scores, the rest only if a walk ran past them."""

    score: typing.Callable
    long: bool
    fill: typing.Callable
    walk: typing.Callable
    replay: typing.Callable
    dirs_bytes: typing.Callable
    ship: int


# K1 dirs16+runs, K2 run-length rounds (a few per diagonal run)
_FUSED = _Route(score_fill, True, rowcb_fill, rle_walk, _replay_rle,
                lambda bm, bn: 2 * (bm + 1) * (bn + 1), 16)


def _step_route(score, long, fill, layout, dirs_bytes):
    """A non-fused route: uint8 dirs, K2s single steps (all shipped)."""
    return _Route(score, long,
                  lambda a, b, la, lb, st, params, table: fill(
                      a, b, la, lb, st, params),
                  functools.partial(step_walk, layout=layout), replay_steps,
                  dirs_bytes, 1)


_ROUTES = {
    "auto": _FUSED,
    "pallas": _FUSED,
    "pallas_rowscan": _FUSED._replace(score=rowscan_score_fill, long=False),
    "wavefront": _step_route(score_fill, False, skew_dirs_fill, "skew",
                             lambda bm, bn: (bm + bn + 1) * (bn + 1)),
    "rowdirs": _step_route(score_fill, True, rowdirs_fill, "row",
                           lambda bm, bn: (bm + 1) * (bn + 1)),
}
BACKENDS = tuple(_ROUTES)


def _round_up(x, q):
    return max(q, -(-x // q) * q)


def _encode_many(seqs):
    return [encode_seq(s) if isinstance(s, (str, bytes)) else
            np.asarray(s, np.uint8) for s in seqs]


def _buckets(enc_a, enc_b, quantum):
    """Pair indices by padded shape, each axis rounded up to ``quantum``."""
    buckets = {}
    for k, (ea, eb) in enumerate(zip(enc_a, enc_b)):
        key = (_round_up(ea.shape[0], quantum),
               _round_up(eb.shape[0], quantum))
        buckets.setdefault(key, []).append(k)
    return buckets


def _bucket_arrays(enc_a, enc_b, idxs, key, matrix=None):
    """(a, b, la, lb) of the pairs ``idxs``, padded to the bucket shape
    ``key`` with PAD_A / PAD_B; with a substitution ``matrix``, alphabet
    codes padded with its pad code (unknown characters raise)."""
    bm, bn = key
    B = len(idxs)
    pa, pb = (PAD_A, PAD_B) if matrix is None else (matrix.pad_code,) * 2
    a = np.full((B, bm), pa, np.uint8)
    b = np.full((B, bn), pb, np.uint8)
    la = np.zeros((B,), np.int32)
    lb = np.zeros((B,), np.int32)
    for r, k in enumerate(idxs):
        ra, rb = enc_a[k], enc_b[k]
        if matrix is not None:
            ra, rb = matrix.encode(bytes(ra)), matrix.encode(bytes(rb))
        la[r] = ra.shape[0]
        lb[r] = rb.shape[0]
        a[r, : la[r]] = ra
        b[r, : lb[r]] = rb
    return a, b, la, lb


def chunk_size(count, per_pair, max_batch, dirs_budget, split_two=False):
    """Pairs per ``align_batch`` chunk of a bucket of ``count`` pairs
    whose dirs take ``per_pair`` bytes each: at most ``max_batch`` and
    ``dirs_budget``, in equal chunks (a ragged tail pays a whole sweep for
    little). With ``split_two`` a bucket of 64 or more pairs that fits one
    chunk goes in two, so the second one's fill hides the first one's
    host work."""
    step = max(1, min(max_batch, dirs_budget // per_pair))
    if split_two and count >= 64 and step >= count:
        return -(-count // 2)
    if step < count:
        nchunks = -(-count // step)
        step = -(-count // nchunks)
    return step


def _end_choice(fin, en, h):
    """End-table choice from the finals (B, 3) with per-pair end types
    ``en``: forced for en > 0, else argmax with tie order T1 >= T2 >= T3
    and the gap-open refund h for end types -2/-3. Returns (tables int32,
    scores), on the finals' device."""
    f1 = fin[:, 0]
    f2 = fin[:, 1] + torch.where(en == -2, h, 0.0)
    f3 = fin[:, 2] + torch.where(en == -3, h, 0.0)
    pick1 = (f1 >= f2) & (f1 >= f3)
    pick2 = ~pick1 & (f2 >= f3)
    tb_free = torch.where(pick1, 1, torch.where(pick2, 2, 3))
    sc_free = torch.where(pick1, f1, torch.where(pick2, f2, f3))
    forced = en > 0
    sc_forced = fin.gather(1, (en.long() - 1).clamp(0, 2)[:, None])[:, 0]
    tb = torch.where(forced, en, tb_free).to(torch.int32)
    return tb, torch.where(forced, sc_forced, sc_free)


class _Marks:
    """Timestamps on the aligner's device: CUDA events on a card (read
    once the host waited for the last one), the host clock on the CPU,
    where every call returns finished."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self):
        if self.cuda:
            self.marks[-1].synchronize()

    def ms(self, k):
        a, b = self.marks[k], self.marks[k + 1]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


PHASES = ("fill_walk_ms", "d2h_ms", "replay_ms", "render_ms")


@dataclasses.dataclass
class BatchAligner:
    """Aligns many pairs at once with length bucketing (global mode).

    ``bucket_quantum`` sets the padded-shape granularity. ``max_batch``
    caps pairs per launch and ``dirs_budget`` the bytes of one launch's
    dirs array; ``align_batch`` shrinks its chunks to fit. ``backend``
    picks the kernels (see the module docstring: "auto"/"pallas",
    "pallas_rowscan", "wavefront", or the port's "rowdirs"). ``device`` is
    where the kernels run. ``last_phases`` holds the phase times (ms) of
    the latest ``align_batch``: fill+walk and device-to-host on the
    device's clock, replay and render on the host's.
    """

    params: ScoringParams = ScoringParams()
    start_type: int = -1
    end_type: int = -1
    parity_swap: bool = True
    bucket_quantum: int = 128
    max_batch: int = 512
    dirs_budget: int = 2 << 30
    # a substitution matrix: core.SubstitutionMatrix, or the JAX
    # package's, carried across by its alphabet and values
    matrix: object = None
    # score_batch gives buckets wider than this to the long fill (K6)
    long_threshold: int = 16384
    backend: str = "auto"
    device: str = "cuda"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: pick from "
                             f"{BACKENDS}")
        self._route = _ROUTES[self.backend]
        if self.matrix is not None and self.backend not in ("auto",
                                                            "pallas"):
            raise ValueError(
                f"a substitution matrix runs on backend 'auto' or "
                f"'pallas' only, not {self.backend!r}: the matrix "
                f"wavefront routes are not ported")
        self._dev = torch.device(self.device)
        if self._dev.type not in ("cpu", "cuda"):
            raise ValueError(f"device {self.device!r}: 'cuda' or 'cpu'")
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"BatchAligner(device={self.device!r}) needs a CUDA card "
                "and none is available; pass device='cpu' to run the "
                "plain PyTorch kernels on the CPU")
        self._table = None
        if self.matrix is not None:
            if not isinstance(self.matrix, SubstitutionMatrix):
                self.matrix = matrix_from_jax(self.matrix)
            if self.matrix.k + 1 > 255:
                raise ValueError(
                    f"a substitution matrix of {self.matrix.k} letters: "
                    "the kernels take at most 254")
            self._table = torch.from_numpy(self.matrix.table()).to(
                self._dev)
        self.last_phases = dict.fromkeys(PHASES, 0.0)

    def _prep(self, pairs):
        enc_a = _encode_many([p[0] for p in pairs])
        enc_b = _encode_many([p[1] for p in pairs])
        if self.parity_swap:  # quirk B8: roles swap when m > n
            for k in range(len(pairs)):
                if enc_a[k].shape[0] > enc_b[k].shape[0]:
                    enc_a[k], enc_b[k] = enc_b[k], enc_a[k]
        return enc_a, enc_b, _buckets(enc_a, enc_b, self.bucket_quantum)

    def _to_dev(self, *arrays):
        return [torch.from_numpy(x).to(self._dev) for x in arrays]

    def score_batch(self, pairs):
        """Scores for a list of (a, b) pairs: (scores, end_tables)."""
        enc_a, enc_b, buckets = self._prep(pairs)
        scores = np.zeros(len(pairs), np.float32)
        tables = np.zeros(len(pairs), np.int32)
        for key, idxs in buckets.items():
            # past the whole-row kernel's reach: the long fill, whose
            # strips spread even a one-pair bucket over the card; a
            # matrix bucket of any width goes to K4s, and the rowscan and
            # wavefront backends take their own fill at every width
            fill = self._route.score
            if self._route.long and max(key) > self.long_threshold:
                fill = long_fill
            for s in range(0, len(idxs), self.max_batch):
                chunk = idxs[s: s + self.max_batch]
                a, b, la, lb = _bucket_arrays(enc_a, enc_b, chunk, key,
                                              self.matrix)
                st = np.full(len(chunk), self.start_type, np.int32)
                en = np.full(len(chunk), self.end_type, np.int32)
                scores[chunk], tables[chunk] = self._score_chunk(
                    fill, a, b, la, lb, st, en)
        return scores, tables

    def _score_dispatch(self, fill, a, b, la, lb, st, en):
        """Queue the score fill and end choice of one padded chunk on the
        device; returns (scores, tables) device tensors."""
        t_a, t_b, t_la, t_lb, t_st, t_en = self._to_dev(a, b, la, lb, st, en)
        if self._table is not None:
            fin = submat_score_fill(t_a, t_b, t_la, t_lb, t_st, self._table,
                                    self.params)
        else:
            fin = fill(t_a, t_b, t_la, t_lb, t_st, self.params)
        tb, sc = _end_choice(fin, t_en, self.params.h)
        return sc, tb

    def _score_chunk(self, fill, a, b, la, lb, st, en):
        """(scores, tables) of one padded chunk as host arrays."""
        sc, tb = self._score_dispatch(fill, a, b, la, lb, st, en)
        return sc.cpu().numpy(), tb.cpu().numpy()

    def align_batch(self, pairs, offsets=None, traceback_mode="parity",
                    start_types=None, end_types=None):
        """Full alignments (device fill + walk, host replay) of all pairs.

        ``offsets``: optional per-pair (id_a, id_b) global coordinate
        offsets (partitioned segment solves); rows are then left to the
        caller. ``traceback_mode``: "parity" (reference quirk B1) or
        "full" (emit the forced edge runs, needed to stitch segments).
        ``start_types``/``end_types``: optional per-pair boundary types
        overriding the aligner's; a mixed batch is still one launch per
        chunk."""
        if traceback_mode not in ("parity", "full"):
            raise ValueError(
                f"traceback_mode {traceback_mode!r}: 'parity' or 'full'")
        enc_a, enc_b, buckets = self._prep(pairs)
        results: list = [None] * len(pairs)
        self.last_phases = dict.fromkeys(PHASES, 0.0)
        pending: list = []
        for key, idxs in buckets.items():
            step = self.chunk_size(key, len(idxs))
            for s in range(0, len(idxs), step):
                chunk = idxs[s: s + step]
                a, b, la, lb = _bucket_arrays(enc_a, enc_b, chunk, key,
                                              self.matrix)
                st = np.full(len(chunk), self.start_type, np.int32)
                en = np.full(len(chunk), self.end_type, np.int32)
                if start_types is not None:
                    st[:] = [start_types[k] for k in chunk]
                if end_types is not None:
                    en[:] = [end_types[k] for k in chunk]
                pending.append(
                    (chunk, la, lb, self._dispatch(a, b, la, lb, st, en)))
                while len(pending) > 1:
                    self._emit_chunk(pending.pop(0), enc_a, enc_b, results,
                                     offsets, traceback_mode)
        while pending:
            self._emit_chunk(pending.pop(0), enc_a, enc_b, results,
                             offsets, traceback_mode)
        return results

    def chunk_size(self, key, count):
        """Pairs per ``align_batch`` chunk of a bucket of shape ``key``
        holding ``count`` pairs, by the route's dirs bytes (uint16 row
        dirs fused, uint8 row dirs for "rowdirs", uint8 skew dirs for
        "wavefront"); two chunks at least, so the second one's fill hides
        the first one's replay and render."""
        return chunk_size(count, self._route.dirs_bytes(*key), self.max_batch,
                          self.dirs_budget, split_two=True)

    def _dispatch(self, a, b, la, lb, st, en):
        """Queue fill, end choice, walk and the device-to-host copies of
        one chunk on the current stream; returns the handles without
        waiting for the device. The fused route walks K1's dirs16+runs
        with K2; "rowdirs" and "wavefront" walk their uint8 dirs with
        K2s."""
        route = self._route
        max_steps = int(la.max(initial=0) + lb.max(initial=0)) + 1
        marks = _Marks(self._dev)
        t_a, t_b, t_la, t_lb, t_st, t_en = self._to_dev(a, b, la, lb, st,
                                                        en)
        marks.mark()
        dirs, fin = route.fill(t_a, t_b, t_la, t_lb, t_st, self.params,
                               self._table)
        tb, sc = _end_choice(fin, t_en, self.params.h)
        entries, used = route.walk(dirs, t_la, t_lb, tb, max_steps)
        del dirs
        marks.mark()
        # the capped prefix of the rounds ships with the scores; the whole
        # buffer stays on the device for the rare overflow
        cap = min(max_steps, max(256, max_steps // route.ship))
        pin = self._dev.type == "cuda"
        host = []
        for x in (entries[:cap], used, tb, sc):
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            buf.copy_(x, non_blocking=pin)
            host.append(buf)
        marks.mark()
        return entries, host, marks, max_steps

    def _collect(self, handles, la, lb, mode, offsets, chunk):
        """Wait for a dispatched chunk, fetch the overflow rounds if the
        walk ran past the shipped cap, and replay them by the route:
        run-length entries natively, K2s op streams with
        ``replay_steps``."""
        entries_d, (ent_h, used_h, tb_h, sc_h), marks, _ = handles
        marks.wait()
        self.last_phases["fill_walk_ms"] += marks.ms(0)
        self.last_phases["d2h_ms"] += marks.ms(1)
        used = int(used_h[0])
        ent = ent_h.numpy()
        if used > ent.shape[0]:
            ent = entries_d[:used].cpu().numpy()
        tables = tb_h.numpy()
        t0 = time.perf_counter()
        tt, ii, jj, lens = self._route.replay(ent, used, la, lb, tables, mode,
                                              offsets, chunk)
        chains = [LazyChain(tt[r, : lens[r]].copy(), ii[r, : lens[r]].copy(),
                            jj[r, : lens[r]].copy())
                  for r in range(len(chunk))]
        self.last_phases["replay_ms"] += (time.perf_counter() - t0) * 1e3
        arrays = (tt, ii, jj, lens) if offsets is None else None
        return chains, arrays, tables, sc_h.numpy()

    def _emit_chunk(self, item, enc_a, enc_b, results, offsets, mode):
        chunk, la, lb, handles = item
        chains, arrays, tables, scores = self._collect(
            handles, la, lb, mode, offsets, chunk)
        t0 = time.perf_counter()
        for r, k in enumerate(chunk):
            row_a = row_b = None
            if arrays is not None:  # offsets: the caller renders
                tt, ii, jj, lens = arrays
                L = int(lens[r])
                row_a, row_b = walker.render(enc_a[k], enc_b[k], tt[r, :L],
                                             ii[r, :L], jj[r, :L])
            results[k] = AlignmentResult(
                score=float(scores[r]), chain=chains[r], aligned_a=row_a,
                aligned_b=row_b, end_table=int(tables[r]))
        self.last_phases["render_ms"] += (time.perf_counter() - t0) * 1e3
