"""Banded global aligner: O(m * W) fill and a band-layout traceback.

The port of the JAX package's ``models/banded.py`` with its fused route:
for pairs whose optimal path stays near the main diagonal (similar
sequences, the production fast path), ``align`` runs the K12d band fill
(ops/banded.py), the end-table choice, the K2 run-length walk in band
layout (ops/device_walk.py), the native replay and the render; ``score``
runs the K12s fill. ``edge_touched`` reports whether a diagonal step of
the chain lies on the band's edge, where a wider band could score more.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import (
    AlignmentResult,
    LazyChain,
    ScoringParams,
    encode_seq,
    end_table_choice,
)
from cse305_parallel_sequence_alignment_torch.models.chunked import (
    check_backend,
)
from cse305_parallel_sequence_alignment_torch.native import walker
from cse305_parallel_sequence_alignment_torch.ops.banded import (
    band_check,
    banded_dirs,
    banded_score,
)
from cse305_parallel_sequence_alignment_torch.ops.device_walk import rle_walk
from cse305_parallel_sequence_alignment_torch.utils.observability import Marks

PHASES = ("fill_ms", "walk_ms", "d2h_ms", "replay_ms", "render_ms")


def _codes(s):
    return encode_seq(s) if isinstance(s, (str, bytes)) else \
        np.asarray(s, np.uint8)


@dataclasses.dataclass
class BandedAligner:
    """Global affine-gap aligner restricted to the band j in [i - w_lo,
    i + w_hi].

    Exact whenever the optimal unrestricted path stays inside the band
    (guaranteed if w_lo/w_hi exceed the longest gap run, e.g. both >=
    |m - n| + max_indels). ``backend`` takes the JAX package's values
    ("auto", "pallas", "wavefront"), each running the K12 kernels.
    ``device`` is where the kernels run ("cuda" by default, "cpu" for
    their plain PyTorch versions). ``last_phases``
    holds the phase times (ms) of the latest ``align``: the fill (with
    the end choice) and the walk on the device's clock, the
    device-to-host copy of the walk, the replay and the render on the
    host's.
    """

    params: ScoringParams = ScoringParams()
    w_lo: int = 64
    w_hi: int = 64
    start_type: int = -1
    end_type: int = -1
    traceback_mode: str = "parity"  # "full" emits forced edge runs
    # the JAX package's values; all three run K12, since the JAX XLA and
    # Pallas band routes agree
    backend: str = "auto"
    device: str = "cuda"

    def __post_init__(self):
        check_backend(self.backend, "BandedAligner")
        self._dev = torch.device(self.device)
        if self._dev.type not in ("cpu", "cuda"):
            raise ValueError(f"device {self.device!r}: 'cuda' or 'cpu'")
        if self._dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"BandedAligner(device={self.device!r}) needs a CUDA card "
                "and none is available; pass device='cpu' to run the "
                "plain PyTorch kernels on the CPU")
        if self.traceback_mode not in ("parity", "full"):
            raise ValueError(f"traceback_mode {self.traceback_mode!r}: "
                             "'parity' or 'full'")
        self.last_phases = dict.fromkeys(PHASES, 0.0)

    def _bucket(self, ea, eb):
        """The pair as a bucket of one on the aligner's device."""
        band_check(len(ea), len(eb), self.w_lo, self.w_hi)
        arrays = (ea[None, :], eb[None, :],
                  np.array([len(ea)], np.int32),
                  np.array([len(eb)], np.int32),
                  np.array([self.start_type], np.int32))
        return [torch.from_numpy(np.ascontiguousarray(x)).to(self._dev)
                for x in arrays]

    def score(self, a, b):
        """The banded score of one pair (K12s, then the end choice)."""
        fin = banded_score(*self._bucket(_codes(a), _codes(b)), self.w_lo,
                           self.w_hi, self.params)
        f = fin[0].cpu().tolist()
        return end_table_choice(*f, self.end_type, self.params.h)[1]

    def align(self, a, b):
        ea, eb = _codes(a), _codes(b)
        m, n = len(ea), len(eb)
        args = self._bucket(ea, eb)
        marks = Marks(self._dev)
        marks.mark()
        dirs, fin = banded_dirs(*args, self.w_lo, self.w_hi, self.params)
        f = fin[0].cpu().tolist()
        table, score = end_table_choice(*f, self.end_type, self.params.h)
        t0 = torch.tensor([table], dtype=torch.int32, device=self._dev)
        marks.mark()
        entries, used = rle_walk(dirs, args[2], args[3], t0, m + n + 1,
                                 band_lo=self.w_lo)
        marks.mark()
        pin = self._dev.type == "cuda"
        host = []
        for x in (entries, used):
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
            buf.copy_(x, non_blocking=pin)
            host.append(buf)
        marks.mark()
        marks.wait()
        del dirs
        ph = self.last_phases
        ph["fill_ms"], ph["walk_ms"], ph["d2h_ms"] = (marks.ms(k)
                                                      for k in range(3))
        t1 = time.perf_counter()
        ent = np.ascontiguousarray(host[0].numpy()[: int(host[1][0])].T)
        tt, ii, jj, lens = walker.replay_rle(
            ent, np.array([m]), np.array([n]), np.array([table], np.int32),
            self.traceback_mode)
        L = int(lens[0])
        tt, ii, jj = tt[0, :L].copy(), ii[0, :L].copy(), jj[0, :L].copy()
        t2 = time.perf_counter()
        row_a, row_b = walker.render(ea, eb, tt, ii, jj)
        ph["replay_ms"] = (t2 - t1) * 1e3
        ph["render_ms"] = (time.perf_counter() - t2) * 1e3
        res = AlignmentResult(score=score, chain=LazyChain(tt, ii, jj),
                              aligned_a=row_a, aligned_b=row_b,
                              end_table=table)
        d = jj - ii
        res.edge_touched = bool(((tt == 1) & ((d == self.w_hi)
                                             | (d == -self.w_lo))).any())
        return res
