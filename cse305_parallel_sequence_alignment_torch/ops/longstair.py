"""One job's last DP row on the whole card (K7).

``stair_lastrow_device`` is the port of the TPU kernel ``_stair_kernel``
(cse305_parallel_sequence_alignment_tpu/ops/pallas_longstair.py:81). On
the TPU it filled one pair with eight column chunks on the sublanes as a
skewed pipeline, because a batch of one used one sublane of eight. On the
H100 the skewed wavefront of ``csrc/longrow.cu`` already is that pipeline,
over lanes, warps and CTAs: K7 launches it for a batch of one job, whose
lanes alone cover the SMs (``longrow.strip_plan`` at B = 1). Its plain
version is K6's plain fill on one job, and the kernel is bit-equal to it.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cse305_parallel_sequence_alignment_torch.core import ScoringParams
from cse305_parallel_sequence_alignment_torch.ops import _build, longrow


def _one_job(a, b, start_type):
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or a.dim() != 1 \
            or b.dim() != 1:
        raise TypeError("a and b must be 1-D uint8 code tensors")
    if a.device != b.device:
        raise ValueError("a and b must be on one device")
    dev = a.device
    lens = [torch.tensor([v], dtype=torch.int32, device=dev)
            for v in (a.shape[0], b.shape[0], int(start_type))]
    return (a.contiguous()[None], b.contiguous()[None], *lens)


def stair_lastrow_plain(a, b, start_type, params):
    """Plain PyTorch K7: K6's plain fill on one job, row m (3, n+1)."""
    return longrow.long_fill_plain(*_one_job(a, b, start_type), params,
                                   want_row=True)[0]


def stair_lastrow_device(a, b, start_type, params):
    """K7: last DP row (3, n+1) float32 of one job, a (m,) and b (n,)
    uint8 tensors, on their device."""
    args = _one_job(a, b, start_type)
    _build.check_bucket(*args)
    if a.device.type == "cpu":
        return stair_lastrow_plain(a, b, start_type, params)
    out = longrow._launch(*args, params, want_row=True)[0]
    stair_lastrow_device.launches += 1
    return out


stair_lastrow_device.launches = 0


def stair_lastrow(a_enc, b_enc, params=ScoringParams(), start_type=-1,
                  device="cuda"):
    """Host (3, n+1) last row through K7 (``pallas_long_lastrow``'s
    contract)."""
    a_enc = np.asarray(a_enc, np.uint8).reshape(-1)
    b_enc = np.asarray(b_enc, np.uint8).reshape(-1)
    if a_enc.shape[0] == 0:
        return longrow._row0_closed(b_enc.shape[0], params.g, params.h,
                                    start_type)
    row = stair_lastrow_device(torch.from_numpy(a_enc).to(device),
                               torch.from_numpy(b_enc).to(device),
                               start_type, params)
    return row.cpu().numpy()
