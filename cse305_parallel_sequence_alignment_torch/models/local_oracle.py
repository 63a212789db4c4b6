"""Default scoring of local (Smith-Waterman) mode.

The port's copy of ``LOCAL_PARAMS`` from the JAX package's
``models/local_oracle.py``; the serial oracle stays there, and the tests
call it there.
"""

from __future__ import annotations

from cse305_parallel_sequence_alignment_torch.core import ScoringParams

LOCAL_PARAMS = ScoringParams(g=1.0, h=2.0, match=2.0, mismatch=-1.0)
