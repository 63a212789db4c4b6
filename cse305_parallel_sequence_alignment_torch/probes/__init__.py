"""Score-fill and walk probes on the card: the H100 counterparts of the
JAX package's TPU probe scripts on the K3'' / K2' path, each a module run
as ``python -m cse305_parallel_sequence_alignment_torch.probes.<name>
[--device cpu] [--small] [--rounds N]`` that prints one JSON line per
measurement:

- ``ab_rowscan2``: K3'' against K3', interleaved rounds, and a sweep of
  columns a thread (scripts/probes/ab_rowscan2_r4.py, ab_unroll_r4.py,
  rowscan2k.py);
- ``trim_rowscan``: K3' against P-trim (scripts/kern_rowscan2.py);
- ``dual_stream``: P-dual against K3'', then K8 through the long-pair
  pipeline (scripts/probes/dual_halostair_r4.py);
- ``walk_ab``: K2' at each G against K2 on K1's dirs, then the fused
  ``BatchAligner`` (scripts/probes/pallas_walk_r4.py).

They run on the card unless ``--device cpu`` is given, and then report
host-clock times (``host_ms``) and no rate.
"""

MODULES = ("ab_rowscan2", "trim_rowscan", "dual_stream", "walk_ab")
