"""Score-fill, walk and row-step probes on the card: the H100
counterparts of the JAX package's TPU probe scripts on the K3'' / K2'
path and on the K3' row step, each a module run
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
  ``BatchAligner`` (scripts/probes/pallas_walk_r4.py);

and the row-step attribution probes over ops/rowprobe.py, each timing
the variants of the K3' row step beside K3' and its own full step:

- ``perm_layout``: P-perm, K3''s finals in the contiguous and the strided
  thread layout (scripts/probes/attrib3_r5.py);
- ``stripes``: P-stripes, 1 to 8 pairs interleaved a CTA
  (scripts/kern_stripes.py);
- ``knockout``: P-knock, pieces of the row step knocked out
  (scripts/kern_attrib.py);
- ``ablate``: P-ablate, per-row parts ablated, and the raw max-chain
  floors (scripts/probes/attrib_r5.py);
- ``lane0``: P-lane0, column 0's T3 in the forms A to E
  (scripts/kern_scalar.py);
- ``sweep``: P-sweep, pairs x row width x columns a thread x unroll of
  the step with A's character fixed (scripts/kern_sweep.py);
- ``attrib2``: P-attrib2, the prefix max's aligned and unaligned parts,
  the scan and the halo through shared memory, two CTAs an SM, and the
  live-array and integer floors, beside K3' and K3
  (scripts/probes/attrib2_r5.py);

and the op-cost micro-probes over ops/micro.py:

- ``micro``: P-micro and P-micro2, ns an operation of each class in a
  dependent loop, by the difference of two step counts
  (scripts/kern_probe.py, scripts/kern_probe2.py; ``--which``).

They run on the card unless ``--device cpu`` is given, and then report
host-clock times (``host_ms``) and no rate.
"""

MODULES = ("ab_rowscan2", "trim_rowscan", "dual_stream", "walk_ab",
           "perm_layout", "stripes", "knockout", "ablate", "lane0",
           "sweep", "attrib2", "micro")
