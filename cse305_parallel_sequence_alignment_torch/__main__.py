"""CLI entry point: ``python -m cse305_parallel_sequence_alignment_torch``.

The ported subcommands of the JAX package's CLI, with its flags and
output format, plus ``--device`` ("cuda" by default):

  align   one global alignment (prints the reference's two-row format)
  batch   score/align many pairs from a FASTA file
  info    versions and devices
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from cse305_parallel_sequence_alignment_torch import __version__
from cse305_parallel_sequence_alignment_torch.utils.config import (
    RunConfig,
    add_config_args,
    config_from_args,
)


def _load_data(cfg: RunConfig):
    from cse305_parallel_sequence_alignment_torch.utils.fasta import (
        read_and_store_sequences,
    )
    return read_and_store_sequences(cfg.data_path)


def _resolve_pair(args, cfg):
    """(a, b) from --a/--b literals or --pair indices into the dataset."""
    if args.a and args.b:
        return args.a, args.b
    names, seqs = _load_data(cfg)
    i, j = args.pair
    a, b = seqs[i], seqs[j]
    if args.truncate:
        a, b = a[: args.truncate], b[: args.truncate]
    return a, b


def cmd_align(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment_torch.models.gotoh import (
        GotohAligner,
    )
    t0 = time.perf_counter()
    res = GotohAligner(params=cfg.params, device=args.device).align(a, b)
    dt = time.perf_counter() - t0
    print(res.aligned_a)
    print(res.aligned_b)
    if args.verbose:
        print(f"score={res.score} end_table={res.end_table} "
              f"time={dt:.4f}s", file=sys.stderr)
    return 0


def cmd_batch(args):
    cfg = config_from_args(args)
    names, seqs = _load_data(cfg)
    rng = np.random.default_rng(cfg.seed)
    count = args.count
    idx1 = rng.integers(0, len(seqs) - 1, size=count)
    idx2 = rng.integers(0, len(seqs) - 1, size=count)
    pairs = []
    for k in range(count):
        s1, s2 = seqs[idx1[k]], seqs[idx2[k]]
        L = min(cfg.input_size, len(s1), len(s2))
        pairs.append((s1[:L], s2[:L]))
    from cse305_parallel_sequence_alignment_torch.models.batch import (
        BatchAligner,
    )
    aligner = BatchAligner(params=cfg.params,
                           bucket_quantum=cfg.bucket_quantum,
                           max_batch=cfg.max_batch, device=args.device)
    t0 = time.perf_counter()
    if args.scores_only:
        scores, tables = aligner.score_batch(pairs)
        dt = time.perf_counter() - t0
        for k in range(count):
            print(f"{idx1[k]},{idx2[k]},{scores[k]:g}")
    else:
        results = aligner.align_batch(pairs)
        dt = time.perf_counter() - t0
        for res in results:
            print(res.aligned_a)
            print(res.aligned_b)
    cells = sum(len(a) * len(b) for a, b in pairs)
    print(f"# {count} pairs, {cells} cells, {dt:.3f}s, "
          f"{cells / dt / 1e9:.3f} GCUPS", file=sys.stderr)
    return 0


def cmd_info(args):
    import torch
    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": ([torch.cuda.get_device_name(k)
                     for k in range(torch.cuda.device_count())]
                    if cuda else []),
    }, indent=2))
    return 0


def _add_pair_args(p):
    p.add_argument("--a", help="literal sequence A")
    p.add_argument("--b", help="literal sequence B")
    p.add_argument("--pair", type=int, nargs=2, default=[0, 1],
                   metavar=("I", "J"),
                   help="dataset indices when --a/--b not given")
    p.add_argument("--truncate", type=int, default=0,
                   help="truncate dataset sequences to this length")
    p.add_argument("-v", "--verbose", action="store_true")


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the kernels run (cpu: plain PyTorch)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="cse305_parallel_sequence_alignment_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("align", help="one global alignment")
    _add_pair_args(p)
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("batch", help="score/align many dataset pairs")
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--scores-only", action="store_true")
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("info", help="versions and devices")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
