"""CLI entry point: ``python -m cse305_parallel_sequence_alignment_torch``.

The ported subcommands of the JAX package's CLI, with its flags and
output format, plus ``--device`` ("cuda" by default):

  align      one global alignment (prints the reference's two-row format)
  local      one local (SW) alignment with CIGAR (prints JSON)
  semiglobal one semi-global alignment, A fitted into B (prints JSON)
  overlap    one overlap (dovetail) alignment (prints JSON)
  batch      score/align many pairs from a FASTA file
  partition  balanced-partition alignment of one long pair
  longscore  score of one long pair through the long fill (K6)
  perf       GCUPS sweep of the kernels (JSON lines)
  info       versions and devices
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


def cmd_local(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.local import (
        LocalBatchAligner,
    )
    params = ScoringParams(g=cfg.g, h=cfg.h, match=args.sw_match,
                           mismatch=args.sw_mismatch)
    res = LocalBatchAligner(params=params,
                            device=args.device).align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "cigar_extended": res.cigar_extended,
        "query_span": [res.start_a, res.end_a],
        "target_span": [res.start_b, res.end_b],
    }))
    return 0


def cmd_semiglobal(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.semiglobal import (
        SemiGlobalBatchAligner,
    )
    params = ScoringParams(g=cfg.g, h=cfg.h, match=cfg.match,
                           mismatch=args.sg_mismatch)
    res = SemiGlobalBatchAligner(params=params, device=args.device) \
        .align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "cigar_extended": res.cigar_extended,
        "target_span": list(res.target_span),
    }))
    return 0


def cmd_overlap(args):
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment_torch.core import ScoringParams
    from cse305_parallel_sequence_alignment_torch.models.overlap import (
        OverlapBatchAligner,
    )
    params = ScoringParams(g=cfg.g, h=cfg.h, match=cfg.match,
                           mismatch=args.ov_mismatch)
    res = OverlapBatchAligner(params=params, device=args.device) \
        .align_batch([(a, b)])[0]
    print(json.dumps({
        "score": res.score,
        "cigar": res.cigar,
        "a_span": list(res.a_span),
        "b_span": list(res.b_span),
    }))
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


def cmd_partition(args):
    cfg = config_from_args(args)
    if args.full_dataset_pair:
        # the reference's design target: the two longest dataset genes at
        # full length (partial.cpp:149, main_alignment.cpp:353-410)
        names, seqs = _load_data(cfg)
        order = sorted(range(len(seqs)), key=lambda k: -len(seqs[k]))
        i, j = order[0], order[1]
        a, b = seqs[i], seqs[j]
        print(f"pair: {names[i].split()[0]} ({len(a)} nt) x "
              f"{names[j].split()[0]} ({len(b)} nt)", file=sys.stderr)
    else:
        a, b = _resolve_pair(args, cfg)
    from cse305_parallel_sequence_alignment_torch.core import encode_seq
    from cse305_parallel_sequence_alignment_torch.parallel.partition import (
        PartitionedAligner,
        score_chain,
    )
    t0 = time.perf_counter()
    aligner = PartitionedAligner(params=cfg.params, p=args.p,
                                 fill_backend=args.fill_backend,
                                 device=args.device)
    res = aligner.align(a, b)
    dt = time.perf_counter() - t0
    if args.full_dataset_pair:
        # no ~100 kb rows on the terminal: the verified result instead
        ea, eb = encode_seq(a), encode_seq(b)
        if len(ea) > len(eb):
            ea, eb = eb, ea  # the aligner's parity swap
        cells = len(a) * len(b)
        print(json.dumps({
            "len_a": len(a), "len_b": len(b),
            "score": res.score,
            "chain_score": score_chain(ea, eb, res.chain, cfg.params),
            "chain_len": len(res.chain),
            "aligned_rows_len": len(res.aligned_a),
            "wall_s": round(dt, 2),
            "effective_gcups": round(cells / dt / 1e9, 3),
        }))
    else:
        print(res.aligned_a)
        print(res.aligned_b)
    if args.verbose:
        print(f"score={res.score} time={dt:.2f}s", file=sys.stderr)
    return 0


def cmd_longscore(args):
    """Score one (possibly huge) pair through the long fill (K6)."""
    if args.devices > 1:
        raise NotImplementedError(
            "longscore across devices (the column-sharded pipeline, kernel "
            "K8) is not ported yet: ROADMAP queue 1 item 13")
    cfg = config_from_args(args)
    a, b = _resolve_pair(args, cfg)
    import torch

    from cse305_parallel_sequence_alignment_torch.core import (
        encode_seq,
        end_table_choice,
    )
    from cse305_parallel_sequence_alignment_torch.ops.longrow import (
        long_fill,
    )
    ea = encode_seq(a) if isinstance(a, (str, bytes)) else a
    eb = encode_seq(b) if isinstance(b, (str, bytes)) else b
    t0 = time.perf_counter()
    args_t = [torch.from_numpy(x).to(args.device) for x in (
        ea[None, :], eb[None, :], np.array([len(ea)], np.int32),
        np.array([len(eb)], np.int32), np.array([-1], np.int32))]
    finals = long_fill(*args_t, cfg.params)[0].cpu().numpy()
    dt = time.perf_counter() - t0
    table, score = end_table_choice(
        float(finals[0]), float(finals[1]), float(finals[2]), -1, cfg.h)
    print(json.dumps({
        "score": score, "end_table": table,
        "m": len(a), "n": len(b),
        "devices": 1,
        "seconds": round(dt, 3),
        "gcups": round(len(a) * len(b) / dt / 1e9, 3),
    }))
    return 0


def cmd_perf(args):
    from cse305_parallel_sequence_alignment_torch.harness.perfreport import (
        run_report,
    )
    run_report(lengths=tuple(args.lengths), batches=tuple(args.batches),
               include_longseq=not args.no_longseq, device=args.device)
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

    p = sub.add_parser("local", help="one local (SW) alignment with CIGAR")
    _add_pair_args(p)
    p.add_argument("--sw-match", type=float, default=2.0)
    p.add_argument("--sw-mismatch", type=float, default=-1.0)
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_local)

    p = sub.add_parser("semiglobal",
                       help="fit query into target (free target flanks)")
    _add_pair_args(p)
    p.add_argument("--sg-mismatch", type=float, default=-1.0)
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_semiglobal)

    p = sub.add_parser("overlap",
                       help="dovetail overlap detection (free outer ends)")
    _add_pair_args(p)
    p.add_argument("--ov-mismatch", type=float, default=-1.0)
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_overlap)

    p = sub.add_parser("batch", help="score/align many dataset pairs")
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--scores-only", action="store_true")
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("partition", help="balanced-partition alignment")
    _add_pair_args(p)
    p.add_argument("--p", type=int, default=0,
                   help="number of segments (0 = auto from memory budget)")
    p.add_argument("--fill-backend", default="auto",
                   choices=["auto", "rowscan", "longrow", "sharded"],
                   help="crossing-search fill engine")
    p.add_argument("--full-dataset-pair", action="store_true",
                   help="align the two longest dataset sequences at full "
                        "length (the reference's design workload)")
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_partition)

    p = sub.add_parser("longscore",
                       help="score of one long pair (long fill, K6)")
    _add_pair_args(p)
    p.add_argument("--devices", type=int, default=1,
                   help="cards to shard the columns over (only 1 so far)")
    add_config_args(p)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_longscore)

    p = sub.add_parser("perf", help="GCUPS sweep report (JSON lines)")
    p.add_argument("--lengths", type=int, nargs="+", default=[512, 2048])
    p.add_argument("--batches", type=int, nargs="+", default=[64, 256])
    p.add_argument("--no-longseq", action="store_true",
                   help="leave out the multi-device longseq rows (not "
                        "ported yet; required)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_perf)

    p = sub.add_parser("info", help="versions and devices")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
