"""``PartitionedAligner.align`` of each pair of the call, one after the
other, at the configuration's ``partitions``: a full alignment of each
(score, end table, chain, rendered rows); spans: its ``last_phases``
(crossing_ms, segments_ms, stitch_ms and its counters), summed over the
pairs."""

import entry

LIMITS = {"missing": 0, "scores_wrong": 0, "tables_wrong": 0,
          "chains_wrong": 0, "rows_wrong": 0}


class Entry(entry.Base):

    def __init__(self, config, device):
        super().__init__(config, device)
        from cse305_parallel_sequence_alignment_torch.parallel.partition \
            import PartitionedAligner
        params, _ = entry.scoring(config)
        self.aligner = PartitionedAligner(
            params=params, p=int(config["partitions"]),
            parity_swap=bool(config["parity_swap"]), device=device)

    def __call__(self, pairs):
        out = []
        for a, b in pairs:
            out.append(self.aligner.align(a, b))
            self.spans.update(self.aligner.last_phases)
        return out

    @staticmethod
    def answer(outputs, k):
        if k >= len(outputs) or outputs[k] is None:
            return None
        r = outputs[k]
        return entry.Answer(float(r.score), r.end_table, list(r.chain),
                            ((r.aligned_a or "").encode(),
                             (r.aligned_b or "").encode()))
