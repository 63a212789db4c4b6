"""``BatchAligner.align_batch`` of the call's pairs: a full alignment of
each (score, end table, chain, rendered rows); spans: its
``last_phases`` (fill_walk_ms, d2h_ms, replay_ms, render_ms)."""

import entry

LIMITS = {"missing": 0, "scores_wrong": 0, "tables_wrong": 0,
          "chains_wrong": 0, "rows_wrong": 0}


class Entry(entry.Base):

    def __init__(self, config, device):
        super().__init__(config, device)
        from cse305_parallel_sequence_alignment_torch.models.batch import (
            BatchAligner,
        )
        params, matrix = entry.scoring(config)
        self.aligner = BatchAligner(
            params=params, matrix=matrix, start_type=int(config["start_type"]),
            end_type=int(config["end_type"]),
            parity_swap=bool(config["parity_swap"]), device=device)

    def __call__(self, pairs):
        out = self.aligner.align_batch(pairs)
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
