"""The multi-device layer and the long-pair decomposition: the balanced
partition (``partition``), the column-sharded long-pair pipeline
(``longseq``, kernel K8), many-pairs sharding (``batch_shard``), device
meshes (``mesh``) and process groups (``multihost``)."""

import importlib

_NAMES = {
    "partition": ("PartitionedAligner", "balanced_partition",
                  "crossing_on_row", "score_chain"),
    "longseq": ("longseq_score", "longseq_lastrow", "longseq_score_batch",
                "longseq_pipeline_stats"),
    "batch_shard": ("ShardedBatchAligner", "ShardedLocalBatchAligner"),
    "mesh": ("Mesh", "make_data_mesh", "make_seq_mesh", "make_2d_mesh"),
    "multihost": ("init_distributed", "process_info", "host_shard"),
}
_MODULE = {name: mod for mod, names in _NAMES.items() for name in names}


def __getattr__(name):
    if name in _MODULE:
        module = importlib.import_module(f"{__name__}.{_MODULE[name]}")
        return getattr(module, name)
    raise AttributeError(name)


__all__ = sorted(_MODULE)
