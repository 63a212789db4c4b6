"""The port's run configuration = the JAX package's: the same defaults,
the default data path included, and the same ``--data`` default."""

import argparse
import dataclasses

from cse305_parallel_sequence_alignment_torch.utils import config as port
from cse305_parallel_sequence_alignment_tpu.utils import config as ref


def test_run_config_defaults_equal_the_jax_package():
    mine, theirs = port.RunConfig(), ref.RunConfig()
    names = [f.name for f in dataclasses.fields(ref.RunConfig)]
    assert [f.name for f in dataclasses.fields(port.RunConfig)] == names
    for name in names:
        assert getattr(mine, name) == getattr(theirs, name), name
    assert mine.params.astuple() == tuple(
        getattr(theirs.params, k) for k in ("g", "h", "match", "mismatch"))


def test_data_flag_default_equals_the_jax_package():
    mine = port.add_config_args(argparse.ArgumentParser()).parse_args([])
    theirs = ref.add_config_args(argparse.ArgumentParser()).parse_args([])
    assert mine.data_path == theirs.data_path == ref.RunConfig().data_path
    assert vars(mine) == vars(theirs)
    cfg = port.config_from_args(
        port.add_config_args(argparse.ArgumentParser()).parse_args(
            ["--data", "elsewhere.fa"]))
    assert cfg.data_path == "elsewhere.fa"
