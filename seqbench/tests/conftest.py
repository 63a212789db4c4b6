"""The benchmark's own tests: ``python -m pytest seqbench/tests`` from the
root of the repo. Cases that need a card carry the ``cuda`` marker and
skip on a host without one."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]
