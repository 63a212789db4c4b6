"""FASTA ingestion (reference C8: test_functions/pull_data.cpp:18-71).

Same contract as the reference reader: ``>`` lines are names, body lines
concatenate into one sequence per record, a name/sequence count mismatch
is an error, and duplicate sequences are detected (reported, not fatal).
"""

from __future__ import annotations

import dataclasses
import pathlib


@dataclasses.dataclass
class FastaData:
    names: list
    sequences: list
    has_duplicates: bool

    def __iter__(self):  # (names, sequences) tuple-unpacking compatibility
        return iter((self.names, self.sequences))


def read_and_store_sequences(filename, verbose=False):
    """Load a FASTA file. Returns FastaData(names, sequences, dups flag).

    Raises FileNotFoundError / ValueError where the reference returns 1.
    """
    log = print if verbose else (lambda *a, **k: None)
    log(f"Opening data file: {filename}")
    data = pathlib.Path(filename).read_bytes()
    log("File opened successfully!")
    names, sequences, cur = [], [], []
    for raw in data.split(b"\n"):
        line = raw.rstrip(b"\r")
        if not line:
            continue
        if line.startswith(b">"):
            if cur:
                sequences.append(b"".join(cur).decode("ascii"))
                cur = []
            names.append(line.decode("ascii"))
        else:
            cur.append(line)
    if cur:
        sequences.append(b"".join(cur).decode("ascii"))
    if len(sequences) != len(names):
        raise ValueError(
            "mismatch in sequences and names list sizes "
            f"({len(sequences)} vs {len(names)})")
    has_duplicates = len(set(sequences)) != len(sequences)
    if has_duplicates:
        log("There is at least one duplicate sequence found. "
            "Please check your data file.")
    else:
        log("No duplicate sequences found.")
    log("Dataset read successfully!")
    return FastaData(names, sequences, has_duplicates)
