"""Traffic of kind ``offset_pairs``: each sequence of a pool paired with
the one ``offset`` places further in sorted order.

    {"kind": "offset_pairs", "pool": [lengths], "offset": k,
     "per_call": n}

The pool holds one random sequence of each length, whole. Sequence i of
the sorted lengths is paired with sequence i + k, for every i that has
one; the seed draws the residues and orders the pairs, and each call
holds ``per_call`` of them.
"""

from generate import capped, scaled


def calls(spec, residues, rng, scale, max_items):
    lengths = sorted(scaled(spec["pool"], scale))
    k = spec["offset"]
    index = [(i, i + k) for i in range(len(lengths) - k)]
    index = index[:capped(len(index), max_items)]
    pool = [residues.draw(rng, x).tobytes().decode("ascii") for x in lengths]
    pairs = [(pool[i], pool[j]) for i, j in index]
    per = capped(spec["per_call"], max_items)
    order = rng.permutation(len(pairs))
    pairs = [pairs[q] for q in order]
    return [pairs[s: s + per] for s in range(0, len(pairs), per)]
