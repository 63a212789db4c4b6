"""Traffic of kind ``pairs``: pairs drawn from a pool of unrelated
sequences.

    {"kind": "pairs", "pool": [lengths], "cut": null or a length,
     "pairing": {"every": k}, "per_call": n}

The pool holds one random sequence of each length, each cut on its own
to ``cut`` where given. Its pairs (i < j) of the sorted lengths, in
lexicographic order, are taken every ``every``-th; the seed orders them,
and each call holds ``per_call`` of them.
"""

from generate import capped, scaled


def calls(spec, residues, rng, scale, max_items):
    lengths = sorted(scaled(spec["pool"], scale))
    cut = spec.get("cut")
    if cut is not None:
        cut = max(4, round(cut * scale))
        lengths = [min(x, cut) for x in lengths]
    n = len(lengths)
    index = [(i, j) for i in range(n)
             for j in range(i + 1, n)][::spec["pairing"]["every"]]
    index = index[:capped(len(index), max_items)]
    pool = [residues.draw(rng, x).tobytes().decode("ascii") for x in lengths]
    pairs = [(pool[i], pool[j]) for i, j in index]
    per = capped(spec["per_call"], max_items)
    order = rng.permutation(len(pairs))
    pairs = [pairs[k] for k in order]
    return [pairs[s: s + per] for s in range(0, len(pairs), per)]
