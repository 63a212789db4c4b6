"""Every seed gives a cell the same calls, the same multiset of pair
lengths and so the same cells to count, and the same length buckets of
the batch (quantum 128); only the residues and the order differ. That is
not the same work for the partition, whose second solves and segment
widths follow the residues."""

import collections
import hashlib

import pytest

import generate
import manifest

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
QUANTUM = 128  # the program's bucket quantum on both axes


def work(p, swap):
    """The seed-free shape of a pass: the sorted call sizes, the multiset
    of oriented pair lengths and of bucket keys."""
    la, lb = p.oriented_lengths(swap)
    keys = collections.Counter(zip((-(-la // QUANTUM) * QUANTUM).tolist(),
                                   (-(-lb // QUANTUM) * QUANTUM).tolist()))
    return (sorted(len(c) for c in p.calls),
            sorted(zip(la.tolist(), lb.tolist())), keys)


# sha256 of each cell's pass as ``digest`` reads it: (workload, seed) ->
# digest. A change to a generator or a traffic file that changes a pass
# shows here.
PASSES = {
    ("dna-genes-batch", 0):
        "aa2443a2f4aa4b95d359727a0e845c1e17843ce1914e2ea1632c104dcf3e83b1",
    ("dna-genes-batch", 2 ** 31 + 12345):
        "802165f579977b09591465b9119ee800c316901b99b3e2bddd069709e704136c",
    ("dna-genes-batch", 3210000001):
        "3d8c8a7e7b20a2c2294a775c20fa9ed6e3f87ddcaba7f30aae786c516fb19be0",
    ("dna-genes-batch", 2 ** 33 + 7):
        "031b925f69e3592a336d7abac99657956f94f866e3a0e48a4b1d04d8cc02ae10",
    ("dna-genes-partition", 0):
        "008cb1bc3fbafa6f17edd6552a6fba67ff93cb32858596cb72dcd2ed196d51b7",
    ("dna-genes-partition", 2 ** 31 + 12345):
        "0b973b00b04a2ee5e30787a02a39020d3dde70cd1cd741b3a372f8c74c31e3c7",
    ("dna-genes-partition", 3210000001):
        "2ebfdaf23f8e9962a20dfea4c9eb9f28d76f2d8ff42c51097878ea3b0d97f56d",
    ("dna-genes-partition", 2 ** 33 + 7):
        "79381d3b603ebaeb48e6e729e22030c2a0ee430031e068bc17dceee2372bd40a",
}


def digest(calls):
    h = hashlib.sha256()
    for call in calls:
        h.update(b"|call|")
        for a, b in call:
            h.update(a.encode() + b"," + b.encode() + b";")
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", list(PASSES))
def test_pass_is_the_same_bytes(name, seed):
    cell = manifest.Cell(BENCH, name)
    p = generate.make_pass(cell.traffic, cell.config, seed)
    assert digest(p.calls) == PASSES[name, seed]


@pytest.mark.parametrize("name", CELLS)
def test_pass_work_is_the_same_for_every_seed(name):
    cell = manifest.Cell(BENCH, name)
    swap = cell.config["parity_swap"]
    passes = [generate.make_pass(cell.traffic, cell.config, s)
              for s in range(12)]
    first = work(passes[0], swap)
    for p in passes[1:]:
        assert work(p, swap) == first
        assert p.cells(swap) == passes[0].cells(swap)
    # the seed does change the residues
    assert passes[0].calls != passes[1].calls


@pytest.mark.parametrize("name", CELLS)
def test_large_seed_and_its_repeat(name):
    cell = manifest.Cell(BENCH, name)
    seed = 2 ** 33 + 7
    a = generate.make_pass(cell.traffic, cell.config, seed, 0.05, 4)
    b = generate.make_pass(cell.traffic, cell.config, seed, 0.05, 4)
    assert a.calls == b.calls


def test_gene_batch_is_the_stated_pass():
    """One call of 64 pairs, every third of the 190 pairs of the 20 genes,
    each sequence cut on its own to 16,384 nt."""
    cell = manifest.Cell(BENCH, "dna-genes-batch")
    p = generate.make_pass(cell.traffic, cell.config, 0)
    assert [len(c) for c in p.calls] == [64]
    cut = cell.config["batch_cut_nt"]
    genes = sorted(min(x, cut) for x in cell.config["gene_lengths_nt"])
    index = [(i, j) for i in range(20) for j in range(i + 1, 20)][::3]
    want = sorted((genes[i], genes[j]) for i, j in index)
    assert sorted(zip(*[x.tolist() for x in p.oriented_lengths()])) == want
    assert p.cells() == 7 * 13_309 * 16_384 + 57 * 16_384 ** 2


def test_unknown_kind_is_refused():
    cell = manifest.Cell(BENCH, CELLS[0])
    traffic = dict(cell.traffic, calls=dict(cell.traffic["calls"],
                                            kind="no-such-kind"))
    with pytest.raises(LookupError):
        generate.make_pass(traffic, cell.config, 0)
