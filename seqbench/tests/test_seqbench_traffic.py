"""Every seed gives a cell the same work: the same calls, the same
multiset of pair lengths and so the same cells, and the same length
buckets; only the residues and the order differ."""

import collections

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
