"""The benchmark's corpus generator: seeded, a copy of the port's scale
corpus for one tree, and clades that follow their law, in list order."""

import filecmp
import os

import numpy as np

from kmerdb_tpu_torch.utils import bench_corpus
from portbench import corpus

TREE = {"kind": "tree", "n_samples": 12, "genome_len": 500,
        "branch_rate": 0.01}
CLADES = {"kind": "clades", "n_samples": 60, "genome_len": 400,
          "branch_rate": 0.01, "clade_exponent": 2.0, "max_clade": 16,
          "sizes_seed": 3}


def _files(d):
    return sorted(f for f in os.listdir(d) if f != corpus.MARKER)


def test_same_seed_same_bytes(tmp_path):
    for spec in (TREE, CLADES):
        a = corpus.write(spec, 2**31 + 5, str(tmp_path / spec["kind"] / "a"))
        b = corpus.write(spec, 2**31 + 5, str(tmp_path / spec["kind"] / "b"))
        da, db = os.path.dirname(a), os.path.dirname(b)
        names = _files(da)
        assert names == _files(db)
        assert len(names) == spec["n_samples"] + 1
        _, mismatch, errors = filecmp.cmpfiles(
            da, db, [n for n in names if n != corpus.LIST_NAME],
            shallow=False)
        assert not mismatch and not errors
        c = corpus.write(spec, 7, str(tmp_path / spec["kind"] / "c"))
        assert not filecmp.cmp(os.path.join(da, "g00001.fasta"),
                               os.path.join(os.path.dirname(c),
                                            "g00001.fasta"), shallow=False)


def test_tree_is_the_scale_corpus(tmp_path):
    """The tree kind writes generate_scale's genomes for the same seed."""
    ours = os.path.dirname(corpus.write(TREE, 99, str(tmp_path / "ours")))
    theirs = os.path.dirname(bench_corpus.generate_scale(
        str(tmp_path / "theirs"), n_samples=TREE["n_samples"],
        genome_len=TREE["genome_len"], branch_rate=TREE["branch_rate"],
        seed=99))
    for i in range(TREE["n_samples"]):
        name = corpus.sample_name(i) + ".fasta"
        assert filecmp.cmp(os.path.join(ours, name),
                           os.path.join(theirs, name), shallow=False)


def test_clade_sizes_follow_the_law():
    sizes = []
    for seed in range(40):
        s = corpus.clade_sizes(corpus.rng_for(seed), 2000, 2.0, 64)
        assert sum(s) == 2000 and all(1 <= x <= 64 for x in s)
        sizes += s[:-1]                      # the last is cut to fit
    sizes = np.array(sizes)
    p = np.arange(1, 65, dtype=float) ** -2.0
    p /= p.sum()
    for size in (1, 2, 3):
        assert abs((sizes == size).mean() - p[size - 1]) < 0.02


def _clade_starts(spec, seed):
    """The first genome of each clade: a clade's genomes differ in a few
    per cent of sites, genomes of two clades in about three quarters."""
    gs = list(corpus.genomes(spec, seed))
    assert len(gs) == spec["n_samples"]
    starts = [0]
    for i in range(1, len(gs)):
        diff = (gs[i] != gs[i - 1]).mean()
        assert diff > 0.6 or diff < 0.2
        if diff > 0.6:
            starts.append(i)
    return starts


def test_clades_listed_in_clade_order():
    """Genomes of one clade are contiguous, and every seed lists the same
    clade sizes (sizes_seed's), in an order of its own."""
    sizes = corpus.clade_sizes(corpus.rng_for(CLADES["sizes_seed"]),
                               CLADES["n_samples"], CLADES["clade_exponent"],
                               CLADES["max_clade"])
    orders = []
    for seed in (3, 4):
        starts = _clade_starts(CLADES, seed)
        got = np.diff(starts + [CLADES["n_samples"]]).tolist()
        assert sorted(got) == sorted(sizes)
        orders.append(got)
    assert orders[0] != orders[1]
