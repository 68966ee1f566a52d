"""The plain reference against brute-force set intersection of canonical
k-mers, and its CSV lines against hand-written ones."""


import pytest
import torch

from portbench import corpus
from portbench.reference import counts, csvfmt

_COMP = str.maketrans("ACGT", "TGCA")


def _kmer_set(seq: str, k: int) -> set:
    out = set()
    for p in range(len(seq) - k + 1):
        f = seq[p:p + k]
        r = f.translate(_COMP)[::-1]
        out.add(min(f, r))       # ACGT order is the 2-bit codes' order
    return out


@pytest.mark.parametrize("k", [18, 25])
def test_counts_match_brute_force(tmp_path, k):
    spec = {"kind": "clades", "n_samples": 14, "genome_len": 300,
            "branch_rate": 0.02, "clade_exponent": 2.0, "max_clade": 6,
            "sizes_seed": 1}
    lst = corpus.write(spec, 21, str(tmp_path / "c"))
    entries = open(lst).read().split()
    paths = [e + ".fasta" for e in entries]
    # a palindromic k-mer and a short genome among the samples
    pal = "ACGT" * (k // 4) + "ACGTACGT"[:k % 4]
    with open(tmp_path / "odd.fasta", "w") as f:
        f.write(">odd\n" + pal + "TTTTAAAACC" + "\n")
    paths.append(str(tmp_path / "odd.fasta"))
    seqs = [open(p).read().split("\n", 1)[1].replace("\n", "")
            for p in paths]
    sets = [_kmer_set(s, k) for s in seqs]
    rows = [0, 3, 7, len(paths) - 1]
    totals, got = counts.row_counts(paths, k, rows, block=4)
    assert totals.tolist() == [len(s) for s in sets]
    for c, i in enumerate(rows):
        assert got[c].tolist() == [len(sets[i] & s) for s in sets]


def test_bfloat16_control_rounds_counts(tmp_path):
    spec = {"kind": "tree", "n_samples": 6, "genome_len": 2000,
            "branch_rate": 0.002}
    lst = corpus.write(spec, 4, str(tmp_path / "t"))
    paths = [e + ".fasta" for e in open(lst).read().split()]
    _, exact = counts.row_counts(paths, 18, [5])
    _, low = counts.row_counts(paths, 18, [5], dtype=torch.bfloat16)
    assert (exact > 256).all()
    assert (low != exact).any()


def test_canonical_kmers_codes():
    codes = torch.tensor([[0, 1, 2, 3, 3]])        # ACGTT
    got = counts.canonical_kmers(codes, 3).tolist()[0]
    # ACG (0b000110) vs CGT (0b011011): ACG; CGT vs ACG: ACG; GTT vs AAC
    assert got == [0b000110, 0b000110, 0b000001]


def test_csv_lines():
    assert csvfmt.header(18, 1.0, ["a", "b"]) == \
        "kmer-length: 18 fraction: 1 ,db-samples ,a,b,\n"
    assert csvfmt.totals([5, 7]) == "query-samples,total-kmers,5,7,\n"
    dense = csvfmt.Output([])
    assert dense.row("c", 9, [3, 0, 12]) == "c,9,3,0,12,\n"
    assert dense.row("a", 9, []) == "a,9,\n"
    sparse = csvfmt.Output(["-sparse", "-min", "num-kmers:11"])
    assert sparse.row("c", 9, [3, 0, 12, 11]) == "c,9,3:12,4:11,\n"
    with pytest.raises(ValueError):
        csvfmt.Output(["-sparse", "-min", "jaccard:0.5"])
