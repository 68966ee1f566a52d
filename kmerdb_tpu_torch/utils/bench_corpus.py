"""Deterministic synthetic benchmark corpus.

The reference's scale corpus (ICTV phage set, test/ictv/ictv.list) is
not committed, so the benchmark uses a reproducible stand-in with
similar structure: clusters of related genomes (shared ancestry +
point mutations) so the pattern decomposition is non-trivial, as in
real pangenome collections.
"""

import os

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_corpus(out_dir, list_path, marker, rng, ancestors,
                  n_samples, genome_len):
    paths = []
    n_ancestors = len(ancestors)
    for i in range(n_samples):
        anc = ancestors[i % n_ancestors]
        rate = 0.001 + 0.02 * (i / n_samples)
        genome = anc.copy()
        n_mut = int(genome_len * rate)
        pos = rng.integers(0, genome_len, size=n_mut)
        genome[pos] = (genome[pos] + rng.integers(1, 4, size=n_mut)) % 4
        _write_fasta(out_dir, f"s{i:04d}", genome, paths)
    with open(list_path, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    with open(marker, "w") as f:
        f.write("ok")
    return list_path


def _write_fasta(out_dir, name, genome, paths):
    seq = _BASES[genome]
    path = os.path.join(out_dir, name + ".fasta")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for j in range(0, genome.size, 80):
            f.write(seq[j:j + 80].tobytes() + b"\n")
    paths.append(os.path.join(out_dir, name))


def generate_scale(out_dir: str, n_samples: int = 2048,
                   genome_len: int = 100_000, branch_rate: float = 0.005,
                   seed: int = 20270101) -> str:
    """Phylogenetic scale corpus (the ICTV-scale role,
    /root/reference/test/ictv/ictv.list — upstream's input data is not
    committed, so the role is filled by a reproducible stand-in).

    Genomes evolve along a random binary tree: each branch applies
    point mutations, so a k-mer born on a branch is carried by that
    subtree minus downstream re-mutation holes.  That yields the
    many-distinct-sample-subsets pattern structure of real pangenome
    collections — the regime the pattern decomposition and the
    device/host crossover are designed for.
    """
    os.makedirs(out_dir, exist_ok=True)
    list_path = os.path.join(out_dir, "corpus.list")
    marker = os.path.join(out_dir, ".complete")
    if os.path.exists(marker) and os.path.exists(list_path):
        return list_path

    rng = np.random.default_rng(seed)
    root = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    paths = []
    counter = [0]

    def mutate(genome):
        child = genome.copy()
        n_mut = int(genome_len * branch_rate)
        pos = rng.integers(0, genome_len, size=n_mut)
        child[pos] = (child[pos] + rng.integers(1, 4, size=n_mut)) % 4
        return child

    # iterative DFS over an implicit balanced binary tree with
    # n_samples leaves; only the path genomes are held in memory
    stack = [(root, n_samples)]
    while stack:
        genome, leaves = stack.pop()
        if leaves == 1:
            _write_fasta(out_dir, f"g{counter[0]:05d}", genome, paths)
            counter[0] += 1
            continue
        left = leaves // 2
        stack.append((mutate(genome), leaves - left))
        stack.append((mutate(genome), left))

    with open(list_path, "w") as f:
        f.write("".join(p + "\n" for p in paths))
    with open(marker, "w") as f:
        f.write("ok")
    return list_path
