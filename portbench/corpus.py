"""Synthetic phage collections from a seed: the benchmark's inputs.

``tree`` is the repository's scale corpus (the ICTV-scale stand-in): genomes
evolve along one balanced binary tree from a random root, each branch
applying ``branch_rate`` point mutations, so every pair of samples shares
k-mers and the k-mer sample sets form many distinct patterns.  The code is
a copy of kmerdb_tpu_torch/utils/bench_corpus.generate_scale (the same
genomes for the same seed), which the benchmark does not import.

``clades`` is a diverse collection: clades whose sizes follow a power law
(P(size = s) proportional to s^-exponent over 1..max_clade), drawn from
``sizes_seed`` until ``n_samples`` genomes, each clade a ``tree`` of its own
with its own random root, listed in clade order as a taxonomic list is.
Every seed gets the same sizes, in an order of its own: the seed draws the
genomes, not the amount of work.  Unrelated clades share only chance k-mers.

Run as a script, it writes one configuration's corpus:
``python portbench/corpus.py <config.json> <seed> <out_dir>``.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
LINE = 80
MARKER = ".complete"
LIST_NAME = "corpus.list"
#: threads that write the FASTA files
WRITERS = 8


def rng_for(seed: int) -> np.random.Generator:
    """The generator of a seed; any integer, negative or above 64 bits, maps
    to one stream."""
    return np.random.default_rng(seed % (1 << 64))


def fasta_bytes(name: str, genome: np.ndarray) -> bytes:
    """One FASTA record: '>' name, then the bases in lines of 80."""
    seq = _BASES[genome]
    full = seq.size // LINE * LINE
    lines = np.empty((full // LINE, LINE + 1), dtype=np.uint8)
    lines[:, :LINE] = seq[:full].reshape(-1, LINE)
    lines[:, LINE] = ord("\n")
    tail = seq[full:].tobytes() + b"\n" if seq.size > full else b""
    return b">" + name.encode() + b"\n" + lines.tobytes() + tail


def tree_leaves(rng: np.random.Generator, root: np.ndarray, n_leaves: int,
                branch_rate: float):
    """The leaves of a balanced binary tree over n_leaves, in depth-first
    order (generate_scale's order): each child is its parent with
    int(len * branch_rate) point mutations to another base."""
    genome_len = root.size
    n_mut = int(genome_len * branch_rate)

    def mutate(genome):
        child = genome.copy()
        pos = rng.integers(0, genome_len, size=n_mut)
        child[pos] = (child[pos] + rng.integers(1, 4, size=n_mut)) % 4
        return child

    stack = [(root, n_leaves)]
    while stack:
        genome, leaves = stack.pop()
        if leaves == 1:
            yield genome
            continue
        left = leaves // 2
        stack.append((mutate(genome), leaves - left))
        stack.append((mutate(genome), left))


def clade_sizes(rng: np.random.Generator, n_samples: int, exponent: float,
                max_clade: int) -> list:
    """Clade sizes drawn from the power law until their sum reaches
    n_samples; the last is cut so that the sizes sum to n_samples."""
    support = np.arange(1, max_clade + 1)
    p = support.astype(np.float64) ** -exponent
    p /= p.sum()
    sizes: list = []
    total = 0
    while total < n_samples:
        s = int(rng.choice(support, p=p))
        s = min(s, n_samples - total)
        sizes.append(s)
        total += s
    return sizes


def genomes(spec: dict, seed: int):
    """Every genome of the corpus `spec` (a configuration's "corpus"), in
    list order, as base codes 0..3."""
    rng = rng_for(seed)
    n, length, rate = spec["n_samples"], spec["genome_len"], \
        spec["branch_rate"]
    if spec["kind"] == "tree":
        root = rng.integers(0, 4, size=length, dtype=np.int8)
        yield from tree_leaves(rng, root, n, rate)
    elif spec["kind"] == "clades":
        # one set of clade sizes for every seed (drawn from sizes_seed), in
        # the seed's order: the seed changes the genomes, not the amount of
        # work
        sizes = clade_sizes(rng_for(spec["sizes_seed"]), n,
                            spec["clade_exponent"], spec["max_clade"])
        for j in rng.permutation(len(sizes)):
            size = sizes[j]
            root = rng.integers(0, 4, size=length, dtype=np.int8)
            yield from tree_leaves(rng, root, size, rate)
    else:
        raise ValueError(f"unknown corpus kind {spec['kind']!r}")


def sample_name(i: int) -> str:
    return f"g{i:05d}"


def write(spec: dict, seed: int, out_dir: str) -> str:
    """Writes one FASTA file a genome and the sample list into out_dir and
    returns the list's path; a directory already marked complete is kept.
    The genomes are drawn in order; threads write the files."""
    list_path = os.path.join(out_dir, LIST_NAME)
    marker = os.path.join(out_dir, MARKER)
    if os.path.exists(marker):
        return list_path
    os.makedirs(out_dir, exist_ok=True)
    entries = []

    def put(path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    with ThreadPoolExecutor(WRITERS) as pool:
        pending = []
        for i, genome in enumerate(genomes(spec, seed)):
            name = sample_name(i)
            pending.append(pool.submit(
                put, os.path.join(out_dir, name + ".fasta"),
                fasta_bytes(name, genome)))
            entries.append(os.path.join(out_dir, name) + "\n")
            if len(pending) >= 4 * WRITERS:
                for fut in pending:
                    fut.result()
                pending.clear()
        for fut in pending:
            fut.result()
    if len(entries) != spec["n_samples"]:
        raise RuntimeError(f"{len(entries)} genomes, "
                           f"{spec['n_samples']} asked for")
    with open(list_path, "w") as f:
        f.write("".join(entries))
    with open(marker, "w") as f:
        f.write("ok")
    return list_path


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        config = json.load(f)
    write(config["corpus"], int(sys.argv[2]), sys.argv[3])
