"""Common canonical k-mer counts from the genomes, in plain PyTorch.

A sample's k-mers are the distinct canonical k-mers of its sequence: each
k-mer and its reverse complement count as one, and the one whose 2-bit code
is smaller stands for both.  The common count of two samples is the size of
the intersection of their sets; the totals row holds each set's size.

row_counts computes, for a few rows r (samples drawn by the caller), the
count of every sample j against every r, in one pass over the collection:
U is the sorted union of the drawn samples' k-mers and M (|U| x r) their
membership; a block of samples becomes its 0/1 incidence X over U, and
X @ M holds the counts.  The products run in float32 with TF32 off: 0/1
operands and sums below 2^24 are exact.  ``dtype=torch.bfloat16`` is the
benchmark's control: the same products with bfloat16 results, which round
counts above 256.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: threads that read the FASTA files
READERS = 8

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i


def read_fasta(path: str) -> np.ndarray:
    """The base codes (0..3) of a one-record nucleotide FASTA file."""
    with open(path, "rb") as f:
        data = f.read()
    seq = data[data.index(b"\n") + 1:].replace(b"\n", b"").replace(b"\r", b"")
    codes = _CODE[np.frombuffer(seq, dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError(f"{path}: a base other than A, C, G, T")
    return codes


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """int64 canonical k-mers of equal-length sequences (b x L codes):
    b x (L - k + 1), position order."""
    if not 1 <= k <= 31:
        raise ValueError(f"k {k} outside 1..31")
    c = codes.to(torch.int64)
    n = c.shape[1] - k + 1
    fwd = torch.zeros((c.shape[0], n), dtype=torch.int64, device=c.device)
    rev = torch.zeros_like(fwd)
    for t in range(k):
        fwd = (fwd << 2) | c[:, t:t + n]
        # the reverse complement's t-th base is the complement of the
        # k-mer's (k-1-t)-th
        rev = (rev << 2) | (3 - c[:, k - 1 - t:k - 1 - t + n])
    return torch.minimum(fwd, rev)


def distinct_sorted(kmers: torch.Tensor):
    """(sorted rows, mask of each row's first occurrences)."""
    s, _ = torch.sort(kmers, dim=1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    return s, first


def _kmer_block(part, k: int, device):
    """(sorted k-mers, first-occurrence mask) of a block of genomes, padded
    with -1 (never a k-mer) to the longest."""
    n = max(a.size for a in part) - k + 1
    out = torch.full((len(part), max(n, 1)), -1, dtype=torch.int64,
                     device=device)
    for length in sorted({a.size for a in part}):
        rows = [i for i, a in enumerate(part) if a.size == length]
        if length < k:
            continue
        codes = torch.from_numpy(np.stack([part[i] for i in rows])).to(device)
        out[rows, :length - k + 1] = canonical_kmers(codes, k)
    s, first = distinct_sorted(out)
    return s, first & (s >= 0)


def row_counts(paths, k: int, rows, device="cpu", block: int = 512,
               dtype=torch.float32):
    """(totals, counts): each sample's distinct k-mer count (int64, S), and
    the common counts of the drawn rows against every sample (int64,
    len(rows) x S).  The genomes are read from `paths` (FASTA files);
    dtype is the products' precision (float32 exact, bfloat16 the
    control)."""
    device = torch.device(device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _row_counts(paths, k, list(rows), device, block, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _row_counts(paths, k, rows, device, block, dtype):
    S = len(paths)
    sets = []
    for r in rows:
        s, first = _kmer_block([read_fasta(paths[r])], k, device)
        sets.append(s[first])
    U = torch.unique(torch.cat(sets)) if sets else \
        torch.empty(0, dtype=torch.int64, device=device)
    M = torch.zeros((U.numel(), len(rows)), dtype=dtype, device=device)
    for c, s in enumerate(sets):
        M[torch.searchsorted(U, s), c] = 1
    totals = torch.zeros(S, dtype=torch.int64)
    counts = torch.zeros((len(rows), S), dtype=torch.int64)
    with ThreadPoolExecutor(READERS) as pool:
        genomes = pool.map(read_fasta, paths)
        for b0 in range(0, S, block):
            part = list(itertools.islice(genomes, block))
            s, first = _kmer_block(part, k, device)
            totals[b0:b0 + len(part)] = first.sum(1).cpu()
            if U.numel() == 0:
                continue
            idx = torch.searchsorted(U, s).clamp_(max=U.numel() - 1)
            hit = first & (U[idx] == s)
            X = torch.zeros((len(part), U.numel()), dtype=dtype,
                            device=device)
            bi, pi = torch.nonzero(hit, as_tuple=True)
            X[bi, idx[bi, pi]] = 1
            C = X @ M
            counts[:, b0:b0 + len(part)] = C.T.to(torch.float64).round() \
                .to(torch.int64).cpu()
    return totals, counts
