"""Vectorized k-mer extraction: sequence bytes -> packed canonical k-mers.

Behavioral contract (reference src/kmer_extract.h:13-97):

* packing: symbol stream s[0..L-1]; forward k-mer ending at position e
  is  sum_j s[e-k+1+j] << ((k-1-j)*bits);  reverse complement is
  sum_j (size-1-s[e-k+1+j]) << (j*bits);  canonical = min(fwd, rev)
  unless the alphabet preserves strand.
* invalid symbols (mapping < 0) invalidate every window containing
  them (the reference's omit_next_n_kmers counter is equivalent to
  "window contains an invalid position", see the sliding-window
  analysis in the docstring of _window_invalid).
* >=8-bit-prefix guarantee: with prefix_bits = k*bits - 32, if
  prefix_bits < 8 the k-mer is shifted left by (8 - prefix_bits) and
  its low (8 - prefix_bits) bits are duplicated into the vacated
  positions (kmer_extract.h:37-45, 87-88).  The minhash hash operates
  on this *shifted* value, so parity requires it.

The reference walks each contig serially with a rolling pair of
registers; here whole padded batches of contigs are processed as u64
vector lanes with two Horner scans of k static steps — the TPU-native
equivalent (VPU-parallel over positions instead of loop-carried).

This is the NumPy half of kmerdb_tpu/ops/extract.py: `extract_block_np`
(host oracle / fallback of the C++ runtime) and the scalar reference.  The
device half is not carried over (device ingest is not ported yet).
"""

import numpy as np

from ..types import KMER_SENTINEL
from .alphabet import Alphabet
from . import minhash


def prefix_shift(kmer_length: int, bits_per_symbol: int) -> tuple[int, int]:
    """(shift, tail_mask) of the >=8-bit-prefix adjustment."""
    prefix_bits = kmer_length * bits_per_symbol - 32
    if prefix_bits < 8:
        shift = 8 - prefix_bits
        return shift, (1 << shift) - 1
    return 0, 0


# ---------------------------------------------------------------------------
# host (NumPy) implementation — oracle + fallback
# ---------------------------------------------------------------------------

def extract_block_np(seqs: np.ndarray, lengths: np.ndarray, k: int,
                     alphabet: Alphabet, fraction: float = 1.0,
                     start: float = 0.0) -> np.ndarray:
    """Extract k-mers from a padded byte block.

    seqs: uint8[B, L] sequence characters (padding arbitrary).
    lengths: int[B] true lengths.
    Returns uint64[B, L-k+1] packed k-mers with KMER_SENTINEL in
    positions that are out-of-range / invalid / filtered out.
    """
    B, L = seqs.shape
    V = L - k + 1
    if V <= 0:
        return np.full((B, 0), KMER_SENTINEL, dtype=np.uint64)
    bits = alphabet.bits_per_symbol

    sym = alphabet.mapping[seqs]                    # int8[B, L]
    pos = np.arange(L, dtype=np.int64)[None, :]
    invalid = (sym < 0) | (pos >= np.asarray(lengths, dtype=np.int64)[:, None])
    s = np.where(invalid, 0, sym).astype(np.uint64)

    with np.errstate(over="ignore"):
        fwd = np.zeros((B, V), dtype=np.uint64)
        for j in range(k):
            fwd = (fwd << np.uint64(bits)) | s[:, j:V + j]
        if alphabet.preserve_strand:
            canon = fwd
        else:
            comp = np.uint64(alphabet.size - 1) - s
            rev = np.zeros((B, V), dtype=np.uint64)
            for j in range(k - 1, -1, -1):
                rev = (rev << np.uint64(bits)) | comp[:, j:V + j]
            canon = np.minimum(fwd, rev)

        shift, tail_mask = prefix_shift(k, bits)
        if shift:
            canon = (canon << np.uint64(shift)) | (canon & np.uint64(tail_mask))

    c = np.zeros((B, L + 1), dtype=np.int32)
    np.cumsum(invalid, axis=1, out=c[:, 1:])
    window_bad = (c[:, k:] - c[:, :V]) > 0          # any invalid in window

    keep = ~window_bad
    if fraction < 1.0:
        keep &= minhash.accept_mask_np(canon, k, fraction, start)
    return np.where(keep, canon, KMER_SENTINEL)


# ---------------------------------------------------------------------------
# scalar reference (direct transliteration of the semantics, for tests)
# ---------------------------------------------------------------------------

def extract_kmers_scalar(sequence: bytes, k: int, alphabet: Alphabet,
                         fraction: float = 1.0, start: float = 0.0) -> list[int]:
    """Slow, obviously-correct single-contig extraction used as a test
    oracle for the vectorized paths (matches kmer_extract.h:13-97)."""
    L = len(sequence)
    if L < k:
        return []
    bits = alphabet.bits_per_symbol
    mask = (1 << (bits * k)) - 1
    shift, tail_mask = prefix_shift(k, bits)
    lo_thr, hi_thr = minhash.thresholds(fraction, start)

    kmer_str = 0
    kmer_rev = 0
    omit = 0
    out = []
    for i in range(L):
        symb = int(alphabet.mapping[sequence[i]])
        if symb < 0:
            symb = 0
            omit = k if i >= k - 1 else i + 1
        kmer_str = ((kmer_str << bits) | symb) & mask
        kmer_rev = (kmer_rev >> bits) | ((alphabet.size - 1 - symb) << ((k - 1) * bits))
        if i < k - 1:
            continue
        if omit > 0:
            omit -= 1
            continue
        canon = kmer_str if alphabet.preserve_strand else min(kmer_str, kmer_rev)
        canon = (canon << shift) | (canon & tail_mask)
        if fraction >= 1.0:
            out.append(canon)
        else:
            h = int(minhash.hash_np(np.array([canon], dtype=np.uint64), k)[0])
            if lo_thr <= h < hi_thr:
                out.append(canon)
    return out
