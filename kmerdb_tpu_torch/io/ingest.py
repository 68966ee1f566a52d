"""Sample ingest: contig bytes -> sorted, deduplicated packed k-mer arrays.

This replaces the reference's LoaderEx thread pipeline + per-sample
pdqsort (src/loader_ex.{h,cpp}, src/console_build.cpp:94-103) with a
batched vectorized pipeline: contigs are bucketed into padded uint8
blocks and extraction runs as fused vector ops over whole blocks
(the NumPy fallback of the C++ runtime's rolling extraction).  The
device ingest of kmerdb_tpu (KMERDB_DEVICE_INGEST=1) is not ported yet:
the port's CLI refuses that setting.
"""

import numpy as np

from ..types import KMER_SENTINEL
from ..ops.alphabet import Alphabet
from ..ops import extract, minhash
from ..utils import native


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _extract_native(contigs: list[bytes], k: int, alphabet: Alphabet,
                    fraction: float, start: float) -> np.ndarray:
    """C++ rolling extraction per contig; returns unsorted multiset.

    All contigs extract into ONE pooled scratch (consecutive slices),
    and only the valid prefix is copied out through the bulk-
    provisioned allocator — per-contig np.empty + np.concatenate paid
    ~30us/page of fresh-allocation faults per sample, half the scale
    ingest time."""
    pshift, tailmask = extract.prefix_shift(k, alphabet.bits_per_symbol)
    use_filter = fraction < 1.0
    lo, hi = minhash.thresholds(fraction, start) if use_filter else (0, 0)
    cap = sum(max(0, len(c) - k + 1) for c in contigs)
    if cap == 0:
        return np.empty(0, dtype=np.uint64)
    scratch = native.pool.get("extract_out", cap, np.uint64)
    n = 0
    for c in contigs:
        n += native.extract_contig_into(
            np.frombuffer(c, dtype=np.uint8), k, alphabet.mapping,
            alphabet.bits_per_symbol, alphabet.size,
            alphabet.preserve_strand, pshift, tailmask, lo, hi,
            use_filter, scratch[n:])
    out = native.alloc_array(n, np.uint64)
    out[:] = scratch[:n]
    return out


def extract_sample_kmers(contigs: list[bytes], k: int, alphabet: Alphabet,
                         fraction: float = 1.0, start: float = 0.0) -> np.ndarray:
    """All (filtered, canonical) k-mers of one sample: sorted + unique.

    Matches console_build.cpp:94-103 postprocessing: sort + unique of
    the concatenated per-contig extraction output.
    """
    contigs = [c for c in contigs if len(c) >= k]
    if not contigs:
        return np.empty(0, dtype=np.uint64)

    if native.available:
        flat = _extract_native(contigs, k, alphabet, fraction, start)
        return native.sort_unique(flat)

    # bucket contigs by padded length
    buckets: dict[int, list[bytes]] = {}
    for c in contigs:
        buckets.setdefault(max(_ceil_pow2(len(c)), 64), []).append(c)

    pieces = []
    for L, group in sorted(buckets.items()):
        B = len(group)
        block = np.zeros((B, L), dtype=np.uint8)
        lengths = np.zeros(B, dtype=np.int32)
        for i, c in enumerate(group):
            arr = np.frombuffer(c, dtype=np.uint8)
            block[i, :arr.size] = arr
            lengths[i] = arr.size
        out = extract.extract_block_np(block, lengths, k, alphabet,
                                       fraction, start)
        pieces.append(out.ravel())

    flat = np.concatenate(pieces)
    flat.sort()
    n_valid = int(np.searchsorted(flat, KMER_SENTINEL))
    flat = flat[:n_valid]
    if flat.size == 0:
        return flat
    keep = np.empty(flat.size, dtype=bool)
    keep[0] = True
    np.not_equal(flat[1:], flat[:-1], out=keep[1:])
    return np.ascontiguousarray(flat[keep])
