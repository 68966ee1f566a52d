"""Core scalar types and k-mer bit-layout constants.

Mirrors the semantics of reference src/types.h:5-27: k-mers are packed
into uint64 with the top bit never used by a valid k-mer; the low 32
bits are the "suffix" and the remaining high bits the "prefix" (after
the >=8-bit-prefix rotation applied at extraction time,
src/kmer_extract.h:37-45).
"""

import numpy as np

KMER_DTYPE = np.uint64
SAMPLE_ID_DTYPE = np.uint32
NUM_KMERS_DTYPE = np.uint32
PATTERN_ID_DTYPE = np.int32

SUFFIX_BITS = 32
SUFFIX_MASK = np.uint64((1 << SUFFIX_BITS) - 1)

#: Sentinel used for padded / filtered-out k-mer slots.  A valid packed
#: k-mer never has the MSB set (alphabet.maxKmerLen reserves the top
#: bit, reference src/alphabet.h:38), so all-ones is never a k-mer.
KMER_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
