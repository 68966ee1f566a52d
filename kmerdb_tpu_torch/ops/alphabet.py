"""Sequence alphabets: symbol tables + packing geometry.

Behavioral contract from reference src/alphabet.h:10-127: an alphabet
is a comma-separated list of character groups; symbol value = group
index; unknown characters map to -1 (invalid); bitsPerSymbol =
ceil(log2(#groups)); maxKmerLen = 64 // bits - 1 (top bit reserved).
Both upper- and lower-case characters map to their group.
"""

from dataclasses import dataclass, field
import math

import numpy as np

_DESCRIPTIONS = {
    # name: (groups, preserve_strand)   (reference src/alphabet.h:79-86)
    "nt": ("A,C,G,TU", False),
    "nt-preserve": ("A,C,G,TU", True),
    "aa": ("K,R,E,D,Q,N,C,G,H,I,L,V,M,F,Y,W,P,S,T,A", True),
    "aa11_diamond": ("KREDQN,C,G,H,ILV,M,F,Y,W,P,STA", True),
    "aa12_mmseqs": ("AST,C,DN,EQ,FY,G,H,IV,KR,LM,P,W", True),
    "aa6_dayhoff": ("STPAG,NDEQ,HRK,MILV,FYW,C", True),
}


@dataclass(frozen=True)
class Alphabet:
    name: str
    groups: str
    preserve_strand: bool
    size: int = field(init=False)
    bits_per_symbol: int = field(init=False)
    max_kmer_len: int = field(init=False)
    #: int8[256] char byte -> symbol value, -1 for invalid.
    mapping: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        groups = self.groups.split(",")
        size = len(groups)
        bits = max(1, math.ceil(math.log2(size)))
        mapping = np.full(256, -1, dtype=np.int8)
        for gi, group in enumerate(groups):
            for ch in group:
                mapping[ord(ch.upper())] = gi
                mapping[ord(ch.lower())] = gi
        object.__setattr__(self, "size", size)
        object.__setattr__(self, "bits_per_symbol", bits)
        object.__setattr__(self, "max_kmer_len", 64 // bits - 1)
        object.__setattr__(self, "mapping", mapping)


_CACHE: dict[str, Alphabet] = {}


def get_alphabet(name: str) -> Alphabet:
    """Create an alphabet by its CLI name (reference AlphabetFactory)."""
    if name not in _DESCRIPTIONS:
        raise ValueError(f"Invalid alphabet type: {name}")
    if name not in _CACHE:
        groups, preserve = _DESCRIPTIONS[name]
        _CACHE[name] = Alphabet(name=name, groups=groups, preserve_strand=preserve)
    return _CACHE[name]


ALPHABET_NAMES = tuple(_DESCRIPTIONS)
