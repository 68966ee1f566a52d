"""Binary .minhash sample files, bit-compatible with the reference
(src/minhashed_input_file.h:43-118): little-endian
[u32 magic 0xfedcba98][u64 count][count * u64 kmers][u32 k][f64 fraction].
"""

import struct

import numpy as np

MAGIC = 0xFEDCBA98


def store(path_base: str, kmers: np.ndarray, kmer_length: int,
          fraction: float) -> None:
    with open(path_base + ".minhash", "wb") as f:
        f.write(struct.pack("<I", MAGIC))
        f.write(struct.pack("<Q", kmers.size))
        f.write(np.ascontiguousarray(kmers, dtype="<u8").tobytes())
        f.write(struct.pack("<I", kmer_length))
        f.write(struct.pack("<d", fraction))


def load(path_base: str):
    """Returns (kmers u64[], kmer_length, fraction) or None on failure."""
    try:
        with open(path_base + ".minhash", "rb") as f:
            magic, = struct.unpack("<I", f.read(4))
            if magic != MAGIC:
                return None
            count, = struct.unpack("<Q", f.read(8))
            kmers = np.frombuffer(f.read(8 * count), dtype="<u8")
            kmer_length, = struct.unpack("<I", f.read(4))
            fraction, = struct.unpack("<d", f.read(8))
        return np.asarray(kmers, dtype=np.uint64), kmer_length, fraction
    except (OSError, struct.error, ValueError):
        # ValueError: truncated file whose stored count exceeds the
        # remaining bytes (np.frombuffer size mismatch) — treat like
        # any other unreadable input
        return None
