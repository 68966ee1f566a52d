"""KMC database (.kmc_pre / .kmc_suf) reader.

Format contract derived from the reference's vendored reader
(src/kmc_api/kmc_file.cpp: ReadParamsFrom_prefix_file_buf :176-296,
ReadNextKmer :427-520) and the consuming code (src/kmc_input_file.h:
54-135).  Both KMC1 (version 0) and KMC2 (version 0x200) layouts:

.kmc_pre: [4B marker "KMCP"] [LUT: uint64 little-endian record-start
index per prefix (KMC2: per (signature bin, prefix))] [KMC2 only:
signature map] [header fields] [u32 version] [u32 header_offset byte]
[4B marker "KMCP"]

.kmc_suf: [4B marker "KMCS"] [total_kmers records: suffix_size bytes of
big-endian 2-bit-packed suffix symbols + counter_size bytes counter]
[4B marker "KMCS"]

k-mer value = (prefix_index & prefix_mask) << 2*(k - lut_prefix_len)
              | suffix_bits — the standard A=0,C=1,G=2,T=3 packing the
reference gets via CKmerAPI::to_long.  Counters are ignored (kmer-db
only uses k-mer identity, kmc_input_file.h:109-118); the >=8-bit-prefix
shift and minhash window are applied like the reference (:95-118).
"""

import struct

import numpy as np

from ..ops import extract, minhash


class KmcFormatError(Exception):
    pass


def _read_params(pre: bytes):
    if pre[:4] != b"KMCP" or pre[-4:] != b"KMCP":
        raise KmcFormatError("bad .kmc_pre markers")
    version, = struct.unpack_from("<I", pre, len(pre) - 12)
    header_offset = pre[len(pre) - 8]
    if version == 0x200:
        # KMC2: header fields at -(header_offset + 8) from end
        base = len(pre) - (header_offset + 8)
        (k, mode, counter_size, lut_prefix_len, signature_len,
         min_count, max_count) = struct.unpack_from("<7I", pre, base)
        total_kmers, = struct.unpack_from("<Q", pre, base + 28)
        sig_map_size = (1 << (2 * signature_len)) + 1
        size = len(pre) - 8 - 4  # minus markers minus header_offset word
        lut_area = size - (sig_map_size * 4 + header_offset + 8)
        n_lut = lut_area // 8
        lut = np.frombuffer(pre, dtype="<u8", count=n_lut, offset=4).copy()
        prefix_mask = (1 << (2 * lut_prefix_len)) - 1
    elif version == 0:
        size = len(pre) - 8 - 4
        buf = np.frombuffer(pre, dtype="<u8",
                            count=(len(pre) - 12) // 8, offset=4)
        header_index = (size - header_offset) // 8
        d = int(buf[header_index])
        k = d & 0xFFFFFFFF
        counter_size = int(buf[header_index + 1]) & 0xFFFFFFFF
        lut_prefix_len = int(buf[header_index + 1]) >> 32
        total_kmers = int(buf[header_index + 3])
        n_lut = header_index
        lut = buf[:n_lut].copy()
        prefix_mask = (1 << (2 * lut_prefix_len)) - 1
    else:
        raise KmcFormatError(f"unsupported KMC version 0x{version:x}")
    return k, counter_size, lut_prefix_len, total_kmers, lut, prefix_mask


def load(path: str, fraction: float, fraction_start: float = 0.0):
    """Returns (kmers uint64[] unsorted, kmer_length) or None if the
    files cannot be opened."""
    try:
        with open(path + ".kmc_pre", "rb") as f:
            pre = f.read()
        with open(path + ".kmc_suf", "rb") as f:
            suf = f.read()
    except OSError:
        return None
    k, counter_size, lut_len, total, lut, prefix_mask = _read_params(pre)
    if suf[:4] != b"KMCS" or suf[-4:] != b"KMCS":
        raise KmcFormatError("bad .kmc_suf markers")
    if k > 32:
        raise KmcFormatError("k > 32 KMC databases are not supported")

    suffix_size = (k - lut_len) // 4
    rec_size = suffix_size + counter_size
    recs = np.frombuffer(suf, dtype=np.uint8, count=total * rec_size,
                         offset=4).reshape(total, rec_size)

    # suffix value: big-endian byte packing of 2-bit symbols
    sufv = np.zeros(total, dtype=np.uint64)
    for b in range(suffix_size):
        sufv = (sufv << np.uint64(8)) | recs[:, b].astype(np.uint64)

    # prefix per record from the LUT (monotone record-start indices);
    # empty prefixes collapse to the last equal index, matching
    # ReadNextKmer's skip-empty loop (kmc_file.cpp:452-457)
    starts = np.minimum(lut, np.uint64(total))
    rec_idx = np.arange(total, dtype=np.uint64)
    pfx_pos = np.searchsorted(starts, rec_idx, side="right") - 1
    prefix = (pfx_pos.astype(np.uint64)) & np.uint64(prefix_mask)

    kmers = (prefix << np.uint64(2 * 4 * suffix_size)) | sufv

    # >=8-bit-prefix widening + minhash window (kmc_input_file.h:95-118)
    pshift, tailmask = extract.prefix_shift(k, 2)
    if pshift:
        kmers = (kmers << np.uint64(pshift)) | (kmers & np.uint64(tailmask))
    if fraction < 1.0:
        keep = minhash.accept_mask_np(kmers, k, fraction, fraction_start)
        kmers = kmers[keep]
    return np.ascontiguousarray(kmers), int(k)
