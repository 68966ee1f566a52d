"""Database (de)serialization with partial-load modes.

The DB file is the checkpoint artifact, exactly as in the reference
(SURVEY §5): build writes it, every query mode loads it, -extend loads
then continues.  The on-disk format is ours (CSV parity is judged on
outputs, not DB bytes): a flat binary container — a JSON header with a
section table, followed by per-section array bytes — whose sections
can be loaded selectively, mirroring the reference's partial
deserialization modes (kmer_db.h:55-60):

* SAMPLES_ONLY   -> metadata + sample table            (SamplesOnly)
* PATTERNS       -> + pattern CSR and weights          (SkipHashtables:
                     enough for all2all/all2all-sp)
* EVERYTHING     -> + sorted k-mer array + pattern ids (Everything /
                     CompactedHashtables: enough for one2all/new2all/
                     db2db and -extend)

Sections are varint-compressed when the native runtime is present
("d64": delta+LEB128 of a non-decreasing stream — the sorted k-mer
array compresses ~4x; "v32": plain LEB128 — ids bounded by n_patterns/
n_samples compress 2-4x).  The bench hosts sustain only ~30-65 MB/s of
file writeback, so fewer bytes is directly build/query wall-clock.
Raw sections ("raw" or no marker) and the earlier .npz container are
still read transparently.
"""

import json
import zipfile

import numpy as np

from ..models.database import KmerPatternDb

SAMPLES_ONLY = "samples_only"
PATTERNS = "patterns"
EVERYTHING = "everything"

_MAGIC = "kmerdb_tpu-db-v1"
_FLAT_MAGIC = b"KMDBTPU2"

#: sections needed per load mode
_MODE_SECTIONS = {
    SAMPLES_ONLY: (),
    PATTERNS: ("pattern_offsets", "pattern_sample_ids",
               "pattern_num_kmers"),
    EVERYTHING: ("pattern_offsets", "pattern_sample_ids",
                 "pattern_num_kmers", "kmers", "kmer_pattern_ids"),
}

#: encoding per section when the native codecs are available
_SECTION_ENC = {
    "kmers": "d64",             # sorted u64 -> delta varints
    "pattern_offsets": "d64",   # non-decreasing i64 -> delta varints
    "kmer_pattern_ids": "v32",  # < n_patterns
    "pattern_sample_ids": "v32",   # < n_samples
    "pattern_num_kmers": "v32",
    "sample_kmer_counts": "v32",
}


def _encode(name: str, arr: np.ndarray):
    """(blob, enc) for one section; raw when no codec applies."""
    from ..utils import native
    enc = _SECTION_ENC.get(name) if native.available else None
    # per-section pool tags: save_db keeps every blob live until the
    # write loop, so they must not alias one shared scratch buffer
    if enc == "d64" and arr.size:
        return native.vb_encode_delta_u64(
            np.ascontiguousarray(arr).view(np.uint64),
            tag=f"vb_{name}"), "d64"
    if enc == "v32" and arr.size:
        return native.vb_encode_u32(
            np.ascontiguousarray(arr).view(np.uint32),
            tag=f"vb_{name}"), "v32"
    return arr.view(np.uint8).reshape(-1), "raw"


def _decode(blob: np.ndarray, enc: str, dtype: np.dtype, n: int):
    from ..utils import native
    if enc == "raw":
        return blob.view(dtype)[:n]
    if native.available:
        if enc == "d64":
            return native.vb_decode_delta_u64(blob, n).view(dtype)
        return native.vb_decode_u32(blob, n).view(dtype)
    return _vb_decode_py(blob, n, delta=enc == "d64").astype(
        np.uint64 if enc == "d64" else np.uint32).view(dtype)


def _vb_decode_py(blob: np.ndarray, n: int, delta: bool) -> np.ndarray:
    """Vectorized NumPy LEB128 decoder (fallback when the C++ runtime
    is unavailable; the encoder only runs natively, so this path only
    reads files produced elsewhere)."""
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    b = blob.astype(np.uint64)
    ends = np.flatnonzero((blob & 0x80) == 0)[:n]
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    vals = np.zeros(n, dtype=np.uint64)
    lens = ends - starts + 1
    for byte_i in range(int(lens.max()) if n else 0):
        m = lens > byte_i
        vals[m] |= (b[starts[m] + byte_i] & np.uint64(0x7F)) \
            << np.uint64(7 * byte_i)
    if delta:
        vals = np.cumsum(vals, dtype=np.uint64)
    return vals


def save_db(db: KmerPatternDb, path: str) -> None:
    meta = {
        "magic": _MAGIC,
        "kmer_length": int(db.kmer_length),
        "fraction": float(db.fraction),
        "start_fraction": float(db.start_fraction),
        "alphabet": db.alphabet_name,
        "n_samples": db.n_samples,
        "n_kmers": db.n_kmers,
        "n_patterns": db.n_patterns,
    }
    names = "\n".join(db.sample_names).encode()
    arrays = {
        "sample_names": np.frombuffer(names, dtype=np.uint8),
        "sample_kmer_counts": np.ascontiguousarray(db.sample_kmer_counts),
        "pattern_offsets": np.ascontiguousarray(db.pattern_offsets),
        "pattern_sample_ids": np.ascontiguousarray(db.pattern_sample_ids),
        "pattern_num_kmers": np.ascontiguousarray(db.pattern_num_kmers),
        "kmers": np.ascontiguousarray(db.kmers),
        "kmer_pattern_ids": np.ascontiguousarray(db.kmer_pattern_ids),
    }
    blobs = {}
    sections = {}
    offset = 0
    for name, arr in arrays.items():
        blob, enc = _encode(name, arr)
        blobs[name] = blob
        offset = (offset + 63) & ~63
        sections[name] = {"dtype": arr.dtype.str, "n": int(arr.size),
                          "offset": offset, "nbytes": int(blob.nbytes),
                          "enc": enc}
        offset += blob.nbytes
    header = json.dumps({"meta": meta, "sections": sections}).encode()
    base = len(_FLAT_MAGIC) + 8 + len(header)
    with open(path, "wb") as f:
        f.write(_FLAT_MAGIC)
        f.write(np.uint64(len(header)).tobytes())
        f.write(header)
        for name in arrays:
            pos = base + sections[name]["offset"]
            f.seek(pos)
            blobs[name].tofile(f)


def _load_flat(f, path: str, mode: str) -> KmerPatternDb:
    # corrupt/truncated headers must surface as the IOError contract
    # every caller (and the npz path) observes, not raw ValueError/
    # KeyError/JSONDecodeError
    try:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError("short header length field")
        hlen = int(np.frombuffer(raw, dtype=np.uint64)[0])
        hdr = json.loads(f.read(hlen).decode())
        meta = hdr["meta"]
    except IOError:
        raise
    except Exception as e:
        raise IOError(f"Cannot open k-mer database {path}") from e
    if meta.get("magic") != _MAGIC:
        raise IOError(f"Not a kmerdb_tpu database: {path}")
    sections = hdr["sections"]
    base = len(_FLAT_MAGIC) + 8 + hlen

    def read(name):
        s = sections[name]
        dtype = np.dtype(s["dtype"])
        enc = s.get("enc", "raw")
        nbytes = s.get("nbytes", s["n"] * dtype.itemsize)
        f.seek(base + s["offset"])
        # read into a bulk-provisioned buffer: np.fromfile's fresh
        # malloc pages fault one-by-one on sandboxed hosts
        from ..utils.native import alloc_array
        blob = alloc_array(nbytes, np.uint8)
        got = f.readinto(memoryview(blob)) if nbytes else 0
        if got != nbytes:
            raise IOError(f"Truncated k-mer database {path}: section "
                          f"{name} has {got}/{nbytes} bytes")
        return _decode(blob, enc, dtype, s["n"])

    try:
        names_blob = read("sample_names").tobytes().decode()
        db = KmerPatternDb(
            kmer_length=meta["kmer_length"],
            fraction=meta["fraction"],
            start_fraction=meta["start_fraction"],
            alphabet_name=meta["alphabet"],
            sample_names=names_blob.split("\n") if names_blob else [],
            sample_kmer_counts=read("sample_kmer_counts"),
        )
        for name in _MODE_SECTIONS[mode]:
            setattr(db, name, read(name))
    except IOError:
        raise
    except Exception as e:
        raise IOError(f"Cannot open k-mer database {path}") from e
    return db


def _load_npz(path: str, mode: str) -> KmerPatternDb:
    try:
        z = np.load(path, allow_pickle=False)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise IOError(f"Cannot open k-mer database {path}") from e
    with z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("magic") != _MAGIC:
            raise IOError(f"Not a kmerdb_tpu database: {path}")
        names_blob = bytes(z["sample_names"]).decode()
        db = KmerPatternDb(
            kmer_length=meta["kmer_length"],
            fraction=meta["fraction"],
            start_fraction=meta["start_fraction"],
            alphabet_name=meta["alphabet"],
            sample_names=names_blob.split("\n") if names_blob else [],
            sample_kmer_counts=z["sample_kmer_counts"],
        )
        for name in _MODE_SECTIONS[mode]:
            setattr(db, name, z[name])
    return db


def load_db(path: str, mode: str = EVERYTHING) -> KmerPatternDb:
    try:
        f = open(path, "rb")
    except OSError as e:
        raise IOError(f"Cannot open k-mer database {path}") from e
    with f:
        magic = f.read(len(_FLAT_MAGIC))
        if magic == _FLAT_MAGIC:
            return _load_flat(f, path, mode)
    # legacy .npz container
    return _load_npz(path, mode)
