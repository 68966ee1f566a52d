"""ctypes bindings for the C++ host runtime (native/kmerdb_native.cpp at
the repo root, shared source of both packages).

The shared object is compiled with g++ on first import into the port's
own build directory, ``kmerdb_tpu_torch/build/host-<hash>/`` (ignored by
git), keyed on a hash of the source and the flags as the CUDA kernels are
(ops/_cuda.py), so an edit rebuilds it.  Every entry point the callers use
has a NumPy fallback, so the package works without a compiler: check
`available` before relying on speed.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "kmerdb_native.cpp"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
_LIB_NAME = "libkmerdb_native.so"

_lib = None
available = False


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / _LIB_NAME


def _build() -> pathlib.Path | None:
    """The library's path, compiled first when it is missing; None when
    the source or g++ is absent or the compile fails."""
    if not _SRC.exists():
        return None
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # a private name, then an atomic rename: a concurrent loader never
    # sees half a file
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def _init():
    global _lib, available
    path = _build() if _lib is None else None
    if path is None:
        return
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    lib.kmerdb_extract.restype = ctypes.c_int64
    lib.kmerdb_extract.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, i8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int32, u64p]
    lib.kmerdb_radix_sort_k.restype = None
    lib.kmerdb_radix_sort_k.argtypes = [ctypes.c_int64, u64p, u64p]
    lib.kmerdb_unique_u64.restype = ctypes.c_int64
    lib.kmerdb_unique_u64.argtypes = [ctypes.c_int64, u64p]
    u32p_ = ctypes.POINTER(ctypes.c_uint32)
    u64pp = ctypes.POINTER(u64p)
    u32pp = ctypes.POINTER(u32p_)
    lib.kmerdb_merge_groups.restype = ctypes.c_int64
    lib.kmerdb_merge_groups.argtypes = [
        ctypes.c_int32, u64pp, u32pp, u32p_, i64p,
        u32p_, u64p, i64p, u64p, u64p, u64p]
    lib.kmerdb_csr_lengths.restype = None
    lib.kmerdb_csr_lengths.argtypes = [
        ctypes.c_int64, i64p, u64p, u32p_, ctypes.c_uint32, i64p, i64p]
    lib.kmerdb_fill_csr.restype = None
    lib.kmerdb_fill_csr.argtypes = [
        ctypes.c_int64, i64p, u64p, u32p_, ctypes.c_uint32, i64p,
        u32p_, i64p, u32p_]
    lib.kmerdb_malloc_reuse.restype = None
    lib.kmerdb_malloc_reuse.argtypes = []
    lib.kmerdb_malloc_reuse()
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.kmerdb_csr_apply.restype = None
    lib.kmerdb_csr_apply.argtypes = [ctypes.c_int64, i64p, u32p, i64p,
                                     u32p, u32p]
    lib.kmerdb_cross_apply.restype = None
    lib.kmerdb_cross_apply.argtypes = [ctypes.c_int64, i64p, i64p, u32p,
                                       i64p, u32p, i64p, u32p,
                                       ctypes.c_int64, u32p]
    cp = ctypes.c_char_p
    lib.kmerdb_row_dense.restype = ctypes.c_int64
    lib.kmerdb_row_dense.argtypes = [u32p, ctypes.c_int64, cp]
    lib.kmerdb_row_sparse.restype = ctypes.c_int64
    lib.kmerdb_row_sparse.argtypes = [u32p, ctypes.c_int64, cp]
    lib.kmerdb_row_pairs.restype = ctypes.c_int64
    lib.kmerdb_row_pairs.argtypes = [i64p, u32p, ctypes.c_int64, cp]
    lib.kmerdb_row_double6.restype = ctypes.c_int64
    lib.kmerdb_row_double6.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_char, cp]
    lib.kmerdb_metric_row.restype = None
    lib.kmerdb_metric_row.argtypes = [
        ctypes.c_int32, u32p, ctypes.c_uint32, u32p, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
    lib.kmerdb_a2a_dense.restype = None
    lib.kmerdb_a2a_dense.argtypes = [ctypes.c_int64, i64p, u32p, u32p,
                                     ctypes.c_int64, u32p]
    lib.kmerdb_symmetrize_u32.restype = None
    lib.kmerdb_symmetrize_u32.argtypes = [ctypes.c_int64, u32p]
    lib.kmerdb_dedup_groups.restype = ctypes.c_int64
    lib.kmerdb_dedup_groups.argtypes = [ctypes.c_int64, u64p, u64p, u64p,
                                        i64p, i64p]
    lib.kmerdb_gather_ragged_u32.restype = None
    lib.kmerdb_gather_ragged_u32.argtypes = [ctypes.c_int64, i64p, i64p,
                                             u32p, i64p, u32p]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.kmerdb_fill_incidence.restype = None
    lib.kmerdb_fill_incidence.argtypes = [ctypes.c_int64, i32p, i32p,
                                          ctypes.c_int64, i8p]
    lib.kmerdb_fill_incidence_bits.restype = None
    lib.kmerdb_fill_incidence_bits.argtypes = [ctypes.c_int64, i64p, i64p,
                                               u32p, ctypes.c_int64, u8p]
    lib.kmerdb_fill_incidence_bits_rows.restype = None
    lib.kmerdb_fill_incidence_bits_rows.argtypes = [
        ctypes.c_int64, i64p, i64p, i64p, u32p, ctypes.c_int64, u8p]
    lib.kmerdb_one2all_probe.restype = ctypes.c_int64
    lib.kmerdb_one2all_probe.argtypes = [ctypes.c_int64, u64p,
                                         ctypes.c_int64, u64p, i32p, i32p]
    lib.kmerdb_intersect_probe.restype = ctypes.c_int64
    lib.kmerdb_intersect_probe.argtypes = [
        ctypes.c_int64, u64p, i32p, ctypes.c_int64, u64p, i32p, i32p, i32p]
    lib.kmerdb_many2all_probe.restype = ctypes.c_int64
    lib.kmerdb_many2all_probe.argtypes = [
        ctypes.c_int32, u64pp, i64p, i64p, ctypes.c_int64, u64p, i32p,
        ctypes.c_int64, i32p, u32p, i64p]
    lib.kmerdb_csr_apply_many.restype = None
    lib.kmerdb_csr_apply_many.argtypes = [
        ctypes.c_int32, i64p, i64p, i32p, u32p, i64p, u32p,
        ctypes.c_int64, u32p]
    lib.kmerdb_csr_apply_patmajor.restype = None
    lib.kmerdb_csr_apply_patmajor.argtypes = [
        ctypes.c_int32, i64p, i64p, i32p, u32p, i64p, u32p,
        ctypes.c_int64, ctypes.c_int64, u32p]
    lib.kmerdb_vb_encode_delta_u64.restype = ctypes.c_int64
    lib.kmerdb_vb_encode_delta_u64.argtypes = [ctypes.c_int64, u64p, u8p]
    lib.kmerdb_vb_decode_delta_u64.restype = None
    lib.kmerdb_vb_decode_delta_u64.argtypes = [ctypes.c_int64, u8p, u64p]
    lib.kmerdb_vb_encode_u32.restype = ctypes.c_int64
    lib.kmerdb_vb_encode_u32.argtypes = [ctypes.c_int64, u32p, u8p]
    lib.kmerdb_vb_decode_u32.restype = None
    lib.kmerdb_vb_decode_u32.argtypes = [ctypes.c_int64, u8p, u32p]
    lib.kmerdb_set_threads.restype = None
    lib.kmerdb_set_threads.argtypes = [ctypes.c_int32]
    lib.kmerdb_get_threads.restype = ctypes.c_int32
    lib.kmerdb_get_threads.argtypes = []
    _lib = lib
    available = True
    env_t = os.environ.get("KMERDB_THREADS")
    if env_t:
        try:
            lib.kmerdb_set_threads(int(env_t))
        except ValueError:
            pass


_init()


def set_threads(n: int) -> None:
    """Host kernel thread count (the reference's -t reaching its spin
    pool, params.cpp:103-108): 0 = auto (hardware_concurrency).  The
    threaded kernels (blocked all2all scatter, radix sort, incidence
    bit-fill) are byte-identical at any count — uint32 adds commute
    and every thread owns disjoint output bytes."""
    if available:
        _lib.kmerdb_set_threads(int(n))


def _p(a, t):
    return a.ctypes.data_as(t)


_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def extract_contig(seq: np.ndarray, k: int, mapping: np.ndarray, bits: int,
                   asize: int, preserve: bool, pshift: int, tailmask: int,
                   lo_thr: int, hi_thr: int, use_filter: bool) -> np.ndarray:
    """Rolling extraction of one contig (uint8 array) -> kmers u64[]."""
    out = np.empty(max(0, seq.size - k + 1), dtype=np.uint64)
    if out.size == 0:
        return out
    n = extract_contig_into(seq, k, mapping, bits, asize, preserve,
                            pshift, tailmask, lo_thr, hi_thr, use_filter,
                            out)
    return out[:n]


def extract_contig_into(seq: np.ndarray, k: int, mapping: np.ndarray,
                        bits: int, asize: int, preserve: bool, pshift: int,
                        tailmask: int, lo_thr: int, hi_thr: int,
                        use_filter: bool, out: np.ndarray) -> int:
    """extract_contig writing into caller scratch (len >= seq.size-k+1);
    returns the k-mer count.  Lets the per-sample ingest reuse one
    pooled buffer instead of paying fresh-page faults per contig."""
    if seq.size < k:
        return 0
    return _lib.kmerdb_extract(
        _p(seq, _U8P), seq.size, k, _p(mapping, _I8P), bits, asize,
        int(preserve), pshift, ctypes.c_uint64(tailmask),
        ctypes.c_uint64(lo_thr), ctypes.c_uint64(hi_thr),
        int(use_filter), _p(out, _U64P))


def radix_sort(keys: np.ndarray) -> None:
    """In-place sort of u64 keys."""
    # pooled scatter scratch: a fresh np.empty_like per call costs
    # ~30us/page of demand faults — 1.7 ms per 300 kbp sample, half
    # the measured per-sample sort time at scale
    tk = pool.get("radix_tk", keys.size, np.uint64)
    _lib.kmerdb_radix_sort_k(keys.size, _p(keys, _U64P), _p(tk, _U64P))


def sort_unique(keys: np.ndarray) -> np.ndarray:
    """Sort + dedup, returns the compacted prefix (new array view)."""
    radix_sort(keys)
    m = _lib.kmerdb_unique_u64(keys.size, _p(keys, _U64P))
    return keys[:m]


_MADV_POPULATE_WRITE = 23
_MADV_HUGEPAGE = 14


def alloc_array(n: int, dtype, populate: bool = True) -> np.ndarray:
    """Anonymous-mmap-backed array, optionally bulk-provisioned.

    Page provisioning on sandboxed bench hosts costs ~30us/page however
    it happens (demand fault or madvise), beyond a small fast initial
    pool — so the scheme is: populate=True for buffers that will be
    written densely (one syscall instead of n faults), populate=False
    for oversized buffers whose tail may never be touched (pay only for
    pages actually written).  MADV_HUGEPAGE first: provisioning 2 MB
    pages is ~5x cheaper than 4 KB ones (440 MB: 1.07 s -> 0.20 s
    measured here) and the big dense buffers this serves (decoded CSR
    sections, count matrices) gain TLB reach for free."""
    import mmap as _mmap
    dtype = np.dtype(dtype)
    nbytes = max(1, int(n) * dtype.itemsize)
    try:
        # MAP_PRIVATE: python's default anonymous map is MAP_SHARED
        # (shmem), whose THP policy (shmem_enabled) is 'never' on
        # stock kernels — MADV_HUGEPAGE would silently no-op there.
        # Private anonymous memory honors the regular THP 'madvise'
        # policy, matching the C arena (arena_grow).
        mm = _mmap.mmap(-1, nbytes,
                        flags=_mmap.MAP_PRIVATE | _mmap.MAP_ANONYMOUS)
    except (ValueError, OSError, AttributeError):
        mm = _mmap.mmap(-1, nbytes)
    if populate:
        if nbytes >= (4 << 20):  # sub-2MB regions can't get hugepages
            try:
                mm.madvise(_MADV_HUGEPAGE)
            except (OSError, ValueError, AttributeError):
                pass
        try:
            mm.madvise(_MADV_POPULATE_WRITE)
        except (OSError, ValueError, AttributeError):
            pass
    return np.frombuffer(mm, dtype=np.uint8, count=n * dtype.itemsize
                         ).view(dtype) if n else np.empty(0, dtype)


class _Pool:
    """Grow-only buffer pool: big scratch arrays are provisioned once
    (anonymous mmap) and reused forever."""

    def __init__(self):
        self._bufs: dict[str, np.ndarray] = {}

    def get(self, tag: str, n: int, dtype, populate: bool = True
            ) -> np.ndarray:
        dtype = np.dtype(dtype)
        need = n * dtype.itemsize
        buf = self._bufs.get(tag)
        if buf is None or buf.nbytes < need:
            cap = max(need, 1 << 20)
            if buf is not None:
                cap = max(cap, buf.nbytes * 2)
            self._bufs[tag] = buf = alloc_array(cap, np.uint8, populate)
        return buf[:need].view(dtype)


pool = _Pool()


def merge_groups(key_streams: list[np.ndarray],
                 val_streams: list[np.ndarray | None],
                 const_vals: list[int], scratch: bool = False,
                 hashes: bool = True):
    """Fused multiway merge of sorted key streams + per-distinct-key
    content stats.  val_streams[i] may be None (constant const_vals[i]).

    Values are uint32: sample ids < 2^31 or (1<<31)|pattern_id
    references.  Returns (merged_vals u32[N], group_keys u64[G],
    gstart i64[G], glen u64[G], h1 u64[G], h2 u64[G]).  With
    scratch=True the returned arrays are views into the shared pool
    (valid until the next pooled call) — callers must copy what they
    keep.  hashes=False skips the per-element splitmix set-hash pass
    (h1/h2 return empty) — the fused group-Gram path never reads
    them."""
    ns = len(key_streams)
    total = int(sum(a.size for a in key_streams))
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    # contiguous copies must stay alive across the C call
    key_arrs = [np.ascontiguousarray(a) for a in key_streams]
    key_ptrs = (_U64P * ns)(*[_p(a, _U64P) for a in key_arrs])
    val_arrs = [None if v is None else
                np.ascontiguousarray(v, dtype=np.uint32)
                for v in val_streams]
    null = ctypes.cast(None, _U32P)
    val_ptrs = (_U32P * ns)(*[null if v is None else _p(v, _U32P)
                              for v in val_arrs])
    cvals = np.asarray(const_vals, dtype=np.uint32)
    lens = np.asarray([a.size for a in key_streams], dtype=np.int64)

    if scratch:
        merged_vals = pool.get("mg_merged", total, np.uint32)
        # group buffers are sized for the worst case (every key unique)
        # but typically ~20% written: demand-fault only what's used
        group_keys = pool.get("mg_gk", total, np.uint64, populate=False)
        gstart = pool.get("mg_gs", total, np.int64, populate=False)
        glen = pool.get("mg_gl", total, np.uint64, populate=False)
        h1 = pool.get("mg_h1", total, np.uint64, populate=False) \
            if hashes else None
        h2 = pool.get("mg_h2", total, np.uint64, populate=False) \
            if hashes else None
    else:
        merged_vals = np.empty(total, dtype=np.uint32)
        group_keys = np.empty(total, dtype=np.uint64)
        gstart = np.empty(total, dtype=np.int64)
        glen = np.empty(total, dtype=np.uint64)
        h1 = np.empty(total, dtype=np.uint64) if hashes else None
        h2 = np.empty(total, dtype=np.uint64) if hashes else None
    _null64 = ctypes.cast(None, _U64P)
    g = _lib.kmerdb_merge_groups(
        ns, key_ptrs, val_ptrs, _p(cvals, _U32P), _p(lens, _I64P),
        _p(merged_vals, _U32P), _p(group_keys, _U64P), _p(gstart, _I64P),
        _p(glen, _U64P),
        _p(h1, _U64P) if hashes else _null64,
        _p(h2, _U64P) if hashes else _null64)
    if g < 0:
        raise MemoryError("kmerdb_merge_groups: scratch arena mmap failed")
    empty = np.empty(0, dtype=np.uint64)
    if scratch:
        return (merged_vals, group_keys[:g], gstart[:g], glen[:g],
                h1[:g] if hashes else empty,
                h2[:g] if hashes else empty)
    return (merged_vals, group_keys[:g].copy(), gstart[:g].copy(),
            glen[:g].copy(),
            h1[:g].copy() if hashes else empty,
            h2[:g].copy() if hashes else empty)


def csr_lengths(rep_start: np.ndarray, rep_len: np.ndarray,
                merged_vals: np.ndarray, ref_threshold: int,
                old_offsets: np.ndarray) -> np.ndarray:
    P = rep_start.size
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    out_len = np.empty(P, dtype=np.int64)
    _lib.kmerdb_csr_lengths(P, _p(rep_start, _I64P), _p(rep_len, _U64P),
                            _p(merged_vals, _U32P),
                            ctypes.c_uint32(ref_threshold),
                            _p(old_offsets, _I64P), _p(out_len, _I64P))
    return out_len


def fill_csr(rep_start: np.ndarray, rep_len: np.ndarray,
             merged_vals: np.ndarray, ref_threshold: int,
             old_offsets: np.ndarray, old_sample_ids: np.ndarray,
             out_off: np.ndarray, out: np.ndarray) -> None:
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_fill_csr(rep_start.size, _p(rep_start, _I64P),
                         _p(rep_len, _U64P), _p(merged_vals, _U32P),
                         ctypes.c_uint32(ref_threshold),
                         _p(old_offsets, _I64P),
                         _p(old_sample_ids, _U32P), _p(out_off, _I64P),
                         _p(out, _U32P))


def csr_apply(pids: np.ndarray, counts: np.ndarray, offsets: np.ndarray,
              sample_ids: np.ndarray, sims: np.ndarray) -> None:
    """sims[sid] += counts[i] for every sid in pattern pids[i]'s slice."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_csr_apply(pids.size, _p(pids, _I64P), _p(counts, _U32P),
                          _p(offsets, _I64P), _p(sample_ids, _U32P),
                          _p(sims, _U32P))


def cross_apply(p1: np.ndarray, p2: np.ndarray, counts: np.ndarray,
                off1: np.ndarray, sids1: np.ndarray,
                off2: np.ndarray, sids2: np.ndarray,
                C: np.ndarray) -> None:
    """C[r, c] += counts[i] over the cross product of pattern slices."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_cross_apply(p1.size, _p(p1, _I64P), _p(p2, _I64P),
                            _p(counts, _U32P), _p(off1, _I64P),
                            _p(sids1, _U32P), _p(off2, _I64P),
                            _p(sids2, _U32P), C.shape[1], _p(C, _U32P))


_row_buf = bytearray(1 << 20)


def _row_capacity(n: int) -> ctypes.c_char_p:
    global _row_buf
    need = 32 * n + 64
    if len(_row_buf) < need:
        _row_buf = bytearray(max(need, len(_row_buf) * 2))
    return (ctypes.c_char * len(_row_buf)).from_buffer(_row_buf)


def row_dense(vals: np.ndarray) -> bytes:
    """'<v>,' per value (num2str integer collection semantics)."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    buf = _row_capacity(vals.size)
    n = _lib.kmerdb_row_dense(_p(vals, _U32P), vals.size,
                              ctypes.cast(buf, ctypes.c_char_p))
    return bytes(_row_buf[:n])


def row_sparse(vals: np.ndarray) -> bytes:
    """'<i+1>:<v>,' per non-zero value (num2str_sparse semantics)."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    buf = _row_capacity(vals.size)
    n = _lib.kmerdb_row_sparse(_p(vals, _U32P), vals.size,
                               ctypes.cast(buf, ctypes.c_char_p))
    return bytes(_row_buf[:n])


def row_pairs(cols: np.ndarray, vals: np.ndarray) -> bytes:
    """'<col>:<v>,' per element (cols one-based, pre-shifted)."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    buf = _row_capacity(cols.size)
    n = _lib.kmerdb_row_pairs(_p(cols, _I64P), _p(vals, _U32P),
                              cols.size, ctypes.cast(buf, ctypes.c_char_p))
    return bytes(_row_buf[:n])


def row_double6(vals: np.ndarray, delim: str = ",") -> bytes:
    """'<Double2PChar(v,6)>,' per value; exact num2str float rendering."""
    _DP = ctypes.POINTER(ctypes.c_double)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    buf = _row_capacity(vals.size)
    n = _lib.kmerdb_row_double6(_p(vals, _DP), vals.size,
                                ctypes.c_char(delim.encode()),
                                ctypes.cast(buf, ctypes.c_char_p))
    return bytes(_row_buf[:n])


def a2a_dense(offsets: np.ndarray, sids: np.ndarray, w: np.ndarray,
              n_samples: int) -> np.ndarray:
    """Host all2all: full symmetric uint32[S, S] count matrix.

    The kernel writes the lower triangle + diagonal (half the scatter
    work); the symmetrize pass mirrors it."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    C = np.zeros((n_samples, n_samples), dtype=np.uint32)
    _lib.kmerdb_a2a_dense(w.size,
                          _p(np.ascontiguousarray(offsets, np.int64), _I64P),
                          _p(np.ascontiguousarray(sids, np.uint32), _U32P),
                          _p(np.ascontiguousarray(w, np.uint32), _U32P),
                          n_samples, _p(C, _U32P))
    _lib.kmerdb_symmetrize_u32(n_samples, _p(C, _U32P))
    return C


METRIC_IDS = {"jaccard": 0, "min": 1, "max": 2, "cosine": 3, "mash": 4,
              "ani": 5, "ani-shorter": 6, "mash-query": 7, "num-kmers": 8}


def metric_row(metric_name: str, commons: np.ndarray, query_cnt: int,
               db_cnts: np.ndarray, k: int) -> np.ndarray:
    """float64 metric values per cell, libm-log parity."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _DP = ctypes.POINTER(ctypes.c_double)
    commons = np.ascontiguousarray(commons, dtype=np.uint32)
    db_cnts = np.ascontiguousarray(db_cnts, dtype=np.uint32)
    out = np.empty(commons.size, dtype=np.float64)
    _lib.kmerdb_metric_row(METRIC_IDS[metric_name], _p(commons, _U32P),
                           ctypes.c_uint32(query_cnt & 0xFFFFFFFF),
                           _p(db_cnts, _U32P), commons.size, k,
                           _p(out, _DP))
    return out


def dedup_groups(h1: np.ndarray, h2: np.ndarray, glen: np.ndarray):
    """Pattern dedup by (h1, h2, len) content triple.

    Returns (inverse i64[G] group -> pattern id, first_group i64[P])."""
    G = h1.size
    inverse = np.empty(G, dtype=np.int64)
    first = pool.get("dg_first", G, np.int64)
    p = _lib.kmerdb_dedup_groups(G, _p(h1, _U64P), _p(h2, _U64P),
                                 _p(glen, _U64P), _p(inverse, _I64P),
                                 _p(first, _I64P))
    if p < 0:
        raise MemoryError("kmerdb_dedup_groups: scratch arena mmap failed")
    return inverse, first[:p].copy()


def gather_ragged_u32(sel: np.ndarray, src_off: np.ndarray,
                      src: np.ndarray, out_off: np.ndarray,
                      out: np.ndarray) -> None:
    """out[out_off[i]..] = src[src_off[sel[i]] : src_off[sel[i]+1]]."""
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_gather_ragged_u32(sel.size, _p(sel, _I64P),
                                  _p(src_off, _I64P), _p(src, _U32P),
                                  _p(out_off, _I64P), _p(out, _U32P))


_U8P = ctypes.POINTER(ctypes.c_uint8)


def vb_encode_delta_u64(src: np.ndarray, tag: str = "vb64") -> np.ndarray:
    """Varint-encoded deltas of a non-decreasing uint64 stream.  The
    result aliases a per-tag pooled buffer: pass distinct tags for
    blobs that must stay live simultaneously."""
    out = pool.get(tag, src.size * 10 + 1, np.uint8, populate=False)
    nb = _lib.kmerdb_vb_encode_delta_u64(src.size, _p(src, _U64P),
                                         _p(out, _U8P))
    return out[:nb]


def vb_decode_delta_u64(blob: np.ndarray, n: int) -> np.ndarray:
    # bulk-provisioned output: np.empty's fresh pages demand-fault at
    # ~30us/page on the bench hosts — 3+ s of a scale-db load was page
    # faults, not decoding
    out = alloc_array(n, np.uint64)
    if n:
        _lib.kmerdb_vb_decode_delta_u64(n, _p(blob, _U8P), _p(out, _U64P))
    return out


def vb_encode_u32(src: np.ndarray, tag: str = "vb32") -> np.ndarray:
    """Plain LEB128 varints of a uint32 stream (pooled per tag; see
    vb_encode_delta_u64)."""
    out = pool.get(tag, src.size * 5 + 1, np.uint8, populate=False)
    nb = _lib.kmerdb_vb_encode_u32(src.size, _p(src, _U32P), _p(out, _U8P))
    return out[:nb]


def vb_decode_u32(blob: np.ndarray, n: int) -> np.ndarray:
    out = alloc_array(n, np.uint32)  # bulk-provisioned (see above)
    if n:
        _lib.kmerdb_vb_decode_u32(n, _p(blob, _U8P), _p(out, _U32P))
    return out


def one2all_probe(query: np.ndarray, kmers: np.ndarray,
                  pids: np.ndarray) -> np.ndarray:
    """Pattern ids of every sorted-unique query k-mer present in the
    sorted database array (galloping merge)."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    out = pool.get("o2a_hits", query.size, np.int32, populate=False)
    h = _lib.kmerdb_one2all_probe(query.size, _p(query, _U64P),
                                  kmers.size, _p(kmers, _U64P),
                                  _p(pids, _I32P), _p(out, _I32P))
    return out[:h]


def many2all_probe(queries: list, kmers: np.ndarray, pids: np.ndarray,
                   n_patterns: int):
    """Batched multi-query membership probe + per-query run-length
    counts (the whole host stage of new2all in one threaded call; the
    db k-mer array streams from RAM once for the batch instead of
    once per query).

    queries: sorted-unique uint64 arrays.  Returns
    (hit_pids int32[total], hit_cnts uint32[total], qoffs int64[Q+1],
    ucnt int64[Q], max_count) — query q's ascending unique hit pattern
    ids are hit_pids[qoffs[q] : qoffs[q] + ucnt[q]], multiplicities in
    hit_cnts likewise.  The two flat arrays alias pooled buffers."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    Q = len(queries)
    qarrs = [np.ascontiguousarray(q, dtype=np.uint64) for q in queries]
    qptrs = (_U64P * max(Q, 1))(*[_p(a, _U64P) for a in qarrs])
    qlens = np.asarray([a.size for a in qarrs], dtype=np.int64)
    qoffs = np.zeros(Q + 1, dtype=np.int64)
    np.cumsum(qlens, out=qoffs[1:])
    total = int(qoffs[-1])
    hit_pids = pool.get("m2a_pids", max(total, 1), np.int32,
                        populate=False)
    hit_cnts = pool.get("m2a_cnts", max(total, 1), np.uint32,
                        populate=False)
    ucnt = np.zeros(Q, dtype=np.int64)
    max_c = _lib.kmerdb_many2all_probe(
        Q, qptrs, _p(qlens, _I64P), _p(qoffs, _I64P), kmers.size,
        _p(kmers, _U64P), _p(pids, _I32P), int(n_patterns),
        _p(hit_pids, _I32P), _p(hit_cnts, _U32P), _p(ucnt, _I64P))
    if max_c < 0:
        raise MemoryError("kmerdb_many2all_probe: scratch arena failed")
    return hit_pids, hit_cnts, qoffs, ucnt, int(max(max_c, 1))


def csr_apply_many(qoffs: np.ndarray, ucnt: np.ndarray,
                   hit_pids: np.ndarray, hit_cnts: np.ndarray,
                   offsets: np.ndarray, sample_ids: np.ndarray,
                   out: np.ndarray) -> None:
    """Per-query CSR apply of many2all_probe results into the zeroed
    uint32[Q, S] matrix `out` (query rows are disjoint -> threaded)."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_csr_apply_many(
        ucnt.size, _p(qoffs, _I64P), _p(ucnt, _I64P),
        _p(hit_pids, _I32P), _p(hit_cnts, _U32P), _p(offsets, _I64P),
        _p(sample_ids, _U32P), out.shape[1], _p(out, _U32P))


def csr_apply_patmajor(qoffs: np.ndarray, ucnt: np.ndarray,
                       hit_pids: np.ndarray, hit_cnts: np.ndarray,
                       offsets: np.ndarray, sample_ids: np.ndarray,
                       n_patterns: int, out: np.ndarray) -> None:
    """Pattern-major apply of many2all_probe results (each hit
    pattern's sample list read once for the whole batch; dense
    patterns apply as SIMD row AXPYs) — same result as
    csr_apply_many, ~10x less CSR traffic on related corpora."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    _U32P = ctypes.POINTER(ctypes.c_uint32)
    _lib.kmerdb_csr_apply_patmajor(
        ucnt.size, _p(qoffs, _I64P), _p(ucnt, _I64P),
        _p(hit_pids, _I32P), _p(hit_cnts, _U32P), _p(offsets, _I64P),
        _p(sample_ids, _U32P), n_patterns, out.shape[1], _p(out, _U32P))


def intersect_probe(ka: np.ndarray, pa: np.ndarray,
                    kb: np.ndarray, pb: np.ndarray):
    """(pattern_a, pattern_b) int32 pairs for every k-mer present in
    both sorted-unique arrays (galloping merge)."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    cap = min(ka.size, kb.size)
    out_a = pool.get("ip_a", cap, np.int32, populate=False)
    out_b = pool.get("ip_b", cap, np.int32, populate=False)
    h = _lib.kmerdb_intersect_probe(ka.size, _p(ka, _U64P), _p(pa, _I32P),
                                    kb.size, _p(kb, _U64P), _p(pb, _I32P),
                                    _p(out_a, _I32P), _p(out_b, _I32P))
    return out_a[:h], out_b[:h]


def fill_incidence(rows: np.ndarray, cols: np.ndarray,
                   B: np.ndarray) -> None:
    """B[rows[i], cols[i]] = 1 over a zeroed int8 block."""
    _I32P = ctypes.POINTER(ctypes.c_int32)
    _lib.kmerdb_fill_incidence(rows.size, _p(rows, _I32P),
                               _p(cols, _I32P), B.shape[1], _p(B, _I8P))


def fill_incidence_bits(pids: np.ndarray, offs: np.ndarray,
                        sids: np.ndarray, Bp: np.ndarray) -> None:
    """Pattern-axis bit-packed incidence over a zeroed uint8 block:
    bit i & 7 of Bp[i >> 3, s] records pattern pids[i] containing
    sample s, read straight from the pattern CSR (offs int64[P+1],
    sids uint32).  Matches pallas_gram._unpack_pk's layout."""
    _lib.kmerdb_fill_incidence_bits(
        pids.size, _p(pids, _I64P), _p(offs, _I64P), _p(sids, _U32P),
        Bp.shape[1], _p(Bp, _U8P))


def fill_incidence_bits_rows(rows: np.ndarray, pids: np.ndarray,
                             offs: np.ndarray, sids: np.ndarray,
                             Bp: np.ndarray) -> None:
    """fill_incidence_bits with explicit packed-row indices: element
    i's bits land in row rows[i] (bit rows[i] & 7 of byte row
    rows[i] >> 3) — the parts grid's global union k-mer coordinates,
    which have gaps where other parts own the k-mer."""
    _lib.kmerdb_fill_incidence_bits_rows(
        pids.size, _p(rows, _I64P), _p(pids, _I64P), _p(offs, _I64P),
        _p(sids, _U32P), Bp.shape[1], _p(Bp, _U8P))
