"""Fast whole-buffer gzip inflate via system libdeflate (ctypes).

Role parity: the reference links isa-l igzip / zlib-ng for its gz
ingest fast path (reference libs/refresh/compression/lib/
file_wrapper.h:333,472).  Here the same role is played by libdeflate —
a one-shot whole-member inflater that skips zlib's streaming window
bookkeeping entirely, which fits this framework's ingest shape
(io/fasta.py reads each sample fully before vectorized k-mer
extraction) better than a streaming engine would.

Multi-member files (bgzf, cat'ed .gz) are handled by looping
``libdeflate_gzip_decompress_ex`` over the remaining input.  Falls
back to the stdlib ``gzip`` module when the shared object or the
``_ex`` symbol is missing, or when libdeflate rejects the stream.

Env: KMERDB_NO_LIBDEFLATE=1 forces the stdlib path (debug knob, same
spirit as the framework's other KMERDB_* toggles).
"""

import ctypes
import os

_SUCCESS = 0
_INSUFFICIENT_SPACE = 3

_lib = None
_init_done = False


def _init():
    global _lib, _init_done
    if _init_done:
        return
    _init_done = True
    if os.environ.get("KMERDB_NO_LIBDEFLATE") == "1":
        return
    for name in ("libdeflate.so.0", "libdeflate.so", "libdeflate.so.1"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        if not hasattr(lib, "libdeflate_gzip_decompress_ex"):
            continue
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_gzip_decompress_ex.restype = ctypes.c_int
        lib.libdeflate_gzip_decompress_ex.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.libdeflate_free_decompressor.argtypes = [ctypes.c_void_p]
        _lib = lib
        return


def available() -> bool:
    _init()
    return _lib is not None


def _isize_hint(data: bytes) -> int:
    """Last member's ISIZE trailer: exact for single-member < 4 GiB."""
    if len(data) >= 4:
        return int.from_bytes(data[-4:], "little")
    return 0


def gzip_decompress(data: bytes) -> bytes:
    """Inflate a complete gzip byte string (all members concatenated).

    Raises ValueError on corrupt streams (callers treat that like any
    unreadable input); callers that want the stdlib's tolerance should
    catch and fall back — io/fasta.read_raw does.
    """
    _init()
    if _lib is None:
        import gzip
        return gzip.decompress(data)
    d = _lib.libdeflate_alloc_decompressor()
    if not d:
        import gzip
        return gzip.decompress(data)
    try:
        out_parts = []
        pos = 0
        n = len(data)
        # one stable input buffer; members are addressed by offset so a
        # many-member file (bgzf) stays O(n), not O(n^2) of slicing
        inbuf = (ctypes.c_char * n).from_buffer_copy(data)
        # First-member guess from the ISIZE trailer; growth loop covers
        # lying trailers and >4 GiB members.
        cap = max(_isize_hint(data), 4 * n, 1 << 20)
        while pos < n:
            # skip any zero padding between members (bgzf writers pad)
            while pos < n and data[pos] == 0:
                pos += 1
            if pos >= n:
                break
            buf = ctypes.create_string_buffer(cap)
            in_used = ctypes.c_size_t(0)
            out_used = ctypes.c_size_t(0)
            r = _lib.libdeflate_gzip_decompress_ex(
                d, ctypes.byref(inbuf, pos), n - pos, buf, cap,
                ctypes.byref(in_used), ctypes.byref(out_used))
            if r == _INSUFFICIENT_SPACE:
                cap = max(cap * 2, 1 << 22)
                continue
            if r != _SUCCESS:
                raise ValueError(f"libdeflate: bad gzip stream (code {r})")
            out_parts.append(buf.raw[:out_used.value])
            if in_used.value == 0:
                break
            pos += in_used.value
        return b"".join(out_parts)
    finally:
        _lib.libdeflate_free_decompressor(d)
