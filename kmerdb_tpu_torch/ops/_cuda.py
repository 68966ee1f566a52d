"""Build and load the port's CUDA kernels.

The sources under ``kmerdb_tpu_torch/csrc/`` compile with nvcc into one
shared library with a plain C interface: no PyTorch headers, so a build
takes seconds.  The library is keyed on a hash of the sources and the
flags, so an edit rebuilds it, and lives under ``kmerdb_tpu_torch/build/``
(ignored by git).  It is loaded with ctypes; tensors pass as raw pointers
and the stream as PyTorch's current CUDA stream.

Nothing is built or loaded when this module is imported: the first call
of ``lib()`` does both.  The C++ host runtime (utils/native.py) is built
the same way, with g++ in place of nvcc.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = CSRC.parent / "build"
SOURCES = ("gram_pk_tri.cu", "gram_pk_rows.cu", "cross_pk.cu", "tril_tiles.cu",
           "cast_rows.cu", "filter_colsum.cu", "bounds_zero.cu", "matmul_acc.cu",
           "gram_u32.cu")
HEADERS = ("gram_pk.cuh", "tri.cuh")
#: sm_90a: the Hopper target (plain sm_90 refuses wgmma, which later
#: kernels will use); -Xptxas -v logs registers, shared memory and spills
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libkmerdb_torch_cuda.so"


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"cuda-{h.hexdigest()[:16]}" / LIB_NAME


def build_log() -> str:
    """nvcc's output for the current sources (ptxas resource usage)."""
    log = library_path().parent / "nvcc.log"
    return log.read_text() if log.exists() else ""


def _build(path: pathlib.Path) -> None:
    """One nvcc per source, all started together, then one link."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"      # concurrent builds never share a file
    tmp = path.with_name(f".{path.name}.{tag}")
    objs = [path.with_name(f".{s}.{tag}.o") for s in SOURCES]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", str(CSRC / s),
                               "-o", str(o)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
        failed = [(s, p.returncode) for s, p in zip(SOURCES, procs)
                  if p.returncode != 0]
        if not failed:
            r = subprocess.run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                                *map(str, objs)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True,
                               timeout=300)
            outs.append(r.stdout)
            if r.returncode != 0:
                failed = [("link", r.returncode)]
        (path.parent / "nvcc.log").write_text("".join(outs))
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n"
                               f"{''.join(outs)[-4000:]}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


@functools.cache
def lib() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources on first use."""
    path = library_path()
    if not path.exists():
        _build(path)
    so = ctypes.CDLL(str(path))
    vp, i64, i32, u32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_uint32)
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    for name, args in (
            ("kmerdb_gram_pk_tri", [vp, vp, vp, i64, i64, i32, i32, i32, vp]),
            ("kmerdb_gram_pk_rows",
             [vp, vp, vp, i64, i64, i64, i64, i32, i32, i32, vp]),
            ("kmerdb_cross_pk",
             [vp, vp, vp, vp, i64, i64, i64, i32, i32, vp]),
            ("kmerdb_matmul_acc", [vp, i32, vp, vp, i64, i64, i64, i32, vp]),
            ("kmerdb_matmul_u32", [vp, i32, vp, vp, i64, i64, i64, i32, vp]),
            ("kmerdb_gram_u32", [vp, vp, vp, i64, i64, i32, i32, vp]),
            ("kmerdb_tril_tiles", [vp, vp, i64, i32, vp]),
            ("kmerdb_gather_tiles", [vp, vp, vp, vp, i64, i64, i32, vp]),
            ("kmerdb_cast_rows", [vp, vp, i64, vp]),
            ("kmerdb_filter_colsum", [vp, vp, i64, i64, u32, u32, vp]),
            ("kmerdb_bounds_zero", [vp, vp, i64, i32, u32, u32, vp])):
        fn = getattr(so, name)
        fn.argtypes = args
        fn.restype = i32
    return so
