"""Build and load the port's CUDA kernels.

The sources under ``kmerdb_tpu_torch/csrc/`` compile with nvcc into one
shared library with a plain C interface: no PyTorch headers, so a build
takes seconds.  The library is keyed on a hash of the sources and the
flags, so an edit rebuilds it, and lives under ``kmerdb_tpu_torch/build/``
(ignored by git).  It is loaded with ctypes; tensors pass as raw pointers
and the stream as PyTorch's current CUDA stream.

Nothing is built or loaded when this module is imported: the first call
of ``lib()`` does both.  The build half mirrors kmerdb_tpu/utils/native.py
(compile on first use), with nvcc in place of g++.
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
SOURCES = ("gram_pk_tri.cu", "tril_tiles.cu")
HEADERS = ("tri.cuh",)
#: sm_90a: the Hopper target (plain sm_90 refuses wgmma, which later
#: kernels will use); -Xptxas -v logs registers, shared memory and spills
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    (path.parent / "nvcc.log").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file


@functools.cache
def lib() -> ctypes.CDLL:
    """The kernel library, built from the checkout's sources on first use."""
    path = library_path()
    if not path.exists():
        _build(path)
    so = ctypes.CDLL(str(path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    so.kmerdb_gram_pk_tri.argtypes = [vp, vp, vp, i64, i64, i32, i32, i32,
                                      vp]
    so.kmerdb_gram_pk_tri.restype = i32
    so.kmerdb_tril_tiles.argtypes = [vp, vp, i64, i32, vp]
    so.kmerdb_tril_tiles.restype = i32
    return so
