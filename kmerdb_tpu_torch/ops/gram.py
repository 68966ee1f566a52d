"""The all2all kernels: the packed triangle Gram and the triangle pull.

Each kernel has a wrapper, which checks its operands, launches the CUDA
kernel for CUDA tensors (or raises) and counts its launches, and a plain
PyTorch version of the same function, which the wrapper runs for CPU
tensors and which ``chip_smoke.py`` compares the kernel with on the card.

Layouts are those of kmerdb_tpu/ops/pallas_gram.py, so the tests feed both
packages identical operands (``from_jax_layout``):

* ``Bp`` uint8[P/8, S]: bit b of byte-row r is pattern 8r + b;
* ``w`` the P pattern weights permuted by ``pk_weight_order`` for the
  K block ``kt``, uint32 bits in int32 storage;
* ``C`` uint32[S, S] counts in int32 storage.  torch has no uint32 add or
  shift; int32 storage wraps mod 2^32 with the same bits, and numpy reads
  them back with ``.view(np.uint32)``.
"""

import functools

import numpy as np
import torch

from . import _cuda
from .geom import KT, LIMB_BITS, PULL_TILE, TILE

#: enough limbs for any uint32 weight
MAX_LIMBS = -(-32 // LIMB_BITS)


@functools.cache
def tri_tile_tables(nt: int):
    """(i_tab, j_tab) int32 coordinates of the lower-tile triangle in the
    order the kernels enumerate it (pallas_gram.tri_tile_tables)."""
    i_tab = np.repeat(np.arange(nt, dtype=np.int32), np.arange(1, nt + 1))
    j_tab = np.concatenate([np.arange(i + 1, dtype=np.int32)
                            for i in range(nt)]) if nt else \
        np.zeros(0, np.int32)
    return i_tab, j_tab


def untile_symmetric(tiles: np.ndarray, S: int) -> np.ndarray:
    """Full symmetric [S, S] matrix from tril_tiles output (host side;
    pallas_gram.untile_symmetric).  Diagonal tiles were computed in full;
    off-diagonal tiles are mirrored."""
    n_tri, T, _ = tiles.shape
    nt = int((np.sqrt(8 * n_tri + 1) - 1) / 2 + 0.5)
    i_tab, j_tab = tri_tile_tables(nt)
    C = np.empty((nt * T, nt * T), dtype=tiles.dtype)
    for t in range(n_tri):
        i, j = int(i_tab[t]), int(j_tab[t])
        C[i * T:(i + 1) * T, j * T:(j + 1) * T] = tiles[t]
        if i != j:
            C[j * T:(j + 1) * T, i * T:(i + 1) * T] = tiles[t].T
    return np.ascontiguousarray(C[:S, :S])


def pk_weight_order(w: np.ndarray, kt: int = KT) -> np.ndarray:
    """Pattern weights permuted to the kernels' b-major order
    (pallas_gram.pk_weight_order; w.size % kt == 0)."""
    return np.ascontiguousarray(
        w.reshape(-1, kt // 8, 8).transpose(0, 2, 1).reshape(-1))


def from_jax_layout(Bp: np.ndarray, w_pk: np.ndarray, C: np.ndarray,
                    device) -> tuple:
    """The JAX package's numpy operands of gram_u32_pk_tri (uint8 Bp,
    uint32 w_pk [P, 1], uint32 C) as this module's tensors on `device`.
    Always copies: the Gram updates C in place."""
    dev = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(Bp, np.uint8))
            .to(dev, copy=True),
            torch.from_numpy(np.ascontiguousarray(w_pk, np.uint32)
                             .reshape(-1).view(np.int32)).to(dev, copy=True),
            torch.from_numpy(np.ascontiguousarray(C, np.uint32)
                             .view(np.int32)).to(dev, copy=True))


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _kernel_device(*ts: torch.Tensor) -> str:
    """'cpu' or 'cuda' for operands on one device; raises otherwise."""
    dev = ts[0].device
    _require(all(t.device == dev for t in ts),
             "operands lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type


def _check_gram(Bp, w, C, n_limbs, kt, tile) -> None:
    _require(Bp.dtype == torch.uint8 and Bp.dim() == 2, "Bp must be uint8[P/8, S]")
    _require(w.dtype == torch.int32 and w.numel() == Bp.shape[0] * 8,
             "w must be int32 with P = 8 * Bp.shape[0] weights")
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] == C.shape[1] == Bp.shape[1],
             "C must be int32[S, S] with S = Bp.shape[1]")
    _require(all(t.is_contiguous() for t in (Bp, w, C)),
             "operands must be contiguous")
    _require(kt > 0 and kt % 128 == 0 and (Bp.shape[0] * 8) % kt == 0,
             "kt must be a multiple of 128 that divides P")
    _require(tile > 0 and tile % 128 == 0 and C.shape[0] % tile == 0,
             "tile must be a multiple of 128 that divides S")
    _require(1 <= n_limbs <= MAX_LIMBS, f"n_limbs must lie in 1..{MAX_LIMBS}")


def _cuda_call(fn, *args, device) -> None:
    """Run one C launcher on PyTorch's current stream; raise on the
    cudaError_t it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {err}")


def gram_u32_pk_tri(Bp: torch.Tensor, w: torch.Tensor, C: torch.Tensor, *,
                    n_limbs: int, kt: int = KT,
                    tile: int = TILE) -> torch.Tensor:
    """C += B^T diag(w) B over the lower `tile`-edge triangle, in place,
    exact mod 2^32; strict-upper tiles keep their contents.

    Replaces kmerdb_tpu/ops/pallas_gram.py gram_u32_pk_tri with the int8
    engine (_gram_pk_body_s8): 7-bit weight limbs.  CUDA tensors go to
    csrc/gram_pk_tri.cu; CPU tensors to gram_u32_pk_tri_plain."""
    _check_gram(Bp, w, C, n_limbs, kt, tile)
    if _kernel_device(Bp, w, C) == "cpu":
        return gram_u32_pk_tri_plain(Bp, w, C, n_limbs=n_limbs, kt=kt,
                                     tile=tile)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    _cuda_call(_cuda.lib().kmerdb_gram_pk_tri, Bp.data_ptr(), w.data_ptr(),
               C.data_ptr(), Bp.shape[0], C.shape[0], n_limbs, kt, tile,
               device=C.device)
    gram_u32_pk_tri.launches += 1
    return C


gram_u32_pk_tri.launches = 0


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) to int32 storage with the same low bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def gram_u32_pk_tri_plain(Bp: torch.Tensor, w: torch.Tensor,
                          C: torch.Tensor, *, n_limbs: int, kt: int = KT,
                          tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of gram_u32_pk_tri, on any device.

    Unpacks K blocks of patterns to 0/1 rows and multiplies them per limb:
    in int64 on the CPU, in float64 on the card (CUDA has no int64 matmul).
    Both are exact: a block's partial is at most 127 * 8192 < 2^53."""
    _check_gram(Bp, w, C, n_limbs, kt, tile)
    dev = C.device
    S = C.shape[0]
    mm_dtype = torch.int64 if dev.type == "cpu" else torch.float64
    # undo pk_weight_order: w_nat[8r + b] is the weight of pattern 8r + b
    w_nat = (w.reshape(-1, 8, kt // 8).transpose(1, 2).reshape(-1)
             .to(torch.int64) & 0xFFFFFFFF)
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    acc = torch.zeros((S, S), dtype=torch.int64, device=dev)
    step = 1024                               # packed rows per K block
    for r0 in range(0, Bp.shape[0], step):
        blk = Bp[r0:r0 + step].to(torch.int32)
        bits = ((blk[:, None, :] >> shifts[:, None]) & 1).reshape(-1, S)
        bits = bits.to(mm_dtype)               # row 8r + b is pattern 8r + b
        wk = w_nat[8 * r0:8 * r0 + bits.shape[0]]
        for l in range(n_limbs):
            wl = ((wk >> (LIMB_BITS * l)) & 0x7F).to(mm_dtype)
            part = ((bits * wl[:, None]).T @ bits).to(torch.int64)
            acc = (acc + (part << (LIMB_BITS * l))) & 0xFFFFFFFF
    band = torch.arange(S, device=dev) // tile
    lower = band[:, None] >= band[None, :]
    old = C.to(torch.int64) & 0xFFFFFFFF
    C.copy_(_to_int32(torch.where(lower, (old + acc) & 0xFFFFFFFF, old)))
    return C


def _check_tril(C, dtype) -> None:
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] == C.shape[1] and C.shape[0] % PULL_TILE == 0,
             f"C must be int32[S, S] with S a multiple of {PULL_TILE}")
    _require(C.is_contiguous(), "C must be contiguous")
    _require(dtype in (torch.int16, torch.int32),
             "dtype must be torch.int16 (uint16 bits) or torch.int32")


def tril_tiles(C: torch.Tensor, dtype: torch.dtype = torch.int32
               ) -> torch.Tensor:
    """The lower-triangle 128 x 128 tiles of C as [n_tri, 128, 128], in
    tri_tile_tables order; dtype torch.int16 keeps the low 16 bits (the
    uint16 pull).

    Replaces kmerdb_tpu/ops/pallas_gram.py tril_tiles.  CUDA tensors go to
    csrc/tril_tiles.cu; CPU tensors to tril_tiles_plain."""
    _check_tril(C, dtype)
    if _kernel_device(C) == "cpu":
        return tril_tiles_plain(C, dtype)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    nt = C.shape[0] // PULL_TILE
    out = torch.empty((nt * (nt + 1) // 2, PULL_TILE, PULL_TILE),
                      dtype=dtype, device=C.device)
    _cuda_call(_cuda.lib().kmerdb_tril_tiles, C.data_ptr(), out.data_ptr(),
               C.shape[0], out.element_size(), device=C.device)
    tril_tiles.launches += 1
    return out


tril_tiles.launches = 0


def tril_tiles_plain(C: torch.Tensor, dtype: torch.dtype = torch.int32
                     ) -> torch.Tensor:
    """Plain PyTorch version of tril_tiles, on any device."""
    _check_tril(C, dtype)
    T = PULL_TILE
    nt = C.shape[0] // T
    i_tab, j_tab = (torch.from_numpy(t).to(C.device, torch.int64)
                    for t in tri_tile_tables(nt))
    blocks = C.reshape(nt, T, nt, T).transpose(1, 2)
    return blocks[i_tab, j_tab].to(dtype)
