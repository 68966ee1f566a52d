"""The port's kernels: the packed Gram over the triangle (all2all's matrix
route), a row stripe (its streamed route) or the rectangle of two operands
(db2db and the all2all-parts grid), the accumulating query contraction of
new2all, the unpacked Gram and query contraction of the scan tier
(KMERDB_A2A_PALLAS=0), the triangle and survivor-tile pulls, and the
stripe passes (uint16 narrowing, survivor counts of a count filter, and
the filter itself, which zeroes the cells it drops).

Each kernel has a wrapper, which checks its operands, launches the CUDA
kernel for CUDA tensors (or raises) and counts its launches, and a plain
PyTorch version of the same function, which the wrapper runs for CPU
tensors and which ``chip_smoke.py`` compares the kernel with on the card.

Layouts are those of kmerdb_tpu/ops/pallas_gram.py, so the tests feed both
packages identical operands (``from_jax_layout``):

* ``Bp`` uint8[P/8, S]: bit b of byte-row r is pattern 8r + b;
* ``w`` the P pattern weights permuted by ``pk_weight_order`` for the
  K block ``kt``, uint32 bits in int32 storage;
* ``Up``, ``Vp`` two packed operands uint8[P/8, S1] and uint8[P/8, S2]
  over the same patterns (cross_u32_pk);
* ``H`` uint8 or uint32[Q, P] hit counts and ``B`` int8 0/1 [P, S]
  unpacked incidence (matmul_u32_acc, matmul_u32; gram_u32 and
  gram_u32_tri take ``B`` with uint32 weights ``w`` [P], unpermuted);
* ``C`` uint32[S, S] counts, a uint32[R, S] row stripe of them, or a
  uint32[S1, S2] or [Q, S] rectangle, in int32 storage.  torch has no
  uint32 add or shift; int32 storage wraps mod 2^32 with the same bits,
  and numpy reads them back with ``.view(np.uint32)``.
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
    """The JAX package's numpy operands of gram_u32_pk_tri and
    gram_u32_pk_rows (uint8 Bp, uint32 w_pk [P, 1], uint32 C or C stripe)
    as this module's tensors on `device`.  Always copies: the Gram updates
    C in place."""
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


def _check_packed(Bp, w, n_limbs, kt) -> None:
    _require(Bp.dtype == torch.uint8 and Bp.dim() == 2, "Bp must be uint8[P/8, S]")
    _require(w.dtype == torch.int32 and w.numel() == Bp.shape[0] * 8,
             "w must be int32 with P = 8 * Bp.shape[0] weights")
    _require(kt > 0 and kt % 128 == 0 and (Bp.shape[0] * 8) % kt == 0,
             "kt must be a multiple of 128 that divides P")
    _require(1 <= n_limbs <= MAX_LIMBS, f"n_limbs must lie in 1..{MAX_LIMBS}")


def _check_gram(Bp, w, C, n_limbs, kt, tile) -> None:
    _check_packed(Bp, w, n_limbs, kt)
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] == C.shape[1] == Bp.shape[1],
             "C must be int32[S, S] with S = Bp.shape[1]")
    _require(all(t.is_contiguous() for t in (Bp, w, C)),
             "operands must be contiguous")
    _require(tile > 0 and tile % 128 == 0 and C.shape[0] % tile == 0,
             "tile must be a multiple of 128 that divides S")


def _check_rows(Bp, w, C, rt0, n_limbs, kt, tile) -> None:
    _check_packed(Bp, w, n_limbs, kt)
    S = Bp.shape[1]
    _require(C.dtype == torch.int32 and C.dim() == 2 and C.shape[1] == S,
             "C_stripe must be int32[R, S] with S = Bp.shape[1]")
    _require(all(t.is_contiguous() for t in (Bp, w, C)),
             "operands must be contiguous")
    _require(tile > 0 and tile % 128 == 0 and S % tile == 0
             and C.shape[0] % tile == 0,
             "tile must be a multiple of 128 that divides S and R")
    _require(isinstance(rt0, int) and rt0 >= 0
             and rt0 * tile + C.shape[0] <= S,
             "rows [rt0 * tile, rt0 * tile + R) must lie inside [0, S)")


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


def _mm_dtype(dev: torch.device) -> torch.dtype:
    """The plain versions' matmul type: int64 on the CPU, float64 on the
    card (CUDA has no int64 matmul).  Both are exact for the partials they
    take: each is below 2^53."""
    return torch.int64 if dev.type == "cpu" else torch.float64


def _unpack_bits(blk: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8[r, S] packed rows as [8r, S] 0/1 rows of `dtype`: row 8i + b
    is bit b of packed row i."""
    shifts = torch.arange(8, dtype=torch.int32, device=blk.device)
    bits = (blk.to(torch.int32)[:, None, :] >> shifts[:, None]) & 1
    return bits.reshape(-1, blk.shape[1]).to(dtype)


def _cross_plain(Up: torch.Tensor, Vp: torch.Tensor, w: torch.Tensor,
                 n_limbs: int, kt: int, row0: int,
                 n_rows: int) -> torch.Tensor:
    """Rows [row0, row0 + n_rows) of U^T diag(w) V mod 2^32, as int64 (the
    Gram of one database when Up is Vp).

    Unpacks K blocks of patterns to 0/1 rows and multiplies them per 7-bit
    limb: a block's partial is at most 127 * 8192 < 2^53."""
    mm_dtype = _mm_dtype(Up.device)
    # undo pk_weight_order: w_nat[8r + b] is the weight of pattern 8r + b
    w_nat = (w.reshape(-1, 8, kt // 8).transpose(1, 2).reshape(-1)
             .to(torch.int64) & 0xFFFFFFFF)
    acc = torch.zeros((n_rows, Vp.shape[1]), dtype=torch.int64,
                      device=Up.device)
    step = 1024                               # packed rows per K block
    for r0 in range(0, Up.shape[0], step):
        lhs = _unpack_bits(Up[r0:r0 + step, row0:row0 + n_rows], mm_dtype)
        rhs = _unpack_bits(Vp[r0:r0 + step], mm_dtype)
        wk = w_nat[8 * r0:8 * r0 + rhs.shape[0]]
        for l in range(n_limbs):
            wl = ((wk >> (LIMB_BITS * l)) & 0x7F).to(mm_dtype)
            part = ((lhs * wl[:, None]).T @ rhs).to(torch.int64)
            acc = (acc + (part << (LIMB_BITS * l))) & 0xFFFFFFFF
    return acc


def gram_u32_pk_tri_plain(Bp: torch.Tensor, w: torch.Tensor,
                          C: torch.Tensor, *, n_limbs: int, kt: int = KT,
                          tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of gram_u32_pk_tri, on any device."""
    _check_gram(Bp, w, C, n_limbs, kt, tile)
    S = C.shape[0]
    acc = _cross_plain(Bp, Bp, w, n_limbs, kt, 0, S)
    band = torch.arange(S, device=C.device) // tile
    lower = band[:, None] >= band[None, :]
    old = C.to(torch.int64) & 0xFFFFFFFF
    C.copy_(_to_int32(torch.where(lower, (old + acc) & 0xFFFFFFFF, old)))
    return C


def gram_u32_pk_rows(Bp: torch.Tensor, w: torch.Tensor, C_stripe: torch.Tensor,
                     rt0: int, *, n_limbs: int, kt: int = KT,
                     tile: int = TILE) -> torch.Tensor:
    """C_stripe += rows [rt0 * tile, rt0 * tile + R) of B^T diag(w) B, in
    place, exact mod 2^32, over the full rectangle (cells right of the
    diagonal included).  C_stripe is int32[R, S]; rt0 counts tiles of the
    `tile` edge.

    Replaces kmerdb_tpu/ops/pallas_gram.py gram_u32_pk_rows with the int8
    engine: 7-bit weight limbs.  CUDA tensors go to csrc/gram_pk_rows.cu;
    CPU tensors to gram_u32_pk_rows_plain."""
    _check_rows(Bp, w, C_stripe, rt0, n_limbs, kt, tile)
    if _kernel_device(Bp, w, C_stripe) == "cpu":
        return gram_u32_pk_rows_plain(Bp, w, C_stripe, rt0, n_limbs=n_limbs,
                                      kt=kt, tile=tile)
    _require(C_stripe.data_ptr() % 16 == 0, "C_stripe must be 16-byte aligned")
    _cuda_call(_cuda.lib().kmerdb_gram_pk_rows, Bp.data_ptr(), w.data_ptr(),
               C_stripe.data_ptr(), Bp.shape[0], Bp.shape[1],
               C_stripe.shape[0], rt0, n_limbs, kt, tile,
               device=C_stripe.device)
    gram_u32_pk_rows.launches += 1
    return C_stripe


gram_u32_pk_rows.launches = 0


def gram_u32_pk_rows_plain(Bp: torch.Tensor, w: torch.Tensor,
                           C_stripe: torch.Tensor, rt0: int, *, n_limbs: int,
                           kt: int = KT, tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of gram_u32_pk_rows, on any device."""
    _check_rows(Bp, w, C_stripe, rt0, n_limbs, kt, tile)
    acc = _cross_plain(Bp, Bp, w, n_limbs, kt, rt0 * tile,
                       C_stripe.shape[0])
    old = C_stripe.to(torch.int64) & 0xFFFFFFFF
    C_stripe.copy_(_to_int32((old + acc) & 0xFFFFFFFF))
    return C_stripe


def _check_cross(Up, Vp, w, C, n_limbs, kt) -> None:
    _check_packed(Up, w, n_limbs, kt)
    _require(Vp.dtype == torch.uint8 and Vp.dim() == 2
             and Vp.shape[0] == Up.shape[0],
             "Vp must be uint8[P/8, S2] with Up's P/8 rows")
    _require(C.dtype == torch.int32 and C.dim() == 2
             and tuple(C.shape) == (Up.shape[1], Vp.shape[1]),
             "C must be int32[S1, S2] with S1 = Up.shape[1], "
             "S2 = Vp.shape[1]")
    _require(all(t.is_contiguous() for t in (Up, Vp, w, C)),
             "operands must be contiguous")
    _require(C.shape[0] % 128 == 0 and C.shape[1] % 128 == 0,
             "S1 and S2 must be multiples of 128")


def cross_u32_pk(Up: torch.Tensor, Vp: torch.Tensor, w: torch.Tensor,
                 C: torch.Tensor, *, n_limbs: int,
                 kt: int = KT) -> torch.Tensor:
    """C += U^T diag(w) V over the full rectangle, in place, exact mod
    2^32: row p of the packed operands Up uint8[P/8, S1] and Vp
    uint8[P/8, S2] is one pattern (db2db: one pattern pair; the parts
    grid: one union k-mer) of each side, w its weight.

    Replaces kmerdb_tpu/ops/pallas_gram.py cross_u32_pk with the int8
    engine: 7-bit weight limbs.  CUDA tensors go to csrc/cross_pk.cu; CPU
    tensors to cross_u32_pk_plain."""
    _check_cross(Up, Vp, w, C, n_limbs, kt)
    if _kernel_device(Up, Vp, w, C) == "cpu":
        return cross_u32_pk_plain(Up, Vp, w, C, n_limbs=n_limbs, kt=kt)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    _cuda_call(_cuda.lib().kmerdb_cross_pk, Up.data_ptr(), Vp.data_ptr(),
               w.data_ptr(), C.data_ptr(), Up.shape[0], C.shape[0],
               C.shape[1], n_limbs, kt, device=C.device)
    cross_u32_pk.launches += 1
    return C


cross_u32_pk.launches = 0


def cross_u32_pk_plain(Up: torch.Tensor, Vp: torch.Tensor, w: torch.Tensor,
                       C: torch.Tensor, *, n_limbs: int,
                       kt: int = KT) -> torch.Tensor:
    """Plain PyTorch version of cross_u32_pk, on any device."""
    _check_cross(Up, Vp, w, C, n_limbs, kt)
    acc = _cross_plain(Up, Vp, w, n_limbs, kt, 0, C.shape[0])
    old = C.to(torch.int64) & 0xFFFFFFFF
    C.copy_(_to_int32((old + acc) & 0xFFFFFFFF))
    return C


#: 8-bit limbs of the hit counts in matmul_u32_acc and matmul_u32, and of
#: the weights in gram_u32 and gram_u32_tri (the JAX package's bf16 family)
H_LIMB_BITS = 8
#: output block edge of the unpacked kernels: gram_u32_tri computes the
#: blocks on or below the diagonal of this grid
BLOCK = 128


def _check_matmul(H, B, C, n_limbs) -> None:
    """Operands of matmul_u32_acc, or of matmul_u32 when C is None."""
    _require(H.dtype in (torch.uint8, torch.int32) and H.dim() == 2,
             "H must be uint8 or int32 (uint32 bits) [Q, P]")
    _require(B.dtype == torch.int8 and B.dim() == 2
             and B.shape[0] == H.shape[1],
             "B must be int8[P, S] with P = H.shape[1]")
    _require(C is None or (C.dtype == torch.int32
                           and tuple(C.shape) == (H.shape[0], B.shape[1])),
             "C must be int32[Q, S] with Q = H.shape[0], S = B.shape[1]")
    _require(all(t.is_contiguous() for t in (H, B, C) if t is not None),
             "operands must be contiguous")
    _require(all(n % 128 == 0 for n in (*H.shape, B.shape[1])),
             "Q, P and S must be multiples of 128")
    _require(n_limbs == 1 if H.dtype == torch.uint8
             else 1 <= n_limbs <= 32 // H_LIMB_BITS,
             "n_limbs must be 1 for uint8 H and lie in 1..4 for int32 H")


def _limb_matmul_plain(h: torch.Tensor, B: torch.Tensor,
                       n_limbs: int) -> torch.Tensor:
    """sum over the 8-bit limbs l of h of (h_l @ B) << 8l, mod 2^32, as
    int64: h int64 [M, P] in [0, 2^32), B int8 [P, N] read as unsigned
    bytes, as the kernels read it.  Per K block of 4,096 patterns and limb
    the partial is at most 255 * 255 * 4096 < 2^53."""
    mm_dtype = _mm_dtype(B.device)
    acc = torch.zeros((h.shape[0], B.shape[1]), dtype=torch.int64,
                      device=B.device)
    step = 4096
    for k0 in range(0, h.shape[1], step):
        bk = B[k0:k0 + step].view(torch.uint8).to(mm_dtype)
        for l in range(n_limbs):
            hl = (h[:, k0:k0 + step] >> (H_LIMB_BITS * l)) & 0xFF
            part = (hl.to(mm_dtype) @ bk).to(torch.int64)
            acc = (acc + (part << (H_LIMB_BITS * l))) & 0xFFFFFFFF
    return acc


def matmul_splits(q_pad: int, s_pad: int, p_pad: int, n_sm: int) -> int:
    """k_splits of the query contraction's grid (csrc/matmul_acc.cu): the
    runs of 128-pattern stages each 128 x 128 output block is cut into, so
    that the grid holds about one block for each of the card's n_sm SMs.
    1 when the output blocks alone fill the card, and never more than the
    P_pad / 128 stages.  One block an SM and not the two an SM holds: a
    second block adds a fifth to an SM's rate, less than the split's sums
    cost (at new2all's Q_pad 512, 2 splits took 0.0936 ms against 0.0901
    for one; at Q_pad 128, 8 took 0.0401 against 4's 0.0370; PERF.md)."""
    blocks = (q_pad // BLOCK) * (s_pad // BLOCK)
    return max(1, min(p_pad // BLOCK, n_sm // max(1, blocks)))


def split_stages(n_stages: int, k_splits: int) -> list:
    """[(first stage, stages)] of each split, as the kernel's split_range
    cuts n_stages (csrc/matmul_acc.cu): the first n_stages % k_splits
    splits take one stage more than the rest."""
    base, rem = divmod(n_stages, k_splits)
    return [(z * base + min(z, rem), base + (z < rem))
            for z in range(k_splits)]


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_splits(H, k_splits) -> None:
    _require(k_splits is None or (isinstance(k_splits, int)
                                  and 1 <= k_splits <= H.shape[1] // BLOCK),
             "k_splits must lie in 1..P / 128")


def _launch_matmul(fn, H, B, C, n_limbs, k_splits) -> None:
    """One C launcher of csrc/matmul_acc.cu on PyTorch's current stream,
    with the planner's k_splits unless given, and its scratch: the limb
    planes of uint32 H, each split's sums when k_splits > 1 (about one
    output block of 64 KB an SM)."""
    _require(all(t.data_ptr() % 16 == 0 for t in (H, B, C)),
             "H, B and C must be 16-byte aligned")
    Q, P = H.shape
    S = B.shape[1]
    if k_splits is None:
        k_splits = matmul_splits(Q, S, P, _n_sm(C.device.index))
    planes = torch.empty((n_limbs, Q, P), dtype=torch.uint8,
                         device=C.device) if H.dtype == torch.int32 else None
    partials = torch.empty((k_splits, Q, S), dtype=torch.int32,
                           device=C.device) if k_splits > 1 else None
    _cuda_call(fn, H.data_ptr(), H.element_size(), B.data_ptr(), C.data_ptr(),
               Q, P, S, n_limbs, k_splits,
               *(t.data_ptr() if t is not None else None
                 for t in (planes, partials)), device=C.device)


def matmul_u32_acc(H: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
                   n_limbs: int, k_splits: int | None = None) -> torch.Tensor:
    """C += H @ B, in place, exact mod 2^32: H uint8 (one limb) or uint32
    bits in int32 storage [Q, P], split into n_limbs 8-bit limbs; B int8
    0/1 [P, S]; C int32[Q, S].  k_splits (tests and chip_smoke.py only)
    overrides matmul_splits' split of the patterns.

    Replaces kmerdb_tpu/ops/pallas_gram.py matmul_u32_acc.  CUDA tensors
    go to csrc/matmul_acc.cu; CPU tensors to matmul_u32_acc_plain."""
    _check_matmul(H, B, C, n_limbs)
    _check_splits(H, k_splits)
    if _kernel_device(H, B, C) == "cpu":
        return matmul_u32_acc_plain(H, B, C, n_limbs=n_limbs)
    _launch_matmul(_cuda.lib().kmerdb_matmul_acc, H, B, C, n_limbs, k_splits)
    matmul_u32_acc.launches += 1
    return C


matmul_u32_acc.launches = 0


def matmul_u32_acc_plain(H: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                         *, n_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of matmul_u32_acc, on any device."""
    _check_matmul(H, B, C, n_limbs)
    # widen before masking: uint32 counts >= 2^31 are negative in int32
    acc = _limb_matmul_plain(H.to(torch.int64) & 0xFFFFFFFF, B, n_limbs)
    old = C.to(torch.int64) & 0xFFFFFFFF
    C.copy_(_to_int32((old + acc) & 0xFFFFFFFF))
    return C


def matmul_u32(H: torch.Tensor, B: torch.Tensor, *, n_limbs: int,
               k_splits: int | None = None) -> torch.Tensor:
    """Fresh C = H @ B int32[Q, S], exact mod 2^32, with H, B and k_splits
    as in matmul_u32_acc: the chunk product of new2all's scan tier.

    Replaces kmerdb_tpu/ops/pallas_gram.py matmul_u32 (_matmul_tile_kernel).
    CUDA tensors go to csrc/matmul_acc.cu, which writes C fresh; CPU
    tensors to matmul_u32_plain."""
    _check_matmul(H, B, None, n_limbs)
    _check_splits(H, k_splits)
    if _kernel_device(H, B) == "cpu":
        return matmul_u32_plain(H, B, n_limbs=n_limbs)
    C = torch.empty((H.shape[0], B.shape[1]), dtype=torch.int32,
                    device=B.device)
    _launch_matmul(_cuda.lib().kmerdb_matmul_u32, H, B, C, n_limbs, k_splits)
    matmul_u32.launches += 1
    return C


matmul_u32.launches = 0


def matmul_u32_plain(H: torch.Tensor, B: torch.Tensor, *,
                     n_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of matmul_u32, on any device."""
    _check_matmul(H, B, None, n_limbs)
    return _to_int32(_limb_matmul_plain(H.to(torch.int64) & 0xFFFFFFFF, B,
                                        n_limbs))


def _check_planes(H, n_limbs) -> None:
    _require(H.dtype == torch.int32 and H.dim() == 2 and H.is_contiguous(),
             "H must be contiguous int32 (uint32 bits) [Q, P]")
    _require(all(n % 128 == 0 for n in H.shape),
             "Q and P must be multiples of 128")
    _require(1 <= n_limbs <= 32 // H_LIMB_BITS, "n_limbs must lie in 1..4")


def limb_planes(H: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """uint8[n_limbs, Q, P] limb planes of uint32 H (int32 storage): plane
    l is (H >> 8l) & 0xFF, the row operand that csrc/matmul_acc.cu's
    product reads for uint32 H (its launcher splits H so once a call).

    CUDA tensors go to the split kernel of csrc/matmul_acc.cu; CPU tensors
    to limb_planes_plain."""
    _check_planes(H, n_limbs)
    if _kernel_device(H) == "cpu":
        return limb_planes_plain(H, n_limbs)
    _require(H.data_ptr() % 16 == 0, "H must be 16-byte aligned")
    out = torch.empty((n_limbs, *H.shape), dtype=torch.uint8, device=H.device)
    _cuda_call(_cuda.lib().kmerdb_limb_planes, H.data_ptr(), out.data_ptr(),
               H.numel(), n_limbs, device=H.device)
    limb_planes.launches += 1
    return out


limb_planes.launches = 0


def limb_planes_plain(H: torch.Tensor, n_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of limb_planes, on any device."""
    _check_planes(H, n_limbs)
    h = H.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(h >> (H_LIMB_BITS * l)) & 0xFF
                        for l in range(n_limbs)]).to(torch.uint8)


def _check_unpacked_gram(B, w, n_limbs) -> None:
    _require(B.dtype == torch.int8 and B.dim() == 2,
             "B must be int8 0/1 [P, S]")
    _require(w.dtype == torch.int32 and w.dim() == 1
             and w.numel() == B.shape[0],
             "w must be int32 (uint32 bits) [P] with P = B.shape[0]")
    _require(B.is_contiguous() and w.is_contiguous(),
             "operands must be contiguous")
    _require(B.shape[0] % 128 == 0 and B.shape[1] % BLOCK == 0,
             "P and S must be multiples of 128")
    _require(1 <= n_limbs <= 32 // H_LIMB_BITS, "n_limbs must lie in 1..4")


def _launch_gram_u32(B, w, n_limbs: int, triangle: bool) -> torch.Tensor:
    _require(B.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
             "B and w must be 16-byte aligned")
    S = B.shape[1]
    C = torch.empty((S, S), dtype=torch.int32, device=B.device)
    _cuda_call(_cuda.lib().kmerdb_gram_u32, B.data_ptr(), w.data_ptr(),
               C.data_ptr(), B.shape[0], S, n_limbs, int(triangle),
               device=C.device)
    return C


def gram_u32(B: torch.Tensor, w: torch.Tensor, *,
             n_limbs: int) -> torch.Tensor:
    """Fresh C = B^T diag(w) B int32[S, S], exact mod 2^32, over the low
    8 * n_limbs bits of each weight: B int8 0/1 [P, S], w uint32 bits in
    int32 storage [P] (0 on pad rows).

    Replaces kmerdb_tpu/ops/pallas_gram.py gram_u32 (_gram_tile_kernel, the
    full grid, 8-bit limbs).  CUDA tensors go to csrc/gram_u32.cu; CPU
    tensors to gram_u32_plain."""
    _check_unpacked_gram(B, w, n_limbs)
    if _kernel_device(B, w) == "cpu":
        return gram_u32_plain(B, w, n_limbs=n_limbs)
    C = _launch_gram_u32(B, w, n_limbs, triangle=False)
    gram_u32.launches += 1
    return C


gram_u32.launches = 0


def gram_u32_tri(B: torch.Tensor, w: torch.Tensor, *,
                 n_limbs: int) -> torch.Tensor:
    """gram_u32 on the BLOCK x BLOCK tiles with tile row >= tile column
    only; the strictly-upper tiles are zero (uninitialised in the JAX
    package).  Diagonal tiles are computed in full, so
    tril(C) + tril(C, -1).T is the whole Gram.

    Replaces kmerdb_tpu/ops/pallas_gram.py gram_u32_tri
    (_gram_tile_tri_kernel).  CUDA tensors go to csrc/gram_u32.cu; CPU
    tensors to gram_u32_tri_plain."""
    _check_unpacked_gram(B, w, n_limbs)
    if _kernel_device(B, w) == "cpu":
        return gram_u32_tri_plain(B, w, n_limbs=n_limbs)
    C = _launch_gram_u32(B, w, n_limbs, triangle=True)
    gram_u32_tri.launches += 1
    return C


gram_u32_tri.launches = 0


def _gram_unpacked_plain(B, w, n_limbs) -> torch.Tensor:
    """B^T diag(w) B mod 2^32 as int64: the limb product of H = B^T diag(w)
    and B."""
    h = B.view(torch.uint8).T.to(torch.int64) \
        * (w.to(torch.int64) & 0xFFFFFFFF)
    return _limb_matmul_plain(h, B, n_limbs)


def gram_u32_plain(B: torch.Tensor, w: torch.Tensor, *,
                   n_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of gram_u32, on any device."""
    _check_unpacked_gram(B, w, n_limbs)
    return _to_int32(_gram_unpacked_plain(B, w, n_limbs))


def gram_u32_tri_plain(B: torch.Tensor, w: torch.Tensor, *,
                       n_limbs: int) -> torch.Tensor:
    """Plain PyTorch version of gram_u32_tri, on any device."""
    _check_unpacked_gram(B, w, n_limbs)
    band = torch.arange(B.shape[1], device=B.device) // BLOCK
    lower = band[:, None] >= band[None, :]
    return _to_int32(torch.where(lower, _gram_unpacked_plain(B, w, n_limbs),
                                 0))


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 storage to `dtype`; torch.int16 keeps the low 16 bits (the
    bits of a uint32 -> uint16 cast)."""
    if dtype == torch.int32:
        return x
    low = x & 0xFFFF
    return torch.where(low >= 1 << 15, low - (1 << 16), low).to(torch.int16)


def _check_tril(C, dtype) -> None:
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] == C.shape[1] and C.shape[0] % PULL_TILE == 0,
             f"C must be int32[S, S] with S a multiple of {PULL_TILE}")
    _require(C.is_contiguous(), "C must be contiguous")
    _check_pull_dtype(dtype)


def _check_pull_dtype(dtype) -> None:
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
    return _narrow(blocks[i_tab, j_tab], dtype)


def _check_stripe(C) -> None:
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] % PULL_TILE == 0 and C.shape[1] % PULL_TILE == 0,
             f"C must be int32[R, S] with R and S multiples of {PULL_TILE}")
    _require(C.is_contiguous(), "C must be contiguous")


def cast_rows(C: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of every cell of C int32[R, S], as int16[R, S] (the
    bits of a uint32 -> uint16 cast): the streamed stripe pull's
    narrowing.

    Replaces kmerdb_tpu/ops/pallas_gram.py cast_rows at dtype uint16.
    CUDA tensors go to csrc/cast_rows.cu; CPU tensors to cast_rows_plain."""
    _check_stripe(C)
    if _kernel_device(C) == "cpu":
        return cast_rows_plain(C)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    out = torch.empty(C.shape, dtype=torch.int16, device=C.device)
    _cuda_call(_cuda.lib().kmerdb_cast_rows, C.data_ptr(), out.data_ptr(),
               C.numel(), device=C.device)
    cast_rows.launches += 1
    return out


cast_rows.launches = 0


def cast_rows_plain(C: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of cast_rows, on any device."""
    _check_stripe(C)
    return _narrow(C, torch.int16)


def bias_bounds(lo: int, hi: int) -> np.ndarray:
    """Inclusive uint32 bounds encoded for filter_colsum and
    bounds_zero_rows as int32[2]
    (u32 ^ 0x80000000), as kmerdb_tpu/ops/pallas_gram.bias_bounds does."""
    return (np.array([lo, hi], dtype=np.uint32)
            ^ np.uint32(0x80000000)).astype(np.int32)


def _unbias(bounds) -> tuple:
    """(lo, hi) as Python ints from bias_bounds' encoding."""
    b = np.asarray(bounds)
    _require(b.shape == (2,) and b.dtype == np.int32,
             "bounds must be int32[2] from bias_bounds")
    lo, hi = (b.view(np.uint32) ^ np.uint32(0x80000000)).tolist()
    return lo, hi


def filter_colsum(C: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """int32[R/128, S]: for each 128-row tile of C int32[R, S] and each
    column, how many cells lie in [lo, hi], compared as uint32; `bounds`
    is bias_bounds(lo, hi).

    Replaces kmerdb_tpu/ops/pallas_gram.py filter_colsum (whose uint32
    output holds the same counts, at most 128).  CUDA tensors go to
    csrc/filter_colsum.cu, with the bounds decoded; CPU tensors to
    filter_colsum_plain."""
    _check_stripe(C)
    lo, hi = _unbias(bounds)
    if _kernel_device(C) == "cpu":
        return filter_colsum_plain(C, bounds)
    out = torch.empty((C.shape[0] // PULL_TILE, C.shape[1]), dtype=torch.int32,
                      device=C.device)
    _cuda_call(_cuda.lib().kmerdb_filter_colsum, C.data_ptr(), out.data_ptr(),
               C.shape[0], C.shape[1], lo, hi, device=C.device)
    filter_colsum.launches += 1
    return out


filter_colsum.launches = 0


def filter_colsum_plain(C: torch.Tensor, bounds: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version of filter_colsum, on any device."""
    _check_stripe(C)
    lo, hi = _unbias(bounds)
    u = C.to(torch.int64) & 0xFFFFFFFF
    keep = ((u >= lo) & (u <= hi)).to(torch.int32)
    return keep.reshape(-1, PULL_TILE, C.shape[1]).sum(1, dtype=torch.int32)


def bounds_zero_rows(C: torch.Tensor, bounds: np.ndarray,
                     dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """C int32[R, S] with every cell outside [lo, hi] set to 0, compared as
    uint32 (a cell >= 2^31 is negative in int32 storage and still counts as
    large); `bounds` is bias_bounds(lo, hi).  dtype torch.int16 narrows the
    result to uint16 bits: a surviving cell >= 65,536 leaves its low 16
    bits, as the JAX package's astype does.

    Replaces kmerdb_tpu/ops/pallas_gram.py bounds_zero_rows: the count
    filter of the mesh's streamed sparse all2all, run on each stripe before
    it is pulled.  CUDA tensors go to csrc/bounds_zero.cu, with the bounds
    decoded; CPU tensors to bounds_zero_rows_plain."""
    _check_stripe(C)
    _check_pull_dtype(dtype)
    lo, hi = _unbias(bounds)
    if _kernel_device(C) == "cpu":
        return bounds_zero_rows_plain(C, bounds, dtype)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    out = torch.empty(C.shape, dtype=dtype, device=C.device)
    _cuda_call(_cuda.lib().kmerdb_bounds_zero, C.data_ptr(), out.data_ptr(),
               C.numel(), out.element_size(), lo, hi, device=C.device)
    bounds_zero_rows.launches += 1
    return out


bounds_zero_rows.launches = 0


def bounds_zero_rows_plain(C: torch.Tensor, bounds: np.ndarray,
                           dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plain PyTorch version of bounds_zero_rows, on any device."""
    _check_stripe(C)
    _check_pull_dtype(dtype)
    lo, hi = _unbias(bounds)
    u = C.to(torch.int64) & 0xFFFFFFFF
    return _narrow(torch.where((u >= lo) & (u <= hi), C, 0), dtype)


def tile_tables(i_tab, j_tab, device) -> tuple:
    """Tile coordinate tables (integer sequences, e.g. the JAX package's
    numpy tables) as gather_tiles' int32 tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.int32))
                 .to(torch.device(device)) for t in (i_tab, j_tab))


def _check_gather(C, i_tab, j_tab, dtype) -> None:
    _check_stripe(C)
    _check_pull_dtype(dtype)
    _require(all(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
                 for t in (i_tab, j_tab)) and i_tab.numel() == j_tab.numel(),
             "i_tab and j_tab must be int32[n]")
    if i_tab.numel():
        # a kernel reading outside C would return other memory's bits;
        # one transfer brings all four extremes to the host
        i_lo, i_hi, j_lo, j_hi = torch.stack(
            [*torch.aminmax(i_tab), *torch.aminmax(j_tab)]).tolist()
        _require(i_lo >= 0 and j_lo >= 0
                 and i_hi < C.shape[0] // PULL_TILE
                 and j_hi < C.shape[1] // PULL_TILE,
                 "a listed tile lies outside C")


def gather_tiles(C: torch.Tensor, i_tab: torch.Tensor, j_tab: torch.Tensor,
                 dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The 128 x 128 tiles (i_tab[t], j_tab[t]) of C int32[R, S] as
    [n, 128, 128], in the tables' order (repeats allowed); dtype
    torch.int16 keeps the low 16 bits.

    Replaces kmerdb_tpu/ops/pallas_gram.py gather_tiles; n is exact (the
    JAX package pads it to a compile bucket).  CUDA tensors go to
    csrc/tril_tiles.cu; CPU tensors to gather_tiles_plain."""
    _check_gather(C, i_tab, j_tab, dtype)
    if _kernel_device(C, i_tab, j_tab) == "cpu":
        return gather_tiles_plain(C, i_tab, j_tab, dtype)
    _require(C.data_ptr() % 16 == 0, "C must be 16-byte aligned")
    out = torch.empty((i_tab.numel(), PULL_TILE, PULL_TILE), dtype=dtype,
                      device=C.device)
    _cuda_call(_cuda.lib().kmerdb_gather_tiles, C.data_ptr(),
               i_tab.data_ptr(), j_tab.data_ptr(), out.data_ptr(),
               i_tab.numel(), C.shape[1], out.element_size(), device=C.device)
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0


def gather_tiles_plain(C: torch.Tensor, i_tab: torch.Tensor,
                       j_tab: torch.Tensor,
                       dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plain PyTorch version of gather_tiles, on any device."""
    _check_gather(C, i_tab, j_tab, dtype)
    T = PULL_TILE
    blocks = C.reshape(C.shape[0] // T, T, C.shape[1] // T, T).transpose(1, 2)
    return _narrow(blocks[i_tab.long(), j_tab.long()], dtype)
