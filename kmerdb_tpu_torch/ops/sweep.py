"""The Gram variants of the kernel sweep (tools/kernel_sweep.py in
kmerdb_tpu; kmerdb_tpu_torch/tools/kernel_sweep.py here): one triangle Gram
split into its parts, so that its time splits into unpack, product and
weight scale.  They are a measurement, not a route of the CLI.

Every variant updates C int32[S, S] (uint32 bits) in place on the lower
triangle of `tile`-edge tiles, keeps C's contents above it, and loops over
the P patterns in K blocks of kt:

* ``int8``: C += Bi^T diag(w & 0x7F) Bj on packed uint8[P/8, S] operands,
  the production s8 body (gram_u32_pk_tri at one limb);
* ``bf16``, ``bf16_ns``: C += Bi^T diag(w & 0xFF) Bj (or without w) on
  packed operands expanded to bf16 on chip, f32 sums truncated into C at
  the end of each K block (exact: a block's sum is below kt * 255 < 2^24;
  on the bf16 tensor cores, over a grid split like dotonly's);
* ``nodot``: the unpack alone, C_tile[x, y] += U_i[x, y] + U_j[x, y] for
  x, y < tile in each K block, U the block of the tile's columns unpacked
  b-major (row b * kt/8 + r is bit b of byte row r); needs kt >= tile (on
  the card: bf16's packed staging with no product, over the same split
  grid);
* ``dotonly``, ``dotonly_T``, ``dotonly_s8``: C += Bi^T Bj on unpacked
  bf16[P, S] operands (``dotonly_T``: Bi bf16[S, P]), f32 per K block
  truncated toward zero into C (on the bf16 tensor cores, over a grid split
  into runs of whole K blocks: ``dot_splits``), or int8[P, S] operands
  with int32 sums.

w is the P weights in pk_weight_order for kt, uint32 bits in int32
storage (read by ``int8`` and ``bf16`` only).  Bi and Bj may differ.  Each
variant has a wrapper in KERNELS, which checks its operands, launches
csrc/gram_sweep.cu for CUDA tensors (or raises) and counts its launches,
and a plain PyTorch version (``plain``), which the wrapper runs for CPU
tensors and which ``chip_smoke.py`` compares the kernel with on the card.
The plain versions of the bf16 family equal the kernels where the f32
block sums are exact, which integer operands below 2^24 a block are (the
tool's 0/1 operands and 8-bit weights), and half-integer ones below 2^22.
"""

import torch

from . import _cuda, gram
from .gram import _require

#: the variants, in kmerdb_tpu's order
VARIANTS = ("bf16", "bf16_ns", "int8", "nodot", "dotonly", "dotonly_T",
            "dotonly_s8")
#: the variants over bit-packed operands
PACKED = ("bf16", "bf16_ns", "int8", "nodot")
#: the variants whose grid is split over runs of whole K blocks; their
#: wrappers take ``k_splits=`` (default: dot_splits)
SPLIT = ("bf16", "bf16_ns", "nodot", "dotonly", "dotonly_T")
#: the variants that run gram_bf16.cuh's packed block (its staging and
#: its product; nodot runs the staging alone)
PACKED_BF16 = ("bf16", "bf16_ns")
#: the variants over unpacked bf16 operands, which take any bf16 values
UNPACKED_BF16 = tuple(v for v in SPLIT if v not in PACKED)
#: dot_splits takes the fewest splits within this factor of a full card
SPLIT_SLACK = 1.05


def operand_dtype(variant: str) -> torch.dtype:
    """The dtype of Bi and Bj for `variant`."""
    if variant in PACKED:
        return torch.uint8
    return torch.int8 if variant == "dotonly_s8" else torch.bfloat16


def _check(variant, w, Bi, Bj, C, kt, tile) -> int:
    """P, the pattern count of the operands; raises on what the kernel
    does not take."""
    _require(variant in VARIANTS, f"unknown variant {variant}")
    _require(C.dtype == torch.int32 and C.dim() == 2
             and C.shape[0] == C.shape[1], "C must be int32[S, S]")
    S = C.shape[0]
    dt = operand_dtype(variant)
    _require(Bi.dtype == dt and Bj.dtype == dt and Bi.dim() == Bj.dim() == 2,
             f"{variant} takes {dt} operands")
    if variant in PACKED:
        P = Bi.shape[0] * 8
        _require(tuple(Bi.shape) == tuple(Bj.shape) == (P // 8, S),
                 "Bi and Bj must be uint8[P/8, S]")
    else:
        P = Bj.shape[0]
        want = (S, P) if variant == "dotonly_T" else (P, S)
        _require(tuple(Bj.shape) == (P, S) and tuple(Bi.shape) == want,
                 f"Bi must be [{'S, P' if variant == 'dotonly_T' else 'P, S'}]"
                 f" and Bj [P, S]")
    _require(w.dtype == torch.int32 and w.dim() == 1 and w.numel() == P,
             "w must be int32 (uint32 bits) [P]")
    _require(kt > 0 and kt % 128 == 0 and P % kt == 0,
             "kt must be a multiple of 128 that divides P")
    _require(tile > 0 and tile % 128 == 0 and S % tile == 0,
             "tile must be a multiple of 128 that divides S")
    _require(variant != "nodot" or kt >= tile, "nodot needs kt >= tile")
    _require(all(t.is_contiguous() for t in (w, Bi, Bj, C)),
             "operands must be contiguous")
    return P


def n_blocks(S: int, tile: int) -> int:
    """The 128 x 128 output blocks of the lower triangle of `tile`-edge
    tiles of an S x S C, the grid of every variant."""
    nt, sub = S // tile, tile // gram.BLOCK
    return nt * (nt + 1) // 2 * sub * sub


def dot_splits(blocks: int, k_blocks: int, n_sm: int) -> int:
    """k_splits of the bf16 grids (csrc/gram_sweep.cu): the runs of whole
    K blocks each of the `blocks` output blocks is cut into, so that the
    grid fills the card's n_sm SMs, one block each (128 accumulators a
    thread hold a block above 128 registers).  A grid takes
    ceil(blocks * z / n_sm) waves of ceil(k_blocks / z) K blocks; this is
    the fewest splits within SPLIT_SLACK of the best such time or of a full
    card, each split's sums costing a pass of scratch.  At the tool's
    defaults (136 blocks, 132 SMs): 16 for dotonly's 256 K blocks (P 2^17),
    272 K blocks a block's time against 263.8 on a full card and 512 at one
    split; 13 for bf16's 2,048 (P 2^20), 2,212 against 2,110 and 4,096."""
    cost = {z: -(-blocks * z // n_sm) * -(-k_blocks // z)
            for z in range(1, k_blocks + 1)}
    limit = max(min(cost.values()), SPLIT_SLACK * blocks * k_blocks / n_sm)
    return min(z for z, c in cost.items() if c <= limit)


def _make(variant: str):
    entry = f"kmerdb_sweep_{variant.lower()}"

    def kernel(w: torch.Tensor, Bi: torch.Tensor, Bj: torch.Tensor,
               C: torch.Tensor, *, kt: int, tile: int,
               k_splits: int | None = None) -> torch.Tensor:
        P = _check(variant, w, Bi, Bj, C, kt, tile)
        _require(k_splits is None or (variant in SPLIT
                                      and isinstance(k_splits, int)
                                      and 1 <= k_splits <= P // kt),
                 f"k_splits is for {', '.join(SPLIT)} and must lie in "
                 f"1..P / kt")
        if gram._kernel_device(w, Bi, Bj, C) == "cpu":
            return plain(variant, w, Bi, Bj, C, kt=kt, tile=tile)
        _require(all(t.data_ptr() % 16 == 0 for t in (Bi, Bj, C)),
                 "Bi, Bj and C must be 16-byte aligned")
        _require(variant != "bf16" or w.data_ptr() % 16 == 0,
                 "bf16's w must be 16-byte aligned")
        args = (w.data_ptr(), Bi.data_ptr(), Bj.data_ptr(), C.data_ptr(), P,
                C.shape[0], kt, tile)
        if variant in SPLIT:
            blocks = n_blocks(C.shape[0], tile)
            z = k_splits or dot_splits(blocks, P // kt,
                                       gram._n_sm(C.device.index))
            # each split's sums, added into C by the launcher's second pass
            partials = torch.empty((z, blocks, gram.BLOCK, gram.BLOCK),
                                   dtype=torch.int32, device=C.device) \
                if z > 1 else None
            args += (z, partials.data_ptr() if partials is not None
                     else None)
            kernel.k_splits = z
        gram._cuda_call(getattr(_cuda.lib(), entry), *args, device=C.device)
        kernel.launches += 1
        return C

    kernel.__name__ = kernel.__qualname__ = f"sweep_{variant}"
    kernel.__doc__ = (f"The {variant} variant, in place on C; CUDA tensors go "
                      f"to csrc/gram_sweep.cu ({entry}), CPU tensors to "
                      f"plain().  Replaces the {variant} variant of "
                      f"tools/kernel_sweep.py build.")
    kernel.launches = 0
    # a SPLIT variant's k_splits of its last launch on the card
    kernel.k_splits = None
    return kernel


#: the wrapper of each variant, with its launch counter
KERNELS = {v: _make(v) for v in VARIANTS}


def _lower_add(C: torch.Tensor, acc: torch.Tensor, tile: int) -> torch.Tensor:
    """C += acc (int64, mod 2^32) on the lower tiles of edge `tile`; the
    strict-upper tiles keep their contents."""
    band = torch.arange(C.shape[0], device=C.device) // tile
    lower = band[:, None] >= band[None, :]
    old = C.to(torch.int64) & 0xFFFFFFFF
    C.copy_(gram._to_int32(torch.where(lower, (old + acc) & 0xFFFFFFFF,
                                       old)))
    return C


def _natural(w: torch.Tensor, kt: int) -> torch.Tensor:
    """The weights of pk_weight_order(kt) back in pattern order, as int64
    in [0, 2^32)."""
    return (w.reshape(-1, 8, kt // 8).transpose(1, 2).reshape(-1)
            .to(torch.int64) & 0xFFFFFFFF)


def _packed_gram(Bi, Bj, w_nat) -> torch.Tensor:
    """Bi^T diag(w_nat) Bj mod 2^32 as int64, for weights below 2^8: a
    block of 8,192 patterns sums to at most 255 * 8192 < 2^53."""
    mm = gram._mm_dtype(Bi.device)
    acc = torch.zeros((Bi.shape[1], Bj.shape[1]), dtype=torch.int64,
                      device=Bi.device)
    step = 1024                               # packed rows a block
    for r0 in range(0, Bi.shape[0], step):
        lhs = gram._unpack_bits(Bi[r0:r0 + step], mm)
        rhs = gram._unpack_bits(Bj[r0:r0 + step], mm)
        wk = w_nat[8 * r0:8 * r0 + lhs.shape[0]].to(mm)
        acc = (acc + ((lhs * wk[:, None]).T @ rhs).to(torch.int64)) \
            & 0xFFFFFFFF
    return acc


def _unpacked_gram(A, B, kt: int, flush) -> torch.Tensor:
    """sum over the K blocks of kt rows of flush(A_k^T B_k), mod 2^32, as
    int64: A [P, S1] and B [P, S2] in bf16 or int8."""
    mm = torch.float64 if A.dtype == torch.bfloat16 \
        else gram._mm_dtype(A.device)
    acc = torch.zeros((A.shape[1], B.shape[1]), dtype=torch.int64,
                      device=A.device)
    for k0 in range(0, A.shape[0], kt):
        part = A[k0:k0 + kt].to(mm).T @ B[k0:k0 + kt].to(mm)
        acc = (acc + flush(part).to(torch.int64)) & 0xFFFFFFFF
    return acc


def _nodot_sums(Bp: torch.Tensor, kt: int, tile: int) -> torch.Tensor:
    """[tile, S] int64: the first `tile` rows of each K block's b-major
    unpack of Bp, summed over the K blocks."""
    kb = kt // 8
    blocks = Bp.reshape(-1, kb, Bp.shape[1]).to(torch.int32)
    planes = [((blocks >> b) & 1).sum(0) for b in range(-(-tile // kb))]
    return torch.cat(planes)[:tile].to(torch.int64)


def plain(variant: str, w: torch.Tensor, Bi: torch.Tensor, Bj: torch.Tensor,
          C: torch.Tensor, *, kt: int, tile: int) -> torch.Tensor:
    """Plain PyTorch version of the `variant` kernel, on any device."""
    _check(variant, w, Bi, Bj, C, kt, tile)
    S = C.shape[0]
    if variant == "int8":
        acc = gram._cross_plain(Bi, Bj, w, 1, kt, 0, S,
                                gram.LIMB_BITS["s8"])
    elif variant in ("bf16", "bf16_ns"):
        w_nat = _natural(w, kt) & 0xFF if variant == "bf16" \
            else torch.ones(Bi.shape[0] * 8, dtype=torch.int64,
                            device=Bi.device)
        acc = _packed_gram(Bi, Bj, w_nat)
    elif variant == "nodot":
        nt = S // tile
        Ti = _nodot_sums(Bi, kt, tile).reshape(tile, nt, tile)
        Tj = _nodot_sums(Bj, kt, tile).reshape(tile, nt, tile)
        # cell (it * tile + x, jt * tile + y) adds Ti[x, it, y] + Tj[x, jt, y]
        acc = (Ti.permute(1, 0, 2)[:, :, None, :] + Tj[None]).reshape(S, S)
    elif variant == "dotonly_s8":
        acc = _unpacked_gram(Bi, Bj, kt, lambda part: part)
    else:
        A = Bi.T if variant == "dotonly_T" else Bi
        # the kernel's f32 block sum becomes an integer by truncation
        acc = _unpacked_gram(A, Bj, kt, torch.trunc)
    return _lower_add(C, acc, tile)

