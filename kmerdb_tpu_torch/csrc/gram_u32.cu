// Unpacked Gram for Hopper: C = B^T diag(w) B, exact mod 2^32, written fresh.
//
// Replaces gram_u32 (_gram_tile_kernel, the full grid) and gram_u32_tri
// (_gram_tile_tri_kernel, tiles i >= j) of kmerdb_tpu/ops/pallas_gram.py: the
// chunk product of the all2all scan tier (KMERDB_A2A_PALLAS=0), which adds each
// chunk's C into a running sum.
//   b  int8 [p_pad, s_pad] row-major along patterns, every byte 0 or 1;
//   w  uint32[p_pad] pattern weights in pattern order (0 on pad rows);
//   c  uint32[s_pad, s_pad], written in full: the triangle grid leaves the
//      strictly-upper 128 x 128 blocks zero (the TPU kernel leaves them
//      uninitialised).  Diagonal blocks are computed in full, so
//      tril(C) + tril(C, -1)^T is the whole Gram.
// p_pad and s_pad are multiples of 128; b and w are 16-byte aligned.
//
// Limbs.  The JAX package's bf16 family: 8-bit limbs (w >> 8l) & 0xFF of the
// low 8 * n_limbs bits of w, not the 7 bits of gram_pk.cuh.
//
// Block.  gram_u8.cuh's body in its weighted form, on Hopper's int8 tensor
// cores (mma.sync .u8.u8, so limb bytes 128..255 stay positive): b is both
// operands, the block's row samples (PatternRows) and its column samples;
// the limbs are the outer loop and each limb's sum joins C as sum << 8l at
// least every 2^23 patterns.  Its staging, fragments and what bounds it: gram_u8.cuh.
//
// Grids.  One block of 256 threads per 128 x 128 output block: the full grid
// (s_pad / 128)^2, or the lower triangle enumerated by tri_coords (tri.cuh).
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_u8.cuh"
#include "tri.cuh"

namespace {

constexpr int kMaxLimbs = 4;  // 8-bit limbs of a uint32 weight

template <bool kTri>
__global__ void __launch_bounds__(gram_u8::kThreads, gram_u8::kMinBlocks)
gram_u32_kernel(const uint8_t* __restrict__ b, const uint32_t* __restrict__ w,
                uint32_t* __restrict__ c, int64_t p_pad, int64_t s_pad, int n_limbs) {
  extern __shared__ __align__(16) uint8_t smem[];
  int bi, bj;
  if constexpr (kTri) {
    tri_coords(static_cast<int>(blockIdx.x), bi, bj);
  } else {
    bi = static_cast<int>(blockIdx.y);
    bj = static_cast<int>(blockIdx.x);
  }
  const int64_t row0 = static_cast<int64_t>(bi) * gram_u8::kBlock;
  const int64_t col0 = static_cast<int64_t>(bj) * gram_u8::kBlock;
  const gram_u8::PatternRows rows(b + row0, s_pad);
  gram_u8::block<true, true>(smem, rows, b + col0, s_pad, w, 0,
                             static_cast<int>(p_pad / gram_u8::kStage), n_limbs,
                             gram_u8::kFlushU8, true, c + row0 * s_pad + col0, s_pad);
}

}  // namespace

// Launches C = B^T diag(w) B on `stream`: the full grid, or with `triangle`
// the blocks on or below the diagonal after zeroing C.  Returns the first
// cudaError_t of the calls (0 when all were accepted).  The caller checks
// shapes, types and alignment.
extern "C" int kmerdb_gram_u32(const void* b, const void* w, void* c, int64_t p_pad,
                               int64_t s_pad, int n_limbs, int triangle, void* stream) {
  const int64_t nb = s_pad / gram_u8::kBlock;
  if (nb == 0) return 0;
  if (n_limbs < 1 || n_limbs > kMaxLimbs) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  const uint32_t* ww = static_cast<const uint32_t*>(w);
  uint32_t* cc = static_cast<uint32_t*>(c);
  if (triangle) {
    // the strictly-upper blocks get no thread block
    cudaError_t err = gram_u8::allow_smem(gram_u32_kernel<true>);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(c, 0, static_cast<size_t>(s_pad) * s_pad * sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_u32_kernel<true><<<static_cast<unsigned>(nb * (nb + 1) / 2), gram_u8::kThreads,
                            gram_u8::kSmemBytes, st>>>(bb, ww, cc, p_pad, s_pad, n_limbs);
  } else {
    if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = gram_u8::allow_smem(gram_u32_kernel<false>);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(nb));
    gram_u32_kernel<false><<<grid, gram_u8::kThreads, gram_u8::kSmemBytes, st>>>(
        bb, ww, cc, p_pad, s_pad, n_limbs);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of gram_u8.cuh's body takes, in bytes
// (ptxas reports static shared memory only): that of gram_u32.cu's kernels
// and of matmul_acc.cu's.
extern "C" int kmerdb_gram_u8_smem_bytes() { return gram_u8::kSmemBytes; }
