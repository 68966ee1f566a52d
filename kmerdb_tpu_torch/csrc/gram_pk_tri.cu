// Packed lower-triangle Gram for Hopper: C <- C + B^T diag(w) B, exact mod 2^32.
//
// Replaces gram_u32_pk_tri of kmerdb_tpu/ops/pallas_gram.py with its int8
// body _gram_pk_body_s8 (the default all2all engine).  Operands, the block
// body and what bounds it: gram_pk.cuh.  c is uint32[S, S], updated in place;
// S is a multiple of `tile`, itself a multiple of 128.
//
// Grid.  One block of 256 threads per 128 x 128 output block whose coarse
// tile (edge `tile`) lies on or below the diagonal, enumerated in the
// tri_coords order; a coarse diagonal tile is computed in full.  Blocks above
// the coarse diagonal get no thread block and keep C's contents: the same
// triangle contract as the TPU kernel at the same tile.
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_pk.cuh"
#include "tri.cuh"

namespace {

__global__ void __launch_bounds__(gram_pk::kThreads)
gram_pk_tri_kernel(const uint8_t* __restrict__ bp, const uint32_t* __restrict__ w,
                   uint32_t* __restrict__ c, int64_t n_rows8, int64_t s_pad,
                   int n_limbs, int kb, int sub) {
  __shared__ gram_pk::Smem sm;
  const int per_tile = sub * sub;
  int ci, cj;
  tri_coords(blockIdx.x / per_tile, ci, cj);
  const int s = blockIdx.x % per_tile;
  const int64_t row0 = static_cast<int64_t>(ci * sub + s / sub) * gram_pk::kBlock;
  const int64_t col0 = static_cast<int64_t>(cj * sub + s % sub) * gram_pk::kBlock;
  gram_pk::block(sm, bp, w, n_rows8, s_pad, n_limbs, kb, row0, col0,
                 c + row0 * s_pad + col0, s_pad);
}

}  // namespace

// Launches the Gram on `stream`; returns the launch's cudaError_t (0 when it
// was accepted).  The caller checks shapes, types and alignment.
extern "C" int kmerdb_gram_pk_tri(const void* bp, const void* w, void* c, int64_t n_rows8,
                                  int64_t s_pad, int n_limbs, int kt, int tile, void* stream) {
  const int64_t nt = s_pad / tile;
  const int sub = tile / gram_pk::kBlock;
  const int64_t blocks = nt * (nt + 1) / 2 * sub * sub;
  if (blocks == 0 || n_rows8 == 0) return 0;
  gram_pk_tri_kernel<<<static_cast<unsigned>(blocks), gram_pk::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(c), n_rows8, s_pad, n_limbs, kt / 8, sub);
  return static_cast<int>(cudaGetLastError());
}
