// Packed cross-database Gram for Hopper: C <- C + U^T diag(w) V, exact mod 2^32.
//
// Replaces cross_u32_pk of kmerdb_tpu/ops/pallas_gram.py with the int8 body
// _gram_pk_body_s8 (7-bit weight limbs): db2db contracts pattern-pair rows,
// where row p of U is the sample incidence of the row database's pattern and
// row p of V that of the column database's, weighted by their shared k-mers;
// the all2all-parts grid contracts union k-mer rows at weight 1.  Operands,
// the block body and what bounds it: gram_pk.cuh, here with two operands of
// their own widths.  up is uint8[P/8, s1_pad], vp uint8[P/8, s2_pad], c
// uint32[s1_pad, s2_pad] updated in place; s1_pad and s2_pad are multiples of
// 128.
//
// Grid.  One block of 256 threads per 128 x 128 output block over the full
// rectangle: (s2_pad / 128) x (s1_pad / 128).  Block (x, y) reads U's columns
// 128y .. and V's columns 128x .., and updates C's block (y, x).
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_pk.cuh"

namespace {

__global__ void __launch_bounds__(gram_pk::kThreads)
cross_pk_kernel(const uint8_t* __restrict__ up, const uint8_t* __restrict__ vp,
                const uint32_t* __restrict__ w, uint32_t* __restrict__ c, int64_t n_rows8,
                int64_t s1_pad, int64_t s2_pad, int n_limbs, int kb) {
  __shared__ gram_pk::Smem sm;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * gram_pk::kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * gram_pk::kBlock;
  gram_pk::block(sm, up, s1_pad, vp, s2_pad, w, n_rows8, n_limbs, kb, row0, col0,
                 c + row0 * s2_pad + col0, s2_pad);
}

}  // namespace

// Launches the cross Gram on `stream`; returns the launch's cudaError_t.  The
// caller checks shapes, types and alignment.
extern "C" int kmerdb_cross_pk(const void* up, const void* vp, const void* w, void* c,
                               int64_t n_rows8, int64_t s1_pad, int64_t s2_pad, int n_limbs,
                               int kt, void* stream) {
  const int64_t row_blocks = s1_pad / gram_pk::kBlock;
  const int64_t col_blocks = s2_pad / gram_pk::kBlock;
  if (row_blocks == 0 || col_blocks == 0 || n_rows8 == 0) return 0;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks));
  cross_pk_kernel<<<grid, gram_pk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(up), static_cast<const uint8_t*>(vp),
      static_cast<const uint32_t*>(w), static_cast<uint32_t*>(c), n_rows8, s1_pad, s2_pad,
      n_limbs, kt / 8);
  return static_cast<int>(cudaGetLastError());
}
