// Row-stripe packed Gram for Hopper:
//   C_stripe <- C_stripe + (B^T diag(w) B)[rows rt0*tile .. rt0*tile + R, :],
// exact mod 2^32, over the full rectangle (cells with column > row included).
//
// Replaces gram_u32_pk_rows of kmerdb_tpu/ops/pallas_gram.py with its int8
// body _gram_pk_body_s8: the streamed large-collection all2all, where the
// card holds one stripe of C and never the whole matrix.  Operands, the block
// body and what bounds it: gram_pk.cuh.  c is uint32[R, s_pad] with R a
// multiple of `tile` and `tile` a multiple of 128; rt0 counts tiles of that
// edge, as on the TPU, and arrives at run time, so every stripe shares one
// kernel.
//
// Grid.  One block of 256 threads per 128 x 128 block of the stripe:
// (s_pad / 128) x (R / 128).  Block (x, y) reads the B columns of global rows
// rt0*tile + 128y .. and of columns 128x .., and updates C_stripe's local rows
// 128y .. in place.
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_pk.cuh"

namespace {

__global__ void __launch_bounds__(gram_pk::kThreads)
gram_pk_rows_kernel(const uint8_t* __restrict__ bp, const uint32_t* __restrict__ w,
                    uint32_t* __restrict__ c, int64_t n_rows8, int64_t s_pad,
                    int64_t first_row, int n_limbs, int kb) {
  __shared__ gram_pk::Smem sm;
  const int64_t local0 = static_cast<int64_t>(blockIdx.y) * gram_pk::kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * gram_pk::kBlock;
  gram_pk::block(sm, bp, w, n_rows8, s_pad, n_limbs, kb, first_row + local0, col0,
                 c + local0 * s_pad + col0, s_pad);
}

}  // namespace

// Launches the stripe Gram on `stream` for the stripe of `r` rows that starts
// at global row rt0 * tile; returns the launch's cudaError_t.  The caller
// checks shapes, types, alignment and that the stripe lies inside [0, s_pad).
extern "C" int kmerdb_gram_pk_rows(const void* bp, const void* w, void* c, int64_t n_rows8,
                                   int64_t s_pad, int64_t r, int64_t rt0, int n_limbs, int kt,
                                   int tile, void* stream) {
  const int64_t row_blocks = r / gram_pk::kBlock;
  const int64_t col_blocks = s_pad / gram_pk::kBlock;
  if (row_blocks == 0 || col_blocks == 0 || n_rows8 == 0) return 0;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks));
  gram_pk_rows_kernel<<<grid, gram_pk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(c), n_rows8, s_pad, rt0 * tile, n_limbs, kt / 8);
  return static_cast<int>(cudaGetLastError());
}
