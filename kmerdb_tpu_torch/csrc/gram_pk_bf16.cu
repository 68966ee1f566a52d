// The packed Gram on Hopper's bf16 tensor cores, with 8-bit weight limbs:
// the triangle, a row stripe and the rectangle of two operands,
//   C <- C + U^T diag(w) V   exact mod 2^32
// (U = V = Bp for the triangle and the stripe).
//
// Replaces the bf16 engine's body _gram_pk_body of
// kmerdb_tpu/ops/pallas_gram.py (KMERDB_A2A_ENGINE=bf16) at its three
// sites, gram_u32_pk_tri, gram_u32_pk_rows and cross_u32_pk: per 8-bit
// limb of the weights, an f32 sum for each K block of kt patterns,
// truncated and shifted << 8 l into uint32 C.  The block body, its
// operands and what bounds it: gram_bf16.cuh packed_block (two warpgroups
// of wgmma m64n128k16).  The grids are those of the int8 engine's kernels
// (gram_pk_tri.cu, gram_pk_rows.cu, cross_pk.cu), one block of 256 threads
// for each 128 x 128 output block, with 150,528 bytes of dynamic shared
// memory and one block an SM; the
// K blocks are a loop inside the block (no split K: the triangle at 4,096
// samples is 528 blocks, four full waves of the card's 132 SMs).
//
//   tri    c uint32[S, S]: the blocks whose coarse tile (edge `tile`) lies
//          on or below the diagonal, in the tri_coords order; a coarse
//          diagonal tile is computed in full, strict-upper tiles keep C's
//          contents (the TPU kernel's triangle contract).
//   rows   c uint32[R, S], the stripe of rows rt0 * tile .. + R of C, over
//          the full rectangle: (S / 128) x (R / 128) blocks.
//   cross  up uint8[P/8, S1], vp uint8[P/8, S2] (two row pitches), c
//          uint32[S1, S2]: (S2 / 128) x (S1 / 128) blocks.
// S, S1, S2, R are multiples of 128, P of kt, and kt of 128 with 255 kt
// below 2^24; w uint32[P] in pk_weight_order for kt, 16-byte aligned.
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_bf16.cuh"
#include "tri.cuh"

namespace {

constexpr int kBlock = gram_bf16::kBlock;

__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
gram_pk_tri_bf16_kernel(const uint8_t* __restrict__ bp, const uint32_t* __restrict__ w,
                        uint32_t* __restrict__ c, int64_t s_pad, int n_st, int st_kt,
                        int n_limbs, int sub) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int per_tile = sub * sub;
  int ci, cj;
  tri_coords(static_cast<int>(blockIdx.x / per_tile), ci, cj);
  const int s = static_cast<int>(blockIdx.x % per_tile);
  const int64_t row0 = static_cast<int64_t>(ci * sub + s / sub) * kBlock;
  const int64_t col0 = static_cast<int64_t>(cj * sub + s % sub) * kBlock;
  gram_bf16::packed_block<true>(smem, bp + row0, s_pad, bp + col0, s_pad, w, 0, n_st, st_kt,
                                n_limbs, c + row0 * s_pad + col0, s_pad, false);
}

__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
gram_pk_rows_bf16_kernel(const uint8_t* __restrict__ bp, const uint32_t* __restrict__ w,
                         uint32_t* __restrict__ c, int64_t s_pad, int64_t first_row, int n_st,
                         int st_kt, int n_limbs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t local0 = static_cast<int64_t>(blockIdx.y) * kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  gram_bf16::packed_block<true>(smem, bp + first_row + local0, s_pad, bp + col0, s_pad, w, 0,
                                n_st, st_kt, n_limbs, c + local0 * s_pad + col0, s_pad, false);
}

__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
cross_pk_bf16_kernel(const uint8_t* __restrict__ up, const uint8_t* __restrict__ vp,
                     const uint32_t* __restrict__ w, uint32_t* __restrict__ c, int64_t s1_pad,
                     int64_t s2_pad, int n_st, int st_kt, int n_limbs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  gram_bf16::packed_block<true>(smem, up + row0, s1_pad, vp + col0, s2_pad, w, 0, n_st, st_kt,
                                n_limbs, c + row0 * s2_pad + col0, s2_pad, false);
}

// The stages and K blocks of n_rows8 packed rows at kt, after the checks
// the block needs: cudaSuccess, or cudaErrorInvalidValue for a shape no
// block takes.
cudaError_t plan(int64_t n_rows8, int kt, int n_limbs, int& n_st, int& st_kt) {
  const int64_t p = 8 * n_rows8;
  if (kt <= 0 || kt % gram_bf16::kStage != 0 || p % kt != 0 ||
      int64_t{255} * kt >= (int64_t{1} << 24) || n_limbs < 1 || n_limbs > 4 ||
      p / gram_bf16::kStage > INT32_MAX)
    return cudaErrorInvalidValue;
  n_st = static_cast<int>(p / gram_bf16::kStage);
  st_kt = kt / gram_bf16::kStage;
  return cudaSuccess;
}

// Once a device, the dynamic shared memory of kKernel, then its launch on
// `grid`; returns the launch's cudaError_t.
template <auto kKernel, class... Args>
int launch(dim3 grid, void* stream, Args... args) {
  cudaError_t err = gram_bf16::allow_smem_once<kKernel>(gram_bf16::kPkSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kKernel<<<grid, gram_bf16::kThreads, gram_bf16::kPkSmemBytes,
            static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point launches one form on `stream` and returns the launch's
// cudaError_t (0 when it was accepted, cudaErrorInvalidValue for a shape
// the block does not take).  The caller checks types and alignment
// (kmerdb_tpu_torch/ops/gram.py); the arguments are those of the int8
// engine's entry points.
extern "C" int kmerdb_gram_pk_tri_bf16(const void* bp, const void* w, void* c, int64_t n_rows8,
                                       int64_t s_pad, int n_limbs, int kt, int tile,
                                       void* stream) {
  const int64_t nt = s_pad / tile;
  const int sub = tile / kBlock;
  const int64_t blocks = nt * (nt + 1) / 2 * sub * sub;
  if (blocks == 0 || n_rows8 == 0) return 0;
  int n_st = 0, st_kt = 0;
  const cudaError_t err = plan(n_rows8, kt, n_limbs, n_st, st_kt);
  if (err != cudaSuccess || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch<gram_pk_tri_bf16_kernel>(
      dim3(static_cast<unsigned>(blocks)), stream, static_cast<const uint8_t*>(bp),
      static_cast<const uint32_t*>(w), static_cast<uint32_t*>(c), s_pad, n_st, st_kt, n_limbs,
      sub);
}

extern "C" int kmerdb_gram_pk_rows_bf16(const void* bp, const void* w, void* c, int64_t n_rows8,
                                        int64_t s_pad, int64_t r, int64_t rt0, int n_limbs,
                                        int kt, int tile, void* stream) {
  const int64_t row_blocks = r / kBlock;
  const int64_t col_blocks = s_pad / kBlock;
  if (row_blocks == 0 || col_blocks == 0 || n_rows8 == 0) return 0;
  int n_st = 0, st_kt = 0;
  const cudaError_t err = plan(n_rows8, kt, n_limbs, n_st, st_kt);
  if (err != cudaSuccess || row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<gram_pk_rows_bf16_kernel>(
      dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks)), stream,
      static_cast<const uint8_t*>(bp), static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(c), s_pad, rt0 * tile, n_st, st_kt, n_limbs);
}

extern "C" int kmerdb_cross_pk_bf16(const void* up, const void* vp, const void* w, void* c,
                                    int64_t n_rows8, int64_t s1_pad, int64_t s2_pad, int n_limbs,
                                    int kt, void* stream) {
  const int64_t row_blocks = s1_pad / kBlock;
  const int64_t col_blocks = s2_pad / kBlock;
  if (row_blocks == 0 || col_blocks == 0 || n_rows8 == 0) return 0;
  int n_st = 0, st_kt = 0;
  const cudaError_t err = plan(n_rows8, kt, n_limbs, n_st, st_kt);
  if (err != cudaSuccess || row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<cross_pk_bf16_kernel>(
      dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks)), stream,
      static_cast<const uint8_t*>(up), static_cast<const uint8_t*>(vp),
      static_cast<const uint32_t*>(w), static_cast<uint32_t*>(c), s1_pad, s2_pad, n_st, st_kt,
      n_limbs);
}
