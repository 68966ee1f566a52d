// Packed lower-triangle Gram for Hopper: C <- C + B^T diag(w) B, exact mod 2^32.
//
// Replaces gram_u32_pk_tri of kmerdb_tpu/ops/pallas_gram.py with its int8
// body _gram_pk_body_s8 (the default all2all engine).  The operands keep the
// JAX package's layout:
//   bp  uint8[P/8, S]   bit b of byte-row r is pattern 8r + b;
//   w   uint32[P]       pattern weights in pk_weight_order for the block kt:
//                       pattern 8r + b sits at blk*kt + b*(kt/8) + r%(kt/8),
//                       blk = r / (kt/8);
//   c   uint32[S, S]    running counts, updated in place.
// S is a multiple of `tile`, itself a multiple of 128; P is a multiple of kt,
// itself a multiple of 128.
//
// Grid.  One block of 256 threads per 128 x 128 output block whose coarse
// tile (edge `tile`) lies on or below the diagonal, enumerated in the
// tri_coords order; a coarse diagonal tile is computed in full.  Blocks above
// the coarse diagonal get no thread block and keep C's contents: the same
// triangle contract as the TPU kernel at the same tile.  The TPU kernel's
// sequential K grid axis is the stage loop inside the block here.
//
// Stage.  16 packed rows (128 patterns) of the block's two column slabs are
// unpacked into shared memory as dp4a words: the word for (bit plane b,
// quad q, sample s) holds, one per byte, the bits of patterns
// 8*(r0 + 4q + k) + b, k = 0..3.  For each 7-bit weight limb l the lhs words
// are those bits masked by the bytes (w >> 7l) & 0x7F of the same patterns,
// so one __dp4a adds four (bit * w_l) * bit products into a partial that
// stays below 127 * 128 per stage; the partial joins the uint32 accumulator
// as part << 7l, which wraps mod 2^32 like the reference's num_kmers_t.
//
// What bounds it.  Integer multiply-adds: the group costs
// 2 * P * S^2 * tri_frac * n_limbs operations over P * S / 8 bytes of packed
// bits, far above the card's operations-per-byte balance.  The design keeps
// every operand of the inner loop in shared memory and registers (each thread
// owns an 8 x 8 block of outputs and issues 64 dp4a per 16 bytes it loads),
// and re-reads the packed slabs from device memory once per output block.
// dp4a runs on the CUDA cores; the int8 tensor-core path (wgmma on s8
// operands staged by TMA) is later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "tri.cuh"

namespace {

constexpr int kBlock = 128;        // output block edge
constexpr int kRows = 16;          // packed rows per stage: 128 patterns
constexpr int kQuads = kRows / 4;  // dp4a words per bit plane and sample
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLimbBits = 7;

__global__ void __launch_bounds__(kThreads)
gram_pk_tri_kernel(const uint8_t* __restrict__ bp, const uint32_t* __restrict__ w,
                   uint32_t* __restrict__ c, int64_t n_rows8, int64_t s_pad,
                   int n_limbs, int kb, int sub) {
  __shared__ __align__(16) uint32_t a_s[8][kQuads][kBlock];  // lhs: row-slab bits x limb
  __shared__ __align__(16) uint32_t b_s[8][kQuads][kBlock];  // rhs: column-slab bits
  __shared__ uint32_t x_s[kQuads][kBlock];                   // row slab, 4 packed rows a word
  __shared__ uint32_t w_s[8][kRows];                         // stage weights by bit plane

  const int per_tile = sub * sub;
  int ci, cj;
  tri_coords(blockIdx.x / per_tile, ci, cj);
  const int s = blockIdx.x % per_tile;
  const int64_t row0 = static_cast<int64_t>(ci * sub + s / sub) * kBlock;
  const int64_t col0 = static_cast<int64_t>(cj * sub + s % sub) * kBlock;

  const int tid = threadIdx.x;
  // thread (ty, tx) owns rows {ty*4 + k, 64 + ty*4 + k} and columns
  // {tx*4 + k, 64 + tx*4 + k}, k = 0..3: 16-byte shared loads that a
  // quarter warp takes from 128 contiguous bytes
  const int ty = tid / 16;
  const int tx = tid % 16;

  uint32_t acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0u;

  for (int64_t r0 = 0; r0 < n_rows8; r0 += kRows) {
    __syncthreads();  // the previous stage's readers are done
    for (int it = tid; it < kQuads * kBlock; it += kThreads) {
      const int q = it / kBlock;
      const int col = it % kBlock;
      const uint8_t* src = bp + (r0 + 4 * q) * s_pad;
      uint32_t xr = 0u, xc = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xr |= static_cast<uint32_t>(src[k * s_pad + row0 + col]) << (8 * k);
        xc |= static_cast<uint32_t>(src[k * s_pad + col0 + col]) << (8 * k);
      }
      x_s[q][col] = xr;
#pragma unroll
      for (int b = 0; b < 8; ++b) b_s[b][q][col] = (xc >> b) & 0x01010101u;
    }
    if (tid < 8 * kRows) {
      const int b = tid / kRows;
      const int64_t r = r0 + tid % kRows;
      w_s[b][tid % kRows] = w[(r / kb) * kb * 8 + static_cast<int64_t>(b) * kb + r % kb];
    }
    for (int l = 0; l < n_limbs; ++l) {
      __syncthreads();  // staging (l == 0) or the previous limb's readers are done
      for (int it = tid; it < kQuads * kBlock; it += kThreads) {
        const int q = it / kBlock;
        const int col = it % kBlock;
        const uint32_t x = x_s[q][col];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          uint32_t wl = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wl |= ((w_s[b][4 * q + k] >> (kLimbBits * l)) & 0x7Fu) << (8 * k);
          // 0/1 bytes times 0xFF give 0x00/0xFF byte masks without carries
          a_s[b][q][col] = (((x >> b) & 0x01010101u) * 0xFFu) & wl;
        }
      }
      __syncthreads();

      uint32_t part[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) part[m][n] = 0u;
#pragma unroll 2
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const uint4 a0 = *reinterpret_cast<const uint4*>(&a_s[b][q][ty * 4]);
          const uint4 a1 = *reinterpret_cast<const uint4*>(&a_s[b][q][64 + ty * 4]);
          const uint4 b0 = *reinterpret_cast<const uint4*>(&b_s[b][q][tx * 4]);
          const uint4 b1 = *reinterpret_cast<const uint4*>(&b_s[b][q][64 + tx * 4]);
          const uint32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int n = 0; n < 8; ++n) part[m][n] = __dp4a(av[m], bv[n], part[m][n]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] += part[m][n] << (kLimbBits * l);
    }
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int64_t row = row0 + (m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4* dst = reinterpret_cast<uint4*>(c + row * s_pad + col0 + h * 64 + tx * 4);
      uint4 v = *dst;
      v.x += acc[m][h * 4 + 0];
      v.y += acc[m][h * 4 + 1];
      v.z += acc[m][h * 4 + 2];
      v.w += acc[m][h * 4 + 3];
      *dst = v;
    }
  }
}

}  // namespace

// Launches the Gram on `stream`; returns the launch's cudaError_t (0 when it
// was accepted).  The caller checks shapes, types and alignment.
extern "C" int kmerdb_gram_pk_tri(const void* bp, const void* w, void* c, int64_t n_rows8,
                                  int64_t s_pad, int n_limbs, int kt, int tile, void* stream) {
  const int64_t nt = s_pad / tile;
  const int sub = tile / kBlock;
  const int64_t blocks = nt * (nt + 1) / 2 * sub * sub;
  if (blocks == 0 || n_rows8 == 0) return 0;
  gram_pk_tri_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bp), static_cast<const uint32_t*>(w),
      static_cast<uint32_t*>(c), n_rows8, s_pad, n_limbs, kt / 8, sub);
  return static_cast<int>(cudaGetLastError());
}
