// One 128 x 128 output block of the packed two-operand Gram, shared by the
// triangle (gram_pk_tri.cu), row-stripe (gram_pk_rows.cu) and rectangle
// (cross_pk.cu) kernels:
//   out[r, c] += sum_p bit_u(p, row0 + r) * w[p] * bit_v(p, col0 + c)   mod 2^32.
// The two Grams of one database pass the same operand as u and v.
//
// The operands keep the JAX package's layout (kmerdb_tpu/ops/pallas_gram.py):
//   up  uint8[P/8, ld_u]   row operand: bit b of byte-row r is pattern 8r + b;
//   vp  uint8[P/8, ld_v]   column operand, the same patterns (for db2db, the
//                          same pattern pairs) in the same bit order;
//   w   uint32[P]          pattern weights in pk_weight_order for the block kt:
//                          pattern 8r + b sits at blk*kt + b*(kt/8) + r%(kt/8),
//                          blk = r / (kt/8), with kb = kt/8;
//   out uint32             the block's first cell, rows `ld` apart.
// row0 is a column of up and col0 a column of vp; P is a multiple of kt,
// itself a multiple of 128, so a stage never crosses a kt block.
//
// Stage.  16 packed rows (128 patterns) of the block's two column slabs are
// unpacked into shared memory as dp4a words: the word for (bit plane b,
// quad q, sample s) holds, one per byte, the bits of patterns
// 8*(r0 + 4q + k) + b, k = 0..3.  For each 7-bit weight limb l the lhs words
// are those bits masked by the bytes (w >> 7l) & 0x7F of the same patterns,
// so one __dp4a adds four (bit * w_l) * bit products into a partial that
// stays below 127 * 128 per stage; the partial joins the uint32 accumulator
// as part << 7l, which wraps mod 2^32 like the reference's num_kmers_t.
// This is the int8 engine of the TPU kernels (_gram_pk_body_s8), with the
// TPU's sequential K grid axis as the stage loop inside the block.
//
// What bounds it.  Integer multiply-adds: far above the card's
// operations-per-byte balance.  Every operand of the inner loop sits in
// shared memory and registers (each thread owns an 8 x 8 block of outputs
// and issues 64 dp4a per 16 bytes it loads); the packed slabs are re-read
// from device memory once per output block.  dp4a runs on the CUDA cores;
// the int8 tensor-core path (wgmma on s8 operands staged by TMA) is later
// work.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gram_pk {

constexpr int kBlock = 128;        // output block edge
constexpr int kRows = 16;          // packed rows per stage: 128 patterns
constexpr int kQuads = kRows / 4;  // dp4a words per bit plane and sample
constexpr int kThreads = 256;      // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLimbBits = 7;

// 35,328 bytes: under the 48 KB of static shared memory a block may hold
struct Smem {
  __align__(16) uint32_t a[8][kQuads][kBlock];  // lhs: row-slab bits x limb
  __align__(16) uint32_t b[8][kQuads][kBlock];  // rhs: column-slab bits
  uint32_t x[kQuads][kBlock];                   // row slab, 4 packed rows a word
  uint32_t w[8][kRows];                         // stage weights by bit plane
};

// Called by all kThreads threads of the block; `out` must be 16-byte aligned
// and `ld` a multiple of 4.
__device__ __forceinline__ void block(Smem& sm, const uint8_t* __restrict__ up, int64_t ld_u,
                                      const uint8_t* __restrict__ vp, int64_t ld_v,
                                      const uint32_t* __restrict__ w, int64_t n_rows8,
                                      int n_limbs, int kb, int64_t row0, int64_t col0,
                                      uint32_t* __restrict__ out, int64_t ld) {
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
      const uint8_t* src_u = up + (r0 + 4 * q) * ld_u + row0 + col;
      const uint8_t* src_v = vp + (r0 + 4 * q) * ld_v + col0 + col;
      uint32_t xr = 0u, xc = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        xr |= static_cast<uint32_t>(src_u[k * ld_u]) << (8 * k);
        xc |= static_cast<uint32_t>(src_v[k * ld_v]) << (8 * k);
      }
      sm.x[q][col] = xr;
#pragma unroll
      for (int b = 0; b < 8; ++b) sm.b[b][q][col] = (xc >> b) & 0x01010101u;
    }
    if (tid < 8 * kRows) {
      const int b = tid / kRows;
      const int64_t r = r0 + tid % kRows;
      sm.w[b][tid % kRows] = w[(r / kb) * kb * 8 + static_cast<int64_t>(b) * kb + r % kb];
    }
    for (int l = 0; l < n_limbs; ++l) {
      __syncthreads();  // staging (l == 0) or the previous limb's readers are done
      for (int it = tid; it < kQuads * kBlock; it += kThreads) {
        const int q = it / kBlock;
        const int col = it % kBlock;
        const uint32_t x = sm.x[q][col];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          uint32_t wl = 0u;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wl |= ((sm.w[b][4 * q + k] >> (kLimbBits * l)) & 0x7Fu) << (8 * k);
          // 0/1 bytes times 0xFF give 0x00/0xFF byte masks without carries
          sm.a[b][q][col] = (((x >> b) & 0x01010101u) * 0xFFu) & wl;
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
          const uint4 a0 = *reinterpret_cast<const uint4*>(&sm.a[b][q][ty * 4]);
          const uint4 a1 = *reinterpret_cast<const uint4*>(&sm.a[b][q][64 + ty * 4]);
          const uint4 b0 = *reinterpret_cast<const uint4*>(&sm.b[b][q][tx * 4]);
          const uint4 b1 = *reinterpret_cast<const uint4*>(&sm.b[b][q][64 + tx * 4]);
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
    const int64_t row = m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4* dst = reinterpret_cast<uint4*>(out + row * ld + h * 64 + tx * 4);
      uint4 v = *dst;
      v.x += acc[m][h * 4 + 0];
      v.y += acc[m][h * 4 + 1];
      v.z += acc[m][h * 4 + 2];
      v.w += acc[m][h * 4 + 3];
      *dst = v;
    }
  }
}

}  // namespace gram_pk
