// One 128 x 128 output block of the packed two-operand Gram, shared by the
// triangle (gram_pk_tri.cu), row-stripe (gram_pk_rows.cu) and rectangle
// (cross_pk.cu) kernels and the sweep's int8 variant (gram_sweep.cu):
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
// unpacked into shared memory, one row of 32 words a sample: word 4b + q
// holds, one per byte, the bits of patterns 8*(r0 + 4q + k) + b, k = 0..3.
// The row slab's words are masked by the bytes (w >> 7l) & 0x7F of the same
// patterns (weight limb l), whose 32 words a stage are built once into
// shared memory for 8 stages at a time.  Threads 0..127 stage a column of
// the row slab each and 128..255 one of the column slab; the next stage's
// 16 bytes a thread are loaded into registers while the product runs.
//
// Product.  The staged words are the int8 operands of Hopper's tensor cores
// (mma_s8.cuh, m16n8k32) as they stand: K = (bit plane b, quad q, byte k),
// one K step of 32 takes bit planes 2ks and 2ks + 1 (words 8ks .. 8ks + 7
// of each sample), the same order in A, B and the weights.  8 warps each
// own 64 x 32 outputs, 4 x 4 tiles of 16 x 8, and load their fragments with
// ldmatrix (4 x 8 rows of 16 bytes a call); a sample's row is padded to 36
// words so that those 8 rows fall on distinct banks.  The limbs are the
// outer loop: limb l's sum over at most 2^24 patterns (< 127 * 2^24 < 2^31,
// so no s32 sum inside the mma exceeds its range) joins out as sum << 7l
// in uint32 arithmetic, which wraps mod 2^32 like the reference's
// num_kmers_t.  This is the int8 engine of the TPU kernels
// (_gram_pk_body_s8), with the TPU's sequential K grid axis as the stage
// loop inside the block.
//
// What bounds it.  Integer multiply-adds: far above the card's
// operations-per-byte balance.  The packed slabs are re-read from device
// memory once per output block and limb; every operand of the product
// sits in shared memory and registers.  The block takes 37,888 bytes of
// static shared memory and at most 128 registers a thread (ptxas: 118, no
// spill), so two blocks share an SM and one's staging overlaps the
// other's product.  On an H100 SXM (PERF.md §6) a block multiplies at
// about 2 int8 Tops whether it has its SM alone or shares it, so the SM
// is not the limit (two blocks reach about a quarter of the int8 peak):
// the block waits on itself, on two barriers a stage and on the next
// stage's bytes, loaded one stage ahead.  A deeper staging pipeline
// (cp.async or TMA into a ring of stages, wgmma) is later work.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace gram_pk {

constexpr int kBlock = 128;                  // output block edge
constexpr int kRows = 16;                    // packed rows per stage: 128 patterns
constexpr int kWords = 32;                   // operand words a sample and stage
constexpr int kPitch = kWords + 4;           // a sample's words in shared memory
constexpr int kThreads = 256;                // 8 warps of 64 x 32 outputs
constexpr int kMinBlocks = 2;                // blocks an SM holds: <= 128 registers
constexpr int kGroup = kThreads / kWords;    // stages whose limb words are built at once
constexpr int kLimbBits = 7;
constexpr int64_t kFlushRows8 = int64_t{1} << 21;  // 2^24 patterns a flush

// 37,888 bytes: under the 48 KB of static shared memory a block may hold
struct Smem {
  __align__(16) uint32_t a[kBlock][kPitch];   // lhs: row-slab bits x limb
  __align__(16) uint32_t b[kBlock][kPitch];   // rhs: column-slab bits
  __align__(16) uint32_t wl[kGroup][kWords];  // limb words of kGroup stages
};

// Four 8 x 8 matrices of 32-bit words: lane i gives row i % 8 of matrix
// i / 8 (16 contiguous bytes); lane (g, t) receives word t of row g of each.
__device__ __forceinline__ void ldsm_x4(const uint32_t* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// The 16 packed rows from r of one column: row r + 4q + k in byte k of x[q].
__device__ __forceinline__ void load_rows(const uint8_t* __restrict__ src, int64_t ld, int64_t r,
                                          uint32_t (&x)[4]) {
  src += r * ld;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) v |= static_cast<uint32_t>(src[(4 * q + k) * ld]) << (8 * k);
    x[q] = v;
  }
}

// Called by all kThreads threads of the block; `out` must be 8-byte aligned
// and `ld` even.
__device__ __forceinline__ void block(Smem& sm, const uint8_t* __restrict__ up, int64_t ld_u,
                                      const uint8_t* __restrict__ vp, int64_t ld_v,
                                      const uint32_t* __restrict__ w, int64_t n_rows8,
                                      int n_limbs, int kb, int64_t row0, int64_t col0,
                                      uint32_t* __restrict__ out, int64_t ld) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // staging: warps 0-3 take the row slab, 4-7 the column slab, a column each
  const bool lhs = tid < kBlock;
  const int col = tid % kBlock;
  const uint8_t* src = lhs ? up + row0 + col : vp + col0 + col;
  const int64_t ld_src = lhs ? ld_u : ld_v;
  uint32_t* dst = lhs ? sm.a[col] : sm.b[col];
  // product: warp (wm, wn) owns rows 64wm .. 64wm + 63 and columns
  // 32wn .. 32wn + 31; the rows its lane hands to ldmatrix: A's matrices
  // are (rows 0-7, 8-15) x (words 0-3, 4-7) of a 16-row tile, B's (words
  // 0-3, 4-7) x (rows 0-7, 8-15) of two 8-column tiles
  const int wm = warp / 4;
  const int wn = warp % 4;
  const uint32_t* a_frag = &sm.a[64 * wm + lane % 16][4 * (lane / 16)];
  const uint32_t* b_frag = &sm.b[32 * wn + 8 * (lane / 16) + lane % 8][4 * (lane / 8 % 2)];

  for (int l = 0; l < n_limbs; ++l) {
    for (int64_t c0 = 0; c0 < n_rows8; c0 += kFlushRows8) {
      const int64_t c1 = c0 + kFlushRows8 < n_rows8 ? c0 + kFlushRows8 : n_rows8;
      uint32_t acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0u;
      uint32_t x[4];
      load_rows(src, ld_src, c0, x);

      for (int64_t r0 = c0; r0 < c1; r0 += kRows) {
        const int s = static_cast<int>((r0 - c0) / kRows % kGroup);
        __syncthreads();  // the previous stage's readers are done
        if (s == 0) {
          // word 4b + q of stage j: the limbs of patterns 8(r + k) + b,
          // r = r0 + 16j + 4q; the four share r / kb (kb is a multiple of 16)
          const int j = tid / kWords;
          const int b = tid % kWords / 4;
          const int64_t r = r0 + kRows * j + 4 * (tid % 4);
          uint32_t word = 0u;
          if (r < c1) {
            const uint32_t* wp = w + (r / kb) * kb * 8 + static_cast<int64_t>(b) * kb + r % kb;
#pragma unroll
            for (int k = 0; k < 4; ++k) word |= ((wp[k] >> (kLimbBits * l)) & 0x7Fu) << (8 * k);
          }
          sm.wl[j][tid % kWords] = word;
          __syncthreads();
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          uint4 v = make_uint4((x[0] >> b) & 0x01010101u, (x[1] >> b) & 0x01010101u,
                               (x[2] >> b) & 0x01010101u, (x[3] >> b) & 0x01010101u);
          if (lhs) {
            // 0/1 bytes times 0xFF give 0x00/0xFF byte masks without carries
            const uint4 m = *reinterpret_cast<const uint4*>(&sm.wl[s][4 * b]);
            v.x = (v.x * 0xFFu) & m.x;
            v.y = (v.y * 0xFFu) & m.y;
            v.z = (v.z * 0xFFu) & m.z;
            v.w = (v.w * 0xFFu) & m.w;
          }
          *reinterpret_cast<uint4*>(dst + 4 * b) = v;
        }
        __syncthreads();
        if (r0 + kRows < c1) load_rows(src, ld_src, r0 + kRows, x);

#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t af[4][4], bf[4][2];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) ldsm_x4(a_frag + 16 * mt * kPitch + 8 * ks, af[mt]);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            ldsm_x4(b_frag + 16 * np * kPitch + 8 * ks, r);
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8::m16n8k32(acc[mt][nt], af[mt], bf[nt]);
        }
      }

      // lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each tile
      const int g = lane / 4;
      const int t = lane % 4;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* row = out + (64 * wm + 16 * mt + 8 * h + g) * ld + 32 * wn + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint2* dst2 = reinterpret_cast<uint2*>(row + 8 * nt);
            uint2 v = *dst2;
            v.x += acc[mt][nt][2 * h] << (kLimbBits * l);
            v.y += acc[mt][nt][2 * h + 1] << (kLimbBits * l);
            *dst2 = v;
          }
        }
    }
  }
}

}  // namespace gram_pk
