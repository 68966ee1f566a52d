// One 128 x 128 output block of an unpacked bf16 product on Hopper's bf16
// tensor cores, the kernel sweep's dotonly and dotonly_T (gram_sweep.cu):
//   out[r, c] (+)= sum over the K blocks of kt patterns of
//                  (uint32) trunc(f32 sum_{p in the block} a(r, p) * b(p, c))
// trunc toward zero, as tools/kernel_sweep.py body_dotonly casts each K
// grid step's f32 product to int32 and adds it into C as uint32.
//
// The column operand keeps the JAX package's layout:
//   b     bf16 [P, ld] pattern-major, the block's first sample column,
//         16-byte aligned, ld a multiple of 8;
//   out   uint32, the block's first cell, rows `ld_out` apart, 8-byte
//         aligned, ld_out even.
// The row operand is a policy (below): PatternRows, pattern-major like b
// (dotonly's Bi [P, S]), or SampleRows, sample-major with K contiguous
// (dotonly_T's Bi [S, P]).  A block takes the run of n_st stages from
// pattern p0, whole K blocks of st_kt stages each; `store` writes out,
// otherwise the run's sum is added to it.
//
// Stage.  kStage patterns at a time: each operand's 32 KB slab copied with
// 16-byte cp.async into a ring of kStages stages in dynamic shared memory,
// one barrier a stage, the copy kStages - 1 stages ahead.  A stage of 128
// patterns took 1.8125 ms at the sweep's defaults where 64 (in a ring of
// 4) took 2.0316: half the barriers (tools/gram_bf16_rate.py, PERF.md).  A slab row's
// 16-byte chunk c sits at c ^ (row & 7), so the eight rows that one
// ldmatrix matrix reads (eight consecutive rows) fall on eight distinct
// chunks of a 128-byte line: no bank conflict.
//
// Fragments.  mma.sync m16n8k16 (mma_bf16.cuh) wants A row-major (a row's
// K pairs in a register) and B column-major (a column's K pairs).  bf16
// values are 16-bit, so ldmatrix transposes them itself:
//   b            pattern-major: ldmatrix.x4.trans hands a lane the pair of
//                patterns (2t, 2t + 1) at sample g of an 8 x 8 matrix, the
//                B fragment of two n8 tiles a load;
//   PatternRows  the same load gives the A fragment of one m16 tile;
//   SampleRows   already K-contiguous: ldmatrix.x4 without .trans.
// A warp owns 64 x 32 outputs, 4 x 4 tiles of 16 x 8: a K step of 16
// patterns takes 2 ldmatrix for its columns, then for each of its 4 row
// tiles one ldmatrix and 4 mma.
//
// Accumulators.  The mma sums each K block in f32 registers (64 a
// thread).  At every K block's end each is truncated to an integer
// (cvt.rzi), added into a uint32 register (64 a thread) and zeroed, so a
// block's f32 sum never crosses a K block: kt is a multiple of 128
// (ops/sweep.py), so a stage never straddles one.  The truncation is part
// of the function: on half-integer operands it differs from one truncation
// of the whole sum.  The f32 sum is exact, in any order, while every
// partial sum is an integer below 2^24 (0/1 operands) or a multiple of
// 1/4 below 2^22 (half-integer ones); the plain version (ops/sweep.plain)
// equals the kernel there.
//
// What bounds it.  bf16 multiply-adds: S flop a byte of an operand read
// once, far above the card's 295 flop a byte at the sweep's S of 2,048.  A
// block reads its two 128-wide slabs from device memory (L2) once, 64 flop
// a byte of L2; every operand of the product sits in shared memory and
// registers, 6 ldmatrix to 16 mma a warp and K step.  The 128 accumulators hold a thread above
// 128 registers, so one block of 8 warps runs on an SM
// (__launch_bounds__(kThreads, kMinBlocks)), with 192 KB of shared memory;
// a wider block (128 x 256) would double the accumulators a thread, which
// the register file cannot hold.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "gram_u8.cuh"
#include "mma_bf16.cuh"

namespace gram_bf16 {

constexpr int kBlock = 128;    // output block edge
constexpr int kStage = 128;    // patterns a stage: 8 K steps of 16
constexpr int kStages = 3;     // stages in the ring
constexpr int kThreads = 256;  // 8 warps of 64 x 32 outputs
constexpr int kMinBlocks = 1;  // 128 accumulators a thread: one block an SM
constexpr int kSlab = kStage * kBlock * 2;  // bytes of an operand's stage
constexpr int kPasses = kStage / 16;         // a pattern slab's copy: 16 rows a pass
constexpr int kChunks = kStage / 8;          // 16-byte chunks of a sample row
constexpr int kRowPass = kThreads / kChunks; // a sample slab's copy: rows a pass
static_assert(kStage % 64 == 0 && 128 % kStage == 0,
              "whole K steps of 16 in a stage, and a stage inside a K block of 128");
static_assert(kThreads == 16 * 16 && kRowPass % 8 == 0 && kBlock % kRowPass == 0,
              "16 chunks of 16 pattern rows a pass; sample rows keep their key over passes");

struct Stage {
  uint8_t a[kSlab];  // row slab, in the row policy's layout
  uint8_t b[kSlab];  // column slab: kStage pattern rows of 256 bytes
};
// 196,608 bytes of the SM's 227 KB
constexpr int kSmemBytes = kStages * static_cast<int>(sizeof(Stage));

// Lets `kernel`, a launcher of block(), take kSmemBytes of dynamic shared
// memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Four 8 x 8 matrices of 16-bit values: lane i hands the address of row
// i % 8 of matrix i / 8 and receives register j of matrix j.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A thread's share of copying a pattern-major slab: kStage pattern rows of
// kBlock bf16 (256 bytes, 16 chunks), rows `ld` values apart from `base`.
// Thread copies chunk c = tid % 16 of rows k = tid / 16 + 16 it, it <
// kPasses, to chunk c ^ (k & 7), which 16 it leaves alone.
struct PatternSlab {
  const uint8_t* src;  // the thread's first chunk, pattern 0
  int64_t ld;          // bytes between pattern rows
  int dst;             // its byte in the slab, it = 0

  __device__ __forceinline__ PatternSlab(const uint16_t* base, int64_t ld_values)
      : ld(2 * ld_values) {
    const int k = threadIdx.x / 16;
    const int c = threadIdx.x % 16;
    src = reinterpret_cast<const uint8_t*>(base) + k * ld + 16 * c;
    dst = 2 * kBlock * k + 16 * (c ^ (k & 7));
  }

  // patterns p0 .. p0 + kStage - 1
  __device__ __forceinline__ void operator()(uint8_t* slab, int64_t p0) const {
    const uint8_t* s = src + p0 * ld;
#pragma unroll
    for (int it = 0; it < kPasses; ++it)
      gram_u8::cp16(slab + dst + 16 * 2 * kBlock * it, s + 16 * it * ld);
  }
};

// A lane's ldmatrix row in a pattern-major slab, for the 16 x 16 block of
// K step ks (patterns 16 ks ..) and samples 8 q .. 8 q + 15 (q even).
// Matrix j = lane / 8 takes its K half from bit 0 of j (k_in_low_bit) or
// bit 1, and its sample half from the other bit; lane row r = lane % 8 is
// pattern 16 ks + r + 8 khalf, whose key is r.
struct PatternFrag {
  uint32_t row;  // the lane's pattern row, in bytes, at ks = 0
  uint32_t key;  // 16 * (sample half ^ r): its chunk is key ^ 16 q

  __device__ __forceinline__ explicit PatternFrag(bool k_in_low_bit) {
    const int lane = threadIdx.x % 32;
    const int j = lane / 8;
    const int r = lane % 8;
    const int khalf = k_in_low_bit ? j % 2 : j / 2;
    const int shalf = k_in_low_bit ? j / 2 : j % 2;
    row = static_cast<uint32_t>(2 * kBlock * (r + 8 * khalf));
    key = static_cast<uint32_t>(16 * (shalf ^ r));
  }

  __device__ __forceinline__ uint32_t at(uint32_t slab, int ks, int q) const {
    return slab + row + 16 * 2 * kBlock * ks + (key ^ static_cast<uint32_t>(16 * q));
  }
};

// dotonly's row operand: pattern-major bf16 [P, ld] like b, the block's
// first row sample at `a`.  Matrices (rows lo, K lo), (rows hi, K lo),
// (rows lo, K hi), (rows hi, K hi): the A registers in mma's order.
struct PatternRows {
  PatternSlab copy;
  PatternFrag frag;
  int q0;  // the warp's first 8-sample chunk

  __device__ __forceinline__ PatternRows(const uint16_t* a, int64_t ld)
      : copy(a, ld), frag(false), q0(8 * (threadIdx.x / 128)) {}

  __device__ __forceinline__ void load(Stage& st, int64_t p0) const { copy(st.a, p0); }

  // the A registers of the warp's m16 tile mt at K step ks
  __device__ __forceinline__ void read(uint32_t slab, int ks, int mt, uint32_t (&af)[4]) const {
    ldsm_x4_trans(frag.at(slab, ks, q0 + 2 * mt), af);
  }
};

// dotonly_T's row operand: sample-major bf16 [rows, ld], K contiguous, the
// block's first row at `a`.  Stage row r holds sample r's kStage values
// (kChunks chunks), chunk c at c ^ (r & 7); thread copies chunk c = tid %
// kChunks of rows r = tid / kChunks + kRowPass it.  ldmatrix without .trans: lane row
// i % 8 of matrix j = i / 8 is sample 64 wm + 16 mt + i % 8 + 8 (j % 2),
// its 8 values from chunk 2 ks + j / 2.
struct SampleRows {
  const uint8_t* src;  // the thread's first chunk, pattern 0
  int64_t ld;          // bytes between sample rows
  int dst;             // its byte in the slab, it = 0
  uint32_t row;        // the lane's ldmatrix row, in bytes, at mt = 0
  uint32_t key;        // 16 * (j / 2 ^ i % 8): its chunk is key ^ 32 ks

  __device__ __forceinline__ SampleRows(const uint16_t* a, int64_t ld_values)
      : ld(2 * ld_values) {
    const int r = threadIdx.x / kChunks;
    const int c = threadIdx.x % kChunks;
    src = reinterpret_cast<const uint8_t*>(a) + r * ld + 16 * c;
    dst = 2 * kStage * r + 16 * (c ^ (r & 7));
    const int lane = threadIdx.x % 32;
    const int j = lane / 8;
    row = static_cast<uint32_t>(2 * kStage * (64 * (threadIdx.x / 128) + lane % 8 + 8 * (j % 2)));
    key = static_cast<uint32_t>(16 * ((j / 2) ^ (lane % 8)));
  }

  __device__ __forceinline__ void load(Stage& st, int64_t p0) const {
    const uint8_t* s = src + 2 * p0;
#pragma unroll
    for (int it = 0; it < kBlock / kRowPass; ++it)
      gram_u8::cp16(st.a + dst + kRowPass * 2 * kStage * it, s + kRowPass * it * ld);
  }

  __device__ __forceinline__ void read(uint32_t slab, int ks, int mt, uint32_t (&af)[4]) const {
    ldsm_x4(slab + row + 16 * 2 * kStage * mt + (key ^ static_cast<uint32_t>(32 * ks)), af);
  }
};

// Called by all kThreads threads of the block, `smem` the kSmemBytes of
// dynamic shared memory (see the top of the file).
template <class Rows>
__device__ __forceinline__ void block(uint8_t* smem, const Rows& rows,
                                      const uint16_t* __restrict__ b, int64_t ld, int64_t p0,
                                      int n_st, int st_kt, uint32_t* __restrict__ out,
                                      int64_t ld_out, bool store) {
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int warp = threadIdx.x / 32;
  const int q_b = 4 * (warp % 4);  // the warp's first 8-sample column chunk
  const PatternSlab cols(b, ld);
  // B: matrices (K lo, cols lo), (K hi, cols lo), (K lo, cols hi), (K hi,
  // cols hi): b[0], b[1] of n8 tile 2y, then of 2y + 1
  const PatternFrag bfrag(true);

  auto load = [&](Stage& st, int i) {
    const int64_t p = p0 + static_cast<int64_t>(i) * kStage;
    rows.load(st, p);
    cols(st.b, p);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) load(ring[s], s);
    gram_u8::cp_commit();
  }

  float part[4][4][4];
  uint32_t acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[mt][nt][e] = 0.0f;
        acc[mt][nt][e] = 0u;
      }

  for (int i = 0; i < n_st; ++i) {
    gram_u8::cp_wait<kStages - 2>();  // this thread's copies of stage i have landed
    __syncthreads();                  // everyone's have; stage i - 1's readers are done
    const int nx = i + kStages - 1;
    if (nx < n_st) load(ring[nx % kStages], nx);
    gram_u8::cp_commit();

    const Stage& st = ring[i % kStages];
    const uint32_t sa = gram_u8::smem_addr(st.a);
    const uint32_t sb = gram_u8::smem_addr(st.b);
#pragma unroll
    for (int ks = 0; ks < kStage / 16; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        uint32_t r[4];
        ldsm_x4_trans(bfrag.at(sb, ks, q_b + 2 * y), r);
        bf[2 * y][0] = r[0];
        bf[2 * y][1] = r[1];
        bf[2 * y + 1][0] = r[2];
        bf[2 * y + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        rows.read(sa, ks, mt, af);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16::m16n8k16(part[mt][nt], af, bf[nt]);
      }
    }

    if ((i + 1) % st_kt == 0) {
      // the K block's end: its f32 sums join the uint32 ones, truncated
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += static_cast<uint32_t>(__float2int_rz(part[mt][nt][e]));
            part[mt][nt][e] = 0.0f;
          }
    }
  }

  // d[2h], d[2h + 1] of tile (mt, nt) are row 16 mt + g + 8h, columns
  // 8 nt + 2t and 8 nt + 2t + 1 of the warp's 64 x 32
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint2* dst = reinterpret_cast<uint2*>(
            out + (64 * (warp / 4) + 16 * mt + g + 8 * h) * ld_out + 32 * (warp % 4) + 8 * nt +
            2 * t);
        uint2 v = make_uint2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        if (!store) {
          const uint2 o = *dst;
          v = make_uint2(v.x + o.x, v.y + o.y);
        }
        *dst = v;
      }
}

}  // namespace gram_bf16
