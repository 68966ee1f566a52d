// One 128 x 128 output block of a bf16 product on Hopper's bf16 tensor
// cores: the kernel sweep's dotonly and dotonly_T (block, unpacked
// operands, mma.sync, gram_sweep.cu), and packed_block over bit-packed ones
// (wgmma, the end of the file), the sweep's bf16 and bf16_ns and the bf16
// engine's packed Gram (gram_pk_bf16.cu):
//   out[r, c] (+)= sum over the K blocks of kt patterns of
//                  (uint32) trunc(f32 sum_{p in the block} a(r, p) * b(p, c))
// trunc toward zero, as tools/kernel_sweep.py body_dotonly and body_bf16
// cast each K grid step's f32 product to int32 and add it into C as uint32.
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
#include "wgmma_bf16.cuh"

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

// Lets `kernel`, a launcher of block() (or of packed_block(), with
// kPkSmemBytes), take `bytes` of dynamic shared memory.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes = kSmemBytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

constexpr int kMaxDevices = 64;  // devices whose attribute allow_smem_once remembers

// allow_smem(kKernel, bytes), once a device: each call costs host time
// (matmul_acc.cu's allow_smem_once; PERF.md: 0.07 -> 0.037 ms a call at a
// small shape).
template <auto kKernel>
cudaError_t allow_smem_once(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = allow_smem(kKernel, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
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

// The A fragments of a pattern-major row slab.  Matrices (rows lo, K lo),
// (rows hi, K lo), (rows lo, K hi), (rows hi, K hi): the A registers in
// mma's order.
struct PatternRowFrag {
  PatternFrag frag;
  int q0;  // the warp's first 8-sample chunk

  __device__ __forceinline__ PatternRowFrag() : frag(false), q0(8 * (threadIdx.x / 128)) {}

  // the A registers of the warp's m16 tile mt at K step ks
  __device__ __forceinline__ void read(uint32_t slab, int ks, int mt, uint32_t (&af)[4]) const {
    ldsm_x4_trans(frag.at(slab, ks, q0 + 2 * mt), af);
  }
};

// dotonly's row operand: pattern-major bf16 [P, ld] like b, the block's
// first row sample at `a`.
struct PatternRows : PatternRowFrag {
  PatternSlab copy;

  __device__ __forceinline__ PatternRows(const uint16_t* a, int64_t ld) : copy(a, ld) {}

  __device__ __forceinline__ void load(Stage& st, int64_t p0) const { copy(st.a, p0); }
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

// The accumulators of a thread: the K block's f32 sums and the run's
// uint32 ones, 64 each.
struct Sums {
  float part[4][4][4];
  uint32_t acc[4][4][4];

  __device__ __forceinline__ Sums() {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[mt][nt][e] = 0.0f;
          acc[mt][nt][e] = 0u;
        }
  }

  // the K block's end: its f32 sums join the uint32 ones, truncated and
  // shifted left by `shift` (8 l for weight limb l)
  __device__ __forceinline__ void flush(int shift = 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][nt][e] += static_cast<uint32_t>(__float2int_rz(part[mt][nt][e])) << shift;
          part[mt][nt][e] = 0.0f;
        }
  }

  // out (+)= the uint32 sums: d[2h], d[2h + 1] of tile (mt, nt) are row
  // 16 mt + g + 8h, columns 8 nt + 2t and 8 nt + 2t + 1 of the warp's 64 x 32
  __device__ __forceinline__ void write(uint32_t* __restrict__ out, int64_t ld_out,
                                        bool store) const {
    const int warp = threadIdx.x / 32;
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
};

// The product of one stage of kStage patterns, row slab at sa and column
// slab at sb (shared addresses): per K step of 16, 2 ldmatrix for the
// warp's columns, then for each of its 4 row tiles one ldmatrix and 4 mma.
template <class Rows>
__device__ __forceinline__ void stage_mma(uint32_t sa, uint32_t sb, const Rows& rows, Sums& sums) {
  const int q_b = 4 * (threadIdx.x / 32 % 4);  // the warp's first 8-sample column chunk
  // B: matrices (K lo, cols lo), (K hi, cols lo), (K lo, cols hi), (K hi,
  // cols hi): b[0], b[1] of n8 tile 2y, then of 2y + 1
  const PatternFrag bfrag(true);
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
      for (int nt = 0; nt < 4; ++nt) mma_bf16::m16n8k16(sums.part[mt][nt], af, bf[nt]);
    }
  }
}

// Called by all kThreads threads of the block, `smem` the kSmemBytes of
// dynamic shared memory (see the top of the file).
template <class Rows>
__device__ __forceinline__ void block(uint8_t* smem, const Rows& rows,
                                      const uint16_t* __restrict__ b, int64_t ld, int64_t p0,
                                      int n_st, int st_kt, uint32_t* __restrict__ out,
                                      int64_t ld_out, bool store) {
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const PatternSlab cols(b, ld);

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

  Sums sums;
  for (int i = 0; i < n_st; ++i) {
    gram_u8::cp_wait<kStages - 2>();  // this thread's copies of stage i have landed
    __syncthreads();                  // everyone's have; stage i - 1's readers are done
    const int nx = i + kStages - 1;
    if (nx < n_st) load(ring[nx % kStages], nx);
    gram_u8::cp_commit();

    const Stage& st = ring[i % kStages];
    stage_mma(gram_u8::smem_addr(st.a), gram_u8::smem_addr(st.b), rows, sums);
    if ((i + 1) % st_kt == 0) sums.flush();
  }
  sums.write(out, ld_out, store);
}

// ---------------------------------------------------------------------------
// Packed operands: the bf16 engine's Gram and the sweep's bf16
// (kWeighted), and the sweep's bf16_ns.
//   out[r, c] (+)= sum over the limbs l < n_limbs and the K blocks of
//                  trunc(f32 sum_p bit_a(p, r) * wv_l(p) * bit_b(p, c)) << 8 l
// mod 2^32, with wv_l(p) = (w[p] >> 8 l) & 0xFF for kWeighted and 1 for
// bf16_ns (n_limbs 1): kmerdb_tpu/ops/pallas_gram.py _gram_pk_body, whose
// bits of a weight above 8 n_limbs are dropped too.  a is uint8[P/8,
// ld_a] and b uint8[P/8, ld_b] (bit b of byte row r is pattern 8r + b; a
// the block's first row sample, b its first column sample, both 16-byte
// aligned, ld_a and ld_b multiples of 16: the cross Gram's U and V differ
// in width), w uint32[P] in pk_weight_order for kt = 128 st_kt (pattern
// 8r + b of K block k at k kt + b kt/8 + r % (kt/8)), 16-byte aligned.
// Every partial sum is an integer at most 255 kt, below 2^24 for kt below
// 65,793: exact in f32 in any order.
//
// Limbs.  The outer loop: limb l re-runs the whole stage loop, expanding
// the weights' byte l, and each K block's end adds trunc(part) << 8 l into
// the uint32 accumulators; the block is written once, after the last
// limb.  So a limb re-reads the packed slabs from L2, 4.5 KB a stage
// against the stage's 16 wgmma (2^24 bf16 flop), and the block keeps one
// set of f32 sums (64 registers a thread).
//
// Staging (packed_stages, which the sweep's nodot runs too).  A stage is
// 16 byte rows (128 patterns) of each operand, 2 KB, and for bf16 its 128
// weights, 512 bytes (16 consecutive words for each bit b at k kt + b kt/8
// + the stage's first byte row in the K block).  Threads copy them with
// one 16-byte cp.async each (and 32 threads one more for the weights)
// into a ring of kPkRing packed stages, kPkRing - 1 stages ahead.  Each
// stage is expanded once a block into bf16 operands in wgmma's canonical
// MN-major layout with the 128-byte swizzle (ExStage, wgmma_bf16.cuh):
// stage row k = 16 b + r holds bit b of byte row r, samples 0-63 in the
// first 16 KB half (kStage rows of 128 bytes) and 64-127 in the second,
// chunk c of a row at c ^ (k & 7).  Two expanded stages: stage i + 1's
// expansion runs while stage i's product does, with one barrier a stage.
// Thread (r, c) = (tid / 16, tid % 16) expands 8 samples of byte row r of
// both operands, bit plane b to row 16 b + r: per word of two samples a
// prmt spreads their bits to bits 0 and 16, and one multiply by the
// 16-bit bf16 pattern of the weight (bf16(w & 0xFF) is exact; 0x3F80 is
// 1.0) gives both bf16 values with no carry.  A quarter warp's 16-byte
// stores fall on the 8 distinct chunks of one 128-byte row.  The stores
// are generic and wgmma reads through the async proxy: each thread fences
// the proxies (fence.proxy.async) before the barrier that publishes them.
//
// Product (Product).  Warpgroup g (threads 128 g ..) owns output rows
// 64 g .. 64 g + 63: a stage is 8 wgmma m64n128k16, A the row operand's
// half g, B the whole column operand (its halves LBO = 16 KB apart), one
// commit, then the next stage's expansion while they run, then
// wait_group 0 before the barrier that hands the expanded stage back.  A
// third expanded stage (wait_group 1, the products running on across the
// barrier) fits in shared memory but was no faster, and neither was a
// deeper packed ring: the expansion, not the barrier, is what the stage
// waits on (PERF.md).  A K block's first wgmma has scale-d 0 (no zeroing
// pass); after its last stage's wait the f32 sums are truncated into the
// uint32 ones, by an add of 2^23 where 255 kt < 2^23 (cvt.rzi, on the
// conversion pipe, took 10% more time at the sweep's defaults).
//
// What bounds it.  bf16 multiply-adds on the tensor cores, fed from shared
// memory: a stage's 16 wgmma (1,024 clocks of the SM's tensor cores at the
// dense peak) read 96 KB (each warpgroup its 16 KB of A and all 32 KB of
// B), and the expansion stores 64 KB, ≈ 160 B a clock against the 128
// that shared memory delivers; the L2 reads are 4.5 KB a stage.
constexpr int kPkRows = kStage / 8;     // packed byte rows a stage
constexpr int kPkRing = 4;              // packed stages in the ring
constexpr int kExHalf = kStage * 128;   // bytes of 64 samples of a stage
constexpr int kExStep = 16 * 128;       // bytes of a K step's 16 rows
constexpr uint32_t kBf16One = 0x3F80u;

struct PackedStage {
  uint8_t a[kPkRows][kBlock];  // row operand's byte rows
  uint8_t b[kPkRows][kBlock];  // column operand's
  uint32_t w[kStage];          // weight of stage row 16 b + r
};

// An expanded stage: each operand kStage rows of kBlock bf16, two halves
// of 64 samples, 128-byte swizzle (above); 1,024-byte aligned for wgmma.
struct alignas(1024) ExStage {
  uint8_t a[kSlab];  // row operand
  uint8_t b[kSlab];  // column operand
};

struct PackedSmem {
  ExStage ex[2];              // expanded stages, 2 x 64 KB
  PackedStage ring[kPkRing];  // packed stages, 4 x 4.5 KB
};
// 149,504 bytes, and up to 1,024 to align them: 150,528 of the SM's 227 KB
constexpr int kPkSmemBytes = static_cast<int>(sizeof(PackedSmem)) + 1024;
static_assert(kThreads == 2 * kPkRows * kBlock / 16 && kThreads == kPkRows * 16,
              "a 16-byte copy of a packed stage and 8 samples of a byte row a thread");
static_assert(kStage == 8 * 16 && kBlock == 2 * 64,
              "8 K steps a stage; two 64-row warpgroups, two 64-sample halves");

// The byte of chunk c (samples 8c .. 8c + 7) of stage row k in an
// expanded operand.
__device__ __forceinline__ int ex_offset(int k, int c) {
  return (c / 8) * kExHalf + 128 * k + 16 * ((c & 7) ^ (k & 7));
}

// Bit plane `bit` of the 8 samples of `x` (one byte each) as 8 bf16 values
// wv or 0, stage row 16 bit + r, chunk c of `slab`.
__device__ __forceinline__ void expand8(uint8_t* slab, int r, int c, int bit, uint2 x,
                                        uint32_t wv) {
  const uint32_t lo = (x.x >> bit) & 0x01010101u;
  const uint32_t hi = (x.y >> bit) & 0x01010101u;
  // bytes (0, 1) and (2, 3) to bits 0 and 16: samples 2m, 2m + 1 of word m
  const uint4 v = make_uint4(__byte_perm(lo, 0u, 0x4140) * wv, __byte_perm(lo, 0u, 0x4342) * wv,
                             __byte_perm(hi, 0u, 0x4140) * wv, __byte_perm(hi, 0u, 0x4342) * wv);
  *reinterpret_cast<uint4*>(slab + ex_offset(16 * bit + r, c)) = v;
}

// The bf16 bit pattern of the integer w & 0xFF (exact: 8 significant bits);
// limb l passes w >> 8 l.
__device__ __forceinline__ uint32_t bf16_byte(uint32_t w) {
  return __float_as_uint(static_cast<float>(w & 0xFFu)) >> 16;
}

// A thread's share of expanding a packed stage: byte row r, samples 8c ..
// 8c + 7, of both operands, all 8 bit planes, with weight limb `shift` / 8.
template <bool kWeighted>
struct Expand {
  int r, c, shift;

  __device__ __forceinline__ explicit Expand(int shift)
      : r(threadIdx.x / 16), c(threadIdx.x % 16), shift(shift) {}

  __device__ __forceinline__ void operator()(const PackedStage& ps, ExStage& ex) const {
    const uint2 xa = *reinterpret_cast<const uint2*>(&ps.a[r][8 * c]);
    const uint2 xb = *reinterpret_cast<const uint2*>(&ps.b[r][8 * c]);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      expand8(ex.a, r, c, bit, xa,
              kWeighted ? bf16_byte(ps.w[16 * bit + r] >> shift) : kBf16One);
      expand8(ex.b, r, c, bit, xb, kBf16One);
    }
  }
};

// The accumulators of a thread in wgmma's layout (wgmma_bf16.cuh): the K
// block's f32 sums and the run's uint32 ones, 64 each; warpgroup g holds
// rows 64 g ...
struct WgSums {
  float part[64];
  uint32_t acc[64];

  __device__ __forceinline__ WgSums() {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      part[i] = 0.0f;
      acc[i] = 0u;
    }
  }

  // the block row of acc[4j + 2h + e]
  static __device__ __forceinline__ int row(int h) {
    return 64 * (threadIdx.x / 128) + 16 * (threadIdx.x / 32 % 4) + threadIdx.x % 32 / 4 + 8 * h;
  }

  // the block column of acc[4j + 2h]
  static __device__ __forceinline__ int col(int j) { return 8 * j + 2 * (threadIdx.x % 4); }

  // the K block's end: its f32 sums join the uint32 ones, truncated and
  // shifted left by `shift` (8 l for weight limb l); the next K block's
  // first wgmma overwrites part.  A sum is a non-negative integer; below
  // 2^23 (`small`) it is the bits of sum + 2^23 less those of 2^23, an add
  // a value on the FMA pipe where cvt.rzi takes the 4x slower conversion
  // pipe
  __device__ __forceinline__ void flush(int shift, bool small) {
    if (small) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] += (__float_as_uint(__fadd_rn(part[i], 8388608.0f)) - 0x4B000000u) << shift;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        acc[i] += static_cast<uint32_t>(__float2int_rz(part[i])) << shift;
    }
  }

  // out (+)= the uint32 sums
  __device__ __forceinline__ void write(uint32_t* __restrict__ out, int64_t ld_out,
                                        bool store) const {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint2* dst = reinterpret_cast<uint2*>(out + row(h) * ld_out + col(j));
        uint2 v = make_uint2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (!store) {
          const uint2 o = *dst;
          v = make_uint2(v.x + o.x, v.y + o.y);
        }
        *dst = v;
      }
  }
};

// packed_block's body: the stage's product on wgmma into sums.
struct Product {
  WgSums sums;
  uint32_t a_half;  // the warpgroup's half of the row operand, in bytes
  bool small;       // every K block's sum below 2^23: 255 kt < 2^23

  __device__ __forceinline__ explicit Product(int st_kt)
      : a_half(kExHalf * (threadIdx.x / 128)), small(255 * kStage * st_kt < (1 << 23)) {}

  // starts the product of `ex`, a K block's first stage if kb_stage is 0
  __device__ __forceinline__ void start(const ExStage& ex, int kb_stage) {
    const uint64_t da = wgmma_bf16::desc_sw128(gram_u8::smem_addr(ex.a) + a_half, kExHalf, 1024);
    const uint64_t db = wgmma_bf16::desc_sw128(gram_u8::smem_addr(ex.b), kExHalf, 1024);
    wgmma_bf16::fence_operands(sums.part);
    wgmma_bf16::fence();
#pragma unroll
    for (int ks = 0; ks < kStage / 16; ++ks)  // the address field counts 16-byte units
      wgmma_bf16::m64n128k16(sums.part, da + ks * (kExStep >> 4), db + ks * (kExStep >> 4),
                             ks > 0 || kb_stage > 0);
    wgmma_bf16::commit();
  }

  // after the next stage's expansion: this stage's products done before
  // the barrier that hands their expanded stage to the expansion after
  // next, and at a K block's end the flush
  __device__ __forceinline__ void retire(bool kb_end, int shift) {
    wgmma_bf16::wait<0>();
    if (kb_end) {
      wgmma_bf16::fence_operands(sums.part);
      sums.flush(shift, small);
    }
  }
};

// Called by all kThreads threads of the block, `smem` the kPkSmemBytes of
// dynamic shared memory; the run of n_st stages from pattern p0, whole K
// blocks of st_kt stages (p0 a multiple of 128 st_kt), for weight limbs 0
// .. n_limbs - 1.  Stage i, stage j of its K block, goes to
// body.start(ex, j); then stage i + 1 is expanded, and
// body.retire(j == st_kt - 1, 8 l) returns with the product of stage i
// done.
template <bool kWeighted, class Body>
__device__ __forceinline__ void packed_stages(uint8_t* smem, const uint8_t* __restrict__ a,
                                              int64_t ld_a, const uint8_t* __restrict__ b,
                                              int64_t ld_b, const uint32_t* __restrict__ w,
                                              int64_t p0, int n_st, int st_kt, int n_limbs,
                                              Body& body) {
  PackedSmem& sm = *reinterpret_cast<PackedSmem*>(
      smem + ((1024u - (gram_u8::smem_addr(smem) & 1023u)) & 1023u));
  const int tid = threadIdx.x;
  // copy: threads 0-127 the row operand's 16 x 8 chunks, 128-255 the
  // column operand's; threads 0-31 also 4 weights of bit tid / 4
  const int cr = tid % kBlock / 8;
  const int cc = tid % 8;
  const int64_t ld = tid < kBlock ? ld_a : ld_b;
  const uint8_t* src = (tid < kBlock ? a : b) + cr * ld + 16 * cc;
  const int64_t kb = 16 * st_kt;  // byte rows a K block
  auto load = [&](PackedStage& ps, int i) {
    const int64_t row = p0 / 8 + static_cast<int64_t>(kPkRows) * i;
    gram_u8::cp16((tid < kBlock ? ps.a[cr] : ps.b[cr]) + 16 * cc, src + row * ld);
    if (kWeighted && tid < kStage / 4) {
      // stage i is stage j of its K block, which starts at pattern
      // p0 + 128 (i - j)
      const int j = i % st_kt;
      const int bit = tid / 4;
      gram_u8::cp16(&ps.w[4 * tid], w + p0 + static_cast<int64_t>(kStage) * (i - j) + bit * kb +
                                        kPkRows * j + 4 * (tid % 4));
    }
  };

  // The limbs are the outer loop: each runs the whole staging pipeline
  // again.  Limb l's ring and expanded stages are first written after
  // limb l - 1's last barrier, which every reader of them has passed.
  for (int l = 0; l < n_limbs; ++l) {
#pragma unroll
    for (int s = 0; s < kPkRing; ++s) {
      if (s < n_st) load(sm.ring[s], s);
      gram_u8::cp_commit();
    }

    const Expand<kWeighted> expand(8 * l);
    gram_u8::cp_wait<kPkRing - 1>();  // stage 0 has landed
    __syncthreads();
    expand(sm.ring[0], sm.ex[0]);

    int j = 0;  // stage i's place in its K block
    for (int i = 0; i < n_st; ++i) {
      gram_u8::cp_wait<kPkRing - 2>();  // this thread's copies of stage i + 1 have landed
      wgmma_bf16::fence_proxy_async();  // its expansion of stage i is visible to wgmma
      // everyone's have; stage i's expansion is written; stage i - 1's
      // product (the reader of ex[(i + 1) % 2]) and stage i's expansion
      // (the last reader of ring[i % kPkRing]) are done
      __syncthreads();
      const int nx = i + kPkRing;
      if (nx < n_st) load(sm.ring[nx % kPkRing], nx);
      gram_u8::cp_commit();

      body.start(sm.ex[i % 2], j);
      if (i + 1 < n_st) expand(sm.ring[(i + 1) % kPkRing], sm.ex[(i + 1) % 2]);
      const bool kb_end = ++j == st_kt;
      body.retire(kb_end, 8 * l);
      if (kb_end) j = 0;
    }
  }
}

// The packed Gram of the run (packed_stages' arguments) on wgmma; `store`
// as block().
template <bool kWeighted>
__device__ __forceinline__ void packed_block(uint8_t* smem, const uint8_t* __restrict__ a,
                                             int64_t ld_a, const uint8_t* __restrict__ b,
                                             int64_t ld_b, const uint32_t* __restrict__ w,
                                             int64_t p0, int n_st, int st_kt, int n_limbs,
                                             uint32_t* __restrict__ out, int64_t ld_out,
                                             bool store) {
  Product prod(st_kt);
  packed_stages<kWeighted>(smem, a, ld_a, b, ld_b, w, p0, n_st, st_kt, n_limbs, prod);
  prod.sums.write(out, ld_out, store);
}

}  // namespace gram_bf16
