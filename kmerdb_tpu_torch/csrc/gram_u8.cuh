// One 128 x 128 output block of the unpacked two-operand Gram on Hopper's
// int8 tensor cores, shared by gram_u32.cu (gram_u32, the full grid, and
// gram_u32_tri, the lower triangle) and the sweep's dotonly_s8
// (gram_sweep.cu):
//   out[r, c] (+)= sum_p a(p, r) * wl(p) * b(p, c)
//
// The operands keep the JAX package's layout (kmerdb_tpu/ops/pallas_gram.py
// gram_u32, tools/kernel_sweep.py body_dotonly):
//   a, b  int8 [P, ld] pattern-major, the block's first sample column of
//         each (a: the block's rows, b: its columns; gram_u32 passes one
//         operand twice), 16-byte aligned, ld a multiple of 16;
//   w     (kWeighted) uint32[P]: limb l of pattern p is (w[p] >> 8l) & 0xFF;
//   out   uint32, the block's first cell, rows `ld_out` apart, 16-byte
//         aligned, ld_out a multiple of 4.
// P is a multiple of kStage.  Two forms:
//   kWeighted  gram_u32: a and b bytes 0 or 1, read as .u8; n_limbs 8-bit
//              limbs; the first flush of limb 0 writes out, the rest add;
//   otherwise  dotonly_s8: any int8, read as .s8, no weights, every flush
//              adds to out.
//
// Stage.  kStage patterns at a time: the 128 bytes of each of the block's
// two column slabs in every pattern row, and the patterns' weights, copied
// with 16-byte cp.async into a ring of kStages stages in dynamic shared
// memory, one barrier a stage (the copy kStages - 1 stages ahead).  Nothing
// is transposed or masked while staging.  A row's 32-byte segment s is
// stored at s ^ ((k >> 2) & 3), k the pattern's row in the stage, so that
// the fragment reads below fall on 32 distinct banks.
//
// Fragments.  mma.sync (mma_s8.cuh, m16n8k32) wants K contiguous: four
// consecutive patterns of one sample in a register, where the operands
// hold four consecutive samples of one pattern.  Lane (g, t) reads a 4 x 4
// byte block, patterns 4t .. 4t + 3 of the K half x samples 4g .. 4g + 3 of
// a 32-sample window (four 32-bit loads), and transposes it with eight
// __byte_perm: four registers of K-contiguous patterns, one a sample.  The
// order of the samples inside a tile is free as long as the epilogue puts
// each accumulator at its own sample, so the four registers serve several
// tiles: in the column window, sample 4g + i is column g of n8 tile i; in
// row window wi, samples 4g + 2x and 4g + 2x + 1 are rows g and g + 8 of
// m16 tile 2 wi + x.  A warp owns 64 x 32 outputs, 4 x 4 tiles of 16 x 8:
// a K step of 32 patterns takes two reads of its column window, then for
// each of its two row windows two reads and 8 mma (8 A registers live, not
// 16).  Lane (g, t) then holds rows 4g .. 4g + 3 and 32 + 4g .. 32 + 4g + 3
// of the warp's rows and the 8 consecutive columns 8t .. 8t + 7, two
// 16-byte stores a row.
//
// Weights.  gram_u32's limb bytes ride on the column operand, 8 words a K
// step against the row operand's 16: a 0/1 byte word times the limb byte
// (0..255) of its pattern is the word of products, with no carry between
// bytes.  The weights are staged raw beside the rows; __byte_perm picks
// limb l.  .u8 keeps limb bytes 128..255 positive (as .s8 they would be
// negative).
//
// Range.  Limbs are the outer loop (one accumulator set; the operands are
// re-read per limb).  An s32 sum joins out in uint32 arithmetic, which
// wraps mod 2^32 like the reference's num_kmers_t, at least every `flush`
// patterns, chosen by the caller so that no sum inside the mma passes
// 2^31: 2^23 for gram_u32 (255 * 2^23 < 2^31), 2^16 for dotonly_s8 (128 *
// 128 * 2^16 = 2^30).  Each flush's sum is exact, so the result is the
// same at any flush interval; as `limb sum << 8l` the flushes of limb l
// give C mod 2^32.
//
// What bounds it.  Integer multiply-adds: far above the card's
// operations-per-byte balance.  The slabs are re-read from device memory
// (L2) once per output block and limb; every operand of the product sits
// in shared memory and registers.  Besides the 16 mma, a warp's K step
// issues 24 shared loads, 48 __byte_perm and (kWeighted) 8 multiplies.
// The block takes kSmemBytes of dynamic shared memory and at most 128
// registers a thread (__launch_bounds__(kThreads, kMinBlocks)), so two
// blocks share an SM.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace gram_u8 {

constexpr int kBlock = 128;    // output block edge
constexpr int kStage = 128;    // patterns a stage
constexpr int kStages = 3;     // stages in the ring
constexpr int kThreads = 256;  // 8 warps of 64 x 32 outputs
constexpr int kMinBlocks = 2;  // blocks an SM holds: <= 128 registers
constexpr int64_t kFlushU8 = int64_t{1} << 23;  // gram_u32: 255 * 2^23 < 2^31
constexpr int64_t kFlushS8 = int64_t{1} << 16;  // dotonly_s8: 2^14 * 2^16 = 2^30

struct Stage {
  uint8_t a[kStage][kBlock];  // row slab, segments swizzled
  uint8_t b[kStage][kBlock];  // column slab, segments swizzled
  uint32_t w[kStage];         // raw weights (kWeighted)
};
// 99,840 bytes: two blocks fit the SM's 228 KB
constexpr int kSmemBytes = kStages * static_cast<int>(sizeof(Stage));

// Lets `kernel`, a launcher of block(), take kSmemBytes of dynamic shared
// memory with the SM's largest carveout, so that two blocks share an SM.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's share of the staging: 16-byte chunk c = tid % 8 of pattern
// rows k = tid / 8 + 32 it, it = 0..3, of both slabs, at chunk
// c ^ (((k >> 2) & 3) << 1) of the stage's row (its 32-byte segment XOR-ed
// with bits 2-3 of k, which do not depend on it); threads 0..31 also copy
// four weights each.
struct Stager {
  const uint8_t* a;  // the thread's first chunk of the row slab, pattern 0
  const uint8_t* b;  // the same of the column slab
  int64_t ld;
  int dst;           // its byte in a stage's slab, it = 0

  __device__ __forceinline__ Stager(const uint8_t* a0, const uint8_t* b0, int64_t ld_) : ld(ld_) {
    const int k = threadIdx.x / 8;
    const int c = threadIdx.x % 8;
    a = a0 + k * ld + 16 * c;
    b = b0 + k * ld + 16 * c;
    dst = k * kBlock + 16 * (c ^ (((k >> 2) & 3) << 1));
  }

  template <bool kWeighted>
  __device__ __forceinline__ void load(Stage& st, const uint32_t* __restrict__ w, int64_t p0) const {
#pragma unroll
    for (int it = 0; it < kStage / 32; ++it) {
      const int64_t src = (p0 + 32 * it) * ld;
      cp16(&st.a[0][0] + dst + 32 * it * kBlock, a + src);
      cp16(&st.b[0][0] + dst + 32 * it * kBlock, b + src);
    }
    if (kWeighted && threadIdx.x < kStage / 4) cp16(&st.w[4 * threadIdx.x], w + p0 + 4 * threadIdx.x);
  }
};
static_assert(kThreads == 8 * 32, "a stage is 32 rows of 8 chunks a slab per pass");

// o[i] = byte i of r[0..3] (the lowest from r[0]): the 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The word of patterns k .. k + 3 (k a multiple of 4) at each of the four
// samples of one 4-byte column `off` of a slab.
__device__ __forceinline__ void read4x4(const uint8_t (*slab)[kBlock], int k, int off,
                                        uint32_t (&o)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = *reinterpret_cast<const uint32_t*>(&slab[k + j][off]);
  transpose4(r, o);
}

// The same, each pattern's 0/1 bytes times its limb byte (0..255): no carry.
__device__ __forceinline__ void read4x4_weighted(const uint8_t (*slab)[kBlock], int k, int off,
                                                 uint4 wk, uint32_t sel, uint32_t (&o)[4]) {
  const uint32_t wv[4] = {wk.x, wk.y, wk.z, wk.w};
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r[j] = *reinterpret_cast<const uint32_t*>(&slab[k + j][off]) * __byte_perm(wv[j], 0u, sel);
  transpose4(r, o);
}

// out (+)= acc << shift over the warp's 64 x 32 outputs.
__device__ __forceinline__ void flush(uint32_t (&acc)[4][4][4], uint32_t* __restrict__ out,
                                      int64_t ld_out, int shift, bool store) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // row g (h = 0) or g + 8 (h = 1) of m16 tile mt = 2 wi + x is sample
      // 32 wi + 4g + 2x + h; d[2h] is column 2t of n8 tile nt (sample
      // 8t + nt), d[2h + 1] column 2t + 1 (8t + 4 + nt)
      uint4* dst = reinterpret_cast<uint4*>(
          out + (64 * (warp / 4) + 32 * (mt / 2) + 4 * g + 2 * (mt % 2) + h) * ld_out +
          32 * (warp % 4) + 8 * t);
      uint4 lo = make_uint4(acc[mt][0][2 * h] << shift, acc[mt][1][2 * h] << shift,
                            acc[mt][2][2 * h] << shift, acc[mt][3][2 * h] << shift);
      uint4 hi = make_uint4(acc[mt][0][2 * h + 1] << shift, acc[mt][1][2 * h + 1] << shift,
                            acc[mt][2][2 * h + 1] << shift, acc[mt][3][2 * h + 1] << shift);
      if (!store) {
        const uint4 o0 = dst[0];
        const uint4 o1 = dst[1];
        lo = make_uint4(lo.x + o0.x, lo.y + o0.y, lo.z + o0.z, lo.w + o0.w);
        hi = make_uint4(hi.x + o1.x, hi.y + o1.y, hi.z + o1.z, hi.w + o1.w);
      }
      dst[0] = lo;
      dst[1] = hi;
    }
}

// Called by all kThreads threads of the block, `smem` the kSmemBytes of
// dynamic shared memory.  p patterns, a multiple of kStage; `flush_p` a
// multiple of kStage.
template <bool kWeighted>
__device__ __forceinline__ void block(uint8_t* smem, const uint8_t* __restrict__ a,
                                      const uint8_t* __restrict__ b, int64_t ld,
                                      const uint32_t* __restrict__ w, int64_t p, int n_limbs,
                                      int64_t flush_p, uint32_t* __restrict__ out,
                                      int64_t ld_out) {
  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  // the lane's byte in a row of its windows: rows 4t + j of a K half have
  // (k >> 2) & 3 == t, so segment s sits at s ^ t
  const int off_a[2] = {32 * ((2 * (warp / 4)) ^ t) + 4 * g,
                        32 * ((2 * (warp / 4) + 1) ^ t) + 4 * g};
  const int off_b = 32 * ((warp % 4) ^ t) + 4 * g;

  const Stager stager(a, b, ld);
  const int n_st = static_cast<int>(p / kStage);  // stages a limb
  const int flush_st = static_cast<int>(flush_p / kStage);
  const int total = n_st * (kWeighted ? n_limbs : 1);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) stager.load<kWeighted>(ring[s], w, static_cast<int64_t>(s % n_st) * kStage);
    cp_commit();
  }

  uint32_t acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0u;

  for (int i = 0; i < total; ++i) {
    cp_wait<kStages - 2>();  // this thread's copies of stage i have landed
    __syncthreads();         // everyone's have; stage i - 1's readers are done
    const int nx = i + kStages - 1;
    if (nx < total)
      stager.load<kWeighted>(ring[nx % kStages], w, static_cast<int64_t>(nx % n_st) * kStage);
    cp_commit();

    const Stage& st = ring[i % kStages];
    const int l = i / n_st;
    const uint32_t sel = 0x4440u | static_cast<uint32_t>(l);  // byte l, zero above
#pragma unroll
    for (int ks = 0; ks < kStage / 32; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int k = 32 * ks + 16 * kh + 4 * t;
        uint32_t o[4];
        if constexpr (kWeighted) {
          read4x4_weighted(st.b, k, off_b, *reinterpret_cast<const uint4*>(&st.w[k]), sel, o);
        } else {
          read4x4(st.b, k, off_b, o);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) bf[nt][kh] = o[nt];
      }
      // window wi's samples 4g + 2x and 4g + 2x + 1 are rows g and g + 8
      // of m16 tile 2 wi + x
#pragma unroll
      for (int wi = 0; wi < 2; ++wi) {
        uint32_t af[2][4];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          uint32_t o[4];
          read4x4(st.a, 32 * ks + 16 * kh + 4 * t, off_a[wi], o);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            af[x][2 * kh] = o[2 * x];
            af[x][2 * kh + 1] = o[2 * x + 1];
          }
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_s8::m16n8k32<kWeighted>(acc[2 * wi + x][nt], af[x], bf[nt]);
      }
    }

    const int si = i % n_st + 1;  // stages of this limb done
    if (si % flush_st == 0 || si == n_st) {
      // kWeighted writes C fresh: the first flush of limb 0 stores
      flush(acc, out, ld_out, 8 * l, kWeighted && l == 0 && si <= flush_st);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0u;
    }
  }
}

}  // namespace gram_u8
