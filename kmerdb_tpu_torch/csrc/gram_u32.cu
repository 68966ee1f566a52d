// Unpacked Gram for Hopper: C = B^T diag(w) B, exact mod 2^32, written fresh.
//
// Replaces gram_u32 (_gram_tile_kernel, the full grid) and gram_u32_tri
// (_gram_tile_tri_kernel, tiles i >= j) of kmerdb_tpu/ops/pallas_gram.py: the
// chunk product of the all2all scan tier (KMERDB_A2A_PALLAS=0), which adds each
// chunk's C into a running sum.
//   b  int8 [p_pad, s_pad] row-major along patterns, every byte 0 or 1;
//   w  uint32[p_pad] pattern weights in pattern order (0 on pad rows);
//   c  uint32[s_pad, s_pad], written in full: the triangle grid leaves the
//      strictly-upper 128 x 128 blocks zero (the TPU kernel leaves them
//      uninitialised).  Diagonal blocks are computed in full, so
//      tril(C) + tril(C, -1)^T is the whole Gram.
// p_pad and s_pad are multiples of 128; b and w are 16-byte aligned.
//
// Limbs.  The JAX package's bf16 family: 8-bit limbs (w >> 8l) & 0xFF of the
// low 8 * n_limbs bits of w, not the 7 bits of gram_pk.cuh.  A row operand
// byte is b * w_l: b's bytes become 0x00 / 0xFF masks while staging, and one
// AND with the limb bytes of four consecutive patterns makes the dp4a word.
// The unsigned __dp4a keeps limb bytes 128..255 positive; a stage's partial is
// at most 255 * 128 and joins the accumulator as part << 8l, which wraps mod
// 2^32 like the reference's num_kmers_t.
//
// Stage.  As in matmul_acc.cu: 128 patterns at a time, the K loop inside the
// block.  A dp4a word needs four consecutive patterns of one sample, which lie
// s_pad bytes apart in b: each staging thread reads one word (four samples)
// from each of four consecutive pattern rows and transposes the 4 x 4 bytes.
// Both operands, the block's row samples and its column samples, are staged
// this way once per stage, for every limb.
//
// Grids.  One block of 256 threads per 128 x 128 output block, each thread an
// 8 x 8 block of outputs: the full grid (s_pad / 128)^2, or the lower triangle
// enumerated by tri_coords (tri.cuh).
//
// What bounds it.  Integer multiply-adds, as in matmul_acc.cu: every operand of
// the inner loop sits in shared memory and registers, and b is re-read from L2
// once per block row and column.  dp4a runs on the CUDA cores; the int8
// tensor-core path (wgmma) is later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "tri.cuh"

namespace {

constexpr int kBlock = 128;         // output block edge
constexpr int kStage = 128;         // patterns per stage
constexpr int kQuads = kStage / 4;  // dp4a words per sample and stage
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int kMaxLimbs = 4;        // 8-bit limbs of a uint32 weight

// 33,280 bytes of static shared memory
struct Smem {
  __align__(16) uint32_t a[kQuads][kBlock];  // row samples: 0x00/0xFF bytes of patterns 4q..4q+3
  __align__(16) uint32_t b[kQuads][kBlock];  // column samples: 0/1 bytes of patterns 4q..4q+3
  uint32_t w[kMaxLimbs][kQuads];             // limb l of the weights of patterns 4q..4q+3
};

// dst[q][s] = the bytes of patterns p0 + 4q .. p0 + 4q + 3 at sample col0 + s,
// one per byte of the word, times `scale` (0xFF turns 0/1 bytes into masks)
__device__ __forceinline__ void stage_samples(uint32_t (*dst)[kBlock],
                                              const uint8_t* __restrict__ b, int64_t s_pad,
                                              int64_t p0, int64_t col0, uint32_t scale) {
  for (int it = threadIdx.x; it < kQuads * (kBlock / 4); it += kThreads) {
    const int q = it / (kBlock / 4);
    const int s = (it % (kBlock / 4)) * 4;
    const uint8_t* src = b + (p0 + 4 * q) * s_pad + col0 + s;
    uint32_t row[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) row[k] = *reinterpret_cast<const uint32_t*>(src + k * s_pad);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t word = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) word |= ((row[k] >> (8 * j)) & 0xFFu) << (8 * k);
      dst[q][s + j] = word * scale;
    }
  }
}

template <bool kTri>
__global__ void __launch_bounds__(kThreads)
gram_u32_kernel(const uint8_t* __restrict__ b, const uint32_t* __restrict__ w,
                uint32_t* __restrict__ c, int64_t p_pad, int64_t s_pad, int n_limbs) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  // thread (ty, tx) owns rows {ty*4 + k, 64 + ty*4 + k} and columns
  // {tx*4 + k, 64 + tx*4 + k}, k = 0..3, as in matmul_acc.cu
  const int ty = tid / 16;
  const int tx = tid % 16;
  int bi, bj;
  if constexpr (kTri) {
    tri_coords(static_cast<int>(blockIdx.x), bi, bj);
  } else {
    bi = static_cast<int>(blockIdx.y);
    bj = static_cast<int>(blockIdx.x);
  }
  const int64_t row0 = static_cast<int64_t>(bi) * kBlock;
  const int64_t col0 = static_cast<int64_t>(bj) * kBlock;

  uint32_t acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0u;

  for (int64_t p0 = 0; p0 < p_pad; p0 += kStage) {
    __syncthreads();  // the previous stage's readers are done
    stage_samples(sm.a, b, s_pad, p0, row0, 0xFFu);
    stage_samples(sm.b, b, s_pad, p0, col0, 1u);
    if (tid < kQuads) {
      const uint4 v = *reinterpret_cast<const uint4*>(w + p0 + 4 * tid);
      for (int l = 0; l < n_limbs; ++l) {
        const int sh = 8 * l;
        sm.w[l][tid] = ((v.x >> sh) & 0xFFu) | (((v.y >> sh) & 0xFFu) << 8) |
                       (((v.z >> sh) & 0xFFu) << 16) | (((v.w >> sh) & 0xFFu) << 24);
      }
    }
    __syncthreads();

    for (int l = 0; l < n_limbs; ++l) {
      uint32_t part[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) part[m][n] = 0u;
#pragma unroll 4
      for (int q = 0; q < kQuads; ++q) {
        const uint32_t wq = sm.w[l][q];
        const uint4 a0 = *reinterpret_cast<const uint4*>(&sm.a[q][ty * 4]);
        const uint4 a1 = *reinterpret_cast<const uint4*>(&sm.a[q][64 + ty * 4]);
        const uint4 b0 = *reinterpret_cast<const uint4*>(&sm.b[q][tx * 4]);
        const uint4 b1 = *reinterpret_cast<const uint4*>(&sm.b[q][64 + tx * 4]);
        const uint32_t av[8] = {a0.x & wq, a0.y & wq, a0.z & wq, a0.w & wq,
                                a1.x & wq, a1.y & wq, a1.z & wq, a1.w & wq};
        const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) part[m][n] = __dp4a(av[m], bv[n], part[m][n]);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] += part[m][n] << (8 * l);
    }
  }

  uint32_t* out = c + row0 * s_pad + col0;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int64_t row = m < 4 ? ty * 4 + m : 64 + ty * 4 + (m - 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      *reinterpret_cast<uint4*>(out + row * s_pad + hh * 64 + tx * 4) =
          make_uint4(acc[m][hh * 4 + 0], acc[m][hh * 4 + 1], acc[m][hh * 4 + 2],
                     acc[m][hh * 4 + 3]);
    }
  }
}

}  // namespace

// Launches C = B^T diag(w) B on `stream`: the full grid, or with `triangle`
// the blocks on or below the diagonal after zeroing C.  Returns the first
// cudaError_t of the calls (0 when all were accepted).  The caller checks
// shapes, types and alignment.
extern "C" int kmerdb_gram_u32(const void* b, const void* w, void* c, int64_t p_pad,
                               int64_t s_pad, int n_limbs, int triangle, void* stream) {
  const int64_t nb = s_pad / kBlock;
  if (nb == 0) return 0;
  if (n_limbs < 1 || n_limbs > kMaxLimbs) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* bb = static_cast<const uint8_t*>(b);
  const uint32_t* ww = static_cast<const uint32_t*>(w);
  uint32_t* cc = static_cast<uint32_t*>(c);
  if (triangle) {
    // the strictly-upper blocks get no thread block
    const cudaError_t err =
        cudaMemsetAsync(c, 0, static_cast<size_t>(s_pad) * s_pad * sizeof(uint32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_u32_kernel<true><<<static_cast<unsigned>(nb * (nb + 1) / 2), kThreads, 0, st>>>(
        bb, ww, cc, p_pad, s_pad, n_limbs);
  } else {
    if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(nb));
    gram_u32_kernel<false><<<grid, kThreads, 0, st>>>(bb, ww, cc, p_pad, s_pad, n_limbs);
  }
  return static_cast<int>(cudaGetLastError());
}
