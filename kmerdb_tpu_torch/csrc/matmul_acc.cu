// Accumulating query contraction for Hopper: C <- C + H @ B, exact mod 2^32.
//
// Replaces matmul_u32_acc (_matmul_acc_kernel) of
// kmerdb_tpu/ops/pallas_gram.py: the new2all device tier, where H holds the
// hit count of each (query, database pattern) and B the patterns' sample
// incidence, so C[q, s] counts the k-mers query q shares with sample s.
//   h  [q_pad, p_pad] row-major: uint8 when one 8-bit limb holds every count,
//      uint32 (kWide) otherwise;
//   b  int8 0/1 [p_pad, s_pad] row-major along patterns (unpacked);
//   c  uint32[q_pad, s_pad], updated in place.
// q_pad and s_pad are multiples of 128, p_pad of the 128-pattern stage; every
// pointer is 16-byte aligned.
//
// Limbs.  For each 8-bit limb l of H (as the TPU kernel splits it), one
// unsigned __dp4a adds four h_l * bit products into a partial of the stage,
// at most 255 * 128; the partial joins the uint32 accumulator as part << 8l,
// which wraps mod 2^32 like the reference's num_kmers_t.  The operands are
// unsigned words: the signed dp4a would read limb bytes 128..255 as negative.
//
// Stage.  128 patterns at a time, the K loop inside the block (the TPU's
// sequential K grid axis).  A dp4a word needs four consecutive patterns of
// one sample, which lie s_pad bytes apart in B: each staging thread reads one
// word (four samples) from each of four consecutive pattern rows and
// transposes the 4 x 4 bytes into four words, one per sample.  H's four
// consecutive patterns of one query are four consecutive bytes (uint8) or the
// limb's byte of four consecutive words (uint32).
//
// Grid.  One block of 256 threads per 128 x 128 output block:
// (s_pad / 128) x (q_pad / 128); each thread owns an 8 x 8 block of outputs.
//
// What bounds it.  Integer multiply-adds, as in gram_pk.cuh: every operand of
// the inner loop sits in shared memory and registers (64 dp4a per 16 bytes a
// thread loads).  H is re-read once per column block and B once per row
// block, from L2 at new2all's shapes (H is 512 queries tall).  dp4a runs on
// the CUDA cores; the int8 tensor-core path (wgmma) is later work.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;         // output block edge
constexpr int kStage = 128;         // patterns per stage
constexpr int kQuads = kStage / 4;  // dp4a words per query or sample and stage
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each

// 32,768 bytes of static shared memory
struct Smem {
  __align__(16) uint32_t a[kQuads][kBlock];  // word (q, row): limb bytes of patterns 4q..4q+3
  __align__(16) uint32_t b[kQuads][kBlock];  // word (q, col): bits of patterns 4q..4q+3
};

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
matmul_acc_kernel(const void* __restrict__ h, const uint8_t* __restrict__ b,
                  uint32_t* __restrict__ c, int64_t p_pad, int64_t s_pad, int n_limbs) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  // thread (ty, tx) owns rows {ty*4 + k, 64 + ty*4 + k} and columns
  // {tx*4 + k, 64 + tx*4 + k}, k = 0..3, as in gram_pk.cuh
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBlock;

  uint32_t acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0u;

  for (int64_t p0 = 0; p0 < p_pad; p0 += kStage) {
    __syncthreads();  // the previous stage's readers are done
    for (int it = tid; it < kQuads * (kBlock / 4); it += kThreads) {
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
        sm.b[q][s + j] = word;
      }
    }
    for (int l = 0; l < n_limbs; ++l) {
      if (l > 0) __syncthreads();  // the previous limb's readers are done
      if constexpr (kWide) {
        const uint32_t* hw = static_cast<const uint32_t*>(h);
        const int sh = 8 * l;
        for (int it = tid; it < kQuads * kBlock; it += kThreads) {
          const int q = it / kBlock;
          const int r = it % kBlock;
          const uint4 v = *reinterpret_cast<const uint4*>(hw + (row0 + r) * p_pad + p0 + 4 * q);
          sm.a[q][r] = ((v.x >> sh) & 0xFFu) | (((v.y >> sh) & 0xFFu) << 8) |
                       (((v.z >> sh) & 0xFFu) << 16) | (((v.w >> sh) & 0xFFu) << 24);
        }
      } else {
        // one limb: 16 bytes (four words) of one query a thread
        const uint8_t* hb = static_cast<const uint8_t*>(h);
        for (int it = tid; it < (kQuads / 4) * kBlock; it += kThreads) {
          const int g = it / kBlock;
          const int r = it % kBlock;
          const uint4 v = *reinterpret_cast<const uint4*>(hb + (row0 + r) * p_pad + p0 + 16 * g);
          sm.a[4 * g + 0][r] = v.x;
          sm.a[4 * g + 1][r] = v.y;
          sm.a[4 * g + 2][r] = v.z;
          sm.a[4 * g + 3][r] = v.w;
        }
      }
      __syncthreads();

      uint32_t part[8][8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) part[m][n] = 0u;
#pragma unroll 4
      for (int q = 0; q < kQuads; ++q) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(&sm.a[q][ty * 4]);
        const uint4 a1 = *reinterpret_cast<const uint4*>(&sm.a[q][64 + ty * 4]);
        const uint4 b0 = *reinterpret_cast<const uint4*>(&sm.b[q][tx * 4]);
        const uint4 b1 = *reinterpret_cast<const uint4*>(&sm.b[q][64 + tx * 4]);
        const uint32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
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
      uint4* dst = reinterpret_cast<uint4*>(out + row * s_pad + hh * 64 + tx * 4);
      uint4 v = *dst;
      v.x += acc[m][hh * 4 + 0];
      v.y += acc[m][hh * 4 + 1];
      v.z += acc[m][hh * 4 + 2];
      v.w += acc[m][hh * 4 + 3];
      *dst = v;
    }
  }
}

}  // namespace

// Launches C += H @ B on `stream`; h_bytes is H's element size (1: uint8, one
// limb; 4: uint32, n_limbs limbs).  Returns the launch's cudaError_t.  The
// caller checks shapes, types and alignment.
extern "C" int kmerdb_matmul_acc(const void* h, int h_bytes, const void* b, void* c,
                                 int64_t q_pad, int64_t p_pad, int64_t s_pad, int n_limbs,
                                 void* stream) {
  const int64_t row_blocks = q_pad / kBlock;
  const int64_t col_blocks = s_pad / kBlock;
  if (row_blocks == 0 || col_blocks == 0 || p_pad == 0) return 0;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h_bytes == 1) {
    matmul_acc_kernel<false><<<grid, kThreads, 0, st>>>(
        h, static_cast<const uint8_t*>(b), static_cast<uint32_t*>(c), p_pad, s_pad, 1);
  } else {
    matmul_acc_kernel<true><<<grid, kThreads, 0, st>>>(
        h, static_cast<const uint8_t*>(b), static_cast<uint32_t*>(c), p_pad, s_pad, n_limbs);
  }
  return static_cast<int>(cudaGetLastError());
}
