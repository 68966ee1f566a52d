// Accumulating query contraction for Hopper: C <- C + H @ B, exact mod 2^32.
//
// Replaces matmul_u32_acc (_matmul_acc_kernel) of
// kmerdb_tpu/ops/pallas_gram.py, the new2all device tier, where H holds the
// hit count of each (query, database pattern) and B the patterns' sample
// incidence, so C[q, s] counts the k-mers query q shares with sample s; and
// with C written fresh, matmul_u32 (_matmul_tile_kernel), the chunk product
// of new2all's scan tier.
//   h  [q_pad, p_pad] row-major: uint8 when one 8-bit limb holds every count,
//      uint32 (h_bytes 4) otherwise;
//   b  int8 0/1 [p_pad, s_pad] row-major along patterns (unpacked);
//   c  uint32[q_pad, s_pad], updated in place.
// q_pad, p_pad and s_pad are multiples of 128; every pointer is 16-byte
// aligned.
//
// Limbs.  The 8-bit limbs (h >> 8l) & 0xFF of uint32 H, as the TPU kernel
// splits them.  limb_planes_kernel splits H once a call into n_limbs planes
// uint8[q_pad, p_pad] (the caller's scratch), so that every limb is a
// one-byte operand like uint8 H.
//
// Block.  gram_u8.cuh's body with its QueryRows operand on Hopper's int8
// tensor cores (mma.sync .u8.u8, so H bytes 128..255 stay positive): H's
// plane rows are K-major already (a query's patterns are consecutive
// bytes), the A fragments mma wants, loaded by ldmatrix; B is the column
// slab of the unpacked Gram, staged and transposed in its fragment reads as
// there.  The limbs are the outer loop and each limb's sum joins C as
// sum << 8l at least every 2^23 patterns.  Its staging, fragments and what
// bounds it: gram_u8.cuh.
//
// Grid.  (s_pad / 128, q_pad / 128, k_splits): one block of 256 threads per
// 128 x 128 output block and split; split z takes a run of whole 128-pattern
// stages (split_range), so that new2all's few output blocks (32 at Q_pad
// 128, 128 at 512) still fill the card's two blocks an SM.  With k_splits ==
// 1 a block adds its flushes into C (stores the first, for the fresh
// product).  With k_splits > 1 split z writes its sums into its own slice
// of `partials` (uint32[k_splits, q_pad, s_pad], the caller's scratch), and
// split_sum_kernel then adds the slices into C in one pass.  Flushing by
// red.global.add.u32 straight into C, tried first, made 2 splits slower
// than one at new2all's chunk shape (Q_pad 512 x P_pad 10,496 x S_pad
// 4,096: 0.1183 against 0.0912 ms, tools/gram_u8_rate.py, PERF.md).
// uint32 addition mod 2^32 is associative and commutative, so C is
// bit-identical at any k_splits and from run to run, with no tolerance.
// The caller (ops/gram.matmul_splits) picks k_splits.
#include <cstdint>

#include <cuda_runtime.h>

#include "gram_u8.cuh"
#include "tri.cuh"

namespace {

constexpr int kMaxLimbs = 4;        // 8-bit limbs of a uint32 count
constexpr int kMaxDevices = 64;     // devices whose attribute is remembered
constexpr int64_t kGridMax = 4096;  // the elementwise kernels' grid; they stride past it

__global__ void __launch_bounds__(gram_u8::kThreads, gram_u8::kMinBlocks)
matmul_acc_kernel(const uint8_t* __restrict__ h, const uint8_t* __restrict__ b,
                  uint32_t* __restrict__ out, int64_t q_pad, int64_t p_pad, int64_t s_pad,
                  int n_limbs, bool fresh) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * gram_u8::kBlock;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * gram_u8::kBlock;
  int st0, n_st;
  split_range(static_cast<int>(p_pad / gram_u8::kStage), static_cast<int>(gridDim.z),
              static_cast<int>(blockIdx.z), st0, n_st);
  const gram_u8::QueryRows rows(h + row0 * p_pad, p_pad, q_pad * p_pad);
  gram_u8::block<false, true>(smem, rows, b + col0, s_pad, nullptr, st0, n_st, n_limbs,
                              gram_u8::kFlushU8, fresh,
                              out + blockIdx.z * q_pad * s_pad + row0 * s_pad + col0, s_pad);
}

// c[i] (+)= sum over the k slices of partials[., i]: four cells a thread.
__global__ void __launch_bounds__(256)
split_sum_kernel(const uint4* __restrict__ partials, uint4* __restrict__ c, int64_t n4, int k,
                 bool fresh) {
  for (int64_t i = blockIdx.x * int64_t{256} + threadIdx.x; i < n4;
       i += int64_t{gridDim.x} * 256) {
    uint4 acc = fresh ? make_uint4(0u, 0u, 0u, 0u) : c[i];
    for (int z = 0; z < k; ++z) {
      const uint4 v = partials[z * n4 + i];
      acc = make_uint4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
    }
    c[i] = acc;
  }
}

// planes[l] = (h >> 8l) & 0xFF for l < n_limbs: four words a thread, one
// 32-bit store a plane.
__global__ void __launch_bounds__(256)
limb_planes_kernel(const uint4* __restrict__ h, uint32_t* __restrict__ planes, int64_t n4,
                   int n_limbs) {
  for (int64_t i = blockIdx.x * int64_t{256} + threadIdx.x; i < n4;
       i += int64_t{gridDim.x} * 256) {
    const uint4 v = h[i];
    for (int l = 0; l < n_limbs; ++l) {
      const int sh = 8 * l;
      planes[l * n4 + i] = ((v.x >> sh) & 0xFFu) | (((v.y >> sh) & 0xFFu) << 8) |
                           (((v.z >> sh) & 0xFFu) << 16) | (((v.w >> sh) & 0xFFu) << 24);
    }
  }
}

// Blocks of 256 threads for n4 items of four, at most kGridMax.
unsigned grid_of(int64_t n4) {
  const int64_t blocks = (n4 + 255) / 256;
  return static_cast<unsigned>(blocks < kGridMax ? blocks : kGridMax);
}

cudaError_t launch_planes(const void* h, void* planes, int64_t n, int n_limbs,
                          cudaStream_t st) {
  const int64_t n4 = n / 4;
  if (n4 == 0) return cudaSuccess;
  limb_planes_kernel<<<grid_of(n4), 256, 0, st>>>(static_cast<const uint4*>(h),
                                                  static_cast<uint32_t*>(planes), n4, n_limbs);
  return cudaGetLastError();
}

// gram_u8::allow_smem for matmul_acc_kernel, once a device: the launcher
// runs once a chunk of new2all, where its calls cost more host time than a
// small product takes on the card.
cudaError_t allow_smem_once() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = gram_u8::allow_smem(matmul_acc_kernel);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// C (+)= H @ B on `stream` over k_splits runs of stages, written fresh when
// `fresh`.  h_bytes is H's element size (1: uint8, one limb; 4: uint32,
// n_limbs limbs, split first into `planes`, uint8[n_limbs, q_pad, p_pad]
// scratch, unused for uint8); `partials` is uint32[k_splits, q_pad, s_pad]
// scratch, unused at one split.  Returns the first cudaError_t of the calls
// (0 when all were accepted).  The caller checks shapes, types, alignment
// and k_splits.
int launch(const void* h, int h_bytes, const void* b, void* c, int64_t q_pad, int64_t p_pad,
           int64_t s_pad, int n_limbs, int k_splits, void* planes, void* partials, bool fresh,
           cudaStream_t st) {
  const int64_t row_blocks = q_pad / gram_u8::kBlock;
  const int64_t col_blocks = s_pad / gram_u8::kBlock;
  if (row_blocks > 65535 || n_limbs < 1 || n_limbs > kMaxLimbs || k_splits < 1 ||
      k_splits > 65535 || (h_bytes != 1 && h_bytes != 4) || (h_bytes == 1 && n_limbs != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_blocks == 0 || col_blocks == 0) return 0;
  if (p_pad == 0)
    return fresh ? static_cast<int>(cudaMemsetAsync(
                       c, 0, static_cast<size_t>(q_pad) * s_pad * sizeof(uint32_t), st))
                 : 0;
  if (k_splits > p_pad / gram_u8::kStage) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem_once();
  if (err == cudaSuccess && h_bytes == 4) {
    err = launch_planes(h, planes, q_pad * p_pad, n_limbs, st);
    h = planes;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(col_blocks), static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(k_splits));
  matmul_acc_kernel<<<grid, gram_u8::kThreads, gram_u8::kSmemBytes, st>>>(
      static_cast<const uint8_t*>(h), static_cast<const uint8_t*>(b),
      static_cast<uint32_t*>(k_splits > 1 ? partials : c), q_pad, p_pad, s_pad, n_limbs,
      fresh || k_splits > 1);
  err = cudaGetLastError();
  if (err == cudaSuccess && k_splits > 1) {
    const int64_t n4 = q_pad * s_pad / 4;
    split_sum_kernel<<<grid_of(n4), 256, 0, st>>>(static_cast<const uint4*>(partials),
                                                   static_cast<uint4*>(c), n4, k_splits, fresh);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Splits the n (a multiple of 4) uint32 words at h into n_limbs planes of
// n bytes at `planes` on `stream`.  Returns the launch's cudaError_t.
extern "C" int kmerdb_limb_planes(const void* h, void* planes, int64_t n, int n_limbs,
                                  void* stream) {
  if (n_limbs < 1 || n_limbs > kMaxLimbs || n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_planes(h, planes, n, n_limbs, static_cast<cudaStream_t>(stream)));
}

// C += H @ B on `stream` (launch above).
extern "C" int kmerdb_matmul_acc(const void* h, int h_bytes, const void* b, void* c,
                                 int64_t q_pad, int64_t p_pad, int64_t s_pad, int n_limbs,
                                 int k_splits, void* planes, void* partials, void* stream) {
  return launch(h, h_bytes, b, c, q_pad, p_pad, s_pad, n_limbs, k_splits, planes, partials,
                false, static_cast<cudaStream_t>(stream));
}

// The fresh product C = H @ B on `stream` (launch above).
extern "C" int kmerdb_matmul_u32(const void* h, int h_bytes, const void* b, void* c,
                                 int64_t q_pad, int64_t p_pad, int64_t s_pad, int n_limbs,
                                 int k_splits, void* planes, void* partials, void* stream) {
  return launch(h, h_bytes, b, c, q_pad, p_pad, s_pad, n_limbs, k_splits, planes, partials,
                true, static_cast<cudaStream_t>(stream));
}
