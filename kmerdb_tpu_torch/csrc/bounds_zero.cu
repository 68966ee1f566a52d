// Count filter of a stripe for Hopper:
//   out[i, j] = lo <= C[i, j] <= hi ? C[i, j] : 0,
// with C, lo and hi compared as unsigned 32-bit integers, written as uint32
// or narrowed to uint16 (the low 16 bits of a surviving cell).
//
// Replaces bounds_zero_rows (_bounds_zero_kernel) of
// kmerdb_tpu/ops/pallas_gram.py: under a device mesh the streamed sparse
// all2all zeroes, on each device, the cells of its stripe that the count
// filter drops, so the stripes that leave the devices carry survivors only.
// The TPU kernel takes the bounds bias-encoded as int32 scalars
// (bias_bounds); here the wrapper decodes them and the kernel gets them as
// uint32_t.  C is uint32[R, S] and out uint32[R, S] or uint16[R, S], both
// contiguous and 16-byte aligned; n = R * S is a multiple of 8.
//
// What bounds it.  Device-memory bandwidth: 4 bytes read and 2 or 4 written
// per cell, two compares and a select.  Each thread reads two 16-byte words
// (8 cells) and writes one (uint16) or two (uint32), neighbouring threads on
// neighbouring words, so loads and stores are coalesced; a grid-stride loop
// covers any n.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t keep(uint32_t v, uint32_t lo, uint32_t hi) {
  return (v >= lo && v <= hi) ? v : 0u;
}

__device__ __forceinline__ uint4 keep4(uint4 v, uint32_t lo, uint32_t hi) {
  return make_uint4(keep(v.x, lo, hi), keep(v.y, lo, hi), keep(v.z, lo, hi), keep(v.w, lo, hi));
}

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return (lo & 0xFFFFu) | (hi << 16);
}

template <bool kNarrow>
__global__ void __launch_bounds__(kThreads)
bounds_zero_kernel(const uint4* __restrict__ c, uint4* __restrict__ out, int64_t n8, uint32_t lo,
                   uint32_t hi) {
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; k < n8;
       k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint4 a = keep4(c[2 * k], lo, hi);
    const uint4 b = keep4(c[2 * k + 1], lo, hi);
    if (kNarrow) {
      out[k] = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
    } else {
      out[2 * k] = a;
      out[2 * k + 1] = b;
    }
  }
}

}  // namespace

// Launches the filter of n cells on `stream`, writing cells of out_bytes (2 or
// 4) bytes; returns the launch's cudaError_t.  The caller checks n % 8 == 0,
// types and alignment.
extern "C" int kmerdb_bounds_zero(const void* c, void* out, int64_t n, int out_bytes, uint32_t lo,
                                  uint32_t hi, void* stream) {
  if (out_bytes != 2 && out_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n8 = n / 8;
  if (n8 == 0) return 0;
  // enough blocks to fill the card several times over; the loop does the rest
  const int64_t blocks = n8 / kThreads + 1 < 132 * 16 ? n8 / kThreads + 1 : 132 * 16;
  const auto* src = static_cast<const uint4*>(c);
  auto* dst = static_cast<uint4*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 2) {
    bounds_zero_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n8, lo, hi);
  } else {
    bounds_zero_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(src, dst, n8, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}
