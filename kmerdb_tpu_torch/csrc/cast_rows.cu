// Stripe narrowing for Hopper: out = low 16 bits of each uint32 cell of C.
//
// Replaces cast_rows (_cast_rows_kernel) of kmerdb_tpu/ops/pallas_gram.py:
// the streamed all2all narrows each uint32 stripe to uint16 on the card when
// every count fits, so the pull to the host halves.  C is uint32[R, S] and
// out uint16[R, S], both contiguous and 16-byte aligned; n = R * S is a
// multiple of 8.
//
// What bounds it.  Device-memory bandwidth: 4 bytes read and 2 written per
// cell, no arithmetic.  Each thread reads two 16-byte words (8 cells) and
// writes one, neighbouring threads on neighbouring words, so loads and
// stores are coalesced; a grid-stride loop covers any n.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return (lo & 0xFFFFu) | (hi << 16);
}

__global__ void __launch_bounds__(kThreads)
cast_rows_kernel(const uint4* __restrict__ c, uint4* __restrict__ out, int64_t n8) {
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; k < n8;
       k += static_cast<int64_t>(gridDim.x) * kThreads) {
    const uint4 a = c[2 * k];
    const uint4 b = c[2 * k + 1];
    out[k] = make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
  }
}

}  // namespace

// Launches the narrowing of n cells on `stream`; returns the launch's
// cudaError_t.  The caller checks n % 8 == 0, types and alignment.
extern "C" int kmerdb_cast_rows(const void* c, void* out, int64_t n, void* stream) {
  const int64_t n8 = n / 8;
  if (n8 == 0) return 0;
  // enough blocks to fill the card several times over; the loop does the rest
  const int64_t blocks = n8 / kThreads + 1 < 132 * 16 ? n8 / kThreads + 1 : 132 * 16;
  cast_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(c), static_cast<uint4*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}
