// Lower-triangle tile pull for Hopper: out[t] = C tile (i_t, j_t), narrowed.
//
// Replaces tril_tiles (_pack_tiles_kernel) of kmerdb_tpu/ops/pallas_gram.py.
// C is uint32[S, S] with S a multiple of 128; out is [n_tri, 128, 128] of
// uint16 (every count is known to fit, so the pull halves) or uint32, and
// tile t is C's 128 x 128 tile (i, j) in the tri_coords order.  Narrowing
// keeps the low 16 bits, as a uint32 -> uint16 cast does.
//
// What bounds it.  Device-memory bandwidth: each count is read once and
// written once, with no arithmetic.  One block per tile reads 16-byte words
// along C's rows (32 threads cover one 512-byte tile row) and writes the
// tile contiguously, so both sides are coalesced.
#include <cstdint>

#include <cuda_runtime.h>

#include "tri.cuh"

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ void store4(uint16_t* dst, uint4 v) {
  *reinterpret_cast<ushort4*>(dst) =
      make_ushort4(static_cast<unsigned short>(v.x), static_cast<unsigned short>(v.y),
                   static_cast<unsigned short>(v.z), static_cast<unsigned short>(v.w));
}

__device__ __forceinline__ void store4(uint32_t* dst, uint4 v) {
  *reinterpret_cast<uint4*>(dst) = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tril_tiles_kernel(const uint32_t* __restrict__ c, T* __restrict__ out, int64_t s_pad) {
  int i, j;
  tri_coords(blockIdx.x, i, j);
  const uint32_t* src = c + static_cast<int64_t>(i) * kTile * s_pad + static_cast<int64_t>(j) * kTile;
  T* dst = out + static_cast<int64_t>(blockIdx.x) * kTile * kTile;
  for (int it = threadIdx.x; it < kTile * kTile / 4; it += kThreads) {
    const int r = it / (kTile / 4);
    const int c4 = (it % (kTile / 4)) * 4;
    store4(dst + r * kTile + c4, *reinterpret_cast<const uint4*>(src + r * s_pad + c4));
  }
}

}  // namespace

// Launches the pull on `stream` with out_bytes = 2 (uint16) or 4 (uint32);
// returns the launch's cudaError_t.  The caller checks shapes and alignment.
extern "C" int kmerdb_tril_tiles(const void* c, void* out, int64_t s_pad, int out_bytes,
                                 void* stream) {
  const int64_t nt = s_pad / kTile;
  const int64_t n_tri = nt * (nt + 1) / 2;
  if (n_tri == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(c);
  if (out_bytes == 2) {
    tril_tiles_kernel<uint16_t><<<static_cast<unsigned>(n_tri), kThreads, 0, st>>>(
        src, static_cast<uint16_t*>(out), s_pad);
  } else if (out_bytes == 4) {
    tril_tiles_kernel<uint32_t><<<static_cast<unsigned>(n_tri), kThreads, 0, st>>>(
        src, static_cast<uint32_t*>(out), s_pad);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
