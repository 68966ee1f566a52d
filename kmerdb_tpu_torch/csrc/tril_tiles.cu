// Tile pull for Hopper: out[t] = the 128 x 128 tile (i_t, j_t) of C, narrowed.
//
// Replaces both users of _pack_tiles_kernel in kmerdb_tpu/ops/pallas_gram.py:
//   tril_tiles    (i_t, j_t) walk the lower-tile triangle of a square C in the
//                 tri_coords order, computed by each block;
//   gather_tiles  (i_t, j_t) = (i_tab[t], j_tab[t]), caller-listed int32 tables
//                 on the device that each block loads itself (the TPU kernel's
//                 scalar prefetch); repeats and any order are allowed.
// C is uint32 with rows `ld` cells apart (ld a multiple of 4); out is
// [n, 128, 128] of uint16 (every count is known to fit, so the pull halves)
// or uint32.  Narrowing keeps the low 16 bits, as a uint32 -> uint16 cast does.
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

// i_tab == nullptr: the triangle order; otherwise the caller's tables
template <typename T>
__global__ void __launch_bounds__(kThreads)
pull_tiles_kernel(const uint32_t* __restrict__ c, const int32_t* __restrict__ i_tab,
                  const int32_t* __restrict__ j_tab, T* __restrict__ out, int64_t ld) {
  int i, j;
  if (i_tab == nullptr) {
    tri_coords(blockIdx.x, i, j);
  } else {
    i = i_tab[blockIdx.x];
    j = j_tab[blockIdx.x];
  }
  const uint32_t* src = c + static_cast<int64_t>(i) * kTile * ld + static_cast<int64_t>(j) * kTile;
  T* dst = out + static_cast<int64_t>(blockIdx.x) * kTile * kTile;
  for (int it = threadIdx.x; it < kTile * kTile / 4; it += kThreads) {
    const int r = it / (kTile / 4);
    const int c4 = (it % (kTile / 4)) * 4;
    store4(dst + r * kTile + c4, *reinterpret_cast<const uint4*>(src + r * ld + c4));
  }
}

int launch(const void* c, const void* i_tab, const void* j_tab, void* out, int64_t n,
           int64_t ld, int out_bytes, void* stream) {
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(c);
  const auto* it = static_cast<const int32_t*>(i_tab);
  const auto* jt = static_cast<const int32_t*>(j_tab);
  if (out_bytes == 2) {
    pull_tiles_kernel<uint16_t><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        src, it, jt, static_cast<uint16_t*>(out), ld);
  } else if (out_bytes == 4) {
    pull_tiles_kernel<uint32_t><<<static_cast<unsigned>(n), kThreads, 0, st>>>(
        src, it, jt, static_cast<uint32_t*>(out), ld);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pulls the lower-tile triangle of the square uint32[s_pad, s_pad] C on
// `stream` with out_bytes = 2 (uint16) or 4 (uint32); returns the launch's
// cudaError_t.  The caller checks shapes and alignment.
extern "C" int kmerdb_tril_tiles(const void* c, void* out, int64_t s_pad, int out_bytes,
                                 void* stream) {
  const int64_t nt = s_pad / kTile;
  return launch(c, nullptr, nullptr, out, nt * (nt + 1) / 2, s_pad, out_bytes, stream);
}

// Pulls the n tiles (i_tab[t], j_tab[t]) of C (rows ld cells apart) on
// `stream`; returns the launch's cudaError_t.  The caller checks shapes,
// alignment and that every listed tile lies inside C.
extern "C" int kmerdb_gather_tiles(const void* c, const void* i_tab, const void* j_tab,
                                   void* out, int64_t n, int64_t ld, int out_bytes,
                                   void* stream) {
  return launch(c, i_tab, j_tab, out, n, ld, out_bytes, stream);
}
