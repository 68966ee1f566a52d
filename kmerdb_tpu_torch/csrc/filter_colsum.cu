// Survivor counts of a count filter for Hopper:
//   out[t, s] = #{ r in [128t, 128t + 128) : lo <= C[r, s] <= hi },
// with C, lo and hi compared as unsigned 32-bit integers.
//
// Replaces filter_colsum (_filter_colsum_kernel) of
// kmerdb_tpu/ops/pallas_gram.py: the streamed sparse all2all counts the
// survivors of its filter on the card, so the host pulls only the 128 x 128
// tiles that hold any.  The TPU kernel takes the bounds bias-encoded as int32
// scalars (bias_bounds); here the wrapper decodes them and the kernel gets
// them as uint32_t.  C is uint32[R, S] with R a multiple of 128; out is
// uint32[R / 128, S] (each count at most 128).
//
// What bounds it.  Device-memory bandwidth: each cell is read once, and the
// output is 1/128 of the input.  One thread per column of a 128-row tile
// walks the tile's rows, so a warp reads 128 contiguous bytes per row and no
// reduction crosses threads.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
filter_colsum_kernel(const uint32_t* __restrict__ c, uint32_t* __restrict__ out, int64_t s,
                     uint32_t lo, uint32_t hi) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= s) return;
  const uint32_t* src = c + static_cast<int64_t>(blockIdx.y) * kTile * s + col;
  uint32_t n = 0u;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    const uint32_t v = src[r * s];
    n += (v >= lo && v <= hi) ? 1u : 0u;
  }
  out[static_cast<int64_t>(blockIdx.y) * s + col] = n;
}

}  // namespace

// Launches the count over the r x s matrix C on `stream`; returns the
// launch's cudaError_t.  The caller checks r % 128 == 0 and the types.
extern "C" int kmerdb_filter_colsum(const void* c, void* out, int64_t r, int64_t s,
                                    uint32_t lo, uint32_t hi, void* stream) {
  const int64_t row_tiles = r / kTile;
  if (row_tiles == 0 || s == 0) return 0;
  if (row_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((s + kThreads - 1) / kThreads),
                  static_cast<unsigned>(row_tiles));
  filter_colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(c), static_cast<uint32_t*>(out), s, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
