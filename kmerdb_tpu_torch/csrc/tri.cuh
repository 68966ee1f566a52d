// Grid enumeration shared by the port's kernels: the lower triangle's
// tiles, and the runs of a split-K grid.
//
// Tile t of the triangle is (i, j) with t = i * (i + 1) / 2 + j and
// 0 <= j <= i: the order of tri_tile_tables in kmerdb_tpu_torch/ops/gram.py
// and in kmerdb_tpu/ops/pallas_gram.py, so tile t of a tril_tiles pull
// lands where untile_symmetric expects it.
#pragma once

__device__ __forceinline__ void tri_coords(int t, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.0f * static_cast<float>(t) + 1.0f) - 1.0f) * 0.5f);
  // the float square root can be off by one near a triangle number
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  i = r;
  j = t - r * (r + 1) / 2;
}

// Split z of k's run of n items (stages, K blocks): the first n % k splits
// take one item more than the rest (ops/gram.split_stages).
__device__ __forceinline__ void split_range(int n, int k, int z, int& first, int& count) {
  const int base = n / k;
  const int rem = n % k;
  first = z * base + min(z, rem);
  count = base + (z < rem ? 1 : 0);
}
