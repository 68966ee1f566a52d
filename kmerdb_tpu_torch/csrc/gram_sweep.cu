// The Gram variants of tools/kernel_sweep.py for Hopper: one packed or
// unpacked triangle Gram split into its parts, so that a time splits into
// unpack, product and weight scale.
//
// Replaces tools/kernel_sweep.py `build` (its pallas_call and the bodies
// body_int8, body_bf16, body_nodot and body_dotonly).  Every variant walks
// the same grid as gram_pk_tri.cu: one block of 256 threads per 128 x 128
// output block whose coarse tile (edge `tile`) lies on or below the
// diagonal, in the tri_coords order; the TPU's K grid axis (P / kt blocks)
// is a loop inside the block (bf16, bf16_ns, dotonly and dotonly_t: split
// over runs of whole K blocks, below).  Blocks above the coarse diagonal get
// no thread block, so C keeps its contents there, as the aliased TPU output
// does.  c
// is uint32[S, S] (int32 storage), updated in place; w uint32[P].
//
//   int8        C += Bi^T diag(w & 0x7F) Bj on packed uint8[P/8, S] operands:
//               gram_pk.cuh's block at one limb, the production s8 body
//               (int8 tensor cores, mma.sync).
//   bf16        C += Bi^T diag(w & 0xFF) Bj on packed operands expanded to
//               bf16 on chip, each product summed in f32 over a K block,
//               the sum truncated into C at the end of the block (below
//               kt * 255 < 2^24: exact): gram_bf16.cuh's packed_block (bf16
//               tensor cores, mma.sync).
//   bf16_ns     the same without the weights.
//   nodot       the unpack alone: per K block, C_tile[x, y] += U_i[x, y] +
//               U_j[x, y] for x, y < tile, U the (kt, tile) block unpacked
//               b-major (row b * kt/8 + r is bit b of byte row r) from the
//               tile's columns of Bi and Bj.  Needs kt >= tile.
//   dotonly     C += Bi^T Bj on unpacked bf16[P, S] operands, f32 per K
//               block, truncated into C as in bf16: gram_bf16.cuh's block
//               (bf16 tensor cores, mma.sync), its PatternRows operand.
//   dotonly_t   the same with Bi laid out bf16[S, P]: its SampleRows.
//   dotonly_s8  C += Bi^T Bj on unpacked int8[P, S] operands: gram_u8.cuh's
//               block in its signed form (int8 tensor cores, mma.sync
//               .s8.s8), its exact s32 sums added into C mod 2^32 every
//               2^16 patterns, which equals adding each K block's sum.
//
// What bounds them.  Products: the int8 and dotonly_s8 bodies run on the
// int8 tensor cores (gram_pk.cuh, gram_u8.cuh), bf16, bf16_ns, dotonly and
// dotonly_t on the bf16 ones (gram_bf16.cuh), all 8 warps of 64 x 32
// outputs, their bounds there; bf16 and bf16_ns expand their packed
// operands into the same bf16 slabs that dotonly's cp.async ring holds, so
// the gap between them is the cost of the packed staging.  nodot moves
// bytes and unpacks them with plain loads and stores (each thread owns an
// 8 x 8 block of outputs); its only arithmetic is the add.  The variants
// exist to measure these parts against each other on the production
// block's grid; nodot on packed_block's staging is later work.
//
// Split K (bf16, bf16_ns, dotonly, dotonly_t).  The triangle's 136 output
// blocks at the tool's S of 2,048 would leave the card's 132 SMs, one
// block each, a second wave of 4; so the grid is n_blocks x k_splits
// (ops/sweep.py dot_splits picks k_splits), split z taking a run of whole
// K blocks (split_range), which leaves each K block's truncation as it is.  With
// one split a block adds its sums into C; with more, split z stores them
// in its slice of `partials` (uint32[k_splits, n_blocks, 128, 128], the
// caller's scratch) and dot_split_sum_kernel adds the slices into C's
// lower blocks in one pass.  uint32 addition mod 2^32 is associative and
// commutative: C is bit-identical at any k_splits.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram_bf16.cuh"
#include "gram_pk.cuh"
#include "gram_u8.cuh"
#include "tri.cuh"

namespace {

constexpr int kBlock = 128;           // output block edge
constexpr int kThreads = 256;         // nodot: 16 x 16 threads, 8 x 8 outputs each
constexpr int kStage = 64;            // patterns staged at a time
constexpr int kStageRows8 = kStage / 8;   // packed rows a stage
constexpr int kMaxDevices = 64;           // devices whose attribute is remembered

// Output block b of the triangle: its row and column in C, and its place
// (sr, sc) inside its coarse tile.
struct Coords {
  int64_t row0, col0;
  int sr, sc, ci, cj;
};

__device__ __forceinline__ Coords coords(int b, int sub) {
  Coords k;
  const int per_tile = sub * sub;
  tri_coords(b / per_tile, k.ci, k.cj);
  const int s = b % per_tile;
  k.sr = s / sub;
  k.sc = s % sub;
  k.row0 = static_cast<int64_t>(k.ci * sub + k.sr) * kBlock;
  k.col0 = static_cast<int64_t>(k.cj * sub + k.sc) * kBlock;
  return k;
}

// Thread (ty, tx) owns rows {ty*4 + k, 64 + ty*4 + k} and columns
// {tx*4 + k, 64 + tx*4 + k}, k = 0..3, of the output block.
__device__ __forceinline__ int own(int t, int m) {
  return m < 4 ? t * 4 + m : 64 + t * 4 + (m - 4);
}

__device__ __forceinline__ void add_out(uint32_t (&acc)[8][8], uint32_t* __restrict__ out,
                                        int64_t ld, int ty, int tx) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int64_t row = own(ty, m);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4* dst = reinterpret_cast<uint4*>(out + row * ld + h * 64 + tx * 4);
      uint4 v = *dst;
      v.x += acc[m][h * 4 + 0];
      v.y += acc[m][h * 4 + 1];
      v.z += acc[m][h * 4 + 2];
      v.w += acc[m][h * 4 + 3];
      *dst = v;
    }
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[8], int base) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[base + 0] = lo.x;
  v[base + 1] = lo.y;
  v[base + 2] = hi.x;
  v[base + 3] = hi.y;
}

struct SmemNodot {
  __align__(16) __nv_bfloat16 a[kStage][kBlock];  // row operand, staged patterns
  __align__(16) __nv_bfloat16 b[kStage][kBlock];  // column operand
};

// nodot.  Stage patterns: the 64 patterns (bit b, byte row r0 + r), r < 8,
// held at a[b * 8 + r].
__global__ void __launch_bounds__(kThreads)
sweep_nodot_kernel(const uint8_t* __restrict__ bi, const uint8_t* __restrict__ bj,
                   uint32_t* __restrict__ c, int64_t p, int64_t s, int kt, int sub) {
  __shared__ SmemNodot sm;
  const Coords k = coords(blockIdx.x, sub);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int kb = kt / 8;
  // nodot adds U[x, y] of the tile's columns y: both operands are read at
  // the output block's columns inside their coarse tiles
  const int64_t a_col = (static_cast<int64_t>(k.ci) * sub + k.sc) * kBlock;
  const int64_t b_col = k.col0;

  uint32_t acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0u;

  for (int64_t kblk = 0; kblk < p; kblk += kt) {
    for (int st = 0; st < kb; st += kStageRows8) {
      __syncthreads();  // the previous stage's readers are done
      const int64_t r_base = kblk / 8 + st;  // first byte row of the stage
      for (int it = tid; it < kStageRows8 * kBlock; it += kThreads) {
        const int r = it / kBlock;
        const int col = it % kBlock;
        const uint32_t xa = bi[(r_base + r) * s + a_col + col];
        const uint32_t xb = bj[(r_base + r) * s + b_col + col];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          sm.a[b * kStageRows8 + r][col] = __float2bfloat16(((xa >> b) & 1u) ? 1.0f : 0.0f);
          sm.b[b * kStageRows8 + r][col] = __float2bfloat16(((xb >> b) & 1u) ? 1.0f : 0.0f);
        }
      }
      __syncthreads();

      // output row x of the coarse tile is U row x: bit x / kb of byte
      // row x % kb; add it where that byte row is in this stage
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int x = k.sr * kBlock + own(ty, m);
        const int r = x % kb - st;
        if (r < 0 || r >= kStageRows8) continue;
        const int row = (x / kb) * kStageRows8 + r;
        float av[8], bv[8];
        load4(&sm.a[row][tx * 4], av, 0);
        load4(&sm.a[row][64 + tx * 4], av, 4);
        load4(&sm.b[row][tx * 4], bv, 0);
        load4(&sm.b[row][64 + tx * 4], bv, 4);
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] += static_cast<uint32_t>(av[n] + bv[n]);
      }
    }
  }
  add_out(acc, c + k.row0 * s + k.col0, s, ty, tx);
}

// dotonly_s8: gram_u8.cuh's body in its signed form (mma.sync .s8.s8, no
// weights), Bi != Bj, every flush added into C.
__global__ void __launch_bounds__(gram_u8::kThreads, gram_u8::kMinBlocks)
sweep_s8_kernel(const int8_t* __restrict__ bi, const int8_t* __restrict__ bj,
                uint32_t* __restrict__ c, int64_t p, int64_t s, int sub) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Coords k = coords(blockIdx.x, sub);
  const gram_u8::PatternRows rows(reinterpret_cast<const uint8_t*>(bi) + k.row0, s);
  gram_u8::block<false, false>(smem, rows, reinterpret_cast<const uint8_t*>(bj) + k.col0, s,
                               nullptr, 0, static_cast<int>(p / gram_u8::kStage), 1,
                               gram_u8::kFlushS8, false, c + k.row0 * s + k.col0, s);
}

// int8: the production block (gram_pk.cuh) at one 7-bit limb, Bi != Bj.
__global__ void __launch_bounds__(gram_pk::kThreads, gram_pk::kMinBlocks)
sweep_int8_kernel(const uint32_t* __restrict__ w, const uint8_t* __restrict__ bi,
                  const uint8_t* __restrict__ bj, uint32_t* __restrict__ c, int64_t p,
                  int64_t s, int kt, int sub) {
  __shared__ gram_pk::Smem sm;
  const Coords k = coords(blockIdx.x, sub);
  gram_pk::block(sm, bi, s, bj, s, w, p / 8, 1, kt / 8, k.row0, k.col0, c + k.row0 * s + k.col0,
                 s);
}

// Split z's run of K blocks of output block b, blockIdx.x = z * n_blocks +
// b: its first pattern and stages, and where its sums go (into C with one
// split, else into its slice of `partials`).
struct SplitRun {
  Coords k;
  int64_t p0;
  int n_st, st_kt;
  uint32_t* out;
  int64_t ld_out;
  bool split;

  __device__ __forceinline__ SplitRun(uint32_t* c, uint32_t* partials, int64_t p, int64_t s,
                                      int kt, int sub, int n_blocks) {
    const int b = static_cast<int>(blockIdx.x % n_blocks);
    const int z = static_cast<int>(blockIdx.x / n_blocks);
    const int k_splits = static_cast<int>(gridDim.x / n_blocks);
    k = coords(b, sub);
    int kb0, n_kb;
    split_range(static_cast<int>(p / kt), k_splits, z, kb0, n_kb);
    st_kt = kt / gram_bf16::kStage;
    n_st = n_kb * st_kt;
    p0 = static_cast<int64_t>(kb0) * kt;
    split = k_splits > 1;
    out = split ? partials + (static_cast<int64_t>(z) * n_blocks + b) * kBlock * kBlock
                : c + k.row0 * s + k.col0;
    ld_out = split ? kBlock : s;
  }
};

// dotonly (kT false: Bi bf16[P, S]) and dotonly_t (kT true: Bi bf16[S,
// P]): gram_bf16.cuh's block over a SplitRun.  w is unused.
template <bool kT>
__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
sweep_dot_bf16_kernel(const uint32_t* __restrict__ w, const uint16_t* __restrict__ bi,
                      const uint16_t* __restrict__ bj, uint32_t* __restrict__ c,
                      uint32_t* __restrict__ partials, int64_t p, int64_t s, int kt, int sub,
                      int n_blocks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SplitRun run(c, partials, p, s, kt, sub, n_blocks);
  if constexpr (kT) {
    const gram_bf16::SampleRows rows(bi + run.k.row0 * p, p);
    gram_bf16::block(smem, rows, bj + run.k.col0, s, run.p0, run.n_st, run.st_kt, run.out,
                     run.ld_out, run.split);
  } else {
    const gram_bf16::PatternRows rows(bi + run.k.row0, s);
    gram_bf16::block(smem, rows, bj + run.k.col0, s, run.p0, run.n_st, run.st_kt, run.out,
                     run.ld_out, run.split);
  }
}

// bf16 (kWeighted) and bf16_ns: gram_bf16.cuh's packed_block over a
// SplitRun, Bi and Bj uint8[P/8, S].
template <bool kWeighted>
__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
sweep_pk_bf16_kernel(const uint32_t* __restrict__ w, const uint8_t* __restrict__ bi,
                     const uint8_t* __restrict__ bj, uint32_t* __restrict__ c,
                     uint32_t* __restrict__ partials, int64_t p, int64_t s, int kt, int sub,
                     int n_blocks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SplitRun run(c, partials, p, s, kt, sub, n_blocks);
  gram_bf16::packed_block<kWeighted>(smem, bi + run.k.row0, bj + run.k.col0, s, w, run.p0,
                                     run.n_st, run.st_kt, run.out, run.ld_out, run.split);
}

// C's output block blockIdx.x += the k_splits slices' sums of it: rows
// 8 blockIdx.y .. + 7, one uint4 of four cells a thread.
__global__ void __launch_bounds__(256)
dot_split_sum_kernel(const uint4* __restrict__ partials, uint32_t* __restrict__ c, int64_t s,
                     int sub, int n_blocks, int k_splits) {
  const Coords k = coords(blockIdx.x, sub);
  const int q = blockIdx.y * 256 + threadIdx.x;  // the uint4 in the block
  const int row = q / (kBlock / 4);
  const int col = 4 * (q % (kBlock / 4));
  uint4* dst = reinterpret_cast<uint4*>(c + (k.row0 + row) * s + k.col0 + col);
  const uint4* src = partials + static_cast<int64_t>(blockIdx.x) * (kBlock * kBlock / 4) + q;
  const int64_t slice = static_cast<int64_t>(n_blocks) * (kBlock * kBlock / 4);
  uint4 acc = *dst;
  for (int z = 0; z < k_splits; ++z) {
    const uint4 v = src[z * slice];
    acc = make_uint4(acc.x + v.x, acc.y + v.y, acc.z + v.z, acc.w + v.w);
  }
  *dst = acc;
}
static_assert(kBlock * kBlock / 4 == 256 * (kBlock / 8), "8 rows of uint4 a thread block");

// gram_bf16::allow_smem(kKernel, bytes), once a device: each call costs
// host time (matmul_acc.cu's allow_smem_once).
template <auto kKernel>
cudaError_t allow_smem_once(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = gram_bf16::allow_smem(kKernel, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

int64_t n_blocks(int64_t s, int tile) {
  const int64_t nt = s / tile;
  const int64_t sub = tile / kBlock;
  return nt * (nt + 1) / 2 * sub * sub;
}

// kKernel (sweep_dot_bf16_kernel or sweep_pk_bf16_kernel), `smem` bytes of
// dynamic shared memory a block, over k_splits runs of K blocks (the top
// of the file); partials is uint32[k_splits, n_blocks, 128, 128] scratch,
// unused at one split.
template <auto kKernel, class T>
int launch_split(int smem, const void* w, const void* bi, const void* bj, void* c, int64_t p,
                 int64_t s, int kt, int tile, int k_splits, void* partials, void* stream) {
  const int64_t blocks = n_blocks(s, tile);
  if (blocks == 0 || p == 0) return 0;
  if (kt % gram_bf16::kStage != 0 || p % kt != 0 || k_splits < 1 || k_splits > p / kt ||
      blocks * k_splits > INT32_MAX || (k_splits > 1 && partials == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem_once<kKernel>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kKernel<<<static_cast<unsigned>(blocks * k_splits), gram_bf16::kThreads, smem, st>>>(
      static_cast<const uint32_t*>(w), static_cast<const T*>(bi), static_cast<const T*>(bj),
      static_cast<uint32_t*>(c), static_cast<uint32_t*>(partials), p, s, kt, tile / kBlock,
      static_cast<int>(blocks));
  err = cudaGetLastError();
  if (err == cudaSuccess && k_splits > 1) {
    dot_split_sum_kernel<<<dim3(static_cast<unsigned>(blocks), kBlock / 8), 256, 0, st>>>(
        static_cast<const uint4*>(partials), static_cast<uint32_t*>(c), s, tile / kBlock,
        static_cast<int>(blocks), k_splits);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// Each entry point launches one variant on `stream` and returns the launch's
// cudaError_t (0 when it was accepted).  w is uint32[P]; bi, bj are the
// variant's operands over p patterns and s samples; c is uint32[s, s].  The
// caller checks shapes, types and alignment (kmerdb_tpu_torch/ops/sweep.py).
extern "C" int kmerdb_sweep_int8(const void* w, const void* bi, const void* bj, void* c, int64_t p,
                                 int64_t s, int kt, int tile, void* stream) {
  const int64_t blocks = n_blocks(s, tile);
  if (blocks == 0 || p == 0) return 0;
  sweep_int8_kernel<<<static_cast<unsigned>(blocks), gram_pk::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), static_cast<const uint8_t*>(bi),
      static_cast<const uint8_t*>(bj), static_cast<uint32_t*>(c), p, s, kt, tile / kBlock);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kmerdb_sweep_nodot(const void* w, const void* bi, const void* bj, void* c,
                                  int64_t p, int64_t s, int kt, int tile, void* stream) {
  (void)w;  // the unpack alone takes no weights
  const int64_t blocks = n_blocks(s, tile);
  if (blocks == 0 || p == 0) return 0;
  sweep_nodot_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bi), static_cast<const uint8_t*>(bj), static_cast<uint32_t*>(c),
      p, s, kt, tile / kBlock);
  return static_cast<int>(cudaGetLastError());
}

// bf16, bf16_ns, dotonly and dotonly_t take two more: k_splits, the runs
// of whole K blocks the grid cuts P into (1..P / kt), and `partials`,
// uint32[k_splits, n_blocks, 128, 128] scratch when k_splits > 1.  bf16's
// w must be 16-byte aligned.
extern "C" int kmerdb_sweep_bf16(const void* w, const void* bi, const void* bj, void* c, int64_t p,
                                 int64_t s, int kt, int tile, int k_splits, void* partials,
                                 void* stream) {
  return launch_split<sweep_pk_bf16_kernel<true>, uint8_t>(
      gram_bf16::kPkSmemBytes, w, bi, bj, c, p, s, kt, tile, k_splits, partials, stream);
}

extern "C" int kmerdb_sweep_bf16_ns(const void* w, const void* bi, const void* bj, void* c,
                                    int64_t p, int64_t s, int kt, int tile, int k_splits,
                                    void* partials, void* stream) {
  return launch_split<sweep_pk_bf16_kernel<false>, uint8_t>(
      gram_bf16::kPkSmemBytes, w, bi, bj, c, p, s, kt, tile, k_splits, partials, stream);
}

extern "C" int kmerdb_sweep_dotonly(const void* w, const void* bi, const void* bj, void* c,
                                    int64_t p, int64_t s, int kt, int tile, int k_splits,
                                    void* partials, void* stream) {
  return launch_split<sweep_dot_bf16_kernel<false>, uint16_t>(
      gram_bf16::kSmemBytes, w, bi, bj, c, p, s, kt, tile, k_splits, partials, stream);
}

extern "C" int kmerdb_sweep_dotonly_t(const void* w, const void* bi, const void* bj, void* c,
                                      int64_t p, int64_t s, int kt, int tile, int k_splits,
                                      void* partials, void* stream) {
  return launch_split<sweep_dot_bf16_kernel<true>, uint16_t>(
      gram_bf16::kSmemBytes, w, bi, bj, c, p, s, kt, tile, k_splits, partials, stream);
}

// The dynamic shared memory of a block, in bytes (ptxas reports static
// shared memory only): dotonly / dotonly_t, and bf16 / bf16_ns.
extern "C" int kmerdb_gram_bf16_smem_bytes() { return gram_bf16::kSmemBytes; }
extern "C" int kmerdb_gram_bf16_pk_smem_bytes() { return gram_bf16::kPkSmemBytes; }

extern "C" int kmerdb_sweep_dotonly_s8(const void* w, const void* bi, const void* bj, void* c,
                                       int64_t p, int64_t s, int kt, int tile, void* stream) {
  (void)w;   // the unpacked product takes no weights
  (void)kt;  // exact sums flushed every kFlushS8 patterns equal the K blocks' sum mod 2^32
  const int64_t blocks = n_blocks(s, tile);
  if (blocks == 0 || p == 0) return 0;
  const cudaError_t err = gram_u8::allow_smem(sweep_s8_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_s8_kernel<<<static_cast<unsigned>(blocks), gram_u8::kThreads, gram_u8::kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bi), static_cast<const int8_t*>(bj), static_cast<uint32_t*>(c), p,
      s, tile / kBlock);
  return static_cast<int>(cudaGetLastError());
}
