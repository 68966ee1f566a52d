// The Gram variants of tools/kernel_sweep.py for Hopper: one packed or
// unpacked triangle Gram split into its parts, so that a time splits into
// unpack, product and weight scale.
//
// Replaces tools/kernel_sweep.py `build` (its pallas_call and the bodies
// body_int8, body_bf16, body_nodot and body_dotonly).  Every variant walks
// the same grid as gram_pk_tri.cu: one block of 256 threads per 128 x 128
// output block whose coarse tile (edge `tile`) lies on or below the
// diagonal, in the tri_coords order; the TPU's K grid axis (P / kt blocks)
// is a loop inside the block (bf16, bf16_ns, nodot, dotonly and dotonly_t:
// split over runs of whole K blocks, below).  Blocks above the coarse diagonal get
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
//               tensor cores, wgmma).
//   bf16_ns     the same without the weights.
//   nodot       the unpack alone: per K block, C_tile[x, y] += U_i[x, y] +
//               U_j[x, y] for x, y < tile, U the (kt, tile) block unpacked
//               b-major (row b * kt/8 + r is bit b of byte row r) from the
//               tile's columns of Bi and Bj.  Needs kt >= tile.
//               packed_block's staging with no product (NodotRows).
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
// dotonly_t on the bf16 ones (gram_bf16.cuh), their bounds there.  nodot
// runs bf16's staging unchanged (the packed cp.async ring, the expansion
// of all 8 bit planes of both operands into the wgmma layout, the
// barriers, the split grid) and in place of the wgmma adds the stage rows
// that are U rows into its accumulators: its time is the staging's, and
// bf16's less nodot's is the product's.  Its byte bound counts each
// operand once; a block reads its two 128-wide column slabs from L2 once,
// which is the staging it measures.  The variants exist to measure these
// parts against each other on the production block's grid.
//
// Split K (bf16, bf16_ns, nodot, dotonly, dotonly_t).  The triangle's 136 output
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

#include <cuda_runtime.h>

#include "gram_bf16.cuh"
#include "gram_pk.cuh"
#include "gram_u8.cuh"
#include "tri.cuh"

namespace {

constexpr int kBlock = 128;           // output block edge

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
  gram_bf16::packed_block<kWeighted>(smem, bi + run.k.row0, s, bj + run.k.col0, s, w, run.p0,
                                     run.n_st, run.st_kt, 1, run.out, run.ld_out, run.split);
}

// nodot's body on packed_stages, in place of the product: the expanded
// stage rows that are U rows of the block's output rows, added into the
// uint32 accumulators.  Output row x of the coarse tile (x0 + the block
// row) is U row x: bit x / kb of byte row x % kb of the K block, so stage
// (x % kb) / 16 of each K block holds it, at stage row 16 (x / kb) + x %
// 16.  The block's rows fall in 8 groups of 16 that share a stage; thread
// t owns row t / 16 of each group at the 8 columns of chunk t % 16, so in
// each stage every thread adds as many rows as every other, one 16-byte
// load an operand a row, and the barrier waits on no warp.  The
// unweighted expansion writes 1.0 (0x3F80) or 0, so bit 7 of a value is
// the value: the sums count in units of 0x80, with no conversion.
struct NodotRows {
  uint32_t acc[8][8];  // group m's row, the chunk's 8 columns; 0x80 a unit
  int st[8];           // the stage of a K block that holds group m
  int off[8];          // the thread's 16 bytes of group m in a stage

  __device__ __forceinline__ NodotRows(int x0, int kb) {
    const int r = threadIdx.x / 16;
    const int c = threadIdx.x % 16;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int x = x0 + 16 * m;  // the group's first U row
      st[m] = x % kb / gram_bf16::kPkRows;
      // stage row 16 (x / kb) + r: a multiple of 16 leaves the chunk's key
      off[m] = gram_bf16::ex_offset(r, c) + 128 * gram_bf16::kPkRows * (x / kb);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[m][e] = 0u;
    }
  }

  __device__ __forceinline__ void start(const gram_bf16::ExStage& ex, int j) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      if (st[m] != j) continue;
      const uint4 a = *reinterpret_cast<const uint4*>(ex.a + off[m]);
      const uint4 b = *reinterpret_cast<const uint4*>(ex.b + off[m]);
      const uint32_t u[4] = {(a.x & 0x00800080u) + (b.x & 0x00800080u),
                             (a.y & 0x00800080u) + (b.y & 0x00800080u),
                             (a.z & 0x00800080u) + (b.z & 0x00800080u),
                             (a.w & 0x00800080u) + (b.w & 0x00800080u)};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        acc[m][2 * w] += u[w] & 0xFFFFu;
        acc[m][2 * w + 1] += u[w] >> 16;
      }
    }
  }

  __device__ __forceinline__ void retire(bool, int) {}

  // out (+)= the sums
  __device__ __forceinline__ void write(uint32_t* __restrict__ out, int64_t ld_out,
                                        bool store) const {
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4* dst = reinterpret_cast<uint4*>(out + (16 * m + threadIdx.x / 16) * ld_out +
                                              8 * (threadIdx.x % 16) + 4 * h);
        uint4 v = make_uint4(acc[m][4 * h] >> 7, acc[m][4 * h + 1] >> 7, acc[m][4 * h + 2] >> 7,
                             acc[m][4 * h + 3] >> 7);
        if (!store) {
          const uint4 o = *dst;
          v = make_uint4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
        }
        *dst = v;
      }
  }
};

// nodot: packed_block's staging (gram_bf16::packed_stages, unweighted)
// over a SplitRun, NodotRows in place of the product.  Both operands are
// read at the output block's columns inside their coarse tiles: Bi at the
// row tile's, Bj at the column tile's.  w is unused.
__global__ void __launch_bounds__(gram_bf16::kThreads, gram_bf16::kMinBlocks)
sweep_nodot_kernel(const uint32_t* __restrict__ w, const uint8_t* __restrict__ bi,
                   const uint8_t* __restrict__ bj, uint32_t* __restrict__ c,
                   uint32_t* __restrict__ partials, int64_t p, int64_t s, int kt, int sub,
                   int n_blocks) {
  extern __shared__ __align__(16) uint8_t smem[];
  const SplitRun run(c, partials, p, s, kt, sub, n_blocks);
  const int64_t a_col = (static_cast<int64_t>(run.k.ci) * sub + run.k.sc) * kBlock;
  NodotRows body(run.k.sr * kBlock, kt / 8);
  gram_bf16::packed_stages<false>(smem, bi + a_col, s, bj + run.k.col0, s, w, run.p0, run.n_st,
                                  run.st_kt, 1, body);
  body.write(run.out, run.ld_out, run.split);
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
  cudaError_t err = gram_bf16::allow_smem_once<kKernel>(smem);
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

// bf16, bf16_ns, nodot, dotonly and dotonly_t take two more: k_splits, the runs
// of whole K blocks the grid cuts P into (1..P / kt), and `partials`,
// uint32[k_splits, n_blocks, 128, 128] scratch when k_splits > 1.  bf16's
// w must be 16-byte aligned; nodot needs kt >= tile.
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

extern "C" int kmerdb_sweep_nodot(const void* w, const void* bi, const void* bj, void* c,
                                  int64_t p, int64_t s, int kt, int tile, int k_splits,
                                  void* partials, void* stream) {
  if (kt < tile) return static_cast<int>(cudaErrorInvalidValue);  // a U row past the K block
  return launch_split<sweep_nodot_kernel, uint8_t>(
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
// shared memory only): dotonly / dotonly_t, and bf16 / bf16_ns / nodot and
// the bf16 engine's forms (gram_pk_bf16.cu).
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
