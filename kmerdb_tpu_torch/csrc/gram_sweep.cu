// The Gram variants of tools/kernel_sweep.py for Hopper: one packed or
// unpacked triangle Gram split into its parts, so that a time splits into
// unpack, product and weight scale.
//
// Replaces tools/kernel_sweep.py `build` (its pallas_call and the bodies
// body_int8, body_bf16, body_nodot and body_dotonly).  Every variant walks
// the same grid as gram_pk_tri.cu: one block of 256 threads per 128 x 128
// output block whose coarse tile (edge `tile`) lies on or below the
// diagonal, in the tri_coords order; the TPU's K grid axis (P / kt blocks)
// is a loop inside the block.  Blocks above the coarse diagonal get no
// thread block, so C keeps its contents there, as the aliased TPU output
// does.  c is uint32[S, S] (int32 storage), updated in place; w uint32[P].
//
//   int8        C += Bi^T diag(w & 0x7F) Bj on packed uint8[P/8, S] operands:
//               gram_pk.cuh's block at one limb, the production s8 body
//               (int8 tensor cores, mma.sync).
//   bf16        C += Bi^T diag(w & 0xFF) Bj on packed operands unpacked to
//               bf16, each product summed in f32 over a K block, the sum
//               flushed into C as an integer at the end of the block
//               (below kt * 255 < 2^24: exact).
//   bf16_ns     the same without the weights.
//   nodot       the unpack alone: per K block, C_tile[x, y] += U_i[x, y] +
//               U_j[x, y] for x, y < tile, U the (kt, tile) block unpacked
//               b-major (row b * kt/8 + r is bit b of byte row r) from the
//               tile's columns of Bi and Bj.  Needs kt >= tile.
//   dotonly     C += Bi^T Bj on unpacked bf16[P, S] operands, f32 per K
//               block, flushed as in bf16 (exact for integer operands whose
//               block sums stay below 2^24, the tool's 0/1 among them).
//   dotonly_t   the same with Bi laid out bf16[S, P].
//   dotonly_s8  C += Bi^T Bj on unpacked int8[P, S] operands: gram_u8.cuh's
//               block in its signed form (int8 tensor cores, mma.sync
//               .s8.s8), its exact s32 sums added into C mod 2^32 every
//               2^16 patterns, which equals adding each K block's sum.
//
// What bounds them.  Products: the int8 and dotonly_s8 bodies run on the
// int8 tensor cores (gram_pk.cuh, gram_u8.cuh: 8 warps of 64 x 32 outputs,
// their bounds there); the bf16 bodies run f32 FMA on the CUDA cores, far
// under the tensor cores' rates, with every operand of the inner loop in
// shared memory and registers (each thread owns an 8 x 8 block of
// outputs).  nodot moves bytes and unpacks them; its only arithmetic is the
// add.  The variants exist to measure these parts against each other on
// the production block's grid; the bf16 bodies on the tensor cores are
// later work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram_pk.cuh"
#include "gram_u8.cuh"
#include "tri.cuh"

namespace {

constexpr int kBlock = 128;           // output block edge
constexpr int kThreads = 256;         // 16 x 16 threads, 8 x 8 outputs each
constexpr int kStage = 64;            // patterns staged at a time
constexpr int kStageRows8 = kStage / 8;   // packed rows a stage

enum Variant { kBf16, kBf16Ns, kNodot, kDotonly, kDotonlyT };

// The output block of blockIdx.x: its row and column in C, and its place
// (sr, sc) inside its coarse tile.
struct Coords {
  int64_t row0, col0;
  int sr, sc, ci, cj;
};

__device__ __forceinline__ Coords coords(int sub) {
  Coords k;
  const int per_tile = sub * sub;
  tri_coords(blockIdx.x / per_tile, k.ci, k.cj);
  const int s = blockIdx.x % per_tile;
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

struct SmemBf16 {
  __align__(16) __nv_bfloat16 a[kStage][kBlock];  // row operand, staged patterns
  __align__(16) __nv_bfloat16 b[kStage][kBlock];  // column operand
  float w[kStage];                                // stage weights (bf16)
};

// The bf16 family.  Stage patterns: for the packed variants the 64
// patterns (bit b, byte row r0 + r), r < 8, held at a[b * 8 + r]; for the
// unpacked ones the rows k0 .. k0 + 63 of the K block.
template <int V>
__global__ void __launch_bounds__(kThreads)
sweep_bf16_kernel(const uint32_t* __restrict__ w, const void* __restrict__ bi_,
                  const void* __restrict__ bj_, uint32_t* __restrict__ c, int64_t p,
                  int64_t s, int kt, int sub) {
  __shared__ SmemBf16 sm;
  constexpr bool kPacked = V == kBf16 || V == kBf16Ns || V == kNodot;
  const Coords k = coords(sub);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int kb = kt / 8;
  // nodot adds U[x, y] of the tile's columns y: both operands are read at
  // the output block's columns inside their coarse tiles
  const int64_t a_col = V == kNodot ? (static_cast<int64_t>(k.ci) * sub + k.sc) * kBlock : k.row0;
  const int64_t b_col = k.col0;

  uint32_t acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0u;

  for (int64_t kblk = 0; kblk < p; kblk += kt) {
    float part[8][8];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n) part[m][n] = 0.0f;

    for (int st = 0; st < (kPacked ? kb : kt); st += kPacked ? kStageRows8 : kStage) {
      __syncthreads();  // the previous stage's readers are done
      if constexpr (kPacked) {
        const uint8_t* bi = static_cast<const uint8_t*>(bi_);
        const uint8_t* bj = static_cast<const uint8_t*>(bj_);
        const int64_t r_base = kblk / 8 + st;  // first byte row of the stage
        if (V == kBf16 && tid < kStage) {
          // weight of (bit b, row st + r): pk_weight_order of the K block
          const int b = tid / kStageRows8;
          const int r = tid % kStageRows8;
          sm.w[tid] = static_cast<float>(w[kblk + static_cast<int64_t>(b) * kb + st + r] & 0xFFu);
        }
        if (V == kBf16) __syncthreads();
        for (int it = tid; it < kStageRows8 * kBlock; it += kThreads) {
          const int r = it / kBlock;
          const int col = it % kBlock;
          const uint32_t xa = bi[(r_base + r) * s + a_col + col];
          const uint32_t xb = bj[(r_base + r) * s + b_col + col];
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const float scale = V == kBf16 ? sm.w[b * kStageRows8 + r] : 1.0f;
            sm.a[b * kStageRows8 + r][col] = __float2bfloat16(((xa >> b) & 1u) ? scale : 0.0f);
            sm.b[b * kStageRows8 + r][col] = __float2bfloat16(((xb >> b) & 1u) ? 1.0f : 0.0f);
          }
        }
      } else {
        const __nv_bfloat16* bi = static_cast<const __nv_bfloat16*>(bi_);
        const __nv_bfloat16* bj = static_cast<const __nv_bfloat16*>(bj_);
        const int64_t k0 = kblk + st;
        // 16-byte loads: 8 bf16 of one row
        for (int it = tid; it < kStage * kBlock / 8; it += kThreads) {
          const int row = it / (kBlock / 8);
          const int col = (it % (kBlock / 8)) * 8;
          *reinterpret_cast<uint4*>(&sm.b[row][col]) =
              *reinterpret_cast<const uint4*>(bj + (k0 + row) * s + b_col + col);
          if (V == kDotonly) {
            *reinterpret_cast<uint4*>(&sm.a[row][col]) =
                *reinterpret_cast<const uint4*>(bi + (k0 + row) * s + a_col + col);
          }
        }
        if (V == kDotonlyT) {
          // bi is [S, P]: 8 consecutive patterns of one sample a load
          for (int it = tid; it < kBlock * kStage / 8; it += kThreads) {
            const int col = it / (kStage / 8);
            const int row = (it % (kStage / 8)) * 8;
            const uint4 raw = *reinterpret_cast<const uint4*>(bi + (a_col + col) * p + k0 + row);
            const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) sm.a[row + e][col] = v[e];
          }
        }
      }
      __syncthreads();

      if constexpr (V == kNodot) {
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
      } else {
#pragma unroll 4
        for (int q = 0; q < kStage; ++q) {
          float av[8], bv[8];
          load4(&sm.a[q][ty * 4], av, 0);
          load4(&sm.a[q][64 + ty * 4], av, 4);
          load4(&sm.b[q][tx * 4], bv, 0);
          load4(&sm.b[q][64 + tx * 4], bv, 4);
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int n = 0; n < 8; ++n) part[m][n] = fmaf(av[m], bv[n], part[m][n]);
        }
      }
    }
    if constexpr (V != kNodot) {
      // the K block's sum: an integer below 2^24, exact in f32
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] += static_cast<uint32_t>(__float2int_rz(part[m][n]));
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
  const Coords k = coords(sub);
  gram_u8::block<false>(smem, reinterpret_cast<const uint8_t*>(bi) + k.row0,
                        reinterpret_cast<const uint8_t*>(bj) + k.col0, s, nullptr, p, 1,
                        gram_u8::kFlushS8, c + k.row0 * s + k.col0, s);
}

// int8: the production block (gram_pk.cuh) at one 7-bit limb, Bi != Bj.
__global__ void __launch_bounds__(gram_pk::kThreads, gram_pk::kMinBlocks)
sweep_int8_kernel(const uint32_t* __restrict__ w, const uint8_t* __restrict__ bi,
                  const uint8_t* __restrict__ bj, uint32_t* __restrict__ c, int64_t p,
                  int64_t s, int kt, int sub) {
  __shared__ gram_pk::Smem sm;
  const Coords k = coords(sub);
  gram_pk::block(sm, bi, s, bj, s, w, p / 8, 1, kt / 8, k.row0, k.col0, c + k.row0 * s + k.col0,
                 s);
}

int64_t n_blocks(int64_t s, int tile) {
  const int64_t nt = s / tile;
  const int64_t sub = tile / kBlock;
  return nt * (nt + 1) / 2 * sub * sub;
}

template <int V>
int launch_bf16(const void* w, const void* bi, const void* bj, void* c, int64_t p, int64_t s,
                int kt, int tile, void* stream) {
  const int64_t blocks = n_blocks(s, tile);
  if (blocks == 0 || p == 0) return 0;
  sweep_bf16_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(w), bi, bj, static_cast<uint32_t*>(c), p, s, kt,
      tile / kBlock);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int kmerdb_sweep_bf16(const void* w, const void* bi, const void* bj, void* c, int64_t p,
                                 int64_t s, int kt, int tile, void* stream) {
  return launch_bf16<kBf16>(w, bi, bj, c, p, s, kt, tile, stream);
}

extern "C" int kmerdb_sweep_bf16_ns(const void* w, const void* bi, const void* bj, void* c,
                                    int64_t p, int64_t s, int kt, int tile, void* stream) {
  return launch_bf16<kBf16Ns>(w, bi, bj, c, p, s, kt, tile, stream);
}

extern "C" int kmerdb_sweep_nodot(const void* w, const void* bi, const void* bj, void* c,
                                  int64_t p, int64_t s, int kt, int tile, void* stream) {
  return launch_bf16<kNodot>(w, bi, bj, c, p, s, kt, tile, stream);
}

extern "C" int kmerdb_sweep_dotonly(const void* w, const void* bi, const void* bj, void* c,
                                    int64_t p, int64_t s, int kt, int tile, void* stream) {
  return launch_bf16<kDotonly>(w, bi, bj, c, p, s, kt, tile, stream);
}

extern "C" int kmerdb_sweep_dotonly_t(const void* w, const void* bi, const void* bj, void* c,
                                      int64_t p, int64_t s, int kt, int tile, void* stream) {
  return launch_bf16<kDotonlyT>(w, bi, bj, c, p, s, kt, tile, stream);
}

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
