// Hopper's bf16 tensor cores through the warp-wide mma.sync, one m16n8k16
// tile: d += a * b, a 16 x 16 row-major, b 16 x 8 column-major, both bf16,
// d f32 16 x 8.  Lane (g, t) = (lane / 4, lane % 4) holds
//   a[0] = A[g][2t .. 2t+1]     a[1] = A[g+8][2t .. 2t+1]
//   a[2] = A[g][8+2t .. 8+2t+1] a[3] = A[g+8][8+2t .. 8+2t+1]
//   b[0] = B[2t .. 2t+1][g]     b[1] = B[8+2t .. 8+2t+1][g]
//   d[0], d[1] = D[g][2t], D[g][2t+1]      d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
// two bf16 values to a register, the lower K in the low half.
#pragma once

#include <cstdint>

namespace mma_bf16 {

__device__ __forceinline__ void m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mma_bf16
