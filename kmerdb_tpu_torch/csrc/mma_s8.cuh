// Hopper's int8 tensor cores through the warp-wide mma.sync, one
// m16n8k32 tile: d += a * b, a 16 x 32 row-major, b 32 x 8 column-major,
// d s32 16 x 8, both operands s8 (the default) or, with kUnsigned, both u8
// (bytes 128..255 count as 128..255, not as negative).  Lane (g, t) =
// (lane / 4, lane % 4) holds
//   a[0] = A[g][4t .. 4t+3]       a[1] = A[g+8][4t .. 4t+3]
//   a[2] = A[g][16+4t .. 16+4t+3] a[3] = A[g+8][16+4t .. 16+4t+3]
//   b[0] = B[4t .. 4t+3][g]       b[1] = B[16+4t .. 16+4t+3][g]
//   d[0], d[1] = D[g][2t], D[g][2t+1]      d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
// four 8-bit values to a register, the lowest K in the lowest byte.  No
// .satfinite: the s32 sum is not clamped.
#pragma once

#include <cstdint>

namespace mma_s8 {

template <bool kUnsigned = false>
__device__ __forceinline__ void m16n8k32(uint32_t (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (kUnsigned) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

}  // namespace mma_s8
