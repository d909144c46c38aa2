// Shared device helpers of the int8 tensor-core count kernels (K1, K3, and
// K2 and K6 through pm1_gemm.cuh's mainloop): packed words to the byte
// operands of mma.sync.m16n8k32, and the two products they feed.
//
// One packed word is one k32 step: bit j of the word is byte k = j of the
// step.  Two operand forms:
//   * +-1: bit 1 -> +1 (0x01), bit 0 -> -1 (0xFF), s8.  For words a, b over
//     all 32 bits, popc(a ^ b) = (32 - dot+-1) / 2.
//   * plane bytes: 8 plane words (plane p weighs 2^p) -> 32 unsigned bytes,
//     byte j = sum_p 2^p * bit j of plane p, u8.  Against filters whose 8
//     planes are copies of one sign word s (+-1 bytes above),
//     sum_p 2^p popc(x_p ^ s) = 255 * popc(s) - dot(u8, s8).

#pragma once

#include <cstdint>

namespace phonebit {

// Bits 0..3 of q -> bytes 0..3 of +-1 (bit 1 -> 0x01, bit 0 -> 0xFF).  The
// multiply spreads bit i to bit 8i (the partial products do not overlap);
// y * 0xFE stays inside each byte.
__device__ __forceinline__ uint32_t expand_nibble(uint32_t q) {
  const uint32_t y = (q * 0x00204081u) & 0x01010101u;
  return ~(y * 0xFEu);
}

// The two registers of one operand row of an m16n8k32 fragment from one
// packed word: bytes 4t..4t+3 (lo) and 16+4t..16+4t+3 (hi) as +-1.
__device__ __forceinline__ void pm1_pair(uint32_t w, int t, uint32_t& lo,
                                         uint32_t& hi) {
  lo = expand_nibble((w >> (4 * t)) & 15u);
  hi = expand_nibble((w >> (16 + 4 * t)) & 15u);
}

// The same two registers under a permutation of the word's bits, at 3
// instructions a register instead of pm1_pair's 6: lo takes bits t, t + 8,
// t + 16, t + 24 (bytes 0..3), hi bits t + 4, t + 12, t + 20, t + 28, so a
// shift and a mask give 0/1 bytes (1 where the bit is 0) and one multiply-
// add their +-1 bytes (0x01 + 0xFE·z, no carry).  Over the quad's threads
// t = 0..3 every bit of the word lands on exactly one k of the k32 step: a
// product whose two operands both take this form is the same dot, summed in
// another order.  Mixing it with pm1_pair or natural byte order is wrong.
__device__ __forceinline__ void pm1_pair_strided(uint32_t w, int t,
                                                 uint32_t& lo, uint32_t& hi) {
  const uint32_t z = ~w;
  lo = ((z >> t) & 0x01010101u) * 0xFEu + 0x01010101u;
  hi = ((z >> (t + 4)) & 0x01010101u) * 0xFEu + 0x01010101u;
}

// Byte q of 8 plane words, transposed: returns bytes 8q..8q+7 of the 32
// plane bytes (bit positions 8q..8q+7), low word first.  Row p of the 8 x 8
// bit matrix is byte q of plane p; three delta swaps transpose it (bit
// 8i + j <-> 8j + i).
__device__ __forceinline__ uint2 plane_bytes8(const uint32_t (&w)[8],
                                              int q) {
  const uint32_t sel = (uint32_t)q | ((uint32_t)(q + 4) << 4);
  const uint32_t lo = __byte_perm(__byte_perm(w[0], w[1], sel),
                                  __byte_perm(w[2], w[3], sel), 0x5410);
  const uint32_t hi = __byte_perm(__byte_perm(w[4], w[5], sel),
                                  __byte_perm(w[6], w[7], sel), 0x5410);
  uint64_t x = ((uint64_t)hi << 32) | lo;
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return make_uint2((uint32_t)x, (uint32_t)(x >> 32));
}

// d += a (16 x 32, row) * b (32 x 8, col), int32 accumulation.
// A fragment: a0 row g, k 4t..4t+3; a1 row g + 8; a2, a3 the same rows at
// k + 16.  B fragment: b0 column g, k 4t..4t+3; b1 at k + 16.  C fragment:
// c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8.
__device__ __forceinline__ void mma_s8s8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kPlanes>
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  if (kPlanes) {
    mma_u8s8(d, a, b);
  } else {
    mma_s8s8(d, a, b);
  }
}

}  // namespace phonebit
