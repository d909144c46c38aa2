// +-1 dot products of packed words on the tensor cores (int8 mma.sync).
//
// Replaces the TPU kernel
// repro/kernels/mxu_pm1_matmul.py :: mxu_pm1_matmul (with _unpack_pm1): the
// TPU unpacks packed words to bf16 +-1 in VMEM and feeds its matrix unit.
//
//   dot[m, n] = sum_k pm1(a[m], k) * pm1(b[n], k) - pad_bits
//
// over all 32·W bits of a (M, W) and b (N, W) int32, bit k of word k / 32
// LSB-first, pm1 = bit ? +1 : -1, and pad_bits = 32·W - k_valid: pad bits
// agree in both operands and add +1 each, so the correction is on the
// padded width of the tensors.  -> (M, N) int32.
//
// Bound on the H100: at AlexNet's conv2 (M = 5,832, N = 256, W = 75)
// operations — 2·M·N·32·W = 7.2e9 take 3.6 us at the int8 tensor-core rate,
// the ~7.8 MB of packed operands and int32 result 2.3 us; at fc6 (M = 8,
// N = 4,096, W = 288) bytes, the 4.7 MB filter matrix.
// Design: one packed word is exactly one k32 step of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, and int32 accumulation makes the
// dot exact at every width (the reference's float32 accumulation is exact
// only to 2^24).  A block of 128 threads (4 warps, 2 x 2) computes a 64 x 64
// output tile, each warp a 32 x 32 tile (2 x 4 mma tiles, 32 int32
// accumulators a thread).  Each step stages 4 words of the block's 64 a rows
// and 64 b rows: every thread unpacks 4 words, 8 nibbles each, to +-1 bytes
// (two 16-byte shared stores a word), into rows padded by 16 bytes so that
// the fragment loads, one 32-bit shared load per register, hit 32 distinct
// banks.  Words past W unpack to 0 bytes, which add nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                      // output rows per block
constexpr int kBN = 64;                      // output columns per block
constexpr int kBKW = 4;                      // packed words per step
constexpr int kRowBytes = kBKW * 32 + 16;    // one unpacked row, padded
constexpr int kThreads = 128;                // 4 warps, 2 x 2
constexpr int kWM = 32;                      // warp tile rows
constexpr int kWN = 32;                      // warp tile columns
constexpr int kMT = kWM / 16;                // m16 tiles per warp
constexpr int kNT = kWN / 8;                 // n8 tiles per warp

// Bits 0..3 of q -> bytes 0..3 of +-1 (bit 1 -> 0x01, bit 0 -> 0xFF).  The
// multiply spreads bit i to bit 8i (the partial products do not overlap);
// y · 0xFE stays inside each byte.
__device__ __forceinline__ uint32_t expand_nibble(uint32_t q) {
  const uint32_t y = (q * 0x00204081u) & 0x01010101u;
  return ~(y * 0xFEu);
}

__device__ __forceinline__ void unpack_word(uint32_t w, bool valid,
                                            uint8_t* dst) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
  if (valid) {
    lo = make_uint4(expand_nibble(w & 15u), expand_nibble((w >> 4) & 15u),
                    expand_nibble((w >> 8) & 15u),
                    expand_nibble((w >> 12) & 15u));
    hi = make_uint4(expand_nibble((w >> 16) & 15u),
                    expand_nibble((w >> 20) & 15u),
                    expand_nibble((w >> 24) & 15u), expand_nibble(w >> 28));
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads) mxu_pm1_matmul_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    int32_t* __restrict__ out, int M, int N, int W, int pad_bits) {
  __shared__ __align__(16) uint8_t sa[kBM * kRowBytes];
  __shared__ __align__(16) uint8_t sb[kBN * kRowBytes];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // mma groupID
  const int t = lane & 3;           // mma threadID_in_group
  const int wm = (warp >> 1) * kWM;
  const int wn = (warp & 1) * kWN;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int w0 = 0; w0 < W; w0 += kBKW) {
    for (int idx = tid; idx < kBM * kBKW; idx += kThreads) {
      const int row = idx / kBKW;
      const int kw = idx - row * kBKW;
      const int gm = m0 + row;
      const int gw = w0 + kw;
      const bool ok = gm < M && gw < W;
      unpack_word(ok ? (uint32_t)a[(long long)gm * W + gw] : 0u, ok,
                  sa + row * kRowBytes + kw * 32);
    }
    for (int idx = tid; idx < kBN * kBKW; idx += kThreads) {
      const int row = idx / kBKW;
      const int kw = idx - row * kBKW;
      const int gn = n0 + row;
      const int gw = w0 + kw;
      const bool ok = gn < N && gw < W;
      unpack_word(ok ? (uint32_t)b[(long long)gn * W + gw] : 0u, ok,
                  sb + row * kRowBytes + kw * 32);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      // A fragment (row-major 16 x 32): a0 row g, k 4t..4t+3; a1 row g+8;
      // a2, a3 the same rows at k + 16.  B fragment (col-major 32 x 8, b
      // stored as rows of n): b0 n = g, k 4t..4t+3; b1 at k + 16.
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint8_t* r0 = sa + (wm + 16 * i + g) * kRowBytes + kw * 32 +
                            4 * t;
        const uint8_t* r1 = r0 + 8 * kRowBytes;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r1);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r1 + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint8_t* r = sb + (wn + 8 * j + g) * kRowBytes + kw * 32 +
                           4 * t;
        bf[j][0] = lds32(r);
        bf[j][1] = lds32(r + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Accumulator fragment (16 x 8): c0, c1 row g, columns 2t, 2t+1; c2, c3
  // row g + 8.
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gm = m0 + wm + 16 * i + g + (r >= 2 ? 8 : 0);
        const int gn = n0 + wn + 8 * j + 2 * t + (r & 1);
        if (gm < M && gn < N) {
          out[(long long)gm * N + gn] = acc[i][j][r] - pad_bits;
        }
      }
}

}  // namespace

extern "C" int launch_mxu_pm1_matmul(const void* a, const void* b, void* out,
                                     int M, int N, int W, int pad_bits,
                                     void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  mxu_pm1_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, M, N, W,
      pad_bits);
  return (int)cudaGetLastError();
}
