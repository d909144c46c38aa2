// Integrated binary matmul + BN + binarize + 32-channel pack (C4+C6).
//
// Replaces the TPU kernel
// repro/kernels/fused_conv_bn_binarize.py :: fused_matmul_bn_binarize
// (with the tile reduction of repro/kernels/xnor_popcount_matmul.py ::
// tile_counts as the inner loop below).
//
//   cnt[m, n]  = sum_w ww[w] * popc(a[m, w] ^ b[n, w])
//   bit[m, n]  = (cnt <= t[n]) ^ s[n]                      (Eqn 9, int form)
//   out[m, g]  = sum_j bit[m, 32g + j] << j                (LSB-first)
//
// a (M, W), b (N, W), ww (W,) or null (all ones), t (N,) int32, s (N,) uint8
// -> out (M, ceil(N/32)) int32.  Pad channels (n >= N) give bit 0.
//
// Bound on the H100: on the main path (packed_dense at batch 8) bytes — the
// filter matrix b is read once and dwarfs everything else, 4096 x 288 words
// for AlexNet fc6; under cuda_popcount's im2col convs, operations (2·M·N·32·W
// at the int8 tensor-core rate).
//
// Two kernels, chosen by the wrapper from what it is given:
//
// * No word weights (every dense layer, every conv but the first under
//   cuda_popcount): the +-1 mainloop of pm1_gemm.cuh on the int8 tensor
//   cores, cnt = (32·W - dot) / 2 exactly (pad bits agree and count 0),
//   with a threshold-and-pack epilogue.  Many rows (64 x 64 wgmma tiles,
//   each 32 columns of a warp one output word): each lane thresholds its 8
//   accumulators of a row, the 4 lanes of a quad OR their bits together by
//   __shfl_xor_sync, and one lane stores the word.  Few rows (fc6/fc7 at
//   batch 8), or a word axis split over a cluster: the leader's reduced
//   counts in shared memory, lane j thresholding channel 32g + j and
//   __ballot_sync giving the word.  One 4-byte store a word either way.
// * Word weights (the first layer's bit planes under cuda_popcount): the
//   CUDA-core kernel below stays the exact path, as K1 keeps its weighted
//   kernel.  One warp per (row m, group g of 32 output channels), lane j
//   owns channel 32g + j, so the threshold + pack epilogue is a single
//   __ballot_sync whose bit j is lane j's bit.  A block of 8 warps takes 8
//   rows and one channel group; each 32-word step of the reduction stages
//   the group's 32 x 32 filter tile (transposed, padded to 33 against bank
//   conflicts), the 8 a-row slices and the word weights in shared memory,
//   so every b word is read from device memory once per 8 rows, and the
//   inner loop is a broadcast shared load of a, a conflict-free shared
//   load of b, a __popc and a multiply-add.

#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_gemm.cuh"

namespace {

constexpr int kWarps = 8;      // rows per block
constexpr int kTile = 32;      // reduction words per step

__global__ void fused_matmul_bn_binarize_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ ww, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ s, int32_t* __restrict__ out, int M, int N,
    int W) {
  __shared__ int32_t sb[kTile][33];
  __shared__ int32_t sa[kWarps][kTile];
  __shared__ int32_t sww[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.y;
  const int m = blockIdx.x * kWarps + warp;
  const int n = g * 32 + lane;
  const int nw = (N + 31) / 32;

  int cnt = 0;
  for (int w0 = 0; w0 < W; w0 += kTile) {
    // Filter tile: 32 channels x kTile words; consecutive threads read
    // consecutive words of one filter row (coalesced).
    for (int idx = threadIdx.x; idx < 32 * kTile; idx += blockDim.x) {
      const int row = idx / kTile;
      const int k = idx - row * kTile;
      const int gn = g * 32 + row;
      const int gw = w0 + k;
      sb[k][row] = (gn < N && gw < W) ? b[(long long)gn * W + gw] : 0;
    }
    {
      const int row = threadIdx.x / kTile;
      const int k = threadIdx.x - row * kTile;
      const int gm = blockIdx.x * kWarps + row;
      const int gw = w0 + k;
      sa[row][k] = (gm < M && gw < W) ? a[(long long)gm * W + gw] : 0;
    }
    if (threadIdx.x < kTile) {
      const int gw = w0 + threadIdx.x;
      sww[threadIdx.x] = gw < W ? ww[gw] : 0;
    }
    __syncthreads();
    const int steps = min(kTile, W - w0);
    for (int k = 0; k < steps; ++k) {
      const int c = __popc(sa[warp][k] ^ sb[k][lane]);
      cnt += sww[k] * c;
    }
    __syncthreads();
  }

  const bool bit = n < N && ((cnt <= t[n]) != (s[n] != 0));
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0 && m < M) out[(long long)m * nw + g] = (int32_t)word;
}

struct ThresholdPackEpilogue {
  int32_t* out;
  const int32_t* t;
  const uint8_t* s;
  int M, N, W;

  // Each 4 n8 tiles of a warp are the 32 channels of one output word (nb
  // is a multiple of 32): lane (g, tq) holds channels 8j + 2tq + e of rows
  // g and g + 8, so its bits sit at 8j + 2tq + e of the word.
  template <class T>
  __device__ __forceinline__ void registers(
      const int (&acc)[T::kMT][T::kNT][4], int corr, int mb, int nb, int g,
      int tq) const {
    static_assert(T::kNT % 4 == 0, "a warp's columns are whole words");
    const int nw = (N + 31) / 32;
    const int total = 32 * W + corr;   // cnt = (32·W - (acc - corr)) / 2
#pragma unroll
    for (int wq = 0; wq < T::kNT / 4; ++wq) {
      const int nq = nb + 32 * wq;
      int thr[4][2];
      bool flip[4][2], ok[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nq + 8 * j + 2 * tq + e;
          ok[j][e] = n < N;
          thr[j][e] = ok[j][e] ? t[n] : 0;
          flip[j][e] = ok[j][e] && s[n] != 0;
        }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cnt = (total - acc[i][4 * wq + j][2 * h + e]) >> 1;
              const bool bit =
                  ok[j][e] && ((cnt <= thr[j][e]) != flip[j][e]);
              word |= (uint32_t)bit << (8 * j + 2 * tq + e);
            }
          word |= __shfl_xor_sync(0xffffffffu, word, 1);
          word |= __shfl_xor_sync(0xffffffffu, word, 2);
          const int m = mb + 16 * i + g + 8 * h;
          if (tq == h && m < M && nq / 32 < nw) {
            out[(long long)m * nw + nq / 32] = (int32_t)word;
          }
        }
    }
  }

  // From the reduced dots: a warp per (row, 32-channel word), lane j
  // thresholds channel 32·gw + j.
  template <class T, class R>
  __device__ __forceinline__ void shared(const R& dot, int x0, int y0) const {
    static_assert(R::kCols % 32 == 0, "whole output words a tile");
    const int mb = T::kSwap ? y0 : x0;
    const int nb = T::kSwap ? x0 : y0;
    const int nw = (N + 31) / 32;
    const int lane = threadIdx.x & 31;
    constexpr int kWords = R::kCols / 32;
    for (int p = threadIdx.x >> 5; p < R::kRows * kWords;
         p += T::kThreads / 32) {
      const int r = p / kWords;
      const int gw = p - r * kWords;
      const int m = mb + r;
      if (m >= M) continue;                      // warp-uniform
      const int n = nb + 32 * gw + lane;
      const int cnt = (32 * W - dot(r, 32 * gw + lane)) >> 1;
      const bool bit = n < N && ((cnt <= t[n]) != (s[n] != 0));
      const unsigned word = __ballot_sync(0xffffffffu, bit);
      const int wi = nb / 32 + gw;
      if (lane == 0 && wi < nw) out[(long long)m * nw + wi] = (int32_t)word;
    }
  }
};

}  // namespace

// Word weights only (the CUDA-core kernel); without them the wrapper calls
// launch_fused_matmul_bn_binarize_pm1.
extern "C" int launch_fused_matmul_bn_binarize(
    const void* a, const void* b, const void* ww, const void* t,
    const void* s, void* out, int M, int N, int W, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (ww == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kWarps - 1) / kWarps, (N + 31) / 32);
  dim3 block(kWarps * 32);
  fused_matmul_bn_binarize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)ww,
      (const int32_t*)t, (const uint8_t*)s, (int32_t*)out, M, N, W);
  return (int)cudaGetLastError();
}

// No word weights: the +-1 tensor-core mainloop; tile, clusters: the
// plan of kernels/pm1_gemm.py plan_pm1.
extern "C" int launch_fused_matmul_bn_binarize_pm1(
    const void* a, const void* b, const void* t, const void* s, void* out,
    int M, int N, int W, int tile, int clusters, void* stream) {
  const ThresholdPackEpilogue epi{(int32_t*)out, (const int32_t*)t,
                                  (const uint8_t*)s, M, N, W};
  return (int)phonebit::pm1::launch_tile(
      tile, (const int32_t*)a, (const int32_t*)b, M, N, W, epi, clusters,
      (cudaStream_t)stream);
}
