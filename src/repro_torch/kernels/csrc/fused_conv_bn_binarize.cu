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
// for AlexNet fc6; under cuda_popcount's im2col convs, the popcounts.
// Design: one warp per (row m, group g of 32 output channels), lane j owns
// channel 32g + j, so the threshold + pack epilogue is a single
// __ballot_sync whose bit j is lane j's bit — the packed word comes out of
// the register file with no shuffle.  A block of 8 warps takes 8 rows and
// one channel group; each 32-word step of the reduction stages the group's
// 32 x 32 filter tile (transposed, padded to 33 against bank conflicts),
// the 8 a-row slices and the word weights in shared memory, so every b
// word is read from device memory once per 8 rows, and the inner loop is a
// broadcast shared load of a, a conflict-free shared load of b, and a
// __popc.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;      // rows per block
constexpr int kTile = 32;      // reduction words per step

template <bool kWeighted>
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
    if (kWeighted && threadIdx.x < kTile) {
      const int gw = w0 + threadIdx.x;
      sww[threadIdx.x] = gw < W ? ww[gw] : 0;
    }
    __syncthreads();
    const int steps = min(kTile, W - w0);
    for (int k = 0; k < steps; ++k) {
      const int c = __popc(sa[warp][k] ^ sb[k][lane]);
      cnt += kWeighted ? sww[k] * c : c;
    }
    __syncthreads();
  }

  const bool bit = n < N && ((cnt <= t[n]) != (s[n] != 0));
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0 && m < M) out[(long long)m * nw + g] = (int32_t)word;
}

}  // namespace

extern "C" int launch_fused_matmul_bn_binarize(
    const void* a, const void* b, const void* ww, const void* t,
    const void* s, void* out, int M, int N, int W, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((M + kWarps - 1) / kWarps, (N + 31) / 32);
  dim3 block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  if (ww != nullptr) {
    fused_matmul_bn_binarize_kernel<true><<<grid, block, 0, st>>>(
        (const int32_t*)a, (const int32_t*)b, (const int32_t*)ww,
        (const int32_t*)t, (const uint8_t*)s, (int32_t*)out, M, N, W);
  } else {
    fused_matmul_bn_binarize_kernel<false><<<grid, block, 0, st>>>(
        (const int32_t*)a, (const int32_t*)b, nullptr, (const int32_t*)t,
        (const uint8_t*)s, (int32_t*)out, M, N, W);
  }
  return (int)cudaGetLastError();
}
