// Weighted xor-popcount count matmul (paper Eqn 1; Eqn 2 with word weights).
//
// Replaces the TPU kernel
// repro/kernels/xnor_popcount_matmul.py :: xnor_popcount_matmul (its tile
// reduction tile_counts).
//
//   cnt[m, n] = sum_w ww[w] * popc(a[m, w] ^ b[n, w])
//
// a (M, W), b (N, W) int32, ww (W,) int32 or null (all ones) -> (M, N) int32.
//
// Bound on the H100: operations.  At AlexNet's conv1 under cuda_pm1 (im2col
// rows M = 8 x 55 x 55 = 24,200, N = 96 filters, W = 11 x 11 x 8 = 968 words)
// it is 2.25e9 weighted popcounts on the CUDA cores against 94 MB of
// patches, read once.  __popc issues at 16 a clock on each SM, a quarter of
// the integer add rate, so the popcount pipe is the limit.
// Design: a block of 128 threads computes a 64 x 32 output tile, each
// thread a 4 x 4 register tile (rows ty + 16i, columns tx + 8j: a warp's
// shared loads are then broadcasts or consecutive words).  Each 32-word step
// of the reduction stages the block's 64 a rows and 32 b rows in shared
// memory, word-major and padded by one word against bank conflicts, so every
// a word comes from device memory once per 32 columns and every b word once
// per 64 rows.  The inner loop is 8 shared loads and 16 xor + __popc + add
// (a multiply-add with word weights) per word, the sum in int32 registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                 // output rows per block
constexpr int kBN = 32;                 // output columns per block
constexpr int kBK = 32;                 // reduction words per step
constexpr int kTX = 8;                  // threads along n
constexpr int kTY = 16;                 // threads along m
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBM / kTY;          // register tile rows (4)
constexpr int kRN = kBN / kTX;          // register tile columns (4)

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads) xnor_popcount_matmul_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ ww, int32_t* __restrict__ out, int M, int N,
    int W) {
  __shared__ int32_t sa[kBK][kBM + 1];
  __shared__ int32_t sb[kBK][kBN + 1];
  __shared__ int32_t sww[kBK];

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  int acc[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += kBK) {
    // Consecutive threads read consecutive words of one row (coalesced) and
    // store them down one column of the word-major slab (stride kBM + 1:
    // 32 distinct banks).
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int row = idx / kBK;
      const int k = idx - row * kBK;
      const int gm = m0 + row;
      const int gw = w0 + k;
      sa[k][row] = (gm < M && gw < W) ? a[(long long)gm * W + gw] : 0;
    }
    for (int idx = tid; idx < kBN * kBK; idx += kThreads) {
      const int row = idx / kBK;
      const int k = idx - row * kBK;
      const int gn = n0 + row;
      const int gw = w0 + k;
      sb[k][row] = (gn < N && gw < W) ? b[(long long)gn * W + gw] : 0;
    }
    if (kWeighted && tid < kBK) {
      sww[tid] = w0 + tid < W ? ww[w0 + tid] : 0;
    }
    __syncthreads();
    const int steps = min(kBK, W - w0);
#pragma unroll 4
    for (int k = 0; k < steps; ++k) {
      int av[kRM], bv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) av[i] = sa[k][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) bv[j] = sb[k][tx + kTX * j];
      const int wk = kWeighted ? sww[k] : 1;
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int c = __popc(av[i] ^ bv[j]);
          acc[i][j] += kWeighted ? c * wk : c;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int gm = m0 + ty + kTY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int gn = n0 + tx + kTX * j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" int launch_xnor_popcount_matmul(const void* a, const void* b,
                                           const void* ww, void* out, int M,
                                           int N, int W, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cudaStream_t st = (cudaStream_t)stream;
  if (ww != nullptr) {
    xnor_popcount_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        (const int32_t*)a, (const int32_t*)b, (const int32_t*)ww,
        (int32_t*)out, M, N, W);
  } else {
    xnor_popcount_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        (const int32_t*)a, (const int32_t*)b, nullptr, (int32_t*)out, M, N,
        W);
  }
  return (int)cudaGetLastError();
}
