// Direct (im2col-free) fused binary convolution + BN + binarize + pack,
// with an optional OR-pool epilogue (DESIGN.md §5).
//
// Replaces the TPU kernel
// repro/kernels/direct_conv_bn_binarize.py :: direct_conv_bn_binarize
// (with its _or_pool_words epilogue and the tile_counts reduction of
// repro/kernels/xnor_popcount_matmul.py).
//
// x (N, H, W, Cw) int32 packed NHWC; w (O, KH*KW*Cw) int32 in
// pack_conv_weights order (kh, kw, word); ww (KH*KW*Cw,) or null (all ones);
// t (O,) int32; s (O,) uint8 -> out (N, FH, FW, ceil(O/32)) int32, where
// (FH, FW) is the conv output (OH, OW), pooled when a pool is given.
//
//   cnt[n, y, x, o] = sum_{di, dj, c} ww[k] * popc(xpad[n, y*st+di, x*st+dj, c]
//                                                  ^ w[o, k]),
//   k = (di*KW + dj)*Cw + c; a position outside the image reads word 0 —
//   32 channels of -1 (DESIGN.md §3.2) — and is counted, not skipped.
//   Pooled: out = OR over the pool window of the packed conv words; a
//   pool-pad position contributes 0, the OR identity.
//
// Bound on the H100: operations — the xor-popcounts (AlexNet conv1 at batch
// 8 is 24200 positions x 96 filters x 968 words); the packed maps are a few
// MB.  Design: one warp per (image, final output pixel, 32-channel output
// word), lane j owning output channel 32g + j, so the threshold + pack is a
// single __ballot_sync and the OR-pool is an OR of ballots in a register:
// neither the unpacked counts, nor the im2col patches, nor (with the pool)
// the pre-pool conv map ever reach device memory.  A block of 8 warps
// shares one channel group and stages that group's whole filter slice
// (32 x K words, padded to 33 against bank conflicts) and the word weights
// in shared memory once; the inner loop is a warp-uniform (broadcast) load
// of the input word, a conflict-free shared load of the filter word and a
// __popc.  Overlapping pools (window 3, stride 2) recompute the conv
// positions that neighbouring windows share — ~2.25x the conv work for
// AlexNet — the first thing a faster design removes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;   // output pixels per block

struct ConvGeom {
  int N, H, W, Cw, O, KH, KW, stride, pad, OH, OW;
  int pool_window, pool_stride, pool_lo, FH, FW;
};

template <bool kWeighted>
__global__ void direct_conv_bn_binarize_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ w,
    const int32_t* __restrict__ ww, const int32_t* __restrict__ t,
    const uint8_t* __restrict__ s, int32_t* __restrict__ out, ConvGeom g) {
  extern __shared__ int32_t smem[];
  const int K = g.KH * g.KW * g.Cw;
  int32_t* sw = smem;                 // [K][33]: filter words, transposed
  int32_t* sww = smem + K * 33;       // [K]: word weights

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = blockIdx.y;
  const int o = grp * 32 + lane;
  const int nw = (g.O + 31) / 32;

  for (int idx = threadIdx.x; idx < 32 * K; idx += blockDim.x) {
    const int row = idx / K;
    const int k = idx - row * K;
    const int go = grp * 32 + row;
    sw[k * 33 + row] = go < g.O ? w[(long long)go * K + k] : 0;
  }
  if (kWeighted) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) sww[k] = ww[k];
  }
  __syncthreads();

  const long long pixels = (long long)g.N * g.FH * g.FW;
  const long long pix = (long long)blockIdx.x * kWarps + warp;
  if (pix >= pixels) return;            // whole warp leaves together
  const int n = (int)(pix / ((long long)g.FH * g.FW));
  const int rem = (int)(pix - (long long)n * g.FH * g.FW);
  const int py = rem / g.FW;
  const int px = rem - py * g.FW;

  const int tv = o < g.O ? t[o] : 0;
  const bool sv = o < g.O && s[o] != 0;
  const int32_t* xn = x + (long long)n * g.H * g.W * g.Cw;

  unsigned word = 0;
  for (int pi = 0; pi < g.pool_window; ++pi) {
    const int cy = py * g.pool_stride - g.pool_lo + pi;
    if (cy < 0 || cy >= g.OH) continue;           // pool pad: OR identity
    for (int pj = 0; pj < g.pool_window; ++pj) {
      const int cx = px * g.pool_stride - g.pool_lo + pj;
      if (cx < 0 || cx >= g.OW) continue;
      int cnt = 0;
      for (int di = 0; di < g.KH; ++di) {
        const int iy = cy * g.stride - g.pad + di;
        const bool row_in = iy >= 0 && iy < g.H;
        for (int dj = 0; dj < g.KW; ++dj) {
          const int ix = cx * g.stride - g.pad + dj;
          const bool in = row_in && ix >= 0 && ix < g.W;
          const int32_t* xp = xn + ((long long)iy * g.W + ix) * g.Cw;
          const int k0 = (di * g.KW + dj) * g.Cw;
          for (int c = 0; c < g.Cw; ++c) {
            const int32_t xv = in ? xp[c] : 0;    // conv pad: word 0, counted
            const int pc = __popc(xv ^ sw[(k0 + c) * 33 + lane]);
            cnt += kWeighted ? sww[k0 + c] * pc : pc;
          }
        }
      }
      const bool bit = o < g.O && ((cnt <= tv) != sv);
      word |= __ballot_sync(0xffffffffu, bit);
    }
  }
  if (lane == 0) {
    out[(((long long)n * g.FH + py) * g.FW + px) * nw + grp] = (int32_t)word;
  }
}

// Shared memory one block needs: the filter slice and the word weights.
// Above the card's per-block limit (K > ~1700 words) cudaFuncSetAttribute
// refuses and the launcher reports the error.
int smem_bytes(int K) { return K * 34 * 4; }

}  // namespace

extern "C" int launch_direct_conv_bn_binarize(
    const void* x, const void* w, const void* ww, const void* t,
    const void* s, void* out, int N, int H, int W, int Cw, int O, int KH,
    int KW, int stride, int pad, int OH, int OW, int pool_window,
    int pool_stride, int pool_lo, int FH, int FW, void* stream) {
  ConvGeom g{N, H, W, Cw, O, KH, KW, stride, pad, OH, OW,
             pool_window, pool_stride, pool_lo, FH, FW};
  const long long pixels = (long long)N * FH * FW;
  if (pixels == 0 || O == 0) return (int)cudaSuccess;
  const int smem = smem_bytes(KH * KW * Cw);
  dim3 grid((unsigned)((pixels + kWarps - 1) / kWarps), (O + 31) / 32);
  dim3 block(kWarps * 32);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (ww != nullptr) {
    err = cudaFuncSetAttribute(direct_conv_bn_binarize_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    direct_conv_bn_binarize_kernel<true><<<grid, block, smem, st>>>(
        (const int32_t*)x, (const int32_t*)w, (const int32_t*)ww,
        (const int32_t*)t, (const uint8_t*)s, (int32_t*)out, g);
  } else {
    err = cudaFuncSetAttribute(direct_conv_bn_binarize_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    direct_conv_bn_binarize_kernel<false><<<grid, block, smem, st>>>(
        (const int32_t*)x, (const int32_t*)w, nullptr, (const int32_t*)t,
        (const uint8_t*)s, (int32_t*)out, g);
  }
  return (int)cudaGetLastError();
}
