// Direct (im2col-free) fused binary convolution + BN + binarize + pack,
// with an optional OR-pool epilogue (DESIGN.md §5).
//
// Replaces the TPU kernel
// repro/kernels/direct_conv_bn_binarize.py :: direct_conv_bn_binarize
// (with its _or_pool_words epilogue and the tile_counts reduction of
// repro/kernels/xnor_popcount_matmul.py).
//
// x (N, H, W, Cw) int32 packed NHWC; w (O, KH*KW*Cw) int32 in
// pack_conv_weights order (kh, kw, word); ww (KH*KW*Cw,) or none (all ones);
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
// Three kernels, chosen by the wrapper from what it is given, never from
// the data:
//
// * conv_mma_kernel<false> — no word weights.  Counts on the int8 tensor
//   cores: popc(a ^ b) = (32 - dot)/2 over the +-1 bytes of each word, so
//   cnt = (32·K - dot)/2 exactly, pad bits included.
// * conv_mma_kernel<true> — the first layer in its u8 x s8 form (the
//   bit-plane variant, direct_conv_bn_binarize_planes): x holds 8 plane
//   words a pixel (plane p weighs 2^p) and the filters are one plane's sign
//   words, the converter having copied them into all 8;
//   cnt = const[o] - dot(u8 bytes, s8 signs), const = 255·popc(signs[o]),
//   exact for any input words (bitmma.cuh).
// * direct_conv_bn_binarize_kernel — any other word weights, on CUDA cores
//   (launch_direct_conv_bn_binarize takes word weights only).
//
// Bound on the H100: the packed maps are a few MB, the products 2.25e9
// (AlexNet conv1 at batch 8, 24,200 positions x 96 filters x 968 words)
// weighted popcounts, which the CUDA cores issue at 16 a clock an SM and the
// tensor cores take as 18 G byte multiply-adds (every bit position of the
// 121 words a position) — 9 us at the int8 rate.
//
// conv_mma_kernel design: a block of 8 warps owns a tile of final (pooled)
// outputs of one image and 32·kNW output channels.  It stages, once, the
// input pixels under the tile (as +-1 source words, or as the 32 plane
// bytes of each word, rebuilt by an 8 x 8 bit transpose) and its filters'
// sign words in shared memory.  The conv positions under the tile — the
// tile plus the pool window's overlap — are the GEMM rows, each computed
// once: warps take (2 m16 row tiles, one 32-channel word) items, run
// mma.sync.m16n8k32 over every tap and word with both fragments built in
// registers from shared memory, threshold the int32 sums, pack 32 channels
// into a word with two quad shuffles and store it in shared memory.  The
// pool then ORs each window from there, so neighbouring windows never
// recompute a shared conv position (the CUDA-core kernel did, ~2.25x the
// work at AlexNet's 3/2 pools).  The wrapper's planner
// (direct_conv_bn_binarize.plan_mma) picks the tile and kNW.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmma.cuh"

namespace {

constexpr int kWarps = 8;   // output pixels per block

struct ConvGeom {
  int N, H, W, Cw, O, KH, KW, stride, pad, OH, OW;
  int pool_window, pool_stride, pool_lo, FH, FW;
};

// The CUDA-core kernel (any word weights): one warp per (image, final
// output pixel, 32-channel output word), lane j owning output channel
// 32g + j, so the threshold + pack is a single __ballot_sync and the
// OR-pool an OR of ballots.  A block of 8 warps stages its channel group's
// filter slice (32 x K words, padded to 33) and the word weights in shared
// memory; overlapping pools recompute the conv positions that
// neighbouring windows share.
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
  for (int k = threadIdx.x; k < K; k += blockDim.x) sww[k] = ww[k];
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
            cnt += sww[k0 + c] * pc;
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


// ---- tensor-core kernel --------------------------------------------------

constexpr int kMmaThreads = 256;       // 8 warps
constexpr int kPlaneStride = 9;        // words a (pixel, word) of plane bytes

struct MmaTile {
  int TH, TW;            // final (pooled) outputs a tile
  int RH, RW;            // most conv positions under a tile
  int IH, IW;            // most input pixels under a tile
  int a_words;           // shared words of the staged input
};

__host__ __device__ inline int odd(int v) { return v | 1; }

// Shared words of one block: filters (NB x odd(K)), threshold, sign flip
// and constant (NB each), each k32 step's offset in the staged input (K),
// the staged input, the packed conv words.
inline long long mma_smem_words(const ConvGeom& g, const MmaTile& tl,
                                int nw_block) {
  const int nb = 32 * nw_block;
  const long long k = (long long)g.KH * g.KW * g.Cw;
  return nb * (long long)odd((int)k) + 3LL * nb + k + tl.a_words +
         (long long)tl.RH * tl.RW * nw_block;
}

template <bool kPlanes, int kNW>
__global__ void __launch_bounds__(kMmaThreads) conv_mma_kernel(
    const int32_t* __restrict__ x, const int32_t* __restrict__ signs,
    const int32_t* __restrict__ cnst, const int32_t* __restrict__ thr,
    const uint8_t* __restrict__ sflip, int32_t* __restrict__ out,
    ConvGeom g, MmaTile tl) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int NB = 32 * kNW;
  const int K = g.KH * g.KW * g.Cw;          // k32 steps a position
  const int KP = odd(K);
  const int CwP = odd(g.Cw);
  uint32_t* sB = sm;                         // [NB][KP] filter sign words
  int* sT = reinterpret_cast<int*>(sB + NB * KP);
  int* sS = sT + NB;
  int* sC = sS + NB;
  int* sK = sC + NB;                         // [K] k32 step -> input offset
  uint32_t* sA = reinterpret_cast<uint32_t*>(sK + K);
  uint32_t* sO = sA + tl.a_words;            // [RH*RW][kNW] conv words

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;                  // mma groupID
  const int tq = lane & 3;                   // mma threadID_in_group

  const int tiles_x = (g.FW + tl.TW - 1) / tl.TW;
  const int tiles_y = (g.FH + tl.TH - 1) / tl.TH;
  const int n = blockIdx.x / (tiles_x * tiles_y);
  const int r = blockIdx.x - n * tiles_x * tiles_y;
  const int fy0 = (r / tiles_x) * tl.TH;
  const int fx0 = (r % tiles_x) * tl.TW;
  const int fh = min(tl.TH, g.FH - fy0);
  const int fw = min(tl.TW, g.FW - fx0);
  const bool pooled = g.pool_window > 1 || g.pool_stride > 1 ||
                      g.pool_lo > 0 || g.FH != g.OH || g.FW != g.OW;
  int cy0 = fy0, cy1 = fy0 + fh - 1, cx0 = fx0, cx1 = fx0 + fw - 1;
  if (pooled) {
    cy0 = max(0, fy0 * g.pool_stride - g.pool_lo);
    cy1 = min(g.OH - 1, (fy0 + fh - 1) * g.pool_stride - g.pool_lo +
                            g.pool_window - 1);
    cx0 = max(0, fx0 * g.pool_stride - g.pool_lo);
    cx1 = min(g.OW - 1, (fx0 + fw - 1) * g.pool_stride - g.pool_lo +
                            g.pool_window - 1);
  }
  const int RH = cy1 - cy0 + 1;
  const int RW = cx1 - cx0 + 1;
  const int IW = (RW - 1) * g.stride + g.KW;
  const int IH = (RH - 1) * g.stride + g.KH;
  const int iy0 = cy0 * g.stride - g.pad;
  const int ix0 = cx0 * g.stride - g.pad;
  const int grp = blockIdx.y;

  // Stage the filters, the epilogue operands and the input tile.
  for (int idx = tid; idx < NB * K; idx += kMmaThreads) {
    const int row = idx / K;
    const int k = idx - row * K;
    const int o = grp * NB + row;
    sB[row * KP + k] =
        o < g.O ? (uint32_t)signs[(long long)o * K + k] : 0u;
  }
  for (int i = tid; i < NB; i += kMmaThreads) {
    const int o = grp * NB + i;
    const bool ok = o < g.O;
    sT[i] = ok ? thr[o] : 0;
    sS[i] = ok ? (int)sflip[o] : 0;
    sC[i] = (ok && kPlanes) ? cnst[o] : 0;
  }
  // Step k = (di, dj, c) reads input pixel (row + di, column + dj), word
  // c: its offset from the row's first pixel in the staged input.
  for (int k = tid; k < K; k += kMmaThreads) {
    const int c = k % g.Cw;
    const int tap = k / g.Cw;
    const int pix = (tap / g.KW) * IW + tap % g.KW;
    sK[k] = kPlanes ? (pix * g.Cw + c) * kPlaneStride : pix * CwP + c;
  }
  const int xw = kPlanes ? 8 * g.Cw : g.Cw;  // words a pixel in x
  for (int idx = tid; idx < IH * IW * g.Cw; idx += kMmaThreads) {
    const int c = idx % g.Cw;
    const int pix = idx / g.Cw;
    const int iy = iy0 + pix / IW;
    const int ix = ix0 + pix % IW;
    const bool in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int32_t* xp =
        x + (((long long)n * g.H + (in ? iy : 0)) * g.W + (in ? ix : 0)) * xw +
        c;
    if (kPlanes) {
      uint32_t w[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) w[p] = in ? (uint32_t)xp[p * g.Cw] : 0u;
      uint32_t* dst = sA + (pix * g.Cw + c) * kPlaneStride;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 v = phonebit::plane_bytes8(w, q);
        dst[2 * q] = v.x;
        dst[2 * q + 1] = v.y;
      }
    } else {
      sA[pix * CwP + c] = in ? (uint32_t)xp[0] : 0u;
    }
  }
  __syncthreads();

  // GEMM: rows are the RH x RW conv positions, items of (2 m16 tiles, one
  // 32-channel word) go round the warps.
  const int M = RH * RW;
  const int pairs = (M + 31) / 32;
  for (int item = warp; item < pairs * kNW; item += kMmaThreads / 32) {
    const int mp = item / kNW;
    const int ws = item - mp * kNW;
    int base[2][2];                            // [m16 tile][row g / g + 8]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (2 * mp + i) * 16 + gq + 8 * h;
        const int mm = m < M ? m : 0;
        const int pix = (mm / RW) * g.stride * IW + (mm % RW) * g.stride;
        base[i][h] = kPlanes ? pix * g.Cw * kPlaneStride : pix * CwP;
      }
    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    const uint32_t* brow = sB + (ws * 32 + gq) * KP;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const int ko = sK[k];
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        phonebit::pm1_pair(brow[j * 8 * KP + k], tq, bf[j][0], bf[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t af[4];
        if (kPlanes) {
          const uint32_t* p0 = sA + base[i][0] + ko;
          const uint32_t* p1 = sA + base[i][1] + ko;
          af[0] = p0[tq];
          af[1] = p1[tq];
          af[2] = p0[4 + tq];
          af[3] = p1[4 + tq];
        } else {
          phonebit::pm1_pair(sA[base[i][0] + ko], tq, af[0], af[2]);
          phonebit::pm1_pair(sA[base[i][1] + ko], tq, af[1], af[3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          phonebit::mma_k32<kPlanes>(acc[i][j], af, bf[j]);
        }
      }
    }
    // Threshold, then pack: lane (g, t) holds channels 8j + 2t + e of rows
    // g and g + 8; the quad's four lanes OR their bits into one word.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t word[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ol = ws * 32 + j * 8 + 2 * tq + e;
          const bool real = grp * NB + ol < g.O;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dot = acc[i][j][2 * h + e];
            const int cnt = kPlanes ? sC[ol] - dot : (32 * K - dot) >> 1;
            const bool bit = real && ((cnt <= sT[ol]) != (sS[ol] != 0));
            word[h] |= (uint32_t)bit << (j * 8 + 2 * tq + e);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        word[h] |= __shfl_xor_sync(0xffffffffu, word[h], 1);
        word[h] |= __shfl_xor_sync(0xffffffffu, word[h], 2);
        const int m = (2 * mp + i) * 16 + gq + 8 * h;
        if (tq == 0 && m < M) sO[m * kNW + ws] = word[h];
      }
    }
  }
  __syncthreads();

  // Write the tile: each pooled word ORs its window's conv words.
  const int nw = (g.O + 31) / 32;
  for (int idx = tid; idx < fh * fw * kNW; idx += kMmaThreads) {
    const int ws = idx % kNW;
    const int pix = idx / kNW;
    const int fy = fy0 + pix / fw;
    const int fx = fx0 + pix % fw;
    const int word_idx = grp * kNW + ws;
    if (word_idx >= nw) continue;
    uint32_t v = 0;
    if (pooled) {
      for (int pi = 0; pi < g.pool_window; ++pi) {
        const int cy = fy * g.pool_stride - g.pool_lo + pi;
        if (cy < 0 || cy >= g.OH) continue;          // pool pad: identity
        for (int pj = 0; pj < g.pool_window; ++pj) {
          const int cx = fx * g.pool_stride - g.pool_lo + pj;
          if (cx < 0 || cx >= g.OW) continue;
          v |= sO[((cy - cy0) * RW + (cx - cx0)) * kNW + ws];
        }
      }
    } else {
      v = sO[((fy - cy0) * RW + (fx - cx0)) * kNW + ws];
    }
    out[(((long long)n * g.FH + fy) * g.FW + fx) * nw + word_idx] =
        (int32_t)v;
  }
}

template <bool kPlanes, int kNW>
int launch_mma(const ConvGeom& g, const MmaTile& tl, const void* x,
               const void* signs, const void* cnst, const void* t,
               const void* s, void* out, cudaStream_t st) {
  const long long smem = 4 * mma_smem_words(g, tl, kNW);
  const int tiles = ((g.FH + tl.TH - 1) / tl.TH) *
                    ((g.FW + tl.TW - 1) / tl.TW);
  const int groups = ((g.O + 31) / 32 + kNW - 1) / kNW;
  cudaError_t err = cudaFuncSetAttribute(
      conv_mma_kernel<kPlanes, kNW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(g.N * tiles), (unsigned)groups);
  conv_mma_kernel<kPlanes, kNW><<<grid, kMmaThreads, smem, st>>>(
      (const int32_t*)x, (const int32_t*)signs, (const int32_t*)cnst,
      (const int32_t*)t, (const uint8_t*)s, (int32_t*)out, g, tl);
  return (int)cudaGetLastError();
}

template <bool kPlanes>
int launch_mma_nw(int nw_block, const ConvGeom& g, const MmaTile& tl,
                  const void* x, const void* signs, const void* cnst,
                  const void* t, const void* s, void* out, cudaStream_t st) {
  switch (nw_block) {
    case 1: return launch_mma<kPlanes, 1>(g, tl, x, signs, cnst, t, s, out, st);
    case 2: return launch_mma<kPlanes, 2>(g, tl, x, signs, cnst, t, s, out, st);
    case 3: return launch_mma<kPlanes, 3>(g, tl, x, signs, cnst, t, s, out, st);
    case 4: return launch_mma<kPlanes, 4>(g, tl, x, signs, cnst, t, s, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
  if (ww == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      direct_conv_bn_binarize_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  direct_conv_bn_binarize_kernel<<<grid, block, smem,
                                   (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)w, (const int32_t*)ww,
      (const int32_t*)t, (const uint8_t*)s, (int32_t*)out, g);
  return (int)cudaGetLastError();
}

// The tensor-core kernel: planes = 1 for the bit-plane first layer (x holds
// 8*Cw words a pixel, signs one plane's words, cnst the per-filter
// constant), 0 for +-1 counts without word weights (signs = the packed
// filters, cnst unused).  (tile_h, tile_w) final outputs a block and
// nw_block output words a block, from the wrapper's planner.
extern "C" int launch_direct_conv_mma(
    const void* x, const void* signs, const void* cnst, const void* t,
    const void* s, void* out, int N, int H, int W, int Cw, int O, int KH,
    int KW, int stride, int pad, int OH, int OW, int pool_window,
    int pool_stride, int pool_lo, int FH, int FW, int tile_h, int tile_w,
    int nw_block, int planes, void* stream) {
  ConvGeom g{N, H, W, Cw, O, KH, KW, stride, pad, OH, OW,
             pool_window, pool_stride, pool_lo, FH, FW};
  if ((long long)N * FH * FW == 0 || O == 0) return (int)cudaSuccess;
  if (tile_h < 1 || tile_w < 1) return (int)cudaErrorInvalidValue;
  const bool pooled = FH != OH || FW != OW || pool_window > 1 ||
                      pool_stride > 1 || pool_lo > 0;
  MmaTile tl;
  tl.TH = tile_h;
  tl.TW = tile_w;
  tl.RH = pooled ? (tile_h - 1) * pool_stride + pool_window : tile_h;
  tl.RW = pooled ? (tile_w - 1) * pool_stride + pool_window : tile_w;
  tl.IH = (tl.RH - 1) * stride + KH;
  tl.IW = (tl.RW - 1) * stride + KW;
  tl.a_words = tl.IH * tl.IW * (planes ? Cw * kPlaneStride : odd(Cw));
  cudaStream_t st = (cudaStream_t)stream;
  if (planes) {
    return launch_mma_nw<true>(nw_block, g, tl, x, signs, cnst, t, s, out,
                               st);
  }
  return launch_mma_nw<false>(nw_block, g, tl, x, signs, cnst, t, s, out,
                              st);
}
