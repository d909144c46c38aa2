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
// Three kernels, chosen by the wrapper from what it is given:
//
// * gemm_mma_kernel<false> — no word weights: +-1 bytes on the int8 tensor
//   cores, cnt = (32·W - dot)/2 exactly, pad bits included.
// * gemm_mma_kernel<true> — the bit-plane first layer in its u8 x s8 form
//   (xnor_popcount_matmul_planes): a's im2col rows in (tap, plane, word)
//   order are rebuilt into plane bytes, b is the filters' +-1 bytes (one
//   plane's sign bits, expanded once at lowering), cnt = const[n] - dot
//   (bitmma.cuh).
// * xnor_popcount_matmul_kernel — any other word weights, on CUDA cores
//   (launch_xnor_popcount_matmul takes word weights only).
//
// Bound on the H100: at AlexNet's conv1 under cuda_pm1 (M = 24,200 im2col
// rows of 968 words, N = 96) bytes — the 94 MB of rows take 28 us, the
// 18 G byte multiply-adds 9 us at the int8 rate; at fc6/fc7 (M = 8)
// bytes, the 4.7 / 2.1 MB filter matrices.
// gemm_mma_kernel design: a block of 4 warps (2 x 2 or 1 x 4) owns a
// BM x BN tile; each step stages 4 k32 steps of its rows and columns in
// shared memory as bytes (+-1 nibble expansion, or the plane bytes by an
// 8 x 8 bit transpose of 8 plane words), rows padded to 48 bytes so that
// the fragment loads hit 32 banks, then runs mma.sync.m16n8k32; the next
// step's source words are loaded into registers before this step's
// products, so their latency hides behind the tensor cores.  For few
// rows (fc6/fc7 at batch 8) the tile is 16 x 128, so every filter word is
// read once, and the reduction is split over blockIdx.z, each slice adding
// its exact int32 share with atomicAdd into a zeroed output.
//
// xnor_popcount_matmul_kernel design: a block of 128 threads computes a
// 64 x 32 output tile, each thread a 4 x 4 register tile (rows ty + 16i,
// columns tx + 8j); each 32-word step stages the block's rows word-major in
// shared memory, padded by one word against bank conflicts; the inner loop
// is 8 shared loads and 16 xor + __popc + multiply-add per word.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmma.cuh"

namespace {

constexpr int kBM = 64;                 // output rows per block
constexpr int kBN = 32;                 // output columns per block
constexpr int kBK = 32;                 // reduction words per step
constexpr int kTX = 8;                  // threads along n
constexpr int kTY = 16;                 // threads along m
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBM / kTY;          // register tile rows (4)
constexpr int kRN = kBN / kTX;          // register tile columns (4)

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
    if (tid < kBK) {
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
      const int wk = sww[k];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const int c = __popc(av[i] ^ bv[j]);
          acc[i][j] += c * wk;
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


// ---- tensor-core kernel --------------------------------------------------

constexpr int kKC = 4;            // k32 steps staged a step
constexpr int kRowWords = 12;     // 32 bytes of a row, padded to 48

// 32 bytes of one staged row from its source words: the 8 plane words of
// one k32 step transposed to plane bytes (kTranspose), 32 bytes as they
// are, or one word's +-1 bytes; an invalid row or step (past M, N or the
// slice) stages 0 bytes, which add nothing.
template <int kWords, bool kTranspose>
__device__ __forceinline__ void stage_row(const uint32_t (&w)[kWords],
                                          bool valid, uint32_t* dst) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
  if (valid) {
    if constexpr (kWords == 8 && !kTranspose) {
      lo = make_uint4(w[0], w[1], w[2], w[3]);
      hi = make_uint4(w[4], w[5], w[6], w[7]);
    } else if constexpr (kWords == 8) {
      const uint2 v0 = phonebit::plane_bytes8(w, 0);
      const uint2 v1 = phonebit::plane_bytes8(w, 1);
      const uint2 v2 = phonebit::plane_bytes8(w, 2);
      const uint2 v3 = phonebit::plane_bytes8(w, 3);
      lo = make_uint4(v0.x, v0.y, v1.x, v1.y);
      hi = make_uint4(v2.x, v2.y, v3.x, v3.y);
    } else {
      const uint32_t x = w[0];
      lo = make_uint4(phonebit::expand_nibble(x & 15u),
                      phonebit::expand_nibble((x >> 4) & 15u),
                      phonebit::expand_nibble((x >> 8) & 15u),
                      phonebit::expand_nibble((x >> 12) & 15u));
      hi = make_uint4(phonebit::expand_nibble((x >> 16) & 15u),
                      phonebit::expand_nibble((x >> 20) & 15u),
                      phonebit::expand_nibble((x >> 24) & 15u),
                      phonebit::expand_nibble(x >> 28));
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

template <bool kPlanes, int kMT, int kNT, int kWM, int kWN>
__global__ void __launch_bounds__(32 * kWM * kWN) gemm_mma_kernel(
    const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const int32_t* __restrict__ cnst, int32_t* __restrict__ out, int M,
    int N, int Ks, int Cw, int k_per_slice) {
  constexpr int kThreadsG = 32 * kWM * kWN;
  constexpr int BM = 16 * kMT * kWM;
  constexpr int BN = 8 * kNT * kWN;
  constexpr int kAW = kPlanes ? 8 : 1;             // source words a row
  constexpr int kBW = kPlanes ? 8 : 1;             // the s8 bytes, or a word
  constexpr int kAT = (BM * kKC + kThreadsG - 1) / kThreadsG;
  constexpr int kBT = (BN * kKC + kThreadsG - 1) / kThreadsG;
  __shared__ __align__(16) uint32_t sa[kKC][BM][kRowWords];
  __shared__ __align__(16) uint32_t sb[kKC][BN][kRowWords];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wm = (warp / kWN) * 16 * kMT;
  const int wn = (warp % kWN) * 8 * kNT;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * k_per_slice;
  const int kend = min(Ks, kbeg + k_per_slice);
  // Words of one a row: 8 plane words for each k32 step with planes; with
  // one word a plane, a step's 8 words are 32 contiguous bytes, read as
  // two 16-byte loads when a is 16-byte aligned.
  const long long a_row = kPlanes ? 8LL * Ks : (long long)Ks;
  const bool vec = Cw == 1 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // The next step's source words wait in registers while the tensor
  // cores work on this one (loads in flight across the compute).
  uint32_t ra[kAT][kAW], rb[kBT][kBW];
  bool va[kAT], vb[kBT];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kAT; ++q) {
      const int idx = tid + q * kThreadsG;
      const int row = idx / kKC;
      const int ks = k0 + idx % kKC;
      const int gm = m0 + row;
      va[q] = idx < BM * kKC && gm < M && ks < kend;
      if (!va[q]) continue;
      if constexpr (kPlanes) {
        // k32 step ks = (tap, word c): plane p's word at
        // tap * 8 * Cw + p * Cw + c.
        const int tap = ks / Cw;
        const int c = ks - tap * Cw;
        const int32_t* src = a + gm * a_row + (long long)tap * 8 * Cw + c;
        if (vec) {
          const uint4 lo = __ldg(reinterpret_cast<const uint4*>(src));
          const uint4 hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
          ra[q][0] = lo.x; ra[q][1] = lo.y; ra[q][2] = lo.z; ra[q][3] = lo.w;
          ra[q][4] = hi.x; ra[q][5] = hi.y; ra[q][6] = hi.z; ra[q][7] = hi.w;
        } else {
#pragma unroll
          for (int p = 0; p < kAW; ++p) ra[q][p] = (uint32_t)src[p * Cw];
        }
      } else {
        ra[q][0] = (uint32_t)a[gm * a_row + ks];
      }
    }
#pragma unroll
    for (int q = 0; q < kBT; ++q) {
      const int idx = tid + q * kThreadsG;
      const int row = idx / kKC;
      const int ks = k0 + idx % kKC;
      const int gn = n0 + row;
      vb[q] = idx < BN * kKC && gn < N && ks < kend;
      if (!vb[q]) continue;
      if constexpr (kPlanes) {
        const uint4* src = reinterpret_cast<const uint4*>(b) +
                           ((long long)gn * Ks + ks) * 2;
        const uint4 lo = __ldg(src), hi = __ldg(src + 1);
        rb[q][0] = lo.x; rb[q][1] = lo.y; rb[q][2] = lo.z; rb[q][3] = lo.w;
        rb[q][4] = hi.x; rb[q][5] = hi.y; rb[q][6] = hi.z; rb[q][7] = hi.w;
      } else {
        rb[q][0] = (uint32_t)b[(long long)gn * Ks + ks];
      }
    }
  };

  if (kbeg < kend) load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += kKC) {
#pragma unroll
    for (int q = 0; q < kAT; ++q) {
      const int idx = tid + q * kThreadsG;
      if (idx < BM * kKC) {
        stage_row<kAW, kPlanes>(ra[q], va[q], sa[idx % kKC][idx / kKC]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBT; ++q) {
      const int idx = tid + q * kThreadsG;
      if (idx < BN * kKC) {
        stage_row<kBW, false>(rb[q], vb[q], sb[idx % kKC][idx / kKC]);
      }
    }
    __syncthreads();
    if (k0 + kKC < kend) load(k0 + kKC);
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const uint32_t* r0 = sa[kk][wm + 16 * i + gq];
        const uint32_t* r1 = sa[kk][wm + 16 * i + gq + 8];
        af[i][0] = r0[tq];
        af[i][1] = r1[tq];
        af[i][2] = r0[4 + tq];
        af[i][3] = r1[4 + tq];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t* r = sb[kk][wn + 8 * j + gq];
        bf[j][0] = r[tq];
        bf[j][1] = r[4 + tq];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          phonebit::mma_k32<kPlanes>(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Counts: const - dot on plane bytes (the constant once, from slice 0);
  // (32·W - dot)/2 on +-1 bytes, W this slice's words.
  const bool split = gridDim.z > 1;
  const int words = kend - kbeg;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm + 16 * i + gq + (e >= 2 ? 8 : 0);
        const int gn = n0 + wn + 8 * j + 2 * tq + (e & 1);
        if (gm >= M || gn >= N) continue;
        const int dot = acc[i][j][e];
        int v;
        if (kPlanes) {
          v = (blockIdx.z == 0 ? cnst[gn] : 0) - dot;
        } else {
          v = (32 * words - dot) >> 1;
        }
        int32_t* o = out + (long long)gm * N + gn;
        if (split) {
          atomicAdd(o, v);
        } else {
          *o = v;
        }
      }
}

template <bool kPlanes, int kMT, int kNT, int kWM, int kWN>
int launch_gemm(const void* a, const void* b, const void* cnst, void* out,
                int M, int N, int Ks, int Cw, int slices, cudaStream_t st) {
  constexpr int BM = 16 * kMT * kWM;
  constexpr int BN = 8 * kNT * kWN;
  const int per = ((Ks + slices - 1) / slices + kKC - 1) / kKC * kKC;
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, (Ks + per - 1) / per);
  gemm_mma_kernel<kPlanes, kMT, kNT, kWM, kWN>
      <<<grid, 32 * kWM * kWN, 0, st>>>(
          (const int32_t*)a, (const int32_t*)b, (const int32_t*)cnst,
          (int32_t*)out, M, N, Ks, Cw, per);
  return (int)cudaGetLastError();
}

template <bool kPlanes>
int launch_gemm_tile(int tile, const void* a, const void* b,
                     const void* cnst, void* out, int M, int N, int Ks,
                     int Cw, int slices, cudaStream_t st) {
  switch (tile) {
    case 0:   // 64 x 64
      return launch_gemm<kPlanes, 2, 4, 2, 2>(a, b, cnst, out, M, N, Ks, Cw,
                                              slices, st);
    case 1:   // 64 x 96
      return launch_gemm<kPlanes, 2, 6, 2, 2>(a, b, cnst, out, M, N, Ks, Cw,
                                              slices, st);
    case 2:   // 16 x 128, few rows
      return launch_gemm<kPlanes, 1, 4, 1, 4>(a, b, cnst, out, M, N, Ks, Cw,
                                              slices, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int launch_xnor_popcount_matmul(const void* a, const void* b,
                                           const void* ww, void* out, int M,
                                           int N, int W, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (ww == nullptr) return (int)cudaErrorInvalidValue;
  xnor_popcount_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)ww,
      (int32_t*)out, M, N, W);
  return (int)cudaGetLastError();
}

// The tensor-core kernel.  planes = 1: a (M, 8·Ks) im2col rows of plane
// words in (tap, plane, word) order with Cw words a plane, b (N, 32·Ks)
// the filters' +-1 bytes (int8, built once at lowering), cnst (N,) the
// per-filter constant; planes = 0: a
// (M, Ks), b (N, Ks) packed words, cnst unused.  tile (0: 64 x 64, 1:
// 64 x 96, 2: 16 x 128) and slices of the reduction from the wrapper's
// planner; with slices > 1 the output must be zeroed.
extern "C" int launch_xnor_popcount_mma(const void* a, const void* b,
                                        const void* cnst, void* out, int M,
                                        int N, int Ks, int Cw, int tile,
                                        int slices, int planes,
                                        void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (slices < 1 || Cw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (planes) {
    return launch_gemm_tile<true>(tile, a, b, cnst, out, M, N, Ks, Cw,
                                  slices, st);
  }
  return launch_gemm_tile<false>(tile, a, b, cnst, out, M, N, Ks, Cw,
                                 slices, st);
}
