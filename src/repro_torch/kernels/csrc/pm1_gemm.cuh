// One +-1 tensor-core mainloop on packed words, shared by K6
// (mxu_pm1_matmul.cu) and K2 (fused_conv_bn_binarize.cu, without word
// weights):
//
//   dot[x, y] = sum over the 32·W bits of pm1(X[x]) * pm1(Y[y])
//
// for X (rows_x, W) and Y (rows_y, W) int32 packed rows, bit k of word k / 32
// LSB-first, pm1 = bit ? +1 : -1.  The epilogue is a template parameter: K6
// stores dot - pad_bits, K2 thresholds the count (32·W - dot) / 2 and packs
// 32 channels a word.  The Python planner (kernels/pm1_gemm.py, plan_pm1)
// picks the tile and the cluster split; its TILES table and slice_bounds
// mirror this file.  The variants tried (more tiles, a ring of 4 stages)
// are instantiated by tools/pm1_variants.cu, outside the kernel library.
//
// Design:
// * Staging.  A block owns BX rows of X and BY rows of Y and walks its word
//   range KW words at a time through a ring of S shared-memory stages
//   filled by cp.async: 16-byte cp.async.cg where W is a multiple of 4 words
//   and both operands are 16-byte aligned, else 4-byte cp.async.ca (AlexNet's
//   conv2 has W = 75).  The copies of step k + S - 1 are issued before the
//   products of step k, so S - 1 steps of copies are in flight while the
//   tensor cores work.  Packed words are staged, not +-1 bytes: an eighth
//   of a byte staging's shared traffic.  Words past the block's range and
//   rows past an operand are zero-filled by the copy (src-size 0); a zero
//   word in both operands adds 32 to the dot, which the block subtracts.
// * Fragments.  A staged row is KW + 4 words: 16-byte aligned, and the 8
//   rows of one fragment load fall in 8 distinct groups of 4 banks.  Each
//   thread reads 4 words of a row with one 128-bit shared load; each word
//   is one k32 step of mma.sync.m16n8k32.s32.s8.s8.s32, its +-1 bytes built
//   in registers by bitmma.cuh's pm1_pair_strided (both operands in its bit
//   order: 3 instructions a register, half of pm1_pair's), int32
//   accumulation (exact at every width).
// * Products.  Many rows (the im2col convs): one warpgroup a 64 x 64 tile
//   issues wgmma.m64n64k32.s32.s8.s8 with A, X's fragments, in registers
//   (the layout above) and B, Y's +-1 bytes, expanded from the staged
//   words into shared memory as wgmma's K-major core matrices, two buffers
//   of 4 k32 steps so that the next buffer is expanded while the tensor
//   cores read the other (mainloop_wgmma).  Few rows (swapped, below):
//   mma.sync.m16n8k32, both fragments in registers (mainloop).
// * Split reduction.  The word axis may be split over the C blocks of a
//   thread-block cluster: rank r takes the r-th of C near-equal slices, cut
//   at multiples of 4 words where W is a multiple of 4.  Each block writes
//   its partial dots to shared memory; after a cluster barrier the leader
//   (rank 0) adds the other ranks' through distributed shared memory, a
//   second barrier lets the others exit, and the leader alone runs the
//   epilogue.  No atomics, no zeroed output, one launch; and K2's threshold
//   sees the whole count.
// * Orientation.  With few rows (the dense layers at small batch) the
//   filters are X, on the m16 side of the mma, and the batch rows Y, on the
//   n8 side, so no mma row is a zero row (kSwap).
// * Epilogue.  Unsplit and unswapped, straight from the accumulator
//   registers (Epi::registers); otherwise from the leader's reduced dots in
//   shared memory (Epi::shared).

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitmma.cuh"

namespace phonebit {
namespace pm1 {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;   // portable cluster size

// A block of kWM x kWN warps, each kMT m16 tiles of X by kNT n8 tiles of Y;
// kKW words a stage, kS stages.  kWgmma (1, 2): one warpgroup, a 64 x 64 or
// 64 x 128 tile, whose products are wgmma.m64n64k32 or m64n128k32 with B,
// Y's +-1 bytes, in shared memory (mainloop_wgmma); 2 expands the next
// bytes while the tensor cores work.
template <bool kSwap_, int kMT_, int kNT_, int kWM_, int kWN_, int kKW_,
          int kS_, int kWgmma_ = 0>
struct Tile {
  static constexpr bool kSwap = kSwap_;
  static constexpr int kWgmma = kWgmma_;
  static constexpr int kMT = kMT_, kNT = kNT_, kWM = kWM_, kWN = kWN_;
  static constexpr int kKW = kKW_, kS = kS_;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int BX = 16 * kMT * kWM;
  static constexpr int BY = 8 * kNT * kWN;
  static constexpr int kLd = kKW + 4;               // words a staged row
  static constexpr int kStage = (BX + BY) * kLd;    // words a stage
  static constexpr int kLdr = BY + 1;               // a row of partial dots
  // kWgmma: two buffers of Y's +-1 bytes, each of kUnit k32 steps (32
  // bytes a row each), after the ring.
  static constexpr int kUnit = BY == 128 ? 2 : 4;
  static constexpr int kBWords = kWgmma ? 2 * kUnit * BY * 32 / 4 : 0;
  static constexpr int kSmem = kS * kStage + kBWords > BX * kLdr
                                   ? kS * kStage + kBWords : BX * kLdr;
  static_assert(!kWgmma || (kMT == 1 && (kNT == 8 || kNT == 16) &&
                             kWM == 4 && kWN == 1),
                "the wgmma tiles are 64 x 64 and 64 x 128, one warpgroup");
  static_assert(kKW % 4 == 0 && kS >= 3, "4-word fragment loads, 3+ stages");
  static_assert(kSmem * 4 <= 48 * 1024, "static shared memory");
};

// X and Y in the kernel's orientation (X on the m16 side).
struct Operands {
  const int32_t* x;
  const int32_t* y;
  int rows_x, rows_y, W;
};

// Words [begin, end) of rank r of c: near-equal slices in units of 4 words
// where W is a multiple of 4, else of 1 (kernels/pm1_gemm.py slice_bounds).
__device__ __forceinline__ void word_slice(int W, int r, int c, int& begin,
                                           int& end) {
  const int g = (W & 3) == 0 ? 4 : 1;
  const int units = W / g;
  begin = (int)((long long)r * units / c) * g;
  end = (int)((long long)(r + 1) * units / c) * g;
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const int32_t* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int32_t* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies of one stage: words [w0, w0 + KW) of the block's rows, zero past
// `wend` and past each operand's rows.
template <class T>
__device__ __forceinline__ void load_stage(uint32_t* st, const Operands& p,
                                           int x0, int y0, int w0, int wend,
                                           bool vec) {
  if (vec) {
    constexpr int kq = T::kKW / 4;              // 16-byte chunks a row
    constexpr int n = (T::BX + T::BY) * kq;
#pragma unroll
    for (int i = 0; i < (n + T::kThreads - 1) / T::kThreads; ++i) {
      const int c = threadIdx.x + i * T::kThreads;
      if (c >= n) break;
      const int row = c / kq;
      const int q = c - row * kq;
      const bool isx = row < T::BX;
      const int grow = isx ? x0 + row : y0 + row - T::BX;
      const int32_t* base = isx ? p.x : p.y;
      const int w = w0 + 4 * q;
      const int words =
          grow < (isx ? p.rows_x : p.rows_y) ? max(0, min(4, wend - w)) : 0;
      cp_async16(st + row * T::kLd + 4 * q,
                 words > 0 ? base + (long long)grow * p.W + w : base,
                 4 * words);
    }
  } else {
    constexpr int n = (T::BX + T::BY) * T::kKW;
#pragma unroll
    for (int i = 0; i < (n + T::kThreads - 1) / T::kThreads; ++i) {
      const int c = threadIdx.x + i * T::kThreads;
      if (c >= n) break;
      const int row = c / T::kKW;
      const int q = c - row * T::kKW;
      const bool isx = row < T::BX;
      const int grow = isx ? x0 + row : y0 + row - T::BX;
      const int32_t* base = isx ? p.x : p.y;
      const int w = w0 + q;
      const bool ok = grow < (isx ? p.rows_x : p.rows_y) && w < wend;
      cp_async4(st + row * T::kLd + q,
                ok ? base + (long long)grow * p.W + w : base, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The block's dots over words [wbeg, wend) into each warp's accumulators
// (C fragment layout of bitmma.cuh's mma_s8s8).  Returns the zero words
// staged past wend, each of which added 32 to every dot.  Ends with the
// ring drained and the block synchronised, so shared memory is free.
template <class T>
__device__ __forceinline__ int mainloop(int (&acc)[T::kMT][T::kNT][4],
                                        uint32_t* smem, const Operands& p,
                                        int x0, int y0, int wbeg, int wend) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wx = (warp / T::kWN) * 16 * T::kMT;
  const int wy = (warp % T::kWN) * 8 * T::kNT;
  const bool vec = (p.W & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.x) |
                     reinterpret_cast<uintptr_t>(p.y)) & 15) == 0;
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (wend - wbeg + T::kKW - 1) / T::kKW;
#pragma unroll
  for (int s = 0; s < T::kS - 1; ++s) {
    if (s < steps) {
      load_stage<T>(smem + s * T::kStage, p, x0, y0, wbeg + s * T::kKW,
                    wend, vec);
    }
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<T::kS - 2>();      // step k has landed
    __syncthreads();                 // ... for every thread; k - 1 is done
    const int kn = k + T::kS - 1;    // into the slot step k - 1 used
    if (kn < steps) {
      load_stage<T>(smem + (kn % T::kS) * T::kStage, p, x0, y0,
                    wbeg + kn * T::kKW, wend, vec);
    }
    cp_async_commit();
    const uint32_t* sx = smem + (k % T::kS) * T::kStage;
    const uint32_t* sy = sx + T::BX * T::kLd;
#pragma unroll
    for (int kq = 0; kq < T::kKW; kq += 4) {
      uint4 xv[T::kMT][2], yv[T::kNT];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const uint32_t* r = sx + (wx + 16 * i + g) * T::kLd + kq;
        xv[i][0] = *reinterpret_cast<const uint4*>(r);
        xv[i][1] = *reinterpret_cast<const uint4*>(r + 8 * T::kLd);
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        yv[j] = *reinterpret_cast<const uint4*>(
            sy + (wy + 8 * j + g) * T::kLd + kq);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // A: a0/a2 row g at k 4t.. / 16+4t.., a1/a3 row g + 8; B: b0/b1
        // column g.  Both in pm1_pair_strided's bit order.
        uint32_t af[T::kMT][4], bf[T::kNT][2];
#pragma unroll
        for (int i = 0; i < T::kMT; ++i) {
          pm1_pair_strided(word_of(xv[i][0], q), t, af[i][0], af[i][2]);
          pm1_pair_strided(word_of(xv[i][1], q), t, af[i][1], af[i][3]);
        }
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          pm1_pair_strided(word_of(yv[j], q), t, bf[j][0], bf[j][1]);
        }
#pragma unroll
        for (int i = 0; i < T::kMT; ++i)
#pragma unroll
          for (int j = 0; j < T::kNT; ++j) mma_s8s8(acc[i][j], af[i], bf[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  return steps * T::kKW - (wend - wbeg);
}

// wgmma shared-memory matrix descriptor, no swizzle, K-major: start
// address, lbo (the stride between the two 16-byte K chunks of a row's 32
// bytes) and sbo (between 8-row groups), in 16-byte units.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr,
                                                   uint32_t lbo,
                                                   uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define PM1_D8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),            \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define PM1_R32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31"

// d (64 x 8·kN s32) += A (64 x 32 s8, registers: each warp's 16 rows in
// mma.m16n8k32's A layout) · B (32 x 8·kN s8, shared, K-major).
template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&d)[4 * kN],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (kN == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" PM1_R32 ", "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
        "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : PM1_D8(0), PM1_D8(8), PM1_D8(16), PM1_D8(24), PM1_D8(32),
          PM1_D8(40), PM1_D8(48), PM1_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(kN == 8, "n64 or n128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" PM1_R32 "}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : PM1_D8(0), PM1_D8(8), PM1_D8(16), PM1_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

#undef PM1_R32
#undef PM1_D8

// mainloop on one warpgroup with wgmma.  A stage's words go kUnit k32
// steps at a time (2 for 128 Y rows, 4 for 64): the Y rows' words of a
// unit are expanded (each row by 128 / BY threads, pm1_pair_strided's
// bytes in k order) into one of two byte buffers
// laid out as wgmma's no-swizzle K-major core matrices (8 rows x 16 bytes,
// a row's two K chunks 128 bytes apart, 8-row groups 256 bytes apart), X's
// fragments stay in registers, and the unit's wgmma read that buffer.
// kWgmma 2 expands the next unit into the other buffer while they run;
// kWgmma 1 waits for them first.  Same contract as mainloop.
template <class T>
__device__ __forceinline__ int mainloop_wgmma(
    int (&acc)[T::kMT][T::kNT][4], uint32_t* smem, const Operands& p, int x0,
    int y0, int wbeg, int wend) {
  constexpr int kSplit = T::kThreads / T::BY;   // threads a Y row
  static_assert(T::kUnit % kSplit == 0, "whole words a thread");
  static_assert(T::kKW % T::kUnit == 0, "whole units a stage");
  constexpr int kUnits = T::kKW / T::kUnit;
  constexpr int kBlock = T::BY * 32;            // bytes of one k32 step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec = (p.W & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.x) |
                     reinterpret_cast<uintptr_t>(p.y)) & 15) == 0;
  constexpr int kD = 4 * T::kNT;
  int(&d)[kD] = reinterpret_cast<int(&)[kD]>(acc[0]);
#pragma unroll
  for (int i = 0; i < kD; ++i) d[i] = 0;
  uint32_t* bb = smem + T::kS * T::kStage;
  const uint32_t bb_addr = (uint32_t)__cvta_generic_to_shared(bb);
  // This thread's row in a byte block (group r / 8, row r % 8), and its
  // first word of a unit.
  const int r = threadIdx.x % T::BY;
  const int q0 = threadIdx.x / T::BY;
  uint32_t* brow = bb + ((r >> 3) * 256 + (r & 7) * 16) / 4;

  // Y's words [kq, kq + kUnit) of the stage into byte buffer `buf`.
  auto expand = [&](const uint32_t* sy, int kq, int buf) {
#pragma unroll
    for (int qq = 0; qq < T::kUnit / kSplit; ++qq) {
      const int q = q0 + qq * kSplit;
      const uint32_t w = sy[r * T::kLd + kq + q];
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) pm1_pair_strided(w, tt, lo[tt], hi[tt]);
      uint32_t* dst = brow + (buf * T::kUnit + q) * (kBlock / 4);
      *reinterpret_cast<uint4*>(dst) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(dst + 32) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  const int steps = (wend - wbeg + T::kKW - 1) / T::kKW;
#pragma unroll
  for (int s = 0; s < T::kS - 1; ++s) {
    if (s < steps) {
      load_stage<T>(smem + s * T::kStage, p, x0, y0, wbeg + s * T::kKW,
                    wend, vec);
    }
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<T::kS - 2>();
    __syncthreads();
    const int kn = k + T::kS - 1;
    if (kn < steps) {
      load_stage<T>(smem + (kn % T::kS) * T::kStage, p, x0, y0,
                    wbeg + kn * T::kKW, wend, vec);
    }
    cp_async_commit();
    const uint32_t* sx = smem + (k % T::kS) * T::kStage;
    const uint32_t* sy = sx + T::BX * T::kLd;
    expand(sy, 0, 0);
    __syncthreads();                   // unit 0's bytes are written
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const uint32_t* xr = sx + (16 * warp + g) * T::kLd + u * T::kUnit;
      uint32_t af[T::kUnit][4];
#pragma unroll
      for (int q = 0; q < T::kUnit; ++q) {
        pm1_pair_strided(xr[q], t, af[q][0], af[q][2]);
        pm1_pair_strided(xr[q + 8 * T::kLd], t, af[q][1], af[q][3]);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int q = 0; q < T::kUnit; ++q) {
        wgmma_s8<T::kNT>(d, af[q],
                 desc_interleave(
                     bb_addr + ((u & 1) * T::kUnit + q) * kBlock, 128, 256));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (T::kWgmma == 2 && u + 1 < kUnits) {
        expand(sy, (u + 1) * T::kUnit, (u + 1) & 1);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < kD; ++i) asm volatile("" : "+r"(d[i])::"memory");
      if (T::kWgmma == 1 && u + 1 < kUnits) {
        expand(sy, (u + 1) * T::kUnit, (u + 1) & 1);
      }
      __syncthreads();                 // next unit written, this one read
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  return steps * T::kKW - (wend - wbeg);
}

// The reduced dot at (row r, column c) of the output tile from the partial
// dots in shared memory (x-major), and the tile's geometry in output
// orientation: rows are X unless swapped.
template <class T>
struct Reduced {
  const int* red;
  static constexpr int kRows = T::kSwap ? T::BY : T::BX;
  static constexpr int kCols = T::kSwap ? T::BX : T::BY;
  __device__ __forceinline__ int operator()(int r, int c) const {
    return T::kSwap ? red[c * T::kLdr + r] : red[r * T::kLdr + c];
  }
};

template <class T, class Epi>
__global__ void __launch_bounds__(T::kThreads)
    pm1_gemm_kernel(Operands p, Epi epi, int clusters) {
  __shared__ __align__(16) uint32_t smem[T::kSmem];
  const int rank = (int)(blockIdx.x % clusters);
  const int x0 = (int)(blockIdx.x / clusters) * T::BX;
  const int y0 = (int)blockIdx.y * T::BY;
  int wbeg, wend;
  word_slice(p.W, rank, clusters, wbeg, wend);

  int acc[T::kMT][T::kNT][4];
  int zero_words;
  if constexpr (T::kWgmma) {
    zero_words = mainloop_wgmma<T>(acc, smem, p, x0, y0, wbeg, wend);
  } else {
    zero_words = mainloop<T>(acc, smem, p, x0, y0, wbeg, wend);
  }
  const int corr = 32 * zero_words;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wx = (warp / T::kWN) * 16 * T::kMT;
  const int wy = (warp % T::kWN) * 8 * T::kNT;
  if constexpr (!T::kSwap) {
    if (clusters == 1) {
      epi.template registers<T>(acc, corr, x0 + wx, y0 + wy, g, t);
      return;
    }
  }
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        red[(wx + 16 * i + g + 8 * (e >> 1)) * T::kLdr + wy + 8 * j +
            2 * t + (e & 1)] = acc[i][j][e] - corr;
      }
  if (clusters > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                  // every rank's partials are written
    if (cluster.block_rank() == 0) {
      // A thread's kPer dots, each rank's loads issued together.
      constexpr int kPer = (T::BX * T::BY + T::kThreads - 1) / T::kThreads;
      int off[kPer], sum[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int idx = threadIdx.x + q * T::kThreads;
        off[q] = idx < T::BX * T::BY
                     ? (idx / T::BY) * T::kLdr + idx % T::BY : -1;
        sum[q] = off[q] >= 0 ? red[off[q]] : 0;
      }
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < clusters) {
          const int* remote = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            if (off[q] >= 0) sum[q] += remote[off[q]];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (off[q] >= 0) red[off[q]] = sum[q];
      }
    }
    cluster.sync();                  // the leader has read every rank
    if (cluster.block_rank() != 0) return;
  } else {
    __syncthreads();
  }
  epi.template shared<T>(Reduced<T>{red}, x0, y0);
}

// One launch of tile T on (a (M, W), b (N, W)) in output orientation; the
// grid is (tiles of X x clusters, tiles of Y) in clusters of (clusters, 1,
// 1).  A refused launch returns its error; nothing retries.
template <class T, class Epi>
cudaError_t launch(const int32_t* a, const int32_t* b, int M, int N, int W,
                   const Epi& epi, int clusters, cudaStream_t stream) {
  if (clusters < 1 || clusters > kMaxCluster) return cudaErrorInvalidValue;
  const Operands p = T::kSwap ? Operands{b, a, N, M, W}
                              : Operands{a, b, M, N, W};
  const long long tiles_x = (p.rows_x + T::BX - 1) / T::BX;
  const long long tiles_y = (p.rows_y + T::BY - 1) / T::BY;
  if (tiles_x * clusters > 0x7fffffffLL || tiles_y > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)clusters;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles_x * clusters), (unsigned)tiles_y, 1);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, pm1_gemm_kernel<T, Epi>, p, epi, clusters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

constexpr int kStages = 3;   // the ring depth of every served tile

// Refuses a launch whose cluster would give a rank an empty word slice.
inline bool empty_slice(int W, int clusters) {
  return W / ((W & 3) == 0 ? 4 : 1) < clusters;
}

// The planner's tiles (kernels/pm1_gemm.py TILES, the same order):
//   0: swapped, 32 filters x 8 batch rows, 2 warps, 16 words a stage;
//   1: swapped, 64 filters x 16 batch rows, 4 warps, 16 words a stage;
//   2: 64 x 64 on one warpgroup with wgmma, the next unit's bytes expanded
//      while the tensor cores work, 8 words a stage.
template <class Epi>
cudaError_t launch_tile(int tile, const int32_t* a, const int32_t* b, int M,
                        int N, int W, const Epi& epi, int clusters,
                        cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (empty_slice(W, clusters)) return cudaErrorInvalidValue;
  switch (tile) {
    case 0:
      return launch<Tile<true, 1, 1, 2, 1, 16, kStages>>(
          a, b, M, N, W, epi, clusters, stream);
    case 1:
      return launch<Tile<true, 1, 2, 4, 1, 16, kStages>>(
          a, b, M, N, W, epi, clusters, stream);
    case 2:
      return launch<Tile<false, 1, 8, 4, 1, 8, kStages, 2>>(
          a, b, M, N, W, epi, clusters, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pm1
}  // namespace phonebit
