// K7b: the backward of K7 (GQA attention with an online softmax), a
// warp-specialised Hopper kernel: TMA ring + wgmma, S and dP computed once
// (the FlashAttention-3 backward's shape), dQ summed in a fixed order.
//
// Replaces the gradient of the TPU kernel repro/kernels/flash_attention.py
// :: flash_attention, whose custom_vjp backward (_bwd, :151) recomputes
// through the jnp chunked attention; no Pallas kernel ran there.  For
// out = softmax(q·kᵀ·scale [causal]) · v with q (B, Sq, H, hd), k and v
// (B, Skv, KV, hd), H = KV·G, and the upstream gradient dO of out, it
// returns
//
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − D),   dK = dSᵀ·Q·scale,   dQ = dS·K·scale
//
// with dK and dV summed over the G q heads of each KV head, P recomputed as
// exp(s − lse) from the forward's per-row log-sum-exp (K7 writes it when
// the autograd Function saves for backward) and D = rowsum(dO ∘ O).
// bf16 in, float32 accumulation, bf16 out; P and dS are rounded to bf16 as
// the A operands of their products (dS also as the operand of dQ's), as
// the forward rounds P, and dS is computed from the rounded P.  Causal
// assumes Sq == Skv; ragged last tiles of either length are masked.
//
// Bound on the H100.  Five products over the causal triangle,
// 10·B·H·hd·S(S+1)/2: at minitron-8b's prefill layer (B 2, S 2048, H 32,
// KV 8, hd 128) 171.9 GFLOP, 0.174 ms at the dense bf16 rate, against
// ~168 MB read once and written once (q, o, dO, dq 33.5 MB each; k, v, dk,
// dv 8.4 MB each; the lse), 0.050 ms at 3.35 TB/s: the tensor cores bound
// it.  At lm-100m's layer (B 8, S 512, H 12, KV 4, hd 64) 8.07 GFLOP take
// 8.2 µs and 33.8 MB 10.1 µs: bytes bound it, barely.  So every product
// has to run on wgmma from tiles TMA streams in, and no product may be
// done twice.
//
// Two launches, in order on the caller's stream:
//   1. flash_bwd_dot_kernel: D[b, h, i] = Σ_d dO·O and lse·log2 e, hd / 16
//      threads a row (16-byte loads), into rows padded to whole 64-row q
//      tiles (0 in the pad); it also zeroes the dQ order counters and the
//      tile claim counter;
//   2. flash_bwd_main_kernel, persistent: one block an SM, 384 threads in
//      three warpgroups, each block claiming work tiles (b, KV head, 128
//      keys) from a global counter until none is left.  Tiles come key tile
//      major (key tile 0 of every (b, KV head) first): under causal masking
//      the longest sweeps first.  A block finishes its tile before it
//      claims the next.
//   * Producer warpgroup (setmaxnreg 40).  Thread 0 loads the tile's K and
//     V (128 x hd bf16 each) once by TMA from K7's tensor maps, then, step
//     by step, one q tile of 64 rows of one q head (its Q and dO tiles by
//     TMA, its lse·log2 e and D rows by bulk copy) into a ring of two
//     stages with full/empty mbarriers.  Threads 32 and 64 move dQ's
//     running sums (below).
//   * Two consumer warpgroups (setmaxnreg 232), 64 keys each.  A step:
//       Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ  wgmma m64n64k16, both operands K-major in
//                               smem, a commit group each;
//       Pᵀ = 2^(Sᵀ·scale·log2 e − lse·log2 e), masked (diagonal, edges),
//                               while dPᵀ runs;
//       dV += Pᵀ·dO             A = Pᵀ from registers (bf16 pairs), B =
//                               dO MN-major (the transpose bit);
//       dSᵀ = Pᵀ ∘ (dPᵀ − D)    while dV runs;
//       dK += dSᵀ·Q             A from registers;
//     dSᵀ is also stored to smem as bf16 (one of two buffers, by step
//     parity), and after a barrier over both consumer warpgroups dQ's
//     64 x hd partial = dS·K (128 keys) is one wgmma chain with both
//     operands in smem and both transpose bits set, one 64-column block of
//     hd a warpgroup a step (at hd 64 the single block alternates between
//     the two by step parity).  Five products, S and dP once each.  dK and
//     dV stay in registers across every q tile of all G heads, so the GQA
//     sum needs no atomics; they are scaled and written once, in bf16.
//   * A deterministic dQ.  Each 64 x 64 dQ block (b, h, q tile, column
//     block) is summed in a float32 workspace in ascending key tile order,
//     a counter per block keeping the order.  For each step the loader
//     (thread 32) waits (ld.acquire.gpu) until the step's counters equal
//     the tile's key tile and bulk-copies the running sums into one of two
//     shared buffers, up to two steps ahead; the consumers add their
//     blocks to them in registers (key tile 0 finds none) and put the sums
//     back, and the storer (thread 64) bulk-stores them with plain stores
//     and, once the store is complete, advances the counters
//     (red.release.gpu).  The last key tile that sees a q tile rounds the
//     sum to bf16 and writes dq itself.  No float atomics: the same inputs
//     give the same bits every call, and the waits and the global round
//     trips stay off the consumers' path while the loader keeps ahead.
//     Why this cannot deadlock: a loader waits only for the key tiles
//     below its own of the same (b, KV head), and those tiles were claimed
//     before its own, so the blocks holding them are running; they in
//     turn wait only for claims earlier still, down to key tile 0, which
//     never waits.  No wait depends on a block that has yet to start.
//     Why it does not serialise: a tile walks its q tiles from the last
//     one down to its diagonal, the G heads innermost, so the steps of key
//     tile kt + 1 are a prefix of key tile kt's (the same q tiles in the
//     same order, less the two that only kt sees at the end).  Tile kt + 1
//     trails tile kt by about a step; neither waits on the other's
//     diagonal.  (Walking from the diagonal on, tile kt + 1 would wait at
//     every head for tile kt's two extra q tiles, and every tile of a (b,
//     KV head) would end with tile 0.)
// Shared memory at hd 128 [64]: K + V 64 KB [32], the ring 2 x (Q + dO)
// 64 KB [32], two dSᵀ buffers 32 KB, two buffers of running sums 2 x 32
// KB [2 x 16], the lse and D rows 1 KB, barriers: 226 KB [130], one block
// an SM.
// Head widths 72 (DiT-XL/2) and 80 (ViT-H/14) run the HD = 128
// instantiation padded (PAD, hopper.cuh) on the true width hd, as K7 does,
// so 64 and 128 keep their widths as constants: the tensor maps span hd
// columns, so TMA fills Q, K, V and dO past hd with zeros, and the
// products' columns past hd (dQ's, dK's, dV's) come out 0.  Every direct
// global address takes the true hd as its row stride and stops at it: the
// pre-pass's rows, dq's final store and the dK/dV stores.  The workspace
// keeps HD's layout (two 64-column dQ blocks a q tile).

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;          // q rows a step
constexpr int kBK = 128;         // keys a work tile, 64 a consumer warpgroup
constexpr int kStages = 2;
constexpr int kThreads = 384;    // producer + 2 consumer warpgroups
constexpr int kDotThreads = 256; // threads a block of the D pre-pass
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQBox = kBQ * kBox * 2;      // 8 KB: 64 rows of a 64-col box
constexpr int kKBox = kBK * kBox * 2;      // 16 KB: 128 rows
constexpr int kDsBytes = kBK * kBQ * 2;    // 16 KB: dSᵀ, 128 keys x 64 rows
constexpr int kRowBytes = kBQ * 4;         // one stage's lse or D row
constexpr int kDqBlock = kBQ * kBox;       // floats of a 64 x 64 dQ block

// Shared-memory offsets from the 1024-byte-aligned base; sizes follow the
// head width HD (64 or 128).
template <int HD>
struct BwdTile {
  static_assert(HD == 64 || HD == 128, "head width 64 or 128");
  static constexpr int kBoxes = HD / kBox;       // 64-column blocks of hd
  static constexpr int kKV = kBK * HD * 2;       // a K or V tile
  static constexpr int kQ = kBQ * HD * 2;        // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kRing = 2 * kKV;          // stage s: Q, then dO
  static constexpr int kDs = kRing + kStages * 2 * kQ;
  // Two buffers of a step's dQ blocks (by step parity): the running sums
  // come in, the consumers add their blocks, the sums go out.
  static constexpr int kSums = kDs + 2 * kDsBytes;
  static constexpr int kSumBytes = kBoxes * kDqBlock * 4;
  static constexpr int kRows = kSums + 2 * kSumBytes;
  static constexpr int kBar = kRows + kStages * 2 * kRowBytes;
  // kv_full, full[kStages], empty[kStages], sums_in[2], sums_added[2],
  // sums_free[2]
  static constexpr int kSlot = kBar + 8 * (7 + 2 * kStages);
  static constexpr int kSmemBytes = kSlot + 16 + 1024;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// D[b, h, i] = Σ_d dO[b, i, h, d] · O[b, i, h, d] in float32 and lse2 =
// lse · log2 e, both (B, H, sq_pad) with 0 in rows i >= S; HD / 16
// threads a (b, i, h) row, up to 32 bytes of O and of dO each, in 16-byte
// halves that stop at the row width (padded: the true hd, a multiple of 8;
// at hd 72 the fifth thread reads one half, the rest none).  Also zeroes
// the n_ctr counters of the main kernel.
template <int HD, bool PAD>
__global__ void __launch_bounds__(kDotThreads) flash_bwd_dot_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2,
    float* __restrict__ delta, int* __restrict__ counters, int n_ctr, int B,
    int S, int sq_pad, int H, int hd) {
  constexpr int kLanes = HD / 16;            // threads a row
  const int row_w = PAD ? hd : HD;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_ctr; i += (long long)gridDim.x * blockDim.x) {
    counters[i] = 0;
  }
  const long long row =
      ((long long)blockIdx.x * kDotThreads + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const bool in = row < (long long)B * sq_pad * H;
  const int h = (int)(row % H);
  const long long bi = row / H;              // b * sq_pad + i
  const int i = (int)(bi % sq_pad);
  const int b = (int)(bi / sq_pad);
  float acc = 0.f;
  if (in && i < S) {
    const long long at =
        (((long long)b * S + i) * H + h) * row_w + 16 * part;
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      if (16 * part + 8 * y >= row_w) continue;
      const uint4 a = *reinterpret_cast<const uint4*>(o + at + 8 * y);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + at + 8 * y);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc += __low2float(pa[x]) * __low2float(pd[x]) +
               __high2float(pa[x]) * __high2float(pd[x]);
      }
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && part == 0) {
    const long long at = ((long long)b * H + h) * sq_pad + i;
    delta[at] = acc;
    lse2[at] = i < S ? lse[((long long)b * H + h) * S + i] * kLog2e : 0.f;
  }
}

// Accumulator layout of m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j], d[4j+1] are row 16w + g, columns 8j + 2t, 8j + 2t
// + 1; d[4j+2], d[4j+3] the same columns of row 16w + g + 8.  For keys as
// rows (Sᵀ, dPᵀ, dK, dV) a thread holds keys 16w + g and 16w + g + 8 of
// its warpgroup's 64; the A fragment of one k16 step over q rows 16kk.. is
// d[8kk..8kk+7] packed in pairs.  PAD: the padded instantiation, rows hd
// wide.
template <int HD, bool PAD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_main_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    float* __restrict__ dq_acc, int* __restrict__ counters,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int B, int Sq, int Skv, int H, int KV, int hd, int causal,
    float scale) {
  using T = BwdTile<HD>;
  const int row_w = PAD ? hd : HD;
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: tiles start on that grain.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t sk = base + T::kK, sv = base + T::kV;
  auto stage_q = [&](int s) { return base + T::kRing + s * 2 * T::kQ; };
  auto stage_do = [&](int s) { return stage_q(s) + T::kQ; };
  auto stage_rows = [&](int s) { return T::kRows + s * 2 * kRowBytes; };
  const uint32_t kv_full = base + T::kBar;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };
  // Sums buffer u: its running sums are in (or, at key tile 0, it is
  // free for the first block); the consumers have added their blocks; the
  // sums have gone out (the buffer may be filled again).
  auto sums_in = [&](int u) { return kv_full + 8 * (1 + 2 * kStages + u); };
  auto sums_added = [&](int u) { return sums_in(u) + 16; };
  auto sums_free = [&](int u) { return sums_in(u) + 32; };
  volatile int* const slot = reinterpret_cast<int*>(base_ptr + T::kSlot);

  const int G = H / KV;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int sq_pad = n_qt * kBQ;
  const int n_kt = (Skv + kBK - 1) / kBK;
  const int n_tiles = n_kt * B * KV;
  int* const claim = counters + (long long)B * H * n_qt * T::kBoxes;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);     // every consumer thread arrives
    }
    for (int u = 0; u < 2; ++u) {
      mbar_init(sums_in(u), 1);
      mbar_init(sums_added(u), 128 * T::kBoxes);   // the block owners
      mbar_init(sums_free(u), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // A work tile (kt, b, kvh) from its claim index: key tile major.  Its
  // steps run from the last q tile down to the first that sees a key of
  // the tile, the G heads of the KV head innermost.
  struct Work {
    int kt, b, kvh, k0, n_steps;
  };
  auto work = [&](int tile) {
    Work w;
    w.kt = tile / (B * KV);
    w.b = (tile % (B * KV)) / KV;
    w.kvh = tile % KV;
    w.k0 = w.kt * kBK;
    w.n_steps = (n_qt - (causal ? w.k0 / kBQ : 0)) * G;
    return w;
  };
  // The first of the dQ blocks (b, h, q tile, column block) of step s.
  auto block_of = [&](const Work& w, int s) {
    const int qi = n_qt - 1 - s / G, h = w.kvh * G + s % G;
    return (((long long)w.b * H + h) * n_qt + qi) * T::kBoxes;
  };
  // The producer warpgroup and the consumers run their own loops over the
  // tiles (setmaxnreg gives each its own register budget), meeting at
  // named barrier 4 twice a tile: after the claim, and when the tile is
  // done (K, V and the claim slot free again).

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int step = 0;                // ring steps of earlier tiles
    for (;;) {
      if (threadIdx.x == 0) *slot = atomicAdd(claim, 1);
      named_bar_sync(4, kThreads);
      const int tile = *slot;
      if (tile >= n_tiles) break;
      const Work w = work(tile);
      const int b = w.b, kvh = w.kvh;
      if (threadIdx.x == 0) {
        // The loads.  Round r of stage s waits for the consumers' release
        // of round r - 1 (parity (r & 1) ^ 1: round 0 passes at once).
        mbar_expect_tx(kv_full, 2 * T::kKV);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(sk + x * kKBox, &kmap, kv_full, x * kBox, kvh, w.k0, b);
          tma_load(sv + x * kKBox, &vmap, kv_full, x * kBox, kvh, w.k0, b);
        }
        for (int s = 0; s < w.n_steps; ++s) {
          const int it = step + s;
          const int st = it % kStages;
          mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          const int q0 = (n_qt - 1 - s / G) * kBQ;
          const int h = kvh * G + s % G;
          mbar_expect_tx(full(st), 2 * T::kQ + 2 * kRowBytes);
#pragma unroll
          for (int x = 0; x < T::kBoxes; ++x) {
            tma_load(stage_q(st) + x * kQBox, &qmap, full(st), x * kBox, h,
                     q0, b);
            tma_load(stage_do(st) + x * kQBox, &domap, full(st), x * kBox,
                     h, q0, b);
          }
          const long long row = ((long long)b * H + h) * sq_pad + q0;
          const uint32_t rows = base + stage_rows(st);
          bulk_load(rows, lse2 + row, kRowBytes, full(st));
          bulk_load(rows + kRowBytes, delta + row, kRowBytes, full(st));
        }
      } else if (threadIdx.x == 32) {
        // The loader of the running sums: for each step, once its sums
        // buffer is free, waits for the step's turn (the key tiles below
        // this one done with the blocks) and bulk-copies the sums in, up to
        // two steps ahead of the consumers.  Key tile 0 only frees the
        // buffer for the first blocks.
        for (int s = 0; s < w.n_steps; ++s) {
          const int it = step + s, u = it & 1;
          mbar_wait(sums_free(u), ((it >> 1) & 1) ^ 1);
          if (w.kt == 0) {
            mbar_arrive(sums_in(u));
            continue;
          }
          const long long blk0 = block_of(w, s);
          // A wait of seconds means a broken order: trap, not hang.
          const long long t0 = clock64();
#pragma unroll
          for (int j = 0; j < T::kBoxes; ++j)
            while (ld_acquire(counters + blk0 + j) != w.kt) {
              if (clock64() - t0 > (1LL << 33)) __trap();
            }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          mbar_expect_tx(sums_in(u), T::kSumBytes);
          bulk_load(base + T::kSums + u * T::kSumBytes,
                    dq_acc + blk0 * kDqBlock, T::kSumBytes, sums_in(u));
        }
      } else if (threadIdx.x == 64) {
        // The storer: once the consumers have added a step's blocks, bulk-
        // stores the sums (plain stores), frees the buffer when the store
        // has read it, and releases the blocks to the next key tile when
        // it is complete.  The last key tile that sees a q tile wrote dq
        // itself: nothing to store.
        for (int s = 0; s < w.n_steps; ++s) {
          const int it = step + s, u = it & 1;
          mbar_wait(sums_added(u), (it >> 1) & 1);
          const int qi = n_qt - 1 - s / G;
          const int last = causal ? min(qi / 2, n_kt - 1) : n_kt - 1;
          if (w.kt == last) {
            mbar_arrive(sums_free(u));
            continue;
          }
          const long long blk0 = block_of(w, s);
          bulk_store(dq_acc + blk0 * kDqBlock,
                     base + T::kSums + u * T::kSumBytes, T::kSumBytes);
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(sums_free(u));
          bulk_wait();
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
          for (int j = 0; j < T::kBoxes; ++j)
            red_release_add(counters + blk0 + j, 1);
        }
      }
      step += w.n_steps;
      named_bar_sync(4, kThreads);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127;
  const int c = wg - 1;                      // consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  int step = 0;
  for (int tile_iter = 0;; ++tile_iter) {
    named_bar_sync(4, kThreads);
    const int tile = *slot;
    if (tile >= n_tiles) break;
    const Work w = work(tile);
    const int b = w.b, kvh = w.kvh, k0 = w.k0;
    // Consumer warpgroup c: keys k0 + 64c .. k0 + 64c + 63; this thread's
    // rows of Sᵀ, dK and dV are keys key0 and key0 + 8.
    const int key0 = k0 + 64 * c + 16 * warp + g4;
    const uint32_t sk_c = sk + c * (kKBox / 2);     // 64 rows of 128 B
    const uint32_t sv_c = sv + c * (kKBox / 2);
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.f;
    mbar_wait(kv_full, tile_iter & 1);

    for (int s = 0; s < w.n_steps; ++s) {
      const int it = step + s;
      const int st = it % kStages;
      const int q0 = (n_qt - 1 - s / G) * kBQ;
      const uint32_t sq = stage_q(st), sdo = stage_do(st);
      const float* lse_s =
          reinterpret_cast<const float*>(base_ptr + stage_rows(st));
      const float* d_s = lse_s + kBQ;
      mbar_wait(full(st), (it / kStages) & 1);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, one commit group each: HD / 16 k16
      // steps each, four to a 128-B box row.
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t kc = (kk >> 2) * kKBox + (kk & 3) * 32;
        const uint32_t qc = (kk >> 2) * kQBox + (kk & 3) * 32;
        wgmma_ss64<0, 0>(sc, desc_sw128(sk_c + kc, 16, 1024),
                         desc_sw128(sq + qc, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t kc = (kk >> 2) * kKBox + (kk & 3) * 32;
        const uint32_t qc = (kk >> 2) * kQBox + (kk & 3) * 32;
        wgmma_ss64<0, 0>(dp, desc_sw128(sv_c + kc, 16, 1024),
                         desc_sw128(sdo + qc, 16, 1024), kk > 0);
      }
      wgmma_commit();

      // Pᵀ while dPᵀ runs: masked where a key lies past Skv or past the q
      // row (causal) or the q row past Sq, rounded to bf16 pairs (the A
      // fragments of dV's product), which is issued at once.
      wgmma_wait<1>();
      fence_regs(sc);
      const bool masked = (causal && q0 < k0 + kBK) || q0 + kBQ > Sq ||
                          k0 + kBK > Skv;
      uint32_t pa[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = 8 * kk + 2 * r + x;
            const int col = 8 * (e >> 2) + 2 * t + x;
            p[x] = ex2(sc[e] * scale_log2 - lse_s[col]);
            if (masked) {
              const int key = key0 + ((e & 2) ? 8 : 0), row = q0 + col;
              if (row >= Sq || key >= Skv || (causal && key > row))
                p[x] = 0.f;
            }
          }
          pa[kk][r] = pack_bf16(p[0], p[1]);
        }
      // dV += Pᵀ·dO: q rows 16 a k step, 2048 B apart in each box of dO,
      // the boxes kQBox apart (MN-major B).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dva, pa[kk], desc_sw128(sdo + kk * 2048, kQBox, 1024));
      wgmma_commit();

      // dSᵀ = Pᵀ ∘ (dPᵀ − D) from the rounded Pᵀ (its float copy is not
      // kept: registers) while dV runs, rounded to bf16 pairs.
      wgmma_wait<1>();
      fence_regs(dp);
      uint32_t da[kBQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          const int col = 8 * (e >> 2) + 2 * t;
          const float p0 = __uint_as_float(pa[kk][r] << 16);
          const float p1 = __uint_as_float(pa[kk][r] & 0xffff0000u);
          da[kk][r] = pack_bf16(p0 * (dp[e] - d_s[col]),
                                p1 * (dp[e + 1] - d_s[col + 1]));
        }

      // dSᵀ into this step's buffer, rows = keys, 128 B of 64 q rows a
      // row under the 128-byte swizzle (16-byte chunk j of row r at
      // j ^ (r & 7)): the MN-major A operand of dQ's product.
      uint8_t* const ds_buf = base_ptr + T::kDs + (it & 1) * kDsBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 64 * c + 16 * warp + g4 + 8 * half;
          *reinterpret_cast<uint32_t*>(
              ds_buf + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
              da[j >> 1][2 * (j & 1) + half];
        }
      fence_proxy_async();

      // dK += dSᵀ·Q, as dV's product with Q for dO.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs(dka, da[kk], desc_sw128(sq + kk * 2048, kQBox, 1024));
      wgmma_commit();

      // Both warpgroups' dSᵀ are in place: dQ's block j_own (64 columns
      // of hd) = dS (64 x 128 keys) · K[:, block], 16 keys a k step,
      // 2048 B apart in the dSᵀ buffer and in K's box.
      named_bar_sync(1, 256);
      const int j_own = (c + it) & 1;
      const bool own = j_own < T::kBoxes;
      float dqa[32];
      if (own) {
        const uint32_t ds_s = base + T::kDs + (it & 1) * kDsBytes;
        const uint32_t kb = sk + j_own * kKBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_ss64<1, 1>(dqa, desc_sw128(ds_s + kk * 2048, kDsBytes, 1024),
                           desc_sw128(kb + kk * 2048, kKBox, 1024), kk > 0);
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(dka);
      fence_regs(dva);
      mbar_arrive(empty(st));             // Q and dO read, stage free

      if (own) {
        // This step's block into its running sum: float4 e4 of thread tid
        // at (e4 · 128 + tid) of the block, added to the sum loaded (key
        // tile 0 finds none) and put back for the storer, or, at the last
        // key tile that sees the q tile, rounded and written to dq.
        fence_regs(dqa);
        const int u = it & 1;
        const int qi = n_qt - 1 - s / G;
        const int last = causal ? min(qi / 2, n_kt - 1) : n_kt - 1;
        float4* const sum = reinterpret_cast<float4*>(
            base_ptr + T::kSums + u * T::kSumBytes) + j_own * (kDqBlock / 4);
        mbar_wait(sums_in(u), (it >> 1) & 1);
        if (w.kt > 0) {
#pragma unroll
          for (int e4 = 0; e4 < 8; ++e4) {
            const float4 v = sum[e4 * 128 + tid];
            dqa[4 * e4] += v.x;
            dqa[4 * e4 + 1] += v.y;
            dqa[4 * e4 + 2] += v.z;
            dqa[4 * e4 + 3] += v.w;
          }
        }
        if (w.kt < last) {
#pragma unroll
          for (int e4 = 0; e4 < 8; ++e4)
            sum[e4 * 128 + tid] = make_float4(dqa[4 * e4], dqa[4 * e4 + 1],
                                              dqa[4 * e4 + 2],
                                              dqa[4 * e4 + 3]);
          fence_proxy_async();
        } else {
          // Rows of width row_w (padded: the padding's columns would
          // land in the next head).
          const int h = kvh * G + s % G;
          const long long q_step = (long long)H * row_w;  // between rows
          bf16* const qb =
              dq + ((long long)b * Sq * H + h) * row_w + j_own * kBox;
          const int r0 = q0 + 16 * warp + g4, r1 = r0 + 8;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * t;
            if (j_own * kBox + 8 * jj >= row_w) continue;
            if (r0 < Sq)
              *reinterpret_cast<uint32_t*>(qb + r0 * q_step + col) =
                  pack_bf16(dqa[4 * jj] * scale, dqa[4 * jj + 1] * scale);
            if (r1 < Sq)
              *reinterpret_cast<uint32_t*>(qb + r1 * q_step + col) =
                  pack_bf16(dqa[4 * jj + 2] * scale,
                            dqa[4 * jj + 3] * scale);
          }
        }
        mbar_arrive(sums_added(u));
      }
    }

    // dK (scaled) and dV of this warpgroup's 64 keys, once, in bf16, rows
    // of width row_w.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= Skv) continue;
      const long long at =
          (((long long)b * Skv + key) * KV + kvh) * row_w;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (8 * jj >= row_w) continue;
        const int e = 4 * jj + 2 * half;
        *reinterpret_cast<uint32_t*>(dk + at + col) =
            pack_bf16(dka[e] * scale, dka[e + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + col) =
            pack_bf16(dva[e], dva[e + 1]);
      }
    }
    step += w.n_steps;
    named_bar_sync(4, kThreads);
  }
}

// Workspace of one call: float32 lse2 and D rows (B, H, sq_pad) and the
// dQ blocks (B, H, q tiles, hd / 64, 64 x 64); int32 counters, one a dQ
// block, and the tile claim counter last.
void workspace_sizes(int B, int Sq, int H, int hd, long long* floats,
                     long long* ints) {
  const long long n_qt = (Sq + kBQ - 1) / kBQ;
  const long long blocks = (long long)B * H * n_qt * (hd / kBox);
  *floats = 2LL * B * H * n_qt * kBQ + blocks * kDqBlock;
  *ints = blocks + 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? sms : 0;
}

template <int HD, bool PAD>
int launch(const void* q, const void* k, const void* v, const bf16* o,
           const bf16* dout, const float* lse, float* ws, int* ctr, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Skv, int H, int KV,
           int hd, int causal, float scale, cudaStream_t stream) {
  using T = BwdTile<HD>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_main_kernel<HD, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!make_map(fn, &qmap, q, hd, H, Sq, B, kBQ)
      || !make_map(fn, &domap, dout, hd, H, Sq, B, kBQ)
      || !make_map(fn, &kmap, k, hd, KV, Skv, B, kBK)
      || !make_map(fn, &vmap, v, hd, KV, Skv, B, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int sq_pad = n_qt * kBQ;
  long long floats, ints;
  workspace_sizes(B, Sq, H, HD, &floats, &ints);
  float* lse2 = ws;
  float* delta = ws + (long long)B * H * sq_pad;
  float* acc = delta + (long long)B * H * sq_pad;
  const long long threads = (long long)B * sq_pad * H * (HD / 16);
  flash_bwd_dot_kernel<HD, PAD><<<(unsigned)((threads + kDotThreads - 1) /
                                             kDotThreads),
                                  kDotThreads, 0, stream>>>(
      o, dout, lse, lse2, delta, ctr, (int)ints, B, Sq, sq_pad, H, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((Skv + kBK - 1) / kBK) * B * KV;
  flash_bwd_main_kernel<HD, PAD>
      <<<(unsigned)(n_tiles < sms ? n_tiles : sms), kThreads, T::kSmemBytes,
         stream>>>(
      qmap, kmap, vmap, domap, lse2, delta, acc, ctr, dq, dk, dv, B, Sq, Skv,
      H, KV, hd, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool PAD>
int info(int* regs, int* smem_bytes, int* threads, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, flash_bwd_main_kernel<HD, PAD>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *smem_bytes = BwdTile<HD>::kSmemBytes;
  *threads = kThreads;
  *local_bytes = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}

}  // namespace

// Float32 and int32 elements of the workspace one call takes (the wrapper
// allocates both; the pre-pass fills what the main kernel reads), in the
// layout of the instantiation hd runs.
extern "C" int flash_attention_bwd_workspace(int B, int Sq, int H, int hd,
                                             long long* floats,
                                             long long* ints) {
  if (!kernel_width(hd)) return (int)cudaErrorInvalidValue;
  workspace_sizes(B, Sq, H, instance(hd), floats, ints);
  return (int)cudaSuccess;
}

// bf16 q, k, v, o, dout, dq, dk, dv in the forward's layouts, contiguous
// and 16-byte aligned; lse float32 (B, H, Sq); ws and ctr the workspace of
// flash_attention_bwd_workspace.  hd 64, 72, 80 or 128.
extern "C" int launch_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* ws, void* ctr, void* dq,
    void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int hd,
    int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || !kernel_width(hd)
      || (causal && Sq != Skv)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* bo = static_cast<const bf16*>(o);
  const auto* bd = static_cast<const bf16*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fw = static_cast<float*>(ws);
  auto* ic = static_cast<int*>(ctr);
  auto* gq = static_cast<bf16*>(dq);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  const auto s = static_cast<cudaStream_t>(stream);
  return with_instance(hd, [&](auto w, auto pad) {
    return launch<decltype(w)::value, decltype(pad)::value>(
        q, k, v, bo, bd, fl, fw, ic, gq, gk, gv, B, Sq, Skv, H, KV, hd,
        causal, scale, s);
  });
}

// The main kernel's registers a thread as compiled at head width hd
// (before setmaxnreg moves them between warpgroups; 72 and 80 report the
// padded instantiation they run), its dynamic shared memory a block, its
// threads a block and its local memory a thread (0: nothing spilled).
extern "C" int flash_attention_bwd_info(int hd, int* regs, int* smem_bytes,
                                        int* threads, int* local_bytes) {
  if (!kernel_width(hd)) return (int)cudaErrorInvalidValue;
  return with_instance(hd, [&](auto w, auto pad) {
    return info<decltype(w)::value, decltype(pad)::value>(
        regs, smem_bytes, threads, local_bytes);
  });
}
