// Causal / non-causal GQA attention forward with an online softmax: a
// warp-specialised Hopper kernel, TMA ring + wgmma (FlashAttention-3 shape).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py ::
// flash_attention (_flash_fwd, _kernel): for q (B, Sq, H, hd) and k, v
// (B, Skv, KV, hd), H = KV·G,
//
//   out[b, i, h] = softmax_j(q[b, i, h] · k[b, j, h / G] / sqrt(hd)
//                            [j <= i when causal]) · v[b, :, h / G]
//
// in q's dtype.  Scores, the running max and sum and the accumulator are
// float32; p is rounded to v's dtype for the PV product, which accumulates
// in float32; the output is divided by max(l, 1e-30).  When the caller
// passes an lse buffer (the autograd Function saving for K7b, the backward
// in flash_attention_bwd.cu), each row's log-sum-exp m + log l of the
// scaled scores is also written, float32 (B, H, Sq); a null pointer (serving,
// prefill) writes nothing more.  The scale goes on
// the float32 scores times log2 e, so p = 2^(x - m) is the reference's
// e^(s - m) with one ex2 (what __expf runs).  Causal assumes Sq == Skv:
// key tiles past a q tile's diagonal are skipped and only the tiles that
// reach past a row's diagonal (or past Skv) are masked.  Each q head reads
// its KV head h / G directly: no K/V copy per q head, where the TPU kernel
// repeated each KV head G times in device memory.
//
// Bound on the H100: at minitron-8b's prefill layer (B 2, S 2048, H 32,
// KV 8, hd 128, bf16, causal) operations — 4·B·H·hd·S(S+1)/2 = 68.8 GFLOP
// take 0.070 ms at the bf16 tensor-core rate, the 84 MB of q, k, v and out
// 0.025 ms; at granite-moe-3b-a800m's (H 24, hd 64) 25.8 GFLOP take 0.026
// ms and 33.6 MB 0.010 ms.  So the products must run at the tensor cores'
// full rate, which only wgmma reaches, and the tensor cores must not wait
// on the loads.
//
// The kernel is a template on the head width HD, 128 (minitron, qwen3,
// command-r) or 64 (granite): every count below is for 128, with 64's in
// brackets where it differs.  Head widths 72 (DiT-XL/2) and 80 (ViT-H/14)
// run a third instantiation, HD = 128 padded (PAD, hopper.cuh), on the
// true width hd, so 64 and 128 keep their widths as constants: the tensor
// maps are built over hd columns (rows hd·2 bytes apart, 144 and 160 being
// multiples of 16), so TMA fills columns hd..127 of each 64-column box
// with zeros; Q·Kᵀ over zero columns is exact and P·V's columns past hd
// come out 0, and only the output store reads hd, stopping at it.  That
// costs 128/hd of the products (1.6x at 80, 1.78x at 72) and adds no
// wgmma shape, swizzle or register budget.
//
// Design.  One block per (q head, batch, 128 q rows), issued longest causal
// sweep first over the whole grid; 384 threads in three warpgroups.
//   * Producer warpgroup: gives up its registers (setmaxnreg 40); one
//     elected thread issues every copy with TMA (cp.async.bulk.tensor) from
//     4-D tensor maps over the (B, S, heads, hd) layouts as they lie, so a
//     box cuts one head's rows with no copy.  Q (128 x 128 bf16, 32 KB
//     [16 KB]) is loaded once; K and V tiles of 128 keys (32 KB [16 KB]
//     each) go through a ring of kStages stages, each with a full and an
//     empty mbarrier, so the copy of tile j+1 runs while the consumers
//     compute tile j.  A box is 64 bf16 wide (the 128-byte swizzle's row),
//     so a 128-wide row is two boxes [one]; TMA fills rows past S with
//     zeros, and those keys are masked.
//   * Two consumer warpgroups (setmaxnreg 232), 64 q rows each.
//     S = Q·Kᵀ is 8 [4] wgmma.m64n128k16 (bf16 in, f32 out), both operands
//     read from shared memory through 128-byte-swizzle descriptors, K-major
//     (no transpose).  The online softmax runs on S in registers; the f32
//     accumulator layout, rounded to bf16 and packed in pairs, is the
//     register A-fragment layout, so O += P·V is 8 wgmma.m64n128k16
//     [m64n64k16] with A = P from registers and B = V from shared memory,
//     MN-major (the descriptor's transpose bit).  Each consumer thread then
//     arrives on the stage's empty barrier.  One warpgroup's softmax runs
//     beside the other's products; issuing tile j+1's QKᵀ before tile j's
//     softmax within a warpgroup (with a 3-stage ring) measured slower on
//     the H100 without a ping-pong order between the two warpgroups, so it
//     is not done here.
// Shared memory: 32 KB of Q + kStages x 64 KB of K/V + barriers [half of
// each], so one block an SM (the consumers' 232 registers allow no
// second); registers 168 a thread as compiled, then 40 for the producer
// and 232 for the consumers.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 128;         // q rows a block, 64 a consumer warpgroup
constexpr int kBK = 128;         // keys a ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;    // producer + 2 consumer warpgroups
constexpr int kBoxBytes = kBQ * kBox * 2;      // 16 KB, one 64-column box
constexpr float kNegInf = -1e30f;

// Sizes that follow the head width HD (64 or 128; the wrapper checks).
template <int HD>
struct Tile {
  static_assert(HD == 64 || HD == 128, "head width 64 or 128");
  static constexpr int kBoxes = HD / kBox;             // boxes a row
  static constexpr int kBytes = kBQ * HD * 2;          // a 128 x HD tile
  static constexpr int kBarOffset = kBytes * (1 + 2 * kStages);
  static constexpr int kSmemBytes =
      kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

// Accumulator layout of m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j], d[4j+1] are row 16w + g, columns 8j + 2t, 8j + 2t + 1;
// d[4j+2], d[4j+3] the same columns of row 16w + g + 8.  The A register
// fragment of one k16 step is {row g cols 2t.., row g+8 cols 2t.., row g
// cols 2t+8.., row g+8 cols 2t+8..}: for keys 16kk.. that is d[8kk..8kk+7]
// packed in pairs.  PAD: the padded instantiation (hopper.cuh), whose rows
// are hd wide.
template <int HD, bool PAD>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
    int Skv, int H, int KV, int hd, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: tiles start on that grain.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  using T = Tile<HD>;
  const uint32_t sq = base;
  const uint32_t q_full = base + T::kBarOffset;
  auto stage_k = [&](int s) { return base + T::kBytes * (1 + 2 * s); };
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest sweep first
  const int kvh = h / (H / KV);
  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.  Round r of stage s waits for the consumers' release of
    // round r - 1 (parity (r & 1) ^ 1: round 0 passes at once).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kBytes);
#pragma unroll
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load(sq + x * kBoxBytes, &qmap, q_full, x * kBox, h, q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const uint32_t sk = stage_k(s), sv = sk + T::kBytes;
        const int k0 = i * kBK;
        mbar_expect_tx(full(s), 2 * T::kBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x) {
          tma_load(sk + x * kBoxBytes, &kmap, full(s), x * kBox, kvh, k0, b);
          tma_load(sv + x * kBoxBytes, &vmap, full(s), x * kBox, kvh, k0, b);
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: q rows q0 + 64c .. q0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int r0 = q0 + 64 * c + 16 * (tid >> 5) + (lane >> 2);
  const int r1 = r0 + 8;          // this thread's rows: r0, r1
  const uint32_t sq_c = sq + c * (kBoxBytes / 2);   // 64 rows of 128 B

  float o[HD / 2], s[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) s[e] = 0.f;
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};        // this thread's share of each row's sum

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int st = i % kStages;
    mbar_wait(full(st), (i / kStages) & 1);
    const uint32_t sk = stage_k(st), sv = sk + T::kBytes;

    // S = Q · Kᵀ: HD / 16 k16 steps over hd, four to a box, 32 B apart
    // inside the swizzled 128-B rows.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(sq_c + off, 16, 1024),
               desc_sw128(sk + off, 16, 1024), kk > 0);
    }
    wgmma_commit_and_wait();
    fence_regs(s);

    // Online softmax on the float32 scores (scale applied here, as the
    // reference's chunked attention does, times log2 e so that one FADD
    // and one ex2 give each p).
    const int k0 = i * kBK;
    const bool masked =
        (causal && k0 + kBK - 1 > q0 + 64 * c) || k0 + kBK > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      float x = s[e] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        const int row = (e & 2) ? r1 : r0;
        if (col >= Skv || (causal && col > row)) x = kNegInf;
      }
      s[e] = x;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const float p = ex2(s[e] - m[(e >> 1) & 1]);
      s[e] = p;
      ls[(e >> 1) & 1] += p;
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= corr[(e >> 1) & 1];

    // O += P · V over 16-key steps: p rounded to bf16 in the A layout;
    // V's 16 rows of a step lie 2048 B apart, its 64-wide boxes 16 KB
    // apart (the leading byte offset, unused at HD 64).
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs(o, pa[kk], desc_sw128(sv + kk * 16 * 128, kBoxBytes, 1024));
    wgmma_commit_and_wait();
    fence_regs(o);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if (lse != nullptr && t == 0) {
    // m is in log2 units of the scaled scores: lse = (m + log2 l) · ln 2.
    float* lb = lse + ((long long)b * H + h) * Sq;
    if (r0 < Sq) lb[r0] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (r1 < Sq) lb[r1] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }
  // Rows of width row_w (padded: the true hd, a multiple of 8; columns
  // past it are the padding's zeros and would land in the next head).
  const int row_w = PAD ? hd : HD;
  const long long q_step = (long long)H * row_w;  // between positions
  __nv_bfloat16* ob = out + ((long long)b * Sq * H + h) * row_w;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const bool in_hd = 8 * j < row_w;
    if (in_hd && r0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * q_step + col) =
          pack_bf16(o[4 * j] / l[0], o[4 * j + 1] / l[0]);
    }
    if (in_hd && r1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r1 * q_step + col) =
          pack_bf16(o[4 * j + 2] / l[1], o[4 * j + 3] / l[1]);
    }
  }
}

template <int HD, bool PAD>
int launch(const CUtensorMap& qmap, const CUtensorMap& kmap,
           const CUtensorMap& vmap, void* out, float* lse, int B, int Sq,
           int Skv, int H, int KV, int hd, int causal, float scale,
           cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, PAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<HD>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<HD, PAD>
      <<<grid, kThreads, Tile<HD>::kSmemBytes, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, lse, Sq, Skv, H, KV, hd, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int HD, bool PAD>
int info(int* regs, int* smem_bytes, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, flash_fwd_kernel<HD, PAD>);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *smem_bytes = Tile<HD>::kSmemBytes;
  *threads = kThreads;
  return (int)cudaSuccess;
}

}  // namespace

// bf16 only; hd 128 (minitron's, qwen3's and command-r's head width), 64
// (granite's, lm-100m's, ViT-L/16's, DiT-L/2's), or 80 (ViT-H/14's) and 72
// (DiT-XL/2's) on the hd-128 instantiation; q, k, v contiguous and 16-byte
// aligned; lse null or float32 (B, H, Sq).
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int hd, int causal, float scale,
                                      void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || !kernel_width(hd)) {
    return (int)cudaErrorInvalidValue;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(fn, &qmap, q, hd, H, Sq, B)
      || !make_map(fn, &kmap, k, hd, KV, Skv, B)
      || !make_map(fn, &vmap, v, hd, KV, Skv, B)) {
    return (int)cudaErrorInvalidValue;
  }
  float* lse_f = static_cast<float*>(lse);
  return with_instance(hd, [&](auto w, auto pad) {
    return launch<decltype(w)::value, decltype(pad)::value>(
        qmap, kmap, vmap, out, lse_f, B, Sq, Skv, H, KV, hd, causal, scale,
        (cudaStream_t)stream);
  });
}

// The kernel's registers a thread as compiled at head width hd (before
// setmaxnreg moves them between warpgroups; 72 and 80 report the padded
// instantiation they run), its dynamic shared memory a block, and its
// threads a block.
extern "C" int flash_attention_info(int hd, int* regs, int* smem_bytes,
                                    int* threads) {
  if (!kernel_width(hd)) return (int)cudaErrorInvalidValue;
  return with_instance(hd, [&](auto w, auto pad) {
    return info<decltype(w)::value, decltype(pad)::value>(regs, smem_bytes,
                                                          threads);
  });
}
