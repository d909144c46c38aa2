// K7b: the backward of K7 (GQA attention with an online softmax), the
// FlashAttention-2 backward on the tensor cores.
//
// Replaces the gradient of the TPU kernel repro/kernels/flash_attention.py
// :: flash_attention, whose custom_vjp backward (_bwd) recomputes through
// the jnp chunked attention; no Pallas kernel ran there.  For
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
// the A operand of their products, as the forward rounds P.
//
// Three launches, in order on the caller's stream:
//   1. flash_bwd_dot_kernel: D[b, h, i] = Σ_d dO·O, one warp a row;
//   2. flash_bwd_dkdv_kernel: one block per (KV head, batch, 64 keys), four
//      warps of 16 keys; K and V tiles stay in shared memory while the block
//      walks the q tiles of all G heads (under causal from the key tile's
//      diagonal on, the tiles above it skipped), each warp keeping its dK
//      and dV rows in registers: no atomics, so the result is deterministic;
//   3. flash_bwd_dq_kernel: one block per (q head, batch, 64 q rows) walking
//      the key tiles (under causal up to the diagonal), dQ in registers.
// Every product is mma.sync.m16n8k16 (bf16 in, f32 out) on fragments read
// from shared memory tiles padded by 8 elements a row, so the fragment loads
// hit 32 distinct banks.
//
// Bound on the H100: at lm-100m's layer (B 8, S 512, H 12, KV 4, hd 64,
// causal) the five products over the causal triangle are
// 10·B·H·hd·S(S+1)/2 = 8.07 GFLOP, 8.2 µs at the dense bf16 rate; q, k, v,
// o, dO, lse read once and dq, dk, dv written once are 33.8 MB, 10.1 µs at
// 3.35 TB/s.  So bytes bound it, and a kernel near the bound would need
// both the tensor cores near their rate and the tiles streamed.  This first
// kernel is the simple one: synchronous tile loads, mma.sync rather than
// wgmma, and the S and dP products computed twice (once for dK/dV, once
// for dQ).  Making it fast (TMA, wgmma, one pass with a dQ reduction) is
// later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;          // keys a dK/dV block, and a dQ step
constexpr int kBQ = 64;          // q rows a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// Sizes that follow the head width HD (64 or 128).
template <int HD>
struct Bwd {
  static_assert(HD == 64 || HD == 128, "head width 64 or 128");
  static constexpr int kLd = HD + 8;                  // padded row (bf16)
  // q rows a step of the dK/dV pass: 32 at HD 128 keeps dK, dV and the
  // two score fragments in registers.
  static constexpr int kSQ = HD == 128 ? 32 : 64;
  static constexpr int kSmemDkdv =
      (2 * kBK + 2 * kSQ) * kLd * 2 + 2 * kSQ * 4;
  static constexpr int kSmemDq = (2 * kBQ + 2 * kBK) * kLd * 2;
};

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values as one register, lo in the low half.
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16,
// row-major) a0 = row g cols 2t, 2t+1; a1 = row g+8; a2 = row g cols 2t+8..;
// a3 = row g+8 cols 2t+8..  B (16 x 8, column) b0 = rows 2t, 2t+1 of col g;
// b1 = rows 2t+8, 2t+9.  C (16 x 8 f32) c0, c1 = row g cols 2t, 2t+1; c2,
// c3 = row g+8.  So the C fragments of two adjacent n tiles are the A
// fragment of one k16 step: P and dS feed the next product from registers.

// c (16 x N) = A (16 x K) · B (N x K)ᵀ, both row-major in shared memory
// with row stride ld; A points at this warp's 16 rows.
template <int N, int K>
__device__ __forceinline__ void mma_nt(float (&c)[N / 8][4], const bf16* A,
                                       const bf16* B, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const bf16* a = A + g * ld + 16 * kk + 2 * t;
    const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * ld), a2 = ld32(a + 8),
                   a3 = ld32(a + 8 * ld + 8);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* b = B + (8 * j + g) * ld + 16 * kk + 2 * t;
      mma16816(c[j], a0, a1, a2, a3, ld32(b), ld32(b + 8));
    }
  }
}

// acc (16 x N) += P (16 x K) · B (K x N): P as this warp's float C
// fragments (K / 8 n tiles), rounded to bf16; B row-major in shared memory
// with row stride ld.
template <int N, int K>
__device__ __forceinline__ void mma_pn(float (&acc)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       const bf16* B, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a0 = pack_f2(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_f2(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_f2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_f2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* b = B + (16 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* bj = b + 8 * j;
      mma16816(acc[j], a0, a1, a2, a3, pack2(bj[0], bj[ld]),
               pack2(bj[8 * ld], bj[9 * ld]));
    }
  }
}

// ROWS rows from r0 of one head of a (B, S, heads, HD) bf16 tensor into a
// shared tile of row stride HD + 8, 16 bytes a thread at a time; rows past
// S read as 0.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int r0, int S, int heads,
                                          int head) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      val = *reinterpret_cast<const uint4*>(
          src + (((long long)b * S + row) * heads + head) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

// D[b, h, i] = Σ_d dO[b, i, h, d] · O[b, i, h, d] in float32; one warp a
// (b, i, h) row.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    float* __restrict__ delta, int B, int S, int H) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * H) return;
  const bf16* po = o + row * HD;
  const bf16* pd = dout + row * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = 2 * lane; c < HD; c += 64) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(po + c);
    const __nv_bfloat162 d = *reinterpret_cast<const __nv_bfloat162*>(pd + c);
    acc += __low2float(a) * __low2float(d) + __high2float(a) * __high2float(d);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;            // b * S + i
    const int i = (int)(bs % S);
    const int b = (int)(bs / S);
    delta[((long long)b * H + h) * S + i] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
    int KV, int causal, float scale) {
  using T = Bwd<HD>;
  constexpr int kLd = T::kLd, kSQ = T::kSQ;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBK * kLd;
  bf16* qs = vs + kBK * kLd;
  bf16* dos = qs + kSQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kSQ * kLd);  // × log2 e
  float* d_s = lse_s + kSQ;

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kBK;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + 16 * warp + g;     // this thread's keys: key0, +8
  const float scale_log2 = scale * kLog2e;

  load_tile<HD, kBK>(ks, k, b, k0, Skv, KV, kvh);
  load_tile<HD, kBK>(vs, v, b, k0, Skv, KV, kvh);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Under causal the q tiles before the key tile's first key see none of
  // its keys (kSQ divides kBK, so the tile holding key k0 starts at k0).
  const int q_begin = causal ? k0 : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* d_h = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += kSQ) {
      __syncthreads();                     // the last step's reads are done
      load_tile<HD, kSQ>(qs, q, b, q0, Sq, H, h);
      load_tile<HD, kSQ>(dos, dout, b, q0, Sq, H, h);
      for (int i = threadIdx.x; i < kSQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        lse_s[i] = in ? lse_h[q0 + i] * kLog2e : 0.f;
        d_s[i] = in ? d_h[q0 + i] : 0.f;
      }
      __syncthreads();

      // Pᵀ (this warp's 16 keys x kSQ q rows) = exp(K·Qᵀ·scale − lse).
      float p[kSQ / 8][4];
      mma_nt<kSQ, HD>(p, ks + 16 * warp * kLd, qs, kLd, lane);
      const bool edge =
          (causal && q0 < k0 + kBK) || q0 + kSQ > Sq || k0 + kBK > Skv;
#pragma unroll
      for (int j = 0; j < kSQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float x = exp2f(p[j][e] * scale_log2 - lse_s[qi]);
          if (edge) {
            const int key = key0 + ((e & 2) ? 8 : 0), qrow = q0 + qi;
            if (qrow >= Sq || key >= Skv || (causal && key > qrow)) x = 0.f;
          }
          p[j][e] = x;
        }
      mma_pn<HD, kSQ>(dv_acc, p, dos, kLd, lane);          // dV += Pᵀ·dO

      // dSᵀ = Pᵀ ∘ (V·dOᵀ − D).
      float ds[kSQ / 8][4];
      mma_nt<kSQ, HD>(ds, vs + 16 * warp * kLd, dos, kLd, lane);
#pragma unroll
      for (int j = 0; j < kSQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - d_s[8 * j + 2 * t + (e & 1)]);
      mma_pn<HD, kSQ>(dk_acc, ds, qs, kLd, lane);          // dK += dSᵀ·Q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= Skv) continue;
    const long long base = (((long long)b * Skv + key) * KV + kvh) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + base + col) =
          pack_f2(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack_f2(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
    float scale) {
  constexpr int kLd = Bwd<HD>::kLd;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBQ * kLd;
  bf16* ks = dos + kBQ * kLd;
  bf16* vs = ks + kBK * kLd;

  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * kBQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 16 * warp + g;     // this thread's rows: row0, +8
  const float scale_log2 = scale * kLog2e;

  load_tile<HD, kBQ>(qs, q, b, q0, Sq, H, h);
  load_tile<HD, kBQ>(dos, dout, b, q0, Sq, H, h);
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = ((long long)b * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * kLog2e : 0.f;
    dd[r] = row < Sq ? delta[at] : 0.f;
  }

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                       // the last step's reads are done
    load_tile<HD, kBK>(ks, k, b, k0, Skv, KV, kvh);
    load_tile<HD, kBK>(vs, v, b, k0, Skv, KV, kvh);
    __syncthreads();

    // P (this warp's 16 rows x 64 keys) = exp(Q·Kᵀ·scale − lse).
    float p[kBK / 8][4];
    mma_nt<kBK, HD>(p, qs + 16 * warp * kLd, ks, kLd, lane);
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Skv;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e >> 1) & 1;
        float x = exp2f(p[j][e] * scale_log2 - lse2[r]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= Skv || (causal && key > row0 + 8 * r)) x = 0.f;
        }
        p[j][e] = x;
      }

    // dS = P ∘ (dO·Vᵀ − D); dQ += dS·K.
    float ds[kBK / 8][4];
    mma_nt<kBK, HD>(ds, dos + 16 * warp * kLd, vs, kLd, lane);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - dd[(e >> 1) & 1]);
    mma_pn<HD, kBK>(dq_acc, ds, ks, kLd, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const long long base = (((long long)b * Sq + row) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dq + base + 8 * j + 2 * t) =
          pack_f2(dq_acc[j][2 * r] * scale, dq_acc[j][2 * r + 1] * scale);
    }
  }
}

template <int HD>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, float* delta, bf16* dq,
           bf16* dk, bf16* dv, int B, int Sq, int Skv, int H, int KV,
           int causal, float scale, cudaStream_t stream) {
  using T = Bwd<HD>;
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemDkdv);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmemDq);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot_kernel<HD><<<(unsigned)((rows + kWarps - 1) / kWarps),
                             kThreads, 0, stream>>>(o, dout, delta, B, Sq,
                                                    H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)KV, (unsigned)B,
                     (unsigned)((Skv + kBK - 1) / kBK));
  flash_bwd_dkdv_kernel<HD><<<grid_kv, kThreads, T::kSmemDkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Skv, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((unsigned)H, (unsigned)B,
                    (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_bwd_dq_kernel<HD><<<grid_q, kThreads, T::kSmemDq, stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Skv, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, dout, dq, dk, dv in the forward's layouts, contiguous
// and 16-byte aligned; lse and delta float32 (B, H, Sq), delta scratch the
// first launch fills.  hd 64 or 128.
extern "C" int launch_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int hd, int causal,
    float scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || (hd != 64 && hd != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* bq = static_cast<const bf16*>(q);
  const auto* bk = static_cast<const bf16*>(k);
  const auto* bv = static_cast<const bf16*>(v);
  const auto* bo = static_cast<const bf16*>(o);
  const auto* bd = static_cast<const bf16*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* gq = static_cast<bf16*>(dq);
  auto* gk = static_cast<bf16*>(dk);
  auto* gv = static_cast<bf16*>(dv);
  const auto s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch<64>(bq, bk, bv, bo, bd, fl, fd, gq, gk, gv, B, Sq,
                               Skv, H, KV, causal, scale, s)
                  : launch<128>(bq, bk, bv, bo, bd, fl, fd, gq, gk, gv, B,
                                Sq, Skv, H, KV, causal, scale, s);
}
