// Causal / non-causal GQA attention forward with an online softmax
// (FlashAttention-2 shape).
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
// in float32; the output is divided by max(l, 1e-30).  Causal assumes
// Sq == Skv: key tiles past a q tile's diagonal are skipped and only the
// tiles that reach past a row's diagonal (or past Skv) are masked.  Each q
// head reads its KV head h / G directly: no K/V copy per q head, where the
// TPU kernel repeated each KV head G times in device memory.
//
// Bound on the H100: at minitron-8b's prefill layer (B 2, S 2048, H 32,
// KV 8, hd 128, bf16, causal) operations — 4·B·H·hd·S(S+1)/2 = 68.8 GFLOP
// take 0.070 ms at the bf16 tensor-core rate, the 84 MB of q, k, v and out
// 0.025 ms.  Design (bf16): the products run on the tensor cores, one
// mma.sync.m16n8k16 bf16 -> f32 per 16 x 8 x 16 step, and the score tile
// never leaves registers.  One block of 4 warps takes 64 q rows of one
// (batch, head), 16 rows a warp, with its q fragments held in registers for
// the whole key sweep.  Each step stages a 64-key tile of K and V in shared
// memory (rows padded by 16 bytes, so the ldmatrix row fetches hit 32
// distinct banks); S = q·kᵀ comes out in the accumulator layout, which is
// the A-fragment layout of the PV product, so p goes from the softmax to
// the second mma without touching shared memory.  The blocks of a causal
// sweep are issued longest first.  Inputs are bf16, the LM path's dtype;
// float32 has only the plain version.  Single-buffered staging, mma.sync
// rather than wgmma, and no TMA are the first things a faster version
// changes.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // q rows per block, 16 a warp
constexpr int kBK = 64;          // keys per staged tile
constexpr int kThreads = 128;    // 4 warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i.  Without .trans lane l receives row l/4, columns
// 2(l%4), 2(l%4)+1 of each matrix; with .trans, column l/4 of rows 2(l%4),
// 2(l%4)+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row) · b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16): reg 0 row g, columns 2t, 2t+1; reg 1 row g+8; regs 2, 3
//                the same rows at columns + 8;
//   B (16 x 8):  reg 0 rows 2t, 2t+1 of column g; reg 1 rows + 8;
//   C (16 x 8):  c0, c1 row g, columns 2t, 2t+1; c2, c3 row g+8.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int Sq, int Skv, int H, int KV, int causal, float scale) {
  constexpr int kStride = HD + 8;          // shared row, in bf16 elements
  static_assert(HD % 16 == 0, "head width: whole 16-wide mma steps");
  constexpr int kChunks = HD / 8;          // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 sk[kBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 sv[kBK * kStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest sweep first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int r0 = q0 + warp * 16 + g;       // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  const long long q_step = (long long)H * HD;   // between sequence positions
  const long long kv_step = (long long)KV * HD;
  const __nv_bfloat16* qb = q + ((long long)b * Sq * H + h) * HD;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * KV + kvh) * HD;

  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < Sq ? ldg32(qb + r0 * q_step + c) : 0u;
    qf[kk][1] = r1 < Sq ? ldg32(qb + r1 * q_step + c) : 0u;
    qf[kk][2] = r0 < Sq ? ldg32(qb + r0 * q_step + c + 8) : 0u;
    qf[kk][3] = r1 < Sq ? ldg32(qb + r1 * q_step + c + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};       // this thread's share of each row's sum

  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ + kBK - 1) / kBK);
  const int mi = lane >> 3;      // the ldmatrix matrix this lane addresses
  const int mr = lane & 7;       // and its row in it

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the previous tile's readers are done
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int row = idx / kChunks;
      const int ch = idx - row * kChunks;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (k0 + row < Skv) {      // rows past Skv stay 0: 0 · p adds nothing
        kx = *reinterpret_cast<const uint4*>(kb + (k0 + row) * kv_step +
                                             ch * 8);
        vx = *reinterpret_cast<const uint4*>(vb + (k0 + row) * kv_step +
                                             ch * 8);
      }
      *reinterpret_cast<uint4*>(sk + row * kStride + ch * 8) = kx;
      *reinterpret_cast<uint4*>(sv + row * kStride + ch * 8) = vx;
    }
    __syncthreads();

    // S = q · kᵀ over 16-dim steps; one ldmatrix gives the B fragments of
    // two 8-key column tiles.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sk + (jp * 16 + (mi >> 1) * 8 + mr) * kStride +
                            kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Online softmax on the float32 scores (scale applied here, as the
    // reference's chunked attention does).
    const bool masked = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= Skv || (causal && col > row)) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        ls[e >> 1] += p;
      }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // o += p · v over 16-key steps: p, rounded to bf16, is already in the
    // A layout; one transposing ldmatrix gives the B fragments of two
    // 8-dim column tiles.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sv + (kk * 16 + (mi & 1) * 8 + mr) * kStride +
                                  np * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ob = out + ((long long)b * Sq * H + h) * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r0 * q_step + c) =
          pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
    }
    if (r1 < Sq) {
      *reinterpret_cast<uint32_t*>(ob + r1 * q_step + c) =
          pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
    }
  }
}

template <int HD>
void launch_bf16(const void* q, const void* k, const void* v, void* out,
                 int B, int Sq, int Skv, int H, int KV, int causal,
                 float scale, cudaStream_t st) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_bf16_kernel<HD><<<grid, kThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Skv, H, KV, causal,
      scale);
}

}  // namespace

// bf16 only (the LM path's dtype); hd must be 128 (minitron's and
// command-r's head width).
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int H, int KV, int hd,
                                      int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV != 0 || Skv <= 0 || hd != 128) {
    return (int)cudaErrorInvalidValue;
  }
  launch_bf16<128>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
