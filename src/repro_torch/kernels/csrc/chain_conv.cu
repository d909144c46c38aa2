// A chain of binary conv (+ BN + binarize + pack) and OR-pool stages in one
// launch, with every interior stage output kept in shared memory
// (DESIGN.md §9: the paper's layer integration carried across layers).
//
// Replaces the TPU kernel repro/kernels/chain_conv.py :: chain_conv (with
// _conv_stage, _pool_stage, _mask_invalid and _kernel).
//
// One block per (image block, final output tile): the reference's grid
// (gn, gh, gw).  The block walks the stages in order, __syncthreads()
// between them.  Stage k reads its input tile from the entry in device
// memory (k = 0) or from the arena, and writes its output tile to the
// arena at the planner's offset (interior stages) or to device memory
// (the last stage).  The planner gives stage k's output the lifetime
// [k, k+1], so a stage never writes over the buffer it reads.
//
// Coordinates: stage k's output tile starts at gi*step - off in the
// stage's own frame.  Interior positions outside [0, valid) are stored as
// the 0-word — 32 channels of -1, the conv padding and the OR identity
// (DESIGN.md §3.2) — so the masked store is the next stage's padding.
// The entry is not padded in memory: a read outside the image returns the
// 0-word, which is what the reference's pre-padded entry holds there.
//
// Conv stage: one warp per (32-channel output word, image, output row,
// kPos neighbouring output columns), one output channel per lane.  Each
// lane accumulates sum ww * __popc(in ^ w) for its channel; the input word
// is a warp-uniform (broadcast) load; the filters come transposed to
// (K, O_pad) so a warp's filter load is 128 consecutive bytes, read once
// for kPos positions.  Threshold and pack are one __ballot_sync per
// position (bit j = lane j, LSB-first, as pack_bits).  Work is ordered
// word-major so the block's warps sweep the same filter slice together.
// Pool stage: one thread per output word, OR over the window.
//
// Bound on the H100: operations (AlexNet's region at batch 8 does
// ~2.5e11 bit operations over its valid positions against ~13 MB of
// entry, filters and output).  The entry, filters, word weights and
// thresholds are read from device memory through L1/L2 and the counts live
// in registers: only the arena is in shared memory, which is what the
// region planner budgets (runtime/regions.py plan_chain_vmem).  The cost
// of the simple design: one block per image with the whole-map tile (8 of
// 132 SMs at batch 8), and conv1 computed over its halo-grown 87x87 tile
// rather than its 55x55 map.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 16;   // kernels/chain_conv.py MAX_STAGES
constexpr int kFields = 21;      // int64 fields per stage descriptor
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPos = 4;          // output columns per conv work item

struct Stage {
  int kind;                      // 0 conv, 1 pool
  int k, stride;
  int in_h, in_w, in_cw;         // input tile (the entry tile for k = 0)
  int out_h, out_w, out_cw;      // output tile
  int step_h, step_w, off_h, off_w, valid_h, valid_w;
  int in_off, out_off;           // arena offsets in words (-1: none)
  const int32_t* w;              // (K, out_cw*32) transposed filters
  const int32_t* ww;             // (K,) word weights, or null
  const int32_t* t;              // (out_cw*32,) thresholds
  const int32_t* s;              // (out_cw*32,) sign flips
};

struct Chain {
  int n_stages;
  int N, H, W, cw0;              // the entry (unpadded)
  int bn;                        // images per block
  int e_step_h, e_step_w, e_off_h, e_off_w;
  Stage st[kMaxStages];
};

// Store one output word of stage S at tile position (b, r, c), word g.
__device__ __forceinline__ void store_word(const Stage& S, bool last,
                                           int32_t* arena, int32_t* out,
                                           long long n, int b, int r, int c,
                                           int g, int orow0, int ocol0,
                                           int32_t word) {
  const int gr = orow0 + r, gc = ocol0 + c;
  const bool valid = gr >= 0 && gr < S.valid_h && gc >= 0 && gc < S.valid_w;
  if (last) {
    if (valid) {
      out[((n * S.valid_h + gr) * S.valid_w + gc) * S.out_cw + g] = word;
    }
  } else {
    arena[S.out_off + ((b * S.out_h + r) * S.out_w + c) * S.out_cw + g] =
        valid ? word : 0;
  }
}

template <bool kEntry, bool kWeighted>
__device__ void conv_stage(const Chain& ch, const Stage& S,
                           const int32_t* __restrict__ x, int32_t* arena,
                           int32_t* __restrict__ out, bool last, int ni,
                           int nb, int row0, int col0, int orow0,
                           int ocol0) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cbs = (S.out_w + kPos - 1) / kPos;
  const int items = S.out_cw * nb * S.out_h * cbs;
  const int o_pad = S.out_cw * 32;
  for (int item = warp; item < items; item += kWarps) {
    int rest = item;
    const int cb = rest % cbs;
    rest /= cbs;
    const int r = rest % S.out_h;
    rest /= S.out_h;
    const int b = rest % nb;
    const int g = rest / nb;
    const int c0 = cb * kPos;
    const long long n = (long long)ni * ch.bn + b;
    const int o = g * 32 + lane;
    int cnt[kPos];
#pragma unroll
    for (int p = 0; p < kPos; ++p) cnt[p] = 0;
    for (int di = 0; di < S.k; ++di) {
      const int ir = r * S.stride + di;
      for (int dj = 0; dj < S.k; ++dj) {
        const int kbase = (di * S.k + dj) * S.in_cw;
        const int32_t* src[kPos];
        bool ok[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          const int ic = (c0 + p) * S.stride + dj;
          if (kEntry) {
            const int gr = row0 + ir, gc = col0 + ic;
            ok[p] = c0 + p < S.out_w && gr >= 0 && gr < ch.H && gc >= 0 &&
                    gc < ch.W;
            src[p] = x + ((n * ch.H + gr) * ch.W + gc) * ch.cw0;
          } else {
            ok[p] = c0 + p < S.out_w;
            src[p] = arena + S.in_off +
                     ((b * S.in_h + ir) * S.in_w + ic) * S.in_cw;
          }
        }
        const int32_t* wk = S.w + (long long)kbase * o_pad + o;
        for (int j = 0; j < S.in_cw; ++j) {
          const int32_t wv = __ldg(wk + (long long)j * o_pad);
          const int wt = kWeighted ? __ldg(S.ww + kbase + j) : 1;
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            // Outside the image the entry holds the 0-word: counted.
            const int32_t xv = ok[p] ? (kEntry ? __ldg(src[p] + j)
                                               : src[p][j])
                                     : 0;
            const int pc = __popc(xv ^ wv);
            cnt[p] += kWeighted ? wt * pc : pc;
          }
        }
      }
    }
    const int tv = __ldg(S.t + o);
    const bool sv = __ldg(S.s + o) != 0;
#pragma unroll
    for (int p = 0; p < kPos; ++p) {
      const unsigned word = __ballot_sync(0xffffffffu, (cnt[p] <= tv) != sv);
      if (lane == 0 && c0 + p < S.out_w) {
        store_word(S, last, arena, out, n, b, r, c0 + p, g, orow0, ocol0,
                   (int32_t)word);
      }
    }
  }
}

template <bool kEntry>
__device__ void pool_stage(const Chain& ch, const Stage& S,
                           const int32_t* __restrict__ x, int32_t* arena,
                           int32_t* __restrict__ out, bool last, int ni,
                           int nb, int row0, int col0, int orow0,
                           int ocol0) {
  const int items = nb * S.out_h * S.out_w * S.out_cw;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    int rest = item;
    const int j = rest % S.out_cw;
    rest /= S.out_cw;
    const int c = rest % S.out_w;
    rest /= S.out_w;
    const int r = rest % S.out_h;
    const int b = rest / S.out_h;
    const long long n = (long long)ni * ch.bn + b;
    int32_t word = 0;
    for (int pi = 0; pi < S.k; ++pi) {
      const int ir = r * S.stride + pi;
      for (int pj = 0; pj < S.k; ++pj) {
        const int ic = c * S.stride + pj;
        if (kEntry) {
          const int gr = row0 + ir, gc = col0 + ic;
          if (gr >= 0 && gr < ch.H && gc >= 0 && gc < ch.W) {
            word |= __ldg(x + ((n * ch.H + gr) * ch.W + gc) * ch.cw0 + j);
          }
        } else {
          word |= arena[S.in_off + ((b * S.in_h + ir) * S.in_w + ic) *
                                       S.in_cw + j];
        }
      }
    }
    store_word(S, last, arena, out, n, b, r, c, j, orow0, ocol0, word);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_conv_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out,
                      const __grid_constant__ Chain ch) {
  extern __shared__ int32_t arena[];
  const int wi = blockIdx.x, hi = blockIdx.y, ni = blockIdx.z;
  const int nb = min(ch.bn, ch.N - ni * ch.bn);   // images left in a ragged
  const int row0 = hi * ch.e_step_h - ch.e_off_h;  // last block
  const int col0 = wi * ch.e_step_w - ch.e_off_w;
  for (int k = 0; k < ch.n_stages; ++k) {
    const Stage& S = ch.st[k];
    const bool last = k == ch.n_stages - 1;
    const int orow0 = hi * S.step_h - S.off_h;
    const int ocol0 = wi * S.step_w - S.off_w;
    if (S.kind == 0) {
      if (k == 0) {
        if (S.ww != nullptr) {
          conv_stage<true, true>(ch, S, x, arena, out, last, ni, nb, row0,
                                 col0, orow0, ocol0);
        } else {
          conv_stage<true, false>(ch, S, x, arena, out, last, ni, nb, row0,
                                  col0, orow0, ocol0);
        }
      } else if (S.ww != nullptr) {
        conv_stage<false, true>(ch, S, x, arena, out, last, ni, nb, row0,
                                col0, orow0, ocol0);
      } else {
        conv_stage<false, false>(ch, S, x, arena, out, last, ni, nb, row0,
                                 col0, orow0, ocol0);
      }
    } else if (k == 0) {
      pool_stage<true>(ch, S, x, arena, out, last, ni, nb, row0, col0,
                       orow0, ocol0);
    } else {
      pool_stage<false>(ch, S, x, arena, out, last, ni, nb, row0, col0,
                        orow0, ocol0);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int phonebit_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

// desc: n_stages rows of kFields int64 (kernels/chain_conv.py
// _descriptors).  The arena is arena_words int32 of dynamic shared memory.
extern "C" int launch_chain_conv(const void* x, void* out, const void* desc,
                                 int n_stages, int N, int H, int W, int cw0,
                                 int bn, int gn, int gh, int gw,
                                 int e_step_h, int e_step_w, int e_off_h,
                                 int e_off_w, int arena_words,
                                 void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages) {
    return (int)cudaErrorInvalidValue;
  }
  Chain ch{};
  ch.n_stages = n_stages;
  ch.N = N;
  ch.H = H;
  ch.W = W;
  ch.cw0 = cw0;
  ch.bn = bn;
  ch.e_step_h = e_step_h;
  ch.e_step_w = e_step_w;
  ch.e_off_h = e_off_h;
  ch.e_off_w = e_off_w;
  const long long* d = (const long long*)desc;
  for (int k = 0; k < n_stages; ++k, d += kFields) {
    Stage& S = ch.st[k];
    S.kind = (int)d[0];
    S.k = (int)d[1];
    S.stride = (int)d[2];
    S.in_h = (int)d[3];
    S.in_w = (int)d[4];
    S.in_cw = (int)d[5];
    S.out_h = (int)d[6];
    S.out_w = (int)d[7];
    S.out_cw = (int)d[8];
    S.step_h = (int)d[9];
    S.step_w = (int)d[10];
    S.off_h = (int)d[11];
    S.off_w = (int)d[12];
    S.valid_h = (int)d[13];
    S.valid_w = (int)d[14];
    S.in_off = (int)d[15];
    S.out_off = (int)d[16];
    S.w = (const int32_t*)d[17];
    S.ww = (const int32_t*)d[18];
    S.t = (const int32_t*)d[19];
    S.s = (const int32_t*)d[20];
  }
  if (N == 0 || gn == 0 || gh == 0 || gw == 0) return (int)cudaSuccess;
  const int smem = arena_words * 4;
  cudaError_t err = cudaFuncSetAttribute(
      chain_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)gw, (unsigned)gh, (unsigned)gn);
  chain_conv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, ch);
  return (int)cudaGetLastError();
}
