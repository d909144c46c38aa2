// A chain of binary conv (+ BN + binarize + pack) and OR-pool stages in one
// launch, with every interior stage output kept in shared memory
// (DESIGN.md §9: the paper's layer integration carried across layers), and
// spread over the SMs of one thread-block cluster.
//
// Replaces the TPU kernel repro/kernels/chain_conv.py :: chain_conv (with
// _conv_stage, _pool_stage, _mask_invalid and _kernel).
//
// Bound on the H100: operations (AlexNet's region at batch 8 does ~2.5e11
// bit operations over its valid positions against ~13 MB of entry,
// filters and output), so the work has to reach many SMs; but the
// intermediates must stay on chip, which one block's shared memory holds
// for one (image block, final tile) and no more.
//
// Design: one cluster of C blocks (C = 16, 8 or 4, chosen by the wrapper
// from cudaOccupancyMaxActiveClusters) per (image block, final output
// tile), the reference's grid (gn, gh, gw) with the tile axis scaled by C.
// Every rank holds a full-size copy of the planner's arena at the
// planner's offsets.  Stage k's work is shared out by a table the wrapper
// computes (kernels/chain_conv.py chain_shares): rank r takes contiguous
// output rows when the stage has at least C computed rows, else a range of
// output channel words.  A stage runs in three steps:
//   1. gather — before stage k (k > 0), rank r copies from the ranks that
//      computed them the words of stage k-1's output that its share reads,
//      through distributed shared memory (cluster.map_shared_rank), into
//      the same offsets of its own copy;
//   2. compute — its share from local shared memory (stage 0 from the
//      entry in device memory);
//   3. cluster.sync().
// Why one cluster barrier a stage is enough: the barrier after stage k-1
// orders every rank's stage k-1 writes before any gather of them in stage
// k.  A rank writes, in stage k, only stage k's output region of its own
// copy (and, in the gather, the non-owned words of stage k-1's region,
// which no other rank reads from it).  The planner gives stage k's output
// the lifetime [k, k+1], so the regions that may alias it belong to stages
// k-2 or earlier or k+2 or later: stage k-2's region was last read remotely
// in the gathers of stage k-1, which the barrier after stage k-1 closed;
// stage k's own region is read remotely only in the gathers of stage k+1,
// which end at the barrier after k+1, before stage k+2 may overwrite it.
// The barrier after the last stage also keeps every block alive until no
// rank reads its shared memory.  Inside a block, one __syncthreads()
// orders the gather before the compute.
//
// Coordinates: stage k's output tile starts at gi*step - off in the
// stage's own frame.  Interior positions outside [0, valid) hold the
// 0-word — 32 channels of -1, the conv padding and the OR identity
// (DESIGN.md §3.2): each rank stores it into its own copy without
// computing it, so the arena holds what the reference's masked store
// leaves, and only valid positions are computed (conv1 of AlexNet's
// whole-map tile: 55x55 of its 87x87 tile) or gathered.  The last stage
// computes and stores only valid positions.  The entry is not padded in
// memory: a read outside the image returns the 0-word.
//
// Conv stage: one warp per (32-channel output word, image, output row,
// kPos neighbouring output columns), one output channel per lane.  Each
// lane accumulates sum ww * __popc(in ^ w) for its channel; the input word
// is a warp-uniform (broadcast) load; the filters come transposed to
// (K, O_pad) so a warp's filter load is 128 consecutive bytes, read once
// for kPos positions.  Threshold and pack are one __ballot_sync per
// position (bit j = lane j, LSB-first, as pack_bits).  Pool stage: one
// thread per output word, OR over the window.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 16;   // kernels/chain_conv.py MAX_STAGES
constexpr int kMaxCluster = 16;  // kernels/chain_conv.py MAX_CLUSTER
constexpr int kFields = 24 + 2 * kMaxCluster;   // int64 fields a stage
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
  int by_rows;                   // shares are output rows, else words
  int c_lo, c_hi;                // rows valid in some tile of the grid
  int16_t lo[kMaxCluster];       // rank r's rows (by_rows) or output
  int16_t hi[kMaxCluster];       // words: [lo[r], hi[r])
};

struct Chain {
  int n_stages;
  int N, H, W, cw0;              // the entry (unpadded)
  int bn;                        // images per cluster
  int e_step_h, e_step_w, e_off_h, e_off_w;
  Stage st[kMaxStages];
};

// Rows [r0, r1) x columns [c0, c1) x words [g0, g1) of a stage's tile.
struct Box {
  int r0, r1, c0, c1, g0, g1;
  __device__ bool empty() const { return r0 >= r1 || c0 >= c1 || g0 >= g1; }
};

// The positions of stage S's output tile that lie inside [0, valid).
__device__ Box valid_box(const Stage& S, int orow0, int ocol0) {
  return Box{max(0, -orow0), min(S.out_h, S.valid_h - orow0),
             max(0, -ocol0), min(S.out_w, S.valid_w - ocol0),
             0, S.out_cw};
}

// What rank computes of stage S: its rows or words of the valid box.
__device__ Box share_box(const Stage& S, int rank, const Box& v) {
  Box b = v;
  if (S.by_rows) {
    b.r0 = max(b.r0, (int)S.lo[rank]);
    b.r1 = min(b.r1, (int)S.hi[rank]);
  } else {
    b.g0 = S.lo[rank];
    b.g1 = S.hi[rank];
  }
  return b;
}

// Store a 0-word at every masked position of S's output tile in this
// rank's own arena copy (interior stages).
__device__ void zero_masked(const Stage& S, const Box& v, int32_t* arena,
                            int nb) {
  const int items = nb * S.out_h * S.out_w;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int c = i % S.out_w;
    const int r = (i / S.out_w) % S.out_h;
    if (r >= v.r0 && r < v.r1 && c >= v.c0 && c < v.c1) continue;
    int32_t* p = arena + S.out_off + (long long)i * S.out_cw;
    for (int g = 0; g < S.out_cw; ++g) p[g] = 0;
  }
}

// Copy into this rank's copy, from the ranks that computed them, the valid
// words of P's (stage k-1's) output tile that the share `need` of S (stage
// k) reads: the rows under its windows, all words for a conv or a row
// share, its own words for a pool's word share.
__device__ void gather(const Stage& S, const Stage& P, const Box& need,
                       const Box& pv, int rank, int C, int32_t* arena,
                       int nb) {
  if (need.empty()) return;
  const int r0 = max(pv.r0, need.r0 * S.stride);
  const int r1 = min(pv.r1, (need.r1 - 1) * S.stride + S.k);
  const bool all_words = S.kind == 0 || S.by_rows;
  const int g0 = all_words ? 0 : need.g0;
  const int g1 = all_words ? P.out_cw : need.g1;
  const int cols = pv.c1 - pv.c0;
  cg::cluster_group cluster = cg::this_cluster();
  for (int o = 0; o < C; ++o) {
    if (o == rank) continue;
    const int ra = max(r0, P.by_rows ? (int)P.lo[o] : P.c_lo);
    const int rb = min(r1, P.by_rows ? (int)P.hi[o] : P.c_hi);
    const int ga = max(g0, P.by_rows ? 0 : (int)P.lo[o]);
    const int gb = min(g1, P.by_rows ? P.out_cw : (int)P.hi[o]);
    if (ra >= rb || ga >= gb || cols <= 0) continue;
    const int32_t* remote = cluster.map_shared_rank(arena, o);
    const int words = gb - ga;
    const int items = nb * (rb - ra) * cols * words;
    for (int i = threadIdx.x; i < items; i += kThreads) {
      int rest = i;
      const int g = ga + rest % words;
      rest /= words;
      const int c = pv.c0 + rest % cols;
      rest /= cols;
      const int r = ra + rest % (rb - ra);
      const int b = rest / (rb - ra);
      const int off =
          P.out_off + ((b * P.out_h + r) * P.out_w + c) * P.out_cw + g;
      arena[off] = remote[off];
    }
  }
}

template <bool kEntry, bool kWeighted>
__device__ void conv_stage(const Chain& ch, const Stage& S, const Box& w,
                           const int32_t* __restrict__ x, int32_t* arena,
                           int32_t* __restrict__ out, bool last, int ni,
                           int nb, int row0, int col0, int orow0,
                           int ocol0) {
  if (w.empty()) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = w.r1 - w.r0;
  const int cbs = (w.c1 - w.c0 + kPos - 1) / kPos;
  const int items = (w.g1 - w.g0) * nb * rows * cbs;
  const int o_pad = S.out_cw * 32;
  for (int item = warp; item < items; item += kWarps) {
    int rest = item;
    const int cb = rest % cbs;
    rest /= cbs;
    const int r = w.r0 + rest % rows;
    rest /= rows;
    const int b = rest % nb;
    const int g = w.g0 + rest / nb;
    const int c0 = w.c0 + cb * kPos;
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
            ok[p] = c0 + p < w.c1 && gr >= 0 && gr < ch.H && gc >= 0 &&
                    gc < ch.W;
            src[p] = x + ((n * ch.H + gr) * ch.W + gc) * ch.cw0;
          } else {
            ok[p] = c0 + p < w.c1;
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
      const int c = c0 + p;
      if (lane == 0 && c < w.c1) {
        if (last) {
          out[((n * S.valid_h + orow0 + r) * S.valid_w + ocol0 + c) *
                  S.out_cw + g] = (int32_t)word;
        } else {
          arena[S.out_off + ((b * S.out_h + r) * S.out_w + c) * S.out_cw +
                g] = (int32_t)word;
        }
      }
    }
  }
}

template <bool kEntry>
__device__ void pool_stage(const Chain& ch, const Stage& S, const Box& w,
                           const int32_t* __restrict__ x, int32_t* arena,
                           int32_t* __restrict__ out, bool last, int ni,
                           int nb, int row0, int col0, int orow0,
                           int ocol0) {
  if (w.empty()) return;
  const int rows = w.r1 - w.r0, cols = w.c1 - w.c0, words = w.g1 - w.g0;
  const int items = nb * rows * cols * words;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    int rest = item;
    const int j = w.g0 + rest % words;
    rest /= words;
    const int c = w.c0 + rest % cols;
    rest /= cols;
    const int r = w.r0 + rest % rows;
    const int b = rest / rows;
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
    if (last) {
      out[((n * S.valid_h + orow0 + r) * S.valid_w + ocol0 + c) * S.out_cw +
          j] = word;
    } else {
      arena[S.out_off + ((b * S.out_h + r) * S.out_w + c) * S.out_cw + j] =
          word;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_conv_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out,
                      const __grid_constant__ Chain ch) {
  extern __shared__ int32_t arena[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int wi = blockIdx.x / C, hi = blockIdx.y, ni = blockIdx.z;
  const int nb = min(ch.bn, ch.N - ni * ch.bn);   // images left in a ragged
  const int row0 = hi * ch.e_step_h - ch.e_off_h;  // last image block
  const int col0 = wi * ch.e_step_w - ch.e_off_w;
  Box prev_valid{};
  for (int k = 0; k < ch.n_stages; ++k) {
    const Stage& S = ch.st[k];
    const bool last = k == ch.n_stages - 1;
    const int orow0 = hi * S.step_h - S.off_h;
    const int ocol0 = wi * S.step_w - S.off_w;
    const Box v = valid_box(S, orow0, ocol0);
    const Box w = share_box(S, rank, v);
    if (k > 0) gather(S, ch.st[k - 1], w, prev_valid, rank, C, arena, nb);
    if (!last) zero_masked(S, v, arena, nb);
    __syncthreads();
    if (S.kind == 0) {
      if (k == 0) {
        if (S.ww != nullptr) {
          conv_stage<true, true>(ch, S, w, x, arena, out, last, ni, nb, row0,
                                 col0, orow0, ocol0);
        } else {
          conv_stage<true, false>(ch, S, w, x, arena, out, last, ni, nb,
                                  row0, col0, orow0, ocol0);
        }
      } else if (S.ww != nullptr) {
        conv_stage<false, true>(ch, S, w, x, arena, out, last, ni, nb, row0,
                                col0, orow0, ocol0);
      } else {
        conv_stage<false, false>(ch, S, w, x, arena, out, last, ni, nb, row0,
                                 col0, orow0, ocol0);
      }
    } else if (k == 0) {
      pool_stage<true>(ch, S, w, x, arena, out, last, ni, nb, row0, col0,
                       orow0, ocol0);
    } else {
      pool_stage<false>(ch, S, w, x, arena, out, last, ni, nb, row0, col0,
                        orow0, ocol0);
    }
    cluster.sync();
    prev_valid = v;
  }
}

// The launch configuration of a grid of clusters of `cluster` blocks.
cudaError_t configure(int arena_words, int cluster, dim3 grid,
                      cudaStream_t stream, cudaLaunchAttribute* attr,
                      cudaLaunchConfig_t* cfg) {
  const int smem = arena_words * 4;
  cudaError_t err = cudaFuncSetAttribute(
      chain_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(chain_conv_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
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

// How many clusters of `cluster` blocks, each with arena_words int32 of
// shared memory, the card holds at once (cudaOccupancyMaxActiveClusters);
// 0 when none can be scheduled.
extern "C" int chain_conv_max_clusters(int arena_words, int cluster,
                                       int* n) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  *n = 0;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure(arena_words, cluster, dim3(cluster), nullptr,
                              &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveClusters(n, chain_conv_kernel, &cfg);
  if (err != cudaSuccess) {
    *n = 0;
    cudaGetLastError();          // an unschedulable size is an answer
  }
  return (int)cudaSuccess;
}

// The kernel's registers a thread and threads a block.
extern "C" int chain_conv_info(int* regs, int* threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, chain_conv_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *threads = kThreads;
  return (int)cudaSuccess;
}

// desc: n_stages rows of kFields int64 (kernels/chain_conv.py
// _descriptors).  The arena is arena_words int32 of dynamic shared memory
// in every block; the grid is (gw * cluster, gh, gn) in clusters of
// (cluster, 1, 1).
extern "C" int launch_chain_conv(const void* x, void* out, const void* desc,
                                 int n_stages, int N, int H, int W, int cw0,
                                 int bn, int gn, int gh, int gw,
                                 int e_step_h, int e_step_w, int e_off_h,
                                 int e_off_w, int arena_words, int cluster,
                                 void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || cluster < 1 ||
      cluster > kMaxCluster) {
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
    S.by_rows = (int)d[21];
    S.c_lo = (int)d[22];
    S.c_hi = (int)d[23];
    for (int r = 0; r < kMaxCluster; ++r) {
      S.lo[r] = (int16_t)d[24 + 2 * r];
      S.hi[r] = (int16_t)d[25 + 2 * r];
    }
  }
  if (N == 0 || gn == 0 || gh == 0 || gw == 0) return (int)cudaSuccess;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure(
      arena_words, cluster,
      dim3((unsigned)(gw * cluster), (unsigned)gh, (unsigned)gn),
      (cudaStream_t)stream, &attr, &cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, chain_conv_kernel, (const int32_t*)x,
                           (int32_t*)out, ch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
