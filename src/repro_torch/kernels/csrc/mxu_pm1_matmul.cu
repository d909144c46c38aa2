// +-1 dot products of packed words on the tensor cores (int8 mma.sync).
//
// Replaces the TPU kernel
// repro/kernels/mxu_pm1_matmul.py :: mxu_pm1_matmul (with _unpack_pm1): the
// TPU unpacks packed words to bf16 +-1 in VMEM and feeds its matrix unit.
//
//   dot[m, n] = sum_k pm1(a[m], k) * pm1(b[n], k) - pad_bits
//
// over all 32·W bits of a (M, W) and b (N, W) int32, bit k of word k / 32
// LSB-first, pm1 = bit ? +1 : -1, and pad_bits = 32·W - k_valid: pad bits
// agree in both operands and add +1 each, so the correction is on the
// padded width of the tensors.  -> (M, N) int32.
//
// Bound on the H100: at AlexNet's conv2 (M = 5,832, N = 256, W = 75)
// operations — 2·M·N·32·W = 7.2e9 take 3.6 us at the int8 tensor-core rate,
// the ~7.8 MB of packed operands and int32 result 2.3 us; at fc6 (M = 8,
// N = 4,096, W = 288) bytes, the 4.7 MB filter matrix.
// Design: the +-1 mainloop of pm1_gemm.cuh (packed words staged by
// cp.async through a ring of shared-memory stages, +-1 fragments built in
// registers, int32 accumulation: exact at every width) with the epilogue
// dot - pad_bits.  Many rows (the im2col convs): 64 x 64 tiles on wgmma
// with the filters' +-1 bytes in shared memory, each thread's adjacent
// columns c0, c1 stored as one 8-byte pair (split over a cluster, as
// below, where the grid would leave SMs idle).  Few rows (fc6/fc7 at batch
// 8): the filters on mma.sync's m16 side, the word axis split over a
// thread-block cluster and summed by the leader through distributed
// shared memory, which then writes each batch row's filters contiguously.

#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_gemm.cuh"

namespace {

struct DotEpilogue {
  int32_t* out;
  int M, N, pad_bits;

  // Accumulator fragment (16 x 8): c0, c1 row g, columns 2t, 2t + 1; c2,
  // c3 row g + 8.  `corr` is 32 a zero word staged.
  template <class T>
  __device__ __forceinline__ void registers(
      const int (&acc)[T::kMT][T::kNT][4], int corr, int mb, int nb, int g,
      int t) const {
    const int c = corr + pad_bits;
    const bool pairs = (N & 1) == 0;   // (m·N + even n) is 8-byte aligned
#pragma unroll
    for (int i = 0; i < T::kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb + 16 * i + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) {
          const int n = nb + 8 * j + 2 * t;
          const int v0 = acc[i][j][2 * h] - c;
          const int v1 = acc[i][j][2 * h + 1] - c;
          int32_t* o = out + (long long)m * N + n;
          if (pairs && n + 1 < N) {
            *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
          } else {
            if (n < N) o[0] = v0;
            if (n + 1 < N) o[1] = v1;
          }
        }
      }
  }

  // From the reduced dots: consecutive threads take consecutive columns.
  template <class T, class R>
  __device__ __forceinline__ void shared(const R& dot, int x0, int y0) const {
    const int mb = T::kSwap ? y0 : x0;
    const int nb = T::kSwap ? x0 : y0;
    for (int idx = threadIdx.x; idx < R::kRows * R::kCols;
         idx += T::kThreads) {
      const int r = idx / R::kCols;
      const int c = idx - r * R::kCols;
      const int m = mb + r;
      const int n = nb + c;
      if (m < M && n < N) out[(long long)m * N + n] = dot(r, c) - pad_bits;
    }
  }
};

}  // namespace

// tile, clusters: the plan of kernels/pm1_gemm.py plan_pm1.
extern "C" int launch_mxu_pm1_matmul(const void* a, const void* b, void* out,
                                     int M, int N, int W, int pad_bits,
                                     int tile, int clusters, void* stream) {
  const DotEpilogue epi{(int32_t*)out, M, N, pad_bits};
  return (int)phonebit::pm1::launch_tile(
      tile, (const int32_t*)a, (const int32_t*)b, M, N, W, epi, clusters,
      (cudaStream_t)stream);
}
