// Every variant of the +-1 mainloop (src/repro_torch/kernels/csrc/
// pm1_gemm.cuh) that was tried for K6 and K2, for tools/pm1_sweep.py.
//
// The kernel library instantiates only the planner's three tiles at a ring
// of 3 stages (pm1_gemm.cuh launch_tile).  This file instantiates the whole
// table that was timed: eleven tiles, each at every ring depth it takes,
// with the served epilogues of both kernels.  It includes the two kernel
// sources, so a variant runs exactly the epilogue the library runs.
// tools/pm1_sweep.py builds it on its own into build/ (nvcc -shared, with
// the kernel sources' directory on the include path) and loads it; no
// served path loads it.
//
// Variants (tools/pm1_sweep.py VARIANTS, the same order):
//   0: 64 x 64 output tile, 2 x 2 warps of 32 x 32, 8 words a stage;
//   1: swapped, 64 filters x 8 batch rows, 4 warps of 16 filters, 16 words;
//   2: swapped, 64 filters x 16 batch rows, 16 words (served tile 1);
//   3: 64 x 64, 16 words a stage;
//   4: swapped, 32 filters x 8 batch rows, 2 warps, 16 words (served 0);
//   5: swapped, 64 filters x 8 batch rows, 32 words a stage;
//   6: 32 x 64, 2 x 2 warps of 16 x 32, 8 words a stage;
//   7: 64 x 64, 4 x 2 warps of 16 x 32 (8 warps), 8 words a stage;
//   8: 64 x 128 on one warpgroup with wgmma, the next unit's bytes
//      expanded while the tensor cores work (3 stages only);
//   9: variant 8 expanding after the tensor cores finish;
//  10: 64 x 64 on one warpgroup with wgmma, as variant 8 (served 2).
// Variants 0-7 take 3 or 4 stages.

#include "fused_conv_bn_binarize.cu"
#include "mxu_pm1_matmul.cu"

namespace {

using phonebit::pm1::launch;
using phonebit::pm1::Tile;

template <class Epi>
cudaError_t launch_variant(int variant, int stages, const int32_t* a,
                           const int32_t* b, int M, int N, int W,
                           const Epi& epi, int clusters,
                           cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (phonebit::pm1::empty_slice(W, clusters)) return cudaErrorInvalidValue;
  switch (variant * 8 + stages) {
#define PM1_VARIANT(v, s, ...)                                            \
  case v * 8 + s:                                                         \
    return launch<Tile<__VA_ARGS__>>(a, b, M, N, W, epi, clusters, stream);
    PM1_VARIANT(0, 3, false, 2, 4, 2, 2, 8, 3)
    PM1_VARIANT(0, 4, false, 2, 4, 2, 2, 8, 4)
    PM1_VARIANT(1, 3, true, 1, 1, 4, 1, 16, 3)
    PM1_VARIANT(1, 4, true, 1, 1, 4, 1, 16, 4)
    PM1_VARIANT(2, 3, true, 1, 2, 4, 1, 16, 3)
    PM1_VARIANT(2, 4, true, 1, 2, 4, 1, 16, 4)
    PM1_VARIANT(3, 3, false, 2, 4, 2, 2, 16, 3)
    PM1_VARIANT(3, 4, false, 2, 4, 2, 2, 16, 4)
    PM1_VARIANT(4, 3, true, 1, 1, 2, 1, 16, 3)
    PM1_VARIANT(4, 4, true, 1, 1, 2, 1, 16, 4)
    PM1_VARIANT(5, 3, true, 1, 1, 4, 1, 32, 3)
    PM1_VARIANT(5, 4, true, 1, 1, 4, 1, 32, 4)
    PM1_VARIANT(6, 3, false, 1, 4, 2, 2, 8, 3)
    PM1_VARIANT(6, 4, false, 1, 4, 2, 2, 8, 4)
    PM1_VARIANT(7, 3, false, 1, 4, 4, 2, 8, 3)
    PM1_VARIANT(7, 4, false, 1, 4, 4, 2, 8, 4)
    PM1_VARIANT(8, 3, false, 1, 16, 4, 1, 8, 3, 2)
    PM1_VARIANT(9, 3, false, 1, 16, 4, 1, 8, 3, 1)
    PM1_VARIANT(10, 3, false, 1, 8, 4, 1, 8, 3, 2)
#undef PM1_VARIANT
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K6's epilogue (dot - pad_bits) on one variant.
extern "C" int variant_mxu_pm1_matmul(const void* a, const void* b,
                                      void* out, int M, int N, int W,
                                      int pad_bits, int variant, int stages,
                                      int clusters, void* stream) {
  const DotEpilogue epi{(int32_t*)out, M, N, pad_bits};
  return (int)launch_variant(variant, stages, (const int32_t*)a,
                             (const int32_t*)b, M, N, W, epi, clusters,
                             (cudaStream_t)stream);
}

// K2's threshold-and-pack epilogue on one variant.
extern "C" int variant_fused_matmul_bn_binarize(
    const void* a, const void* b, const void* t, const void* s, void* out,
    int M, int N, int W, int variant, int stages, int clusters,
    void* stream) {
  const ThresholdPackEpilogue epi{(int32_t*)out, (const int32_t*)t,
                                  (const uint8_t*)s, M, N, W};
  return (int)launch_variant(variant, stages, (const int32_t*)a,
                             (const int32_t*)b, M, N, W, epi, clusters,
                             (cudaStream_t)stream);
}

extern "C" const char* variant_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
