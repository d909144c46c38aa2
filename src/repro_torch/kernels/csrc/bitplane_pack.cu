// First-layer bit-plane split + channel packing (paper Eqn 2, C8).
//
// Replaces the TPU kernel repro/kernels/bitplane_pack.py :: bitplane_pack.
//
// (N, H, W, C) uint8 -> (N, H, W, 8*Cw) int32, plane-major per pixel: plane
// p occupies words [p*Cw, (p+1)*Cw), channel c of a plane lands on bit c%32
// of word c/32 (LSB-first), pad channels are 0.
//
// Bound on the H100: bytes.  It does no arithmetic worth counting; it reads
// C bytes and writes 8*Cw*4 bytes per pixel, so at C=3 it writes ~11x what
// it reads.  Design: one thread per output word (pixel, plane, word), so
// consecutive threads store consecutive int32 words (coalesced writes); the
// <=32 input bytes a thread reads are shared with the 8*Cw-1 neighbouring
// threads of the same pixel and come from L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bitplane_pack_kernel(const uint8_t* __restrict__ x,
                                     int32_t* __restrict__ out,
                                     long long total_words, int channels,
                                     int cw) {
  long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total_words) return;
  const int words_per_pixel = 8 * cw;
  const long long pixel = tid / words_per_pixel;
  const int r = (int)(tid - pixel * words_per_pixel);
  const int plane = r / cw;
  const int wi = r - plane * cw;
  const uint8_t* px = x + pixel * channels;
  const int lo = wi * 32;
  const int hi = min(lo + 32, channels);
  uint32_t word = 0;
  for (int c = lo; c < hi; ++c) {
    word |= (uint32_t)((px[c] >> plane) & 1u) << (c - lo);
  }
  out[tid] = (int32_t)word;
}

}  // namespace

extern "C" int launch_bitplane_pack(const void* x, void* out,
                                    long long pixels, int channels,
                                    void* stream) {
  const int cw = (channels + 31) / 32;
  const long long total = pixels * 8LL * cw;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  bitplane_pack_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)x, (int32_t*)out, total, channels, cw);
  return (int)cudaGetLastError();
}

extern "C" const char* phonebit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
