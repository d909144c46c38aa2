// First-layer bit-plane split + channel packing (paper Eqn 2, C8).
//
// Replaces the TPU kernel repro/kernels/bitplane_pack.py :: bitplane_pack.
//
// (N, H, W, C) uint8 -> (N, H, W, 8*Cw) int32, plane-major per pixel: plane
// p occupies words [p*Cw, (p+1)*Cw), channel c of a plane lands on bit c%32
// of word c/32 (LSB-first), pad channels are 0.
//
// Bound on the H100: bytes.  It reads C bytes and writes 32*Cw bytes a
// pixel (at C = 3, ~11x what it reads) and does ~20 integer operations a
// group of 8 channels.  Design:
//  * each block owns a contiguous span of pixels and stages the span's
//    bytes in shared memory with 16-byte loads (the window's unaligned
//    head and tail chunks by bytes), so the input is read once, wide;
//  * one thread builds every word of a pixel: 8 channels at a time as one
//    64-bit value, whose 8 x 8 bit matrix is transposed (Hacker's Delight
//    transpose8) so that byte p holds plane p of those channels; the bytes
//    are then assembled into the plane words;
//  * thread t of a block builds pixel t of the span, so a warp writes 32
//    neighbouring pixels' 32*Cw-byte runs: at Cw = 1 (C <= 32, the
//    main path) the lanes exchange halves through shuffles so that each
//    16-byte store instruction covers 512 contiguous bytes; at Cw 2..4
//    each lane stores its run as 16-byte vectors, above as 4-byte words;
//  * 32-bit index arithmetic and no division in the kernel; the 64-bit
//    path (kWide) only where a byte offset of the input or output reaches
//    2^31.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Bytes of input a block stages at most: its span is kThreads pixels, or
// as many as fit this (at least one).
constexpr int kSpanBytes = 16384;

__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  // Row i = byte i, column j = bit j: afterwards byte p bit j holds what
  // was byte j bit p.
  x = (x & 0xAA55AA55AA55AA55ull) | ((x & 0x00AA00AA00AA00AAull) << 7) |
      ((x >> 7) & 0x00AA00AA00AA00AAull);
  x = (x & 0xCCCC3333CCCC3333ull) | ((x & 0x0000CCCC0000CCCCull) << 14) |
      ((x >> 14) & 0x0000CCCC0000CCCCull);
  x = (x & 0xF0F0F0F00F0F0F0Full) | ((x & 0x00000000F0F0F0F0ull) << 28) |
      ((x >> 28) & 0x00000000F0F0F0F0ull);
  return x;
}

// The 8 plane words of word wi (channels 32*wi ..) of one pixel whose
// bytes start at px: planes[p] = plane p's word.
__device__ __forceinline__ void pixel_word(const uint8_t* px, int channels,
                                           int wi, uint32_t planes[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) planes[p] = 0u;
  const int lo = wi * 32;
  const int count = min(32, channels - lo);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int n = min(8, count - 8 * g);
    if (n <= 0) break;
    uint64_t x = 0;
    for (int j = 0; j < n; ++j) x |= (uint64_t)px[lo + 8 * g + j] << (8 * j);
    x = transpose8(x);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      planes[p] |= (uint32_t)((x >> (8 * p)) & 0xFFu) << (8 * g);
    }
  }
}

// CW > 0: Cw known at compile time (1 .. 4), the pixel's 8*CW words built
// in registers and stored as 16-byte vectors.  CW == 0: any Cw, 4-byte
// stores.  A block's span is at most kThreads pixels: thread t builds
// pixel t of the span.
template <int CW, bool kWide>
__global__ void __launch_bounds__(kThreads)
bitplane_pack_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                     long long pixels, int channels, int cw, int span) {
  using Index = typename std::conditional<kWide, long long, int>::type;
  extern __shared__ __align__(16) uint8_t stage[];
  const Index p0 = (Index)blockIdx.x * span;
  const int n_pix = (int)min((long long)span, pixels - (long long)p0);
  // Stage the span's nbytes bytes from src: the window starts at the
  // 16-byte boundary at or below src, so byte i of the span lands at
  // stage[shift + i] and every full 16-byte chunk is one vector copy.
  const uint8_t* src = x + p0 * (Index)channels;
  const int nbytes = n_pix * channels;
  const int shift = (int)((uintptr_t)src & 15u);
  const uint8_t* base = src - shift;
  const int chunks = (shift + nbytes + 15) >> 4;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int b0 = 16 * k;
    if (b0 >= shift && b0 + 16 <= shift + nbytes) {
      *reinterpret_cast<uint4*>(stage + b0) =
          __ldg(reinterpret_cast<const uint4*>(base + b0));
    } else {
      const int lo = max(b0, shift), hi = min(b0 + 16, shift + nbytes);
      for (int b = lo; b < hi; ++b) stage[b] = base[b];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i0 = threadIdx.x - lane;              // the warp's first pixel
  if (i0 >= n_pix) return;                        // whole warps only
  const int i = i0 + lane;
  const bool real = i < n_pix;
  const uint8_t* px = stage + shift + i * channels;
  if constexpr (CW == 1) {
    uint32_t w[8];
    pixel_word(px, real ? channels : 0, 0, w);
    // The warp's 32 pixels own 64 contiguous 16-byte chunks: store v
    // writes chunk 32v + lane, half (lane & 1) of pixel 16v + lane / 2,
    // fetched from that pixel's lane (both halves, then one is kept), so
    // each store instruction covers 512 contiguous bytes.
    const int half = lane & 1;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int from = 16 * v + (lane >> 1);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = __shfl_sync(0xffffffffu, w[k], from);
        const uint32_t hi = __shfl_sync(0xffffffffu, w[4 + k], from);
        o[k] = half ? hi : lo;
      }
      if (i0 + from < n_pix) {
        uint4* d4 = reinterpret_cast<uint4*>(
            out + (p0 + i0 + from) * (Index)8) + half;
        *d4 = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  } else if constexpr (CW > 1) {
    if (!real) return;
    uint32_t w[8 * CW];
#pragma unroll
    for (int wi = 0; wi < CW; ++wi) {
      uint32_t planes[8];
      pixel_word(px, channels, wi, planes);
#pragma unroll
      for (int p = 0; p < 8; ++p) w[p * CW + wi] = planes[p];
    }
    uint4* d4 = reinterpret_cast<uint4*>(out + (p0 + i) * (Index)(8 * CW));
#pragma unroll
    for (int v = 0; v < 2 * CW; ++v) {
      d4[v] = make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
    }
  } else {
    if (!real) return;
    int32_t* dst = out + (p0 + i) * (Index)(8 * cw);
    for (int wi = 0; wi < cw; ++wi) {
      uint32_t planes[8];
      pixel_word(px, channels, wi, planes);
#pragma unroll
      for (int p = 0; p < 8; ++p) dst[p * cw + wi] = (int32_t)planes[p];
    }
  }
}

template <int CW, bool kWide>
cudaError_t launch(const uint8_t* x, int32_t* out, long long pixels,
                   int channels, int cw, cudaStream_t stream) {
  const int span = max(1, min(kThreads, kSpanBytes / channels));
  const long long blocks = (pixels + span - 1) / span;
  // The staged bytes plus room for the window's alignment shift.
  const size_t smem = (size_t)span * channels + 16;
  bitplane_pack_kernel<CW, kWide><<<(unsigned)blocks, kThreads, smem,
                                    stream>>>(x, out, pixels, channels, cw,
                                              span);
  return cudaGetLastError();
}

template <bool kWide>
cudaError_t dispatch(const uint8_t* x, int32_t* out, long long pixels,
                     int channels, int cw, cudaStream_t stream) {
  switch (cw) {
    case 1: return launch<1, kWide>(x, out, pixels, channels, cw, stream);
    case 2: return launch<2, kWide>(x, out, pixels, channels, cw, stream);
    case 3: return launch<3, kWide>(x, out, pixels, channels, cw, stream);
    case 4: return launch<4, kWide>(x, out, pixels, channels, cw, stream);
    default: return launch<0, kWide>(x, out, pixels, channels, cw, stream);
  }
}

}  // namespace

extern "C" int launch_bitplane_pack(const void* x, void* out,
                                    long long pixels, int channels,
                                    void* stream) {
  if (pixels == 0) return (int)cudaSuccess;
  // One pixel's bytes must fit a block's staged span
  // (bitplane_pack.MAX_CHANNELS on the Python side).
  if (channels < 1 || channels > kSpanBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const int cw = (channels + 31) / 32;
  // Byte offsets of the input (pixels * C) and of the output
  // (pixels * 32 * Cw) past 2^31 - 1 take the 64-bit index path.
  const long long extent = pixels * (long long)max(channels, 32 * cw);
  const bool wide = extent >= (1LL << 31);
  const uint8_t* xp = (const uint8_t*)x;
  int32_t* op = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? dispatch<true>(xp, op, pixels, channels, cw, s)
                    : dispatch<false>(xp, op, pixels, channels, cw, s));
}

extern "C" const char* phonebit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
