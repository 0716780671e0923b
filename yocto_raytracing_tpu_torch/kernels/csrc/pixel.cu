// K3: per-pixel finish of a chunk of per-ray radiance.
//
// Replaces the per-pixel spp sum of render/renderer.py::_render_chunk (106)
// and the device tonemap of _render_chunks_fused (165-172) in the JAX
// package.
//
// One thread per pixel sums each channel of the pixel's spp contiguous
// samples in sample order, the order of the plain version and of the
// reference's accumulation loop. In HDR mode it writes the three f32 sums
// (a (rows, 3) f32 buffer). In LDR mode it then divides each sum by spp,
// applies pow(max(x, 0), 1/2.2), clips to [0, 1], scales by 255 and
// truncates to u8 (image.py tonemap semantics, exposure 0, no filmic), and
// writes the pixel as one 4-byte store of R, G, B and alpha 255: a (rows, 4)
// u8 buffer, the layout of the caller's RGBA image, so the host copies it
// and makes no pass over it.
//
// `chunk`, when not null, is the device loop's chunk index (a device int):
// the npix pixels go to rows chunk * npix.. of a frame-sized output, so a
// captured launch writes each replay's chunk in place.
//
// What bounds it on an H100: reading 12 * spp bytes and writing 12 (HDR) or
// 4 (LDR) bytes per pixel, a bandwidth pass; the strided reads of one warp
// fall within 32 * spp * 12 contiguous bytes, so they coalesce in L2. A
// thread a pixel leaves a third of the threads of a thread a channel, so
// where spp is a multiple of 4 and the rows are 16-byte aligned (the device
// loop's) a thread reads its pixel as 3 * spp / 4 float4 loads, all in
// flight at once: a chunk of 32,768 pixels at 16 spp then takes the time
// that a thread a channel took (4.2 us against 4.15; 6.6 with scalar loads).
#include <cstdint>

#include "common.cuh"

namespace yrt {

__device__ __forceinline__ uint32_t tonemap_u8(float acc, int spp) {
  const float inv_gamma = static_cast<float>(1.0 / 2.2);
  float x = acc / static_cast<float>(spp);
  x = x < 0.0f ? 0.0f : x;  // max(x, 0) that keeps a NaN, like torch
  x = powf(x, inv_gamma);
  x = clamp01(x) * 255.0f;
  return static_cast<uint32_t>(static_cast<uint8_t>(x));
}

// r, g, b += the four samples of three quads, in sample order
__device__ __forceinline__ void add4(float4 x, float4 y, float4 z, float& r,
                                     float& g, float& b) {
  r = r + x.x; g = g + x.y; b = b + x.z;
  r = r + x.w; g = g + y.x; b = b + y.y;
  r = r + y.z; g = g + y.w; b = b + z.x;
  r = r + z.y; g = g + z.z; b = b + z.w;
}

// `quads`: spp % 4 == 0 and rgb 16-byte aligned, so every pixel's samples
// are 3 * spp / 4 aligned float4s
__global__ void pixel_finish_kernel(const float* __restrict__ rgb, int npix,
                                    int spp, int ldr, int quads,
                                    float* __restrict__ out_sum,
                                    uint32_t* __restrict__ out_rgba,
                                    const int* __restrict__ chunk) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const long long row =
      (chunk != nullptr ? static_cast<long long>(npix) * *chunk : 0) + p;
  const float* src = rgb + p * spp * 3;
  // each sum starts from the first sample (0 + -0 would read +0)
  float r = src[0], g = src[1], b = src[2];
  if (quads) {
    const float4* q = reinterpret_cast<const float4*>(src);
    const float4 x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
    r = r + x.w; g = g + y.x; b = b + y.y;   // samples 1-3 of the first quad
    r = r + y.z; g = g + y.w; b = b + z.x;
    r = r + z.y; g = g + z.z; b = b + z.w;
    for (int k = 1; k < spp / 4; ++k)
      add4(__ldg(q + 3 * k), __ldg(q + 3 * k + 1), __ldg(q + 3 * k + 2), r, g,
           b);
  } else {
    for (int k = 1; k < spp; ++k) {
      r = r + src[3 * k];
      g = g + src[3 * k + 1];
      b = b + src[3 * k + 2];
    }
  }
  if (!ldr) {
    float* dst = out_sum + 3 * row;
    dst[0] = r;
    dst[1] = g;
    dst[2] = b;
    return;
  }
  // little-endian: byte 0 is R, byte 3 alpha
  out_rgba[row] = tonemap_u8(r, spp) | (tonemap_u8(g, spp) << 8) |
                  (tonemap_u8(b, spp) << 16) | (255u << 24);
}

}  // namespace yrt

extern "C" int yrt_pixel_finish(const float* rgb, int npix, int spp, int ldr,
                                float* out_sum, uint32_t* out_rgba,
                                const int* chunk, void* stream) {
  if (npix > 0) {
    constexpr int kThreads = 256;
    const int quads =
        spp % 4 == 0 && reinterpret_cast<uintptr_t>(rgb) % 16 == 0;
    yrt::pixel_finish_kernel<<<yrt::blocks_for(npix, kThreads), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        rgb, npix, spp, ldr, quads, out_sum, out_rgba, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
