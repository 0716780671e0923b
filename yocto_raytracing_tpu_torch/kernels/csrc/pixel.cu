// K3: per-pixel finish of a chunk of per-ray radiance.
//
// Replaces the per-pixel spp sum of render/renderer.py::_render_chunk (106)
// and the device tonemap of _render_chunks_fused (165-172) in the JAX
// package.
//
// One thread per (pixel, channel) sums the pixel's spp contiguous samples in
// sample order, the order of the plain version and of the reference's
// accumulation loop. In LDR mode it then divides by spp, applies
// pow(max(x, 0), 1/2.2), clips to [0, 1], scales by 255 and truncates to u8
// (image.py tonemap semantics, exposure 0, no filmic).
//
// `chunk`, when not null, is the device loop's chunk index (a device int):
// the npix pixels go to rows chunk * npix.. of a frame-sized output, so a
// captured launch writes each replay's chunk in place.
//
// What bounds it on an H100: reading 12 * spp bytes and writing 12 (HDR) or
// 3 (LDR) bytes per pixel, a bandwidth pass; the strided reads of one warp
// fall within 32 * spp * 12 contiguous bytes, so they coalesce in L2.
#include <cstdint>

#include "common.cuh"

namespace yrt {

__global__ void pixel_finish_kernel(const float* __restrict__ rgb, int npix,
                                    int spp, int ldr,
                                    float* __restrict__ out_sum,
                                    uint8_t* __restrict__ out_u8,
                                    const int* __restrict__ chunk) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 3LL * npix) return;
  const long long row0 = chunk != nullptr ? 3LL * npix * *chunk : 0;
  const long long p = idx / 3;
  const int c = static_cast<int>(idx % 3);
  const float* src = rgb + p * spp * 3 + c;
  float acc = src[0];
  for (int k = 1; k < spp; ++k) acc = acc + src[3 * k];
  if (!ldr) {
    out_sum[row0 + idx] = acc;
    return;
  }
  const float inv_gamma = static_cast<float>(1.0 / 2.2);
  float x = acc / static_cast<float>(spp);
  x = x < 0.0f ? 0.0f : x;  // max(x, 0) that keeps a NaN, like torch
  x = powf(x, inv_gamma);
  x = clamp01(x) * 255.0f;
  out_u8[row0 + idx] = static_cast<uint8_t>(x);
}

}  // namespace yrt

extern "C" int yrt_pixel_finish(const float* rgb, int npix, int spp, int ldr,
                                float* out_sum, uint8_t* out_u8,
                                const int* chunk, void* stream) {
  if (npix > 0) {
    constexpr int kThreads = 256;
    yrt::pixel_finish_kernel<<<yrt::blocks_for(3LL * npix, kThreads), kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
        rgb, npix, spp, ldr, out_sum, out_u8, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
