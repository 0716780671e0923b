// K2: ray id -> stratified sub-pixel uv -> pinhole camera ray.
//
// Replaces render/camera.py::pixel_uv (124-152) and eval_camera (27-41) of
// the JAX package, as called from render/renderer.py:229-230.
//
// Ray ids are pixel-major, sample-minor: pixel = id / spp, sub-sample
// (jj, ii) = (sub / samples, sub % samples), offsets (k + 0.5) / samples.
// Width, height and samples are runtime divisors: a division by a literal
// may be compiled as a multiplication by its reciprocal, which is not the
// IEEE quotient the reference computes. The frame scalars h and w come from
// the wrapper, which computes them once with the same torch ops as the plain
// version, so both see the same bits.
//
// What bounds it on an H100: writing 7 floats per ray (28 bytes; 4 bytes
// read), a store-bandwidth pass of a few microseconds per million rays. One
// thread per ray with coalesced id reads; nothing else to do.
#include "common.cuh"

namespace yrt {

__global__ void camera_rays_kernel(const int* __restrict__ ids, int n,
                                   int width, int height, int samples,
                                   const float* __restrict__ axes,
                                   const float* __restrict__ org, float h,
                                   float w, float focus, float* __restrict__ uv,
                                   float* __restrict__ ro,
                                   float* __restrict__ rd) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int id = ids[k];
  const int spp = samples * samples;
  const int pix = id / spp;
  const int sample = id % spp;
  const int jj = sample / samples;
  const int ii = sample % samples;
  const float s = static_cast<float>(samples);
  const float u = (static_cast<float>(pix % width) +
                   (static_cast<float>(ii) + 0.5f) / s) /
                  static_cast<float>(width);
  const float v = (static_cast<float>(pix / width) +
                   (static_cast<float>(jj) + 0.5f) / s) /
                  static_cast<float>(height);

  const V3 x = load3(axes, 0);
  const V3 yn = load3(axes, 1);
  const V3 y = make(-yn.x, -yn.y, -yn.z);
  const V3 z = load3(axes, 2);
  const V3 o = load3(org, 0);
  const float cu = (u - 0.5f) * w;
  const float cv = (v - 0.5f) * h;
  const V3 fz = mul(z, focus);
  // q = o + (u - 0.5) * w * x + (v - 0.5) * h * y - focus * z
  const V3 q = sub(add(add(o, mul(x, cu)), mul(y, cv)), fz);
  V3 d = sub(q, o);
  const float nrm = sqrtf(dot(d, d));
  d = make(d.x / nrm, d.y / nrm, d.z / nrm);

  uv[2 * k] = u;
  uv[2 * k + 1] = v;
  ro[3 * k] = o.x;
  ro[3 * k + 1] = o.y;
  ro[3 * k + 2] = o.z;
  rd[3 * k] = d.x;
  rd[3 * k + 1] = d.y;
  rd[3 * k + 2] = d.z;
}

}  // namespace yrt

extern "C" int yrt_camera_rays(const int* ids, int n, int width, int height,
                               int samples, const float* cam_axes,
                               const float* cam_o, float h, float w,
                               float focus, float* uv, float* ro, float* rd,
                               void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    yrt::camera_rays_kernel<<<yrt::blocks_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ids, n, width, height, samples, cam_axes, cam_o, h, w, focus, uv, ro,
        rd);
  }
  return static_cast<int>(cudaGetLastError());
}
