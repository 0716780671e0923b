// K2: ray id -> stratified sub-pixel uv -> pinhole camera ray, and K6, its
// reverse.
//
// K2 replaces render/camera.py::pixel_uv (124-152) and eval_camera (27-41)
// of the JAX package, as called from render/renderer.py:229-230.
//
// Ray ids are pixel-major, sample-minor: pixel = id / spp, sub-sample
// (jj, ii) = (sub / samples, sub % samples), offsets (k + 0.5) / samples.
// Width, height and samples are runtime divisors: a division by a literal
// may be compiled as a multiplication by its reciprocal, which is not the
// IEEE quotient the reference computes. The frame scalars h, w and focus are
// read from device memory (0-dim tensors that the wrapper computes with the
// same torch ops as the plain version), so the launch needs no host sync and
// the scalars stay in the autograd graph.
//
// What bounds K2 on an H100: writing 7 floats per ray (28 bytes; 4 bytes
// read), a store-bandwidth pass of a few microseconds per million rays. One
// thread per ray with coalesced id reads; nothing else to do.
//
// K6 is the reverse of eval_camera (the XLA adjoint of render/camera.py:27 in
// the JAX package's training step): per ray, the adjoint of
// d = normalize((u-.5)*w*x + (v-.5)*h*y - focus*z) and of ro = o, reduced
// over the batch into d_cam_axes (3, 3), d_cam_o (3), d_h, d_w and d_focus.
// What bounds it on an H100: reading 32 bytes per ray (uv, g_ro, g_rd),
// about 10 us for 2^20 rays at 3.35 TB/s; its ~110 operations a ray take
// less (1.7 us at 67 TFLOP/s). An earlier design took a shuffle tree per sum,
// 75 shuffles a thread, and a second launch of one block for the column
// sums. Here each thread takes kCamRays rays and one launch sums the batch
// (common.cuh, camera_block_sums): 16 shuffles a warp, and the last block
// adds the column-major partials, in an order that depends on n alone. The
// per-ray terms are the plain version's, op for op; the 16th slot is 0, so K9
// sums its 15 shared slots in the same order.
#include "common.cuh"

namespace yrt {

__global__ void camera_rays_kernel(const int* __restrict__ ids, int n,
                                   int width, int height, int samples,
                                   const float* __restrict__ axes,
                                   const float* __restrict__ org,
                                   const float* __restrict__ h_p,
                                   const float* __restrict__ w_p,
                                   const float* __restrict__ focus_p,
                                   float* __restrict__ uv,
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

  const float h = __ldg(h_p), w = __ldg(w_p), focus = __ldg(focus_p);
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

// K6: kCamRays rays a thread, 15 terms a ray (slot 15 stays 0), then the
// block's sums; the last block writes out.
__global__ void __launch_bounds__(kCamThreads, kCamMinBlocks)
    camera_bwd_kernel(const float* __restrict__ uv,
                      const float* __restrict__ g_ro,
                      const float* __restrict__ g_rd, int n,
                      const float* __restrict__ axes,
                      const float* __restrict__ org,
                      const float* __restrict__ h_p,
                      const float* __restrict__ w_p,
                      const float* __restrict__ focus_p,
                      float* __restrict__ partials, float* __restrict__ out,
                      int* __restrict__ counter) {
  const float h = __ldg(h_p), w = __ldg(w_p), focus = __ldg(focus_p);
  const V3 x = load3(axes, 0);
  const V3 yn = load3(axes, 1);
  const V3 y = make(-yn.x, -yn.y, -yn.z);
  const V3 z = load3(axes, 2);
  const V3 o = load3(org, 0);
  float acc[kCamSlots];
#pragma unroll
  for (int j = 0; j < kCamSlots; ++j) acc[j] = 0.0f;
#pragma unroll 1
  for (int ray = 0; ray < kCamRays; ++ray) {
    const int k = camera_ray(ray);
    if (k >= n) break;   // the rays of a thread go up with ray
    // the ray's inputs, all loaded before its terms: one wait a ray
    const float u = uv[2 * k], v = uv[2 * k + 1];
    const V3 g = load3(g_rd, k);
    const V3 gro = load3(g_ro, k);
    float gr[kCamSlots];
    const float cu = (u - 0.5f) * w;
    const float cv = (v - 0.5f) * h;
    const V3 q = sub(add(add(o, mul(x, cu)), mul(y, cv)), mul(z, focus));
    const V3 d = sub(q, o);
    const float nrm = sqrtf(dot(d, d));
    const V3 rd = make(d.x / nrm, d.y / nrm, d.z / nrm);
    // rd = d / |d|: d_d = (g - rd (g . rd)) / |d|
    const float c = dot(g, rd);
    const V3 gq = make((g.x - rd.x * c) / nrm, (g.y - rd.y * c) / nrm,
                       (g.z - rd.z * c) / nrm);
    // q = o + cu x + cv y - focus z, y = -axes[1]; d = q - o; ro = o
    gr[0] = gq.x * cu;
    gr[1] = gq.y * cu;
    gr[2] = gq.z * cu;
    gr[3] = -gq.x * cv;
    gr[4] = -gq.y * cv;
    gr[5] = -gq.z * cv;
    gr[6] = -gq.x * focus;
    gr[7] = -gq.y * focus;
    gr[8] = -gq.z * focus;
    gr[9] = gro.x;
    gr[10] = gro.y;
    gr[11] = gro.z;
    gr[12] = (v - 0.5f) * dot(gq, y);
    gr[13] = (u - 0.5f) * dot(gq, x);
    gr[14] = -dot(gq, z);
    gr[15] = 0.0f;
    camera_add_ray(acc, gr);
  }
  camera_block_sums(acc, partials, out, counter);
}

}  // namespace yrt

extern "C" int yrt_camera_rays(const int* ids, int n, int width, int height,
                               int samples, const float* cam_axes,
                               const float* cam_o, const float* h,
                               const float* w, const float* focus, float* uv,
                               float* ro, float* rd, void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    yrt::camera_rays_kernel<<<yrt::blocks_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        ids, n, width, height, samples, cam_axes, cam_o, h, w, focus, uv, ro,
        rd);
  }
  return static_cast<int>(cudaGetLastError());
}

// Number of f32 partials yrt_camera_bwd and yrt_camera_stochastic_bwd need
// as scratch for n rays: 16 a block.
extern "C" int yrt_camera_bwd_scratch(int n) {
  return yrt::camera_blocks(n) * yrt::kCamSlots;
}

// K6. out (16,) = [d_axes (9, row-major), d_o (3), d_h, d_w, d_focus, 0].
// counter: one i32, 0 before the launch and after it; launches that share it
// must not overlap.
extern "C" int yrt_camera_bwd(const float* uv, const float* g_ro,
                              const float* g_rd, int n, const float* cam_axes,
                              const float* cam_o, const float* h,
                              const float* w, const float* focus,
                              float* partials, float* out, int* counter,
                              void* stream) {
  yrt::camera_bwd_kernel<<<yrt::camera_blocks(n), yrt::kCamThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      uv, g_ro, g_rd, n, cam_axes, cam_o, h, w, focus, partials, out,
      counter);
  return static_cast<int>(cudaGetLastError());
}
