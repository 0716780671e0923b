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
// The reduction has two stages, per-block partials then one fixed-order sum,
// so the result does not depend on scheduling. What bounds it: reading 32
// bytes per ray and a shuffle tree of 15 values per warp.
#include "common.cuh"

namespace yrt {

constexpr int kCamGrads = 15;  // axes (9), o (3), h, w, focus
constexpr int kCamBwdThreads = 256;

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

// Stage 1: one thread per ray, warp shuffle tree, then the block's warps in
// order: partials[block][15].
__global__ void __launch_bounds__(kCamBwdThreads)
    camera_bwd_partial_kernel(const float* __restrict__ uv,
                              const float* __restrict__ g_ro,
                              const float* __restrict__ g_rd, int n,
                              const float* __restrict__ axes,
                              const float* __restrict__ org,
                              const float* __restrict__ h_p,
                              const float* __restrict__ w_p,
                              const float* __restrict__ focus_p,
                              float* __restrict__ partials) {
  __shared__ float warp_part[kCamBwdThreads / 32][kCamGrads];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  float gr[kCamGrads];
#pragma unroll
  for (int j = 0; j < kCamGrads; ++j) gr[j] = 0.0f;
  if (k < n) {
    const float u = uv[2 * k], v = uv[2 * k + 1];
    const float h = __ldg(h_p), w = __ldg(w_p), focus = __ldg(focus_p);
    const V3 x = load3(axes, 0);
    const V3 yn = load3(axes, 1);
    const V3 y = make(-yn.x, -yn.y, -yn.z);
    const V3 z = load3(axes, 2);
    const V3 o = load3(org, 0);
    const float cu = (u - 0.5f) * w;
    const float cv = (v - 0.5f) * h;
    const V3 q = sub(add(add(o, mul(x, cu)), mul(y, cv)), mul(z, focus));
    const V3 d = sub(q, o);
    const float nrm = sqrtf(dot(d, d));
    const V3 rd = make(d.x / nrm, d.y / nrm, d.z / nrm);
    const V3 g = load3(g_rd, k);
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
    const V3 gro = load3(g_ro, k);
    gr[9] = gro.x;
    gr[10] = gro.y;
    gr[11] = gro.z;
    gr[12] = (v - 0.5f) * dot(gq, y);
    gr[13] = (u - 0.5f) * dot(gq, x);
    gr[14] = -dot(gq, z);
  }
#pragma unroll
  for (int j = 0; j < kCamGrads; ++j) {
    float s = gr[j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x / 32][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kCamGrads) {
    float s = 0.0f;
    for (int wi = 0; wi < kCamBwdThreads / 32; ++wi)
      s += warp_part[wi][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * kCamGrads + threadIdx.x] = s;
  }
}

// Stage 2: one block, warp j sums column j of the partials in a fixed order.
__global__ void camera_bwd_sum_kernel(const float* __restrict__ partials,
                                      int nblocks, float* __restrict__ out) {
  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int b = lane; b < nblocks; b += 32)
    s += partials[static_cast<long long>(b) * kCamGrads + j];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[j] = s;
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

// Number of f32 partials yrt_camera_bwd needs as scratch for n rays.
extern "C" int yrt_camera_bwd_scratch(int n) {
  return static_cast<int>(yrt::blocks_for(n, yrt::kCamBwdThreads)) *
         yrt::kCamGrads;
}

// out (15,) = [d_axes (9, row-major), d_o (3), d_h, d_w, d_focus]
extern "C" int yrt_camera_bwd(const float* uv, const float* g_ro,
                              const float* g_rd, int n, const float* cam_axes,
                              const float* cam_o, const float* h,
                              const float* w, const float* focus,
                              float* partials, float* out, void* stream) {
  const int nblocks = n > 0 ? static_cast<int>(
                                  yrt::blocks_for(n, yrt::kCamBwdThreads))
                            : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    yrt::camera_bwd_partial_kernel<<<nblocks, yrt::kCamBwdThreads, 0, st>>>(
        uv, g_ro, g_rd, n, cam_axes, cam_o, h, w, focus, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  yrt::camera_bwd_sum_kernel<<<1, 32 * yrt::kCamGrads, 0, st>>>(
      partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}
