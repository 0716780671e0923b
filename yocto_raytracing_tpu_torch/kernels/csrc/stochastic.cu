// K7: stochastic camera rays: ray id -> PCG variates -> jittered sub-pixel
// uv and a unit-disk lens sample -> thin-lens camera ray.
//
// Replaces render/camera.py::_pcg_hash (44-50), per_ray_uniform (53-70),
// pixel_uv_jittered (100-121) and eval_camera_dof (73-97), with
// ops/sampling.py::sample_disk (69-74), of the JAX package, as chained in
// render/renderer.py:214-227: the jitter variates come from `seed`, the
// lens variates from `seed ^ 0x9E3779B9`, and the lens radius is
// cam_aperture / 2.
//
// One thread per ray runs the whole chain; nothing is shared between rays.
// The arithmetic repeats the plain torch chain of render/camera.py op for op
// (u32 hashing that wraps, IEEE divides by the run-time width, height and
// samples, sqrtf, cosf/sinf of the f32 2*pi*r0, the thin-lens origin and the
// normalized direction to the pinhole target), built with --fmad=false, so
// K7 is held bit-equal to it on the card. With aperture 0 the origin is the
// camera origin and the ray equals K2's for the same uv. The frame scalars
// h, w, focus and aperture are read from device memory, as in K2.
//
// What bounds K7 on an H100: 4 bytes read and 32 bytes written per ray
// (uv, ro, rd), about 5.6 us per 524,288-ray chunk at 3.35 TB/s; ~150
// scalar operations per ray are ~1.2 us at 67 TFLOP/s. Memory-bound; one
// thread per ray with coalesced id reads is all the design needs.
#include "common.cuh"

namespace yrt {

constexpr unsigned int kLensSeedXor = 0x9E3779B9u;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // f32 2 * f32 pi

__global__ void camera_rays_stochastic_kernel(
    const int* __restrict__ ids, int n, int width, int height, int samples,
    unsigned int seed, const float* __restrict__ axes,
    const float* __restrict__ org, const float* __restrict__ h_p,
    const float* __restrict__ w_p, const float* __restrict__ focus_p,
    const float* __restrict__ aperture_p, float* __restrict__ uv,
    float* __restrict__ ro, float* __restrict__ rd) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int id = ids[k];
  const float j0 = per_ray_uniform(seed, id, 0u);
  const float j1 = per_ray_uniform(seed, id, 1u);
  const float l0 = per_ray_uniform(seed ^ kLensSeedXor, id, 0u);
  const float l1 = per_ray_uniform(seed ^ kLensSeedXor, id, 1u);

  // stratified-jittered uv: offsets (k + u01) / samples
  const int spp = samples * samples;
  const int pix = id / spp;
  const int sample = id % spp;
  const int jj = sample / samples;
  const int ii = sample % samples;
  const float s = static_cast<float>(samples);
  const float u = (static_cast<float>(pix % width) +
                   (static_cast<float>(ii) + j0) / s) /
                  static_cast<float>(width);
  const float v = (static_cast<float>(pix / width) +
                   (static_cast<float>(jj) + j1) / s) /
                  static_cast<float>(height);

  // sample_disk: r = sqrt(r1), phi = 2 pi r0
  const float r = sqrtf(l1);
  const float phi = kTwoPi * l0;
  const float dx = cosf(phi) * r;
  const float dy = sinf(phi) * r;

  const float h = __ldg(h_p), w = __ldg(w_p), focus = __ldg(focus_p);
  const float lens = __ldg(aperture_p) / 2.0f;
  const V3 x = load3(axes, 0);
  const V3 yn = load3(axes, 1);
  const V3 y = make(-yn.x, -yn.y, -yn.z);
  const V3 z = load3(axes, 2);
  const V3 o = load3(org, 0);
  // pinhole target on the focus plane, as in K2
  const V3 q = sub(add(add(o, mul(x, (u - 0.5f) * w)), mul(y, (v - 0.5f) * h)),
                   mul(z, focus));
  // origin on the aperture disk: o + lens * (dx * x + dy * y)
  const V3 e = add(o, mul(add(mul(x, dx), mul(y, dy)), lens));
  V3 d = sub(q, e);
  const float nrm = sqrtf(dot(d, d));
  d = make(d.x / nrm, d.y / nrm, d.z / nrm);

  uv[2 * k] = u;
  uv[2 * k + 1] = v;
  ro[3 * k] = e.x;
  ro[3 * k + 1] = e.y;
  ro[3 * k + 2] = e.z;
  rd[3 * k] = d.x;
  rd[3 * k + 1] = d.y;
  rd[3 * k + 2] = d.z;
}

}  // namespace yrt

extern "C" int yrt_camera_rays_stochastic(
    const int* ids, int n, int width, int height, int samples,
    unsigned int seed, const float* cam_axes, const float* cam_o,
    const float* h, const float* w, const float* focus, const float* aperture,
    float* uv, float* ro, float* rd, void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    yrt::camera_rays_stochastic_kernel<<<yrt::blocks_for(n, kThreads),
                                         kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        ids, n, width, height, samples, seed, cam_axes, cam_o, h, w, focus,
        aperture, uv, ro, rd);
  }
  return static_cast<int>(cudaGetLastError());
}
