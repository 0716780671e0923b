// K6's and K9's first forms, kept for comparison only.
//
// The camera reverses as the first port wrote them: one thread per ray, a
// shuffle tree per sum into row-major per-block partials, then a second
// launch of one block that sums each column. chip_smoke.py times them in
// turns with camera.cu and stochastic.cu, on the same inputs and the same
// card; no path of the package launches them. Their text below is the first
// form's, under their own names, with the shared device code they used
// (block_partial_sums and column_sums of common.cuh, stochastic_sample with
// its run-time integer divisions, cam_frame and lens_ray of stochastic.cu).
//
// K6 is the reverse of eval_camera (the XLA adjoint of render/camera.py:27 in
// the JAX package's training step): per ray, the adjoint of
// d = normalize((u-.5)*w*x + (v-.5)*h*y - focus*z) and of ro = o, reduced
// over the batch into d_cam_axes (3, 3), d_cam_o (3), d_h, d_w and d_focus.
// The reduction has two stages, per-block partials then one fixed-order sum,
// so the result does not depend on scheduling. What bounds it: reading 32
// bytes per ray and a shuffle tree of 15 values per warp.
//
// K9 is K7's reverse, the adjoint of eval_camera_dof (JAX
// render/camera.py:73-97) for cotangents of (ro, rd): per ray, it recomputes
// the jittered uv and the lens sample from the id and the seed with K7's own
// device function (stochastic_sample), and the ray with K7's arithmetic,
// then runs the adjoint of
//   q  = o + (u - .5) w x + (v - .5) h y - focus z,   y = -axes[1]
//   ro = o + (aperture / 2) (dx x + dy y)
//   rd = (q - ro) / |q - ro|
// The 16 sums (d_axes 9, d_o 3, d_h, d_w, d_focus, d_aperture) are reduced
// like K6's 15. What bounds it: reading 4 + 24 bytes per ray (the id and two
// cotangents) and K7's recompute plus ~60 operations per ray.
#include "common.cuh"

namespace yrt::simple {

constexpr int kCamGrads = 15;  // axes (9), o (3), h, w, focus
constexpr int kCamBwdThreads = 256;
constexpr unsigned int kLensSeedXor = 0x9E3779B9u;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // f32 2 * f32 pi
constexpr int kCamStochGrads = 16;  // axes (9), o (3), h, w, focus, aperture
constexpr int kCamStochBwdThreads = 256;

// Deterministic batch sums of K per-thread values (the camera reverses K6
// and K9), in two stages with a fixed order. Stage 1, in a block of
// kThreads threads: each warp sums its lanes with a shuffle tree, then the
// block's warps are added in order into partials[blockIdx.x][K].
template <int K, int kThreads>
__device__ __forceinline__ void block_partial_sums(const float (&v)[K],
                                                   float* __restrict__ partials) {
  __shared__ float warp_part[kThreads / 32][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float s = v[j];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x / 32][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.0f;
    for (int wi = 0; wi < kThreads / 32; ++wi) s += warp_part[wi][threadIdx.x];
    partials[static_cast<long long>(blockIdx.x) * K + threadIdx.x] = s;
  }
}

// Stage 2, in one block of 32 * K threads: warp j sums column j of the
// nblocks partials (lane-strided, then a shuffle tree) into out[j].
template <int K>
__device__ __forceinline__ void column_sums(const float* __restrict__ partials,
                                            int nblocks,
                                            float* __restrict__ out) {
  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int b = lane; b < nblocks; b += 32)
    s += partials[static_cast<long long>(b) * K + j];
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[j] = s;
}

// Stage 1: one thread per ray, then block_partial_sums: partials[block][15].
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
  block_partial_sums<kCamGrads, kCamBwdThreads>(gr, partials);
}

// Stage 2: one block, warp j sums column j of the partials in a fixed order.
__global__ void camera_bwd_sum_kernel(const float* __restrict__ partials,
                                      int nblocks, float* __restrict__ out) {
  column_sums<kCamGrads>(partials, nblocks, out);
}

// Jittered uv and unit-disk lens sample (dx, dy) of ray `id`.
struct StochasticSample {
  float u, v, dx, dy;
};

__device__ __forceinline__ StochasticSample stochastic_sample(
    int id, int width, int height, int samples, unsigned int seed) {
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
  return StochasticSample{u, v, cosf(phi) * r, sinf(phi) * r};
}

// The camera frame of a launch, read from device memory.
struct CamFrame {
  V3 x, y, z, o;  // y = -axes[1]
  float h, w, focus, lens;  // lens = aperture / 2
};

__device__ __forceinline__ CamFrame cam_frame(const float* __restrict__ axes,
                                              const float* __restrict__ org,
                                              const float* __restrict__ h_p,
                                              const float* __restrict__ w_p,
                                              const float* __restrict__ focus_p,
                                              const float* __restrict__ ap_p) {
  CamFrame c;
  c.x = load3(axes, 0);
  const V3 yn = load3(axes, 1);
  c.y = make(-yn.x, -yn.y, -yn.z);
  c.z = load3(axes, 2);
  c.o = load3(org, 0);
  c.h = __ldg(h_p);
  c.w = __ldg(w_p);
  c.focus = __ldg(focus_p);
  c.lens = __ldg(ap_p) / 2.0f;
  return c;
}

// Thin-lens ray: origin e on the aperture disk, unnormalized direction
// d = q - e and its length.
struct LensRay {
  V3 e, d;
  float nrm;
};

__device__ __forceinline__ LensRay lens_ray(const CamFrame& c,
                                            const StochasticSample& sm) {
  // pinhole target on the focus plane, as in K2
  const V3 q = sub(add(add(c.o, mul(c.x, (sm.u - 0.5f) * c.w)),
                       mul(c.y, (sm.v - 0.5f) * c.h)),
                   mul(c.z, c.focus));
  // origin on the aperture disk: o + lens * (dx * x + dy * y)
  LensRay r;
  r.e = add(c.o, mul(add(mul(c.x, sm.dx), mul(c.y, sm.dy)), c.lens));
  r.d = sub(q, r.e);
  r.nrm = sqrtf(dot(r.d, r.d));
  return r;
}

// K9 stage 1: one thread per ray, then block_partial_sums:
// partials[block][16].
__global__ void __launch_bounds__(kCamStochBwdThreads)
    camera_stochastic_bwd_partial_kernel(
        const int* __restrict__ ids, int n, int width, int height,
        int samples, unsigned int seed, const float* __restrict__ g_ro,
        const float* __restrict__ g_rd, const float* __restrict__ axes,
        const float* __restrict__ org, const float* __restrict__ h_p,
        const float* __restrict__ w_p, const float* __restrict__ focus_p,
        const float* __restrict__ aperture_p, float* __restrict__ partials) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  float gr[kCamStochGrads];
#pragma unroll
  for (int j = 0; j < kCamStochGrads; ++j) gr[j] = 0.0f;
  if (k < n) {
    const StochasticSample sm =
        stochastic_sample(ids[k], width, height, samples, seed);
    const CamFrame c = cam_frame(axes, org, h_p, w_p, focus_p, aperture_p);
    const LensRay r = lens_ray(c, sm);
    const V3 rdn = make(r.d.x / r.nrm, r.d.y / r.nrm, r.d.z / r.nrm);
    // rd = d / |d|: g_d = (g - rd (g . rd)) / |d|; q gets g_d, e gets
    // g_ro - g_d
    const V3 g = load3(g_rd, k);
    const float cg = dot(g, rdn);
    const V3 gq = make((g.x - rdn.x * cg) / r.nrm, (g.y - rdn.y * cg) / r.nrm,
                       (g.z - rdn.z * cg) / r.nrm);
    const V3 gro = load3(g_ro, k);
    const V3 ge = sub(gro, gq);
    const float cu = (sm.u - 0.5f) * c.w;
    const float cv = (sm.v - 0.5f) * c.h;
    // e = o + lens (dx x + dy y): x gets ge lens dx, y ge lens dy
    const V3 gel = mul(ge, c.lens);
    const V3 gx = add(mul(gq, cu), mul(gel, sm.dx));
    const V3 gy = add(mul(gq, cv), mul(gel, sm.dy));
    gr[0] = gx.x;
    gr[1] = gx.y;
    gr[2] = gx.z;
    gr[3] = -gy.x;  // y = -axes[1]
    gr[4] = -gy.y;
    gr[5] = -gy.z;
    gr[6] = -gq.x * c.focus;
    gr[7] = -gq.y * c.focus;
    gr[8] = -gq.z * c.focus;
    gr[9] = gro.x;  // o: g_d from q and g_ro - g_d from e
    gr[10] = gro.y;
    gr[11] = gro.z;
    gr[12] = (sm.v - 0.5f) * dot(gq, c.y);
    gr[13] = (sm.u - 0.5f) * dot(gq, c.x);
    gr[14] = -dot(gq, c.z);
    gr[15] = dot(ge, add(mul(c.x, sm.dx), mul(c.y, sm.dy))) / 2.0f;
  }
  block_partial_sums<kCamStochGrads, kCamStochBwdThreads>(gr, partials);
}

// K9 stage 2: one block, warp j sums column j of the partials in a fixed
// order.
__global__ void camera_stochastic_bwd_sum_kernel(
    const float* __restrict__ partials, int nblocks, float* __restrict__ out) {
  column_sums<kCamStochGrads>(partials, nblocks, out);
}

}  // namespace yrt::simple

// Number of f32 partials the first forms need as scratch for n rays (16
// a block of 256 rays).
extern "C" int yrt_camera_bwd_simple_scratch(int n) {
  return static_cast<int>(yrt::blocks_for(n, yrt::simple::kCamBwdThreads)) *
         yrt::simple::kCamStochGrads;
}

// K6's first form. out (15,) = [d_axes (9, row-major), d_o (3), d_h, d_w,
// d_focus]
extern "C" int yrt_camera_bwd_simple(const float* uv, const float* g_ro,
                                     const float* g_rd, int n,
                                     const float* cam_axes,
                                     const float* cam_o, const float* h,
                                     const float* w, const float* focus,
                                     float* partials, float* out,
                                     void* stream) {
  const int nblocks =
      n > 0 ? static_cast<int>(
                  yrt::blocks_for(n, yrt::simple::kCamBwdThreads))
            : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    yrt::simple::camera_bwd_partial_kernel<<<
        nblocks, yrt::simple::kCamBwdThreads, 0, st>>>(
        uv, g_ro, g_rd, n, cam_axes, cam_o, h, w, focus, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  yrt::simple::camera_bwd_sum_kernel<<<1, 32 * yrt::simple::kCamGrads, 0,
                                       st>>>(partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}

// K9's first form. out (16,) = [d_axes (9, row-major), d_o (3), d_h, d_w,
// d_focus, d_aperture] for the cotangents g_ro, g_rd (N, 3) of K7's rays.
extern "C" int yrt_camera_stochastic_bwd_simple(
    const int* ids, int n, int width, int height, int samples,
    unsigned int seed, const float* g_ro, const float* g_rd,
    const float* cam_axes, const float* cam_o, const float* h, const float* w,
    const float* focus, const float* aperture, float* partials, float* out,
    void* stream) {
  const int nblocks =
      n > 0 ? static_cast<int>(
                  yrt::blocks_for(n, yrt::simple::kCamStochBwdThreads))
            : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nblocks > 0) {
    yrt::simple::camera_stochastic_bwd_partial_kernel<<<
        nblocks, yrt::simple::kCamStochBwdThreads, 0, st>>>(
        ids, n, width, height, samples, seed, g_ro, g_rd, cam_axes, cam_o, h,
        w, focus, aperture, partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  yrt::simple::camera_stochastic_bwd_sum_kernel<<<
      1, 32 * yrt::simple::kCamStochGrads, 0, st>>>(partials, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}
