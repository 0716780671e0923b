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
// Ray ids are in [0, 2^31).
// The arithmetic repeats the plain torch chain of render/camera.py op for op
// (u32 hashing that wraps, IEEE divides by the run-time width, height and
// samples, sqrtf, sincosf of the f32 2*pi*r0, the thin-lens origin and the
// normalized direction to the pinhole target), built with --fmad=false, so
// K7 is held bit-equal to it on the card. With aperture 0 the origin is the
// camera origin and the ray equals K2's for the same uv. The frame scalars
// h, w, focus and aperture are read from device memory, as in K2. So is the
// seed where the caller gives a seed word (the device loop's kept graph,
// whose launch arguments are fixed at capture): each thread reads it once;
// without one, the launch's own seed argument is used.
//
// What bounds K7 on an H100: 4 bytes read and 32 bytes written per ray
// (uv, ro, rd), about 5.6 us per 524,288-ray chunk at 3.35 TB/s; ~150
// scalar operations per ray are ~1.2 us at 67 TFLOP/s. Memory-bound; one
// thread per ray with coalesced id reads is all the design needs.
//
// K9 is K7's reverse, the adjoint of eval_camera_dof (JAX
// render/camera.py:73-97) for cotangents of (ro, rd): per ray, it recomputes
// the jittered uv and the lens sample from the id and the seed with K7's own
// device function (stochastic_sample), and the ray with K7's arithmetic,
// then runs the adjoint of
//   q  = o + (u - .5) w x + (v - .5) h y - focus z,   y = -axes[1]
//   ro = o + (aperture / 2) (dx x + dy y)
//   rd = (q - ro) / |q - ro|
// The per-ray origin carries g_ro into o, x, y and the aperture, and
// d = q - ro sends -g_d into it. The 16 sums (d_axes 9, d_o 3, d_h, d_w,
// d_focus, d_aperture) are reduced like K6's, kCamRays rays a thread and one
// launch (common.cuh, camera_block_sums), in an order that depends on n
// alone; h and w go back to fovy, aspect and focus through torch. With
// aperture 0 every shared term is K6's value on the same uv, and so are
// the 15 shared sums, bit for bit.
//
// What bounds K9 on an H100: reading 4 + 24 bytes per ray (the id and two
// cotangents), 8.8 us for 2^20 rays, and issuing the recompute: four PCG
// hashes, sqrtf, sincosf, and nine IEEE divides by run-time values a
// ray. Its first form (camera_bwd_simple.cu) also paid six integer
// divisions or remainders by run-time divisors, about 20 instructions each;
// here stochastic_sample divides by the launch's spp, samples and width
// with multipliers the host computes (Divisor: exact for every id in
// [0, 2^31)), so K7 takes them too and stays bit-equal to the plain chain.
#include "common.cuh"

namespace yrt {

constexpr unsigned int kLensSeedXor = 0x9E3779B9u;
constexpr float kTwoPi = 2.0f * 3.14159265358979323846f;  // f32 2 * f32 pi

// Division by a divisor d in [1, 2^31) that is the same for a whole launch,
// exact for every dividend n in [0, 2^31): n / d = (m * n) >> (31 + l) with
// l = ceil(log2 d) and m = ceil(2^(31 + l) / d) < 2^32, the round-up method
// of Granlund and Montgomery ("Division by invariant integers using
// multiplication", PLDI 1994, section 4). The host computes m and l
// (render/camera.py::magic_divisor); __umulhi(m, 2 n) is (m * n) >> 31.
struct Divisor {
  unsigned int m, l;
  int d;
};

__device__ __forceinline__ int quotient(int n, Divisor dv) {
  return static_cast<int>(
      __umulhi(dv.m, static_cast<unsigned int>(n) << 1) >> dv.l);
}

// The launch's divisors: spp = samples^2, samples and width.
struct FrameDivisors {
  Divisor spp, samples, width;
};

// Jittered uv and unit-disk lens sample (dx, dy) of ray `id`.
struct StochasticSample {
  float u, v, dx, dy;
};

__device__ __forceinline__ StochasticSample stochastic_sample(
    int id, const FrameDivisors& dv, int height, unsigned int seed) {
  const float j0 = per_ray_uniform(seed, id, 0u);
  const float j1 = per_ray_uniform(seed, id, 1u);
  const float l0 = per_ray_uniform(seed ^ kLensSeedXor, id, 0u);
  const float l1 = per_ray_uniform(seed ^ kLensSeedXor, id, 1u);

  // stratified-jittered uv: offsets (k + u01) / samples
  const int pix = quotient(id, dv.spp);
  const int sample = id - pix * dv.spp.d;
  const int jj = quotient(sample, dv.samples);
  const int ii = sample - jj * dv.samples.d;
  const int row = quotient(pix, dv.width);
  const int col = pix - row * dv.width.d;
  const float s = static_cast<float>(dv.samples.d);
  const float u = (static_cast<float>(col) +
                   (static_cast<float>(ii) + j0) / s) /
                  static_cast<float>(dv.width.d);
  const float v = (static_cast<float>(row) +
                   (static_cast<float>(jj) + j1) / s) /
                  static_cast<float>(height);

  // sample_disk: r = sqrt(r1), phi = 2 pi r0; sincosf's values are cosf's
  // and sinf's (camera_bwd_ablation.py: every ray id of the smoke run's
  // area frames)
  const float r = sqrtf(l1);
  const float phi = kTwoPi * l0;
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  return StochasticSample{u, v, cos_phi * r, sin_phi * r};
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

__global__ void camera_rays_stochastic_kernel(
    const int* __restrict__ ids, int n, FrameDivisors dv, int height,
    unsigned int seed, const unsigned int* __restrict__ seed_word,
    const float* __restrict__ axes,
    const float* __restrict__ org, const float* __restrict__ h_p,
    const float* __restrict__ w_p, const float* __restrict__ focus_p,
    const float* __restrict__ aperture_p, float* __restrict__ uv,
    float* __restrict__ ro, float* __restrict__ rd) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const unsigned int s = seed_word != nullptr ? __ldg(seed_word) : seed;
  const StochasticSample sm = stochastic_sample(ids[k], dv, height, s);
  const CamFrame c = cam_frame(axes, org, h_p, w_p, focus_p, aperture_p);
  const LensRay r = lens_ray(c, sm);
  uv[2 * k] = sm.u;
  uv[2 * k + 1] = sm.v;
  ro[3 * k] = r.e.x;
  ro[3 * k + 1] = r.e.y;
  ro[3 * k + 2] = r.e.z;
  rd[3 * k] = r.d.x / r.nrm;
  rd[3 * k + 1] = r.d.y / r.nrm;
  rd[3 * k + 2] = r.d.z / r.nrm;
}

// K9: kCamRays rays a thread, 16 terms a ray, then the block's sums; the
// last block writes out.
__global__ void __launch_bounds__(kCamThreads, kCamMinBlocks)
    camera_stochastic_bwd_kernel(
        const int* __restrict__ ids, int n, FrameDivisors dv, int height,
        unsigned int seed, const float* __restrict__ g_ro,
        const float* __restrict__ g_rd, const float* __restrict__ axes,
        const float* __restrict__ org, const float* __restrict__ h_p,
        const float* __restrict__ w_p, const float* __restrict__ focus_p,
        const float* __restrict__ aperture_p, float* __restrict__ partials,
        float* __restrict__ out, int* __restrict__ counter) {
  const CamFrame c = cam_frame(axes, org, h_p, w_p, focus_p, aperture_p);
  float acc[kCamSlots];
#pragma unroll
  for (int j = 0; j < kCamSlots; ++j) acc[j] = 0.0f;
#pragma unroll 1
  for (int ray = 0; ray < kCamRays; ++ray) {
    const int k = camera_ray(ray);
    if (k >= n) break;   // the rays of a thread go up with ray
    // the ray's inputs, all loaded before its terms: one wait a ray
    const int id = ids[k];
    const V3 g = load3(g_rd, k);
    const V3 gro = load3(g_ro, k);
    float gr[kCamSlots];
    const StochasticSample sm = stochastic_sample(id, dv, height, seed);
    const LensRay r = lens_ray(c, sm);
    const V3 rdn = make(r.d.x / r.nrm, r.d.y / r.nrm, r.d.z / r.nrm);
    // rd = d / |d|: g_d = (g - rd (g . rd)) / |d|; q gets g_d, e gets
    // g_ro - g_d
    const float cg = dot(g, rdn);
    const V3 gq = make((g.x - rdn.x * cg) / r.nrm, (g.y - rdn.y * cg) / r.nrm,
                       (g.z - rdn.z * cg) / r.nrm);
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
    camera_add_ray(acc, gr);
  }
  camera_block_sums(acc, partials, out, counter);
}

}  // namespace yrt

namespace {

// magic: [m, l] of spp, then of samples, then of width (magic_divisor).
yrt::FrameDivisors frame_divisors(const unsigned int* magic, int width,
                                  int samples) {
  return yrt::FrameDivisors{{magic[0], magic[1], samples * samples},
                            {magic[2], magic[3], samples},
                            {magic[4], magic[5], width}};
}

}  // namespace

// K7. seed_word, where not null, is a device word holding the seed's 32
// bits, read in place of `seed` when the kernel runs.
extern "C" int yrt_camera_rays_stochastic(
    const int* ids, int n, int width, int height, int samples,
    const unsigned int* magic, unsigned int seed,
    const unsigned int* seed_word, const float* cam_axes, const float* cam_o,
    const float* h, const float* w, const float* focus,
    const float* aperture, float* uv, float* ro, float* rd, void* stream) {
  if (n > 0) {
    constexpr int kThreads = 256;
    yrt::camera_rays_stochastic_kernel<<<yrt::blocks_for(n, kThreads),
                                         kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        ids, n, frame_divisors(magic, width, samples), height, seed,
        seed_word, cam_axes, cam_o, h, w, focus, aperture, uv, ro, rd);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9. out (16,) = [d_axes (9, row-major), d_o (3), d_h, d_w, d_focus,
// d_aperture] for the cotangents g_ro, g_rd (N, 3) of K7's rays; partials
// and counter as for yrt_camera_bwd (yrt_camera_bwd_scratch floats).
extern "C" int yrt_camera_stochastic_bwd(
    const int* ids, int n, int width, int height, int samples,
    const unsigned int* magic, unsigned int seed, const float* g_ro,
    const float* g_rd, const float* cam_axes, const float* cam_o,
    const float* h, const float* w, const float* focus, const float* aperture,
    float* partials, float* out, int* counter, void* stream) {
  yrt::camera_stochastic_bwd_kernel<<<yrt::camera_blocks(n), yrt::kCamThreads,
                                      0, static_cast<cudaStream_t>(stream)>>>(
      ids, n, frame_divisors(magic, width, samples), height, seed, g_ro, g_rd,
      cam_axes, cam_o, h, w, focus, aperture, partials, out, counter);
  return static_cast<int>(cudaGetLastError());
}
