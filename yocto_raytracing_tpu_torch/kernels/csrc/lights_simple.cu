// K8's and K10's first forms, kept for comparison only.
//
// The area-light points and their reverse as the first port wrote them: one
// thread per (light, ray) with a dense O(E) element scan, and K10's sums
// raced into shared and global f64 rows with atomics. chip_smoke.py times
// them in turns with lights.cu, on the same inputs and the same card, and
// holds K8 bit-equal and K10 within its tolerance; no path of the package
// launches them. Their text below is the first form's, under their own
// names.
//
// K8: area-light sample points: one shape-space point per (light, ray).
//
// Replaces render/lights.py::sample_light_points (82-116) of the JAX package
// with its variates (render/renderer.py:271-275: per_ray_uniform keyed by
// ray id under `seed ^ 0x85EBCA6B`, three columns) and
// ops/sampling.py::sample_triangle (92-104). The tables (cdf, n, prim_lo,
// deg) come from render/lights.py::build_light_sampler, on the host.
//
// One thread per (light l, ray i), output row l * N + i of (L, N, 3):
//   1. r0, r1, r2 = the ray's three variates;
//   2. element idx = the count of cdf[l, :] < r0 * cdf[l, E-1], clipped to
//      [0, n[l] - 1]: the JAX dense compare, not a binary search, so ties
//      pick the same element;
//   3. prim = clip(prim_lo[l] + idx, 0, P - 1) and its prim_v / prim_type;
//   4. a triangle gives v0 * (1 - a - b) + v1 * a + v2 * b with
//      a = 1 - sqrt(r1), b = r2 * sqrt(r1); a line v0 * (1 - r1) + v1 * r1;
//      a point v0;
//   5. a light whose shape has no element (deg[l]) keeps light_pos[l].
// Only IEEE + - * sqrt and compares, built with --fmad=false: bit-equal to
// the plain torch version.
//
// What bounds K8 on an H100: 4 bytes read per ray and 12 bytes written per
// (light, ray), 14.7 MB for 524,288 rays and two lights, about 4.4 us at
// 3.35 TB/s; the CDF rows and the light's vertices are a few hundred bytes
// that stay in L1/L2. The element scan is O(E) per thread, which is fine
// for the few elements of a light shape; a light mesh with thousands of
// elements would want a binary search with the same tie rule.
//
// K10 is K8's reverse (the adjoint of sample_light_points, JAX
// render/lights.py:82-116): the (L, N, 3) cotangent of the points goes back
// to the vertices the points were made from, with the weights of step 4
// (triangle (1 - a - b, a, b), line (1 - r1, r1), point 1), and, for a
// `deg` light, to light_pos[l]. It recomputes each (light, ray)'s variates,
// element and weights with K8's own function, so it sees the forward's
// exact pick. Every ray of a light adds into the same few vertices (4 for a
// quad, 5 for a 4-segment polyline) and picks its element at random, so
// neighbouring lanes seldom share an address and per-lane global atomics
// would serialise on a handful of words. Each block therefore covers rays of
// one light and sums into an f64 shared-memory row per vertex of that
// light's span (vertex ids of its elements, min to max), then adds that row
// to the f64 global gradient with one atomic per non-zero entry; a light
// whose span exceeds the shared row (kAccVerts) adds each lane's terms to
// global memory directly. The caller rounds the f64 sums to f32 once. The
// order of the atomics varies, so the last bit of a sum may differ between
// runs, as in K5.
#include <cstdint>

#include "common.cuh"

namespace yrt::simple {

constexpr unsigned int kLightSeedXor = 0x85EBCA6Bu;
constexpr int kLightLine = 1, kLightTriangle = 2;  // scene.PRIM_*

// The element of light l that ray `id` samples and the point's weights on
// its vertices: steps 1-4 above. `count` is 3 (triangle), 2 (line) or 1.
struct LightPick {
  int vid[3];
  float w[3];
  int count;
};

__device__ __forceinline__ LightPick light_pick(
    int l, int id, unsigned int seed, const float* __restrict__ cdf,
    int num_elems, const int* __restrict__ elem_n,
    const int* __restrict__ prim_lo, const int* __restrict__ prim_v,
    const int* __restrict__ prim_type, int num_prims) {
  const unsigned int lseed = seed ^ kLightSeedXor;
  const float r0 = per_ray_uniform(lseed, id, 0u);
  const float r1 = per_ray_uniform(lseed, id, 1u);
  const float r2 = per_ray_uniform(lseed, id, 2u);
  const float* row = cdf + static_cast<long long>(l) * num_elems;
  const float x = r0 * __ldg(row + num_elems - 1);
  int idx = 0;
  for (int e = 0; e < num_elems; ++e) idx += __ldg(row + e) < x ? 1 : 0;
  const int hi = __ldg(elem_n + l) - 1;
  idx = idx < hi ? idx : hi;  // idx >= 0 already
  int prim = __ldg(prim_lo + l) + idx;
  prim = prim < 0 ? 0 : (prim > num_prims - 1 ? num_prims - 1 : prim);
  const int ptype = __ldg(prim_type + prim);
  LightPick pk;
  pk.vid[0] = __ldg(prim_v + 3 * prim);
  pk.vid[1] = __ldg(prim_v + 3 * prim + 1);
  pk.vid[2] = __ldg(prim_v + 3 * prim + 2);
  if (ptype == kLightTriangle) {
    const float sq = sqrtf(r1);
    const float a = 1.0f - sq;
    const float b = r2 * sq;
    pk.w[0] = 1.0f - a - b;
    pk.w[1] = a;
    pk.w[2] = b;
    pk.count = 3;
  } else if (ptype == kLightLine) {
    pk.w[0] = 1.0f - r1;
    pk.w[1] = r1;
    pk.w[2] = 0.0f;
    pk.count = 2;
  } else {
    pk.w[0] = 1.0f;
    pk.w[1] = pk.w[2] = 0.0f;
    pk.count = 1;
  }
  return pk;
}

__global__ void light_points_kernel(
    const int* __restrict__ ids, int n, unsigned int seed,
    const float* __restrict__ cdf, int num_lights, int num_elems,
    const int* __restrict__ elem_n, const int* __restrict__ prim_lo,
    const uint8_t* __restrict__ deg, const int* __restrict__ prim_v,
    const int* __restrict__ prim_type, int num_prims,
    const float* __restrict__ pos, const float* __restrict__ light_pos,
    float* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (k >= static_cast<long long>(num_lights) * n) return;
  const int l = static_cast<int>(k / n);
  const int i = static_cast<int>(k - static_cast<long long>(l) * n);
  V3 p;
  if (deg[l] != 0) {
    p = load3(light_pos, l);
  } else {
    const LightPick pk = light_pick(l, ids[i], seed, cdf, num_elems, elem_n,
                                    prim_lo, prim_v, prim_type, num_prims);
    // v0 * w0 (+ v1 * w1 (+ v2 * w2)), in the plain version's order
    p = mul(load3(pos, pk.vid[0]), pk.w[0]);
    if (pk.count > 1) p = add(p, mul(load3(pos, pk.vid[1]), pk.w[1]));
    if (pk.count > 2) p = add(p, mul(load3(pos, pk.vid[2]), pk.w[2]));
  }
  out[3 * k] = p.x;
  out[3 * k + 1] = p.y;
  out[3 * k + 2] = p.z;
}

constexpr int kAccVerts = 256;  // vertices in a block's shared f64 row
constexpr int kBwdThreads = 256;

// K10: one block per (ray block, light), blockIdx.y the light.
__global__ void __launch_bounds__(kBwdThreads) light_points_bwd_kernel(
    const int* __restrict__ ids, int n, unsigned int seed,
    const float* __restrict__ cdf, int num_elems,
    const int* __restrict__ elem_n, const int* __restrict__ prim_lo,
    const uint8_t* __restrict__ deg, const int* __restrict__ prim_v,
    const int* __restrict__ prim_type, int num_prims,
    const float* __restrict__ g, double* __restrict__ d_pos,
    double* __restrict__ d_light_pos) {
  __shared__ double acc[3 * kAccVerts];
  __shared__ int vmin, vmax;
  const int l = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool is_deg = deg[l] != 0;
  // the light's vertex span: every vertex its elements can pick (a deg
  // light's row is its light_pos)
  if (threadIdx.x == 0) {
    vmin = is_deg ? 0 : 0x7fffffff;
    vmax = is_deg ? 0 : -1;
  }
  __syncthreads();
  if (!is_deg) {
    const int lo = __ldg(prim_lo + l), cnt = __ldg(elem_n + l);
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      int prim = lo + e;
      prim = prim < 0 ? 0 : (prim > num_prims - 1 ? num_prims - 1 : prim);
      const int t = __ldg(prim_type + prim);
      const int k = t == kLightTriangle ? 3 : (t == kLightLine ? 2 : 1);
      for (int j = 0; j < k; ++j) {
        const int v = __ldg(prim_v + 3 * prim + j);
        atomicMin(&vmin, v);
        atomicMax(&vmax, v);
      }
    }
  }
  __syncthreads();
  const int base = vmin;
  const int span = vmax - vmin + 1;
  const bool shared_row = span <= kAccVerts;  // uniform over the block
  if (shared_row)
    for (int j = threadIdx.x; j < 3 * span; j += blockDim.x) acc[j] = 0.0;
  __syncthreads();
  if (i < n) {
    const V3 gi =
        load3(g, static_cast<int>(static_cast<long long>(l) * n + i));
    if (is_deg) {
      atomicAdd(&acc[0], static_cast<double>(gi.x));
      atomicAdd(&acc[1], static_cast<double>(gi.y));
      atomicAdd(&acc[2], static_cast<double>(gi.z));
    } else {
      const LightPick pk = light_pick(l, ids[i], seed, cdf, num_elems,
                                      elem_n, prim_lo, prim_v, prim_type,
                                      num_prims);
      for (int j = 0; j < pk.count; ++j) {
        const V3 t = mul(gi, pk.w[j]);  // f32, as torch's gather reverse
        double* dst = shared_row ? acc + 3 * (pk.vid[j] - base)
                                 : d_pos + 3LL * pk.vid[j];
        if (t.x != 0.0f) atomicAdd(dst, static_cast<double>(t.x));
        if (t.y != 0.0f) atomicAdd(dst + 1, static_cast<double>(t.y));
        if (t.z != 0.0f) atomicAdd(dst + 2, static_cast<double>(t.z));
      }
    }
  }
  __syncthreads();
  if (!shared_row) return;
  double* out = is_deg ? d_light_pos + 3LL * l : d_pos + 3LL * base;
  for (int j = threadIdx.x; j < 3 * span; j += blockDim.x)
    if (acc[j] != 0.0) atomicAdd(out + j, acc[j]);
}

}  // namespace yrt::simple

extern "C" int yrt_light_points_simple(
    const int* ids, int n, unsigned int seed, const float* cdf,
    int num_lights, int num_elems, const int* elem_n, const int* prim_lo,
    const uint8_t* deg, const int* prim_v, const int* prim_type,
    int num_prims, const float* pos, const float* light_pos, float* out,
    void* stream) {
  const long long total = static_cast<long long>(num_lights) * n;
  if (total > 0) {
    constexpr int kThreads = 256;
    yrt::simple::light_points_kernel<<<yrt::blocks_for(total, kThreads),
                                       kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        ids, n, seed, cdf, num_lights, num_elems, elem_n, prim_lo, deg,
        prim_v, prim_type, num_prims, pos, light_pos, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10's first form. d_pos (V, 3) and d_light_pos (L, 3) are f64,
// zero-filled by the caller; g is the (L, N, 3) cotangent of the points.
extern "C" int yrt_light_points_bwd_simple(
    const int* ids, int n, unsigned int seed, const float* cdf,
    int num_lights, int num_elems, const int* elem_n, const int* prim_lo,
    const uint8_t* deg, const int* prim_v, const int* prim_type,
    int num_prims, const float* g, double* d_pos, double* d_light_pos,
    void* stream) {
  if (n > 0 && num_lights > 0) {
    const dim3 grid(yrt::blocks_for(n, yrt::simple::kBwdThreads),
                    num_lights);
    yrt::simple::light_points_bwd_kernel<<<
        grid, yrt::simple::kBwdThreads, 0,
        static_cast<cudaStream_t>(stream)>>>(
        ids, n, seed, cdf, num_elems, elem_n, prim_lo, deg, prim_v,
        prim_type, num_prims, g, d_pos, d_light_pos);
  }
  return static_cast<int>(cudaGetLastError());
}
