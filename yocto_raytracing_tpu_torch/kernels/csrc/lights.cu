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
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr unsigned int kLightSeedXor = 0x85EBCA6Bu;
constexpr int kLightLine = 1, kLightTriangle = 2;  // scene.PRIM_*

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
    const int id = ids[i];
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
    const V3 v0 = load3(pos, __ldg(prim_v + 3 * prim));
    if (ptype == kLightTriangle) {
      const V3 v1 = load3(pos, __ldg(prim_v + 3 * prim + 1));
      const V3 v2 = load3(pos, __ldg(prim_v + 3 * prim + 2));
      const float sq = sqrtf(r1);
      const float a = 1.0f - sq;
      const float b = r2 * sq;
      const float w0 = 1.0f - a - b;
      p = add(add(mul(v0, w0), mul(v1, a)), mul(v2, b));
    } else if (ptype == kLightLine) {
      const V3 v1 = load3(pos, __ldg(prim_v + 3 * prim + 1));
      p = add(mul(v0, 1.0f - r1), mul(v1, r1));
    } else {
      p = v0;
    }
  }
  out[3 * k] = p.x;
  out[3 * k + 1] = p.y;
  out[3 * k + 2] = p.z;
}

}  // namespace yrt

extern "C" int yrt_light_points(const int* ids, int n, unsigned int seed,
                                const float* cdf, int num_lights,
                                int num_elems, const int* elem_n,
                                const int* prim_lo, const uint8_t* deg,
                                const int* prim_v, const int* prim_type,
                                int num_prims, const float* pos,
                                const float* light_pos, float* out,
                                void* stream) {
  const long long total = static_cast<long long>(num_lights) * n;
  if (total > 0) {
    constexpr int kThreads = 256;
    yrt::light_points_kernel<<<yrt::blocks_for(total, kThreads), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        ids, n, seed, cdf, num_lights, num_elems, elem_n, prim_lo, deg,
        prim_v, prim_type, num_prims, pos, light_pos, out);
  }
  return static_cast<int>(cudaGetLastError());
}
