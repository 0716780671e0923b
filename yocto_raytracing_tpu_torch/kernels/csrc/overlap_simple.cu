// K11's first form, kept for comparison only.
//
// The brute-force overlap query of the first port: one thread per query
// tests every prim of every instance. chip_smoke.py times it in turns with
// the culled walk of overlap.cu, on the same queries and the same card, and
// holds the two bit-equal; no path of the package launches it. Its text
// below is the first form's, under its own names.
//
// K11: the overlap query: per query point, the closest scene element within
// dist_max (plus the element's radius), in instance-local space.
//
// Replaces ops/overlap.py::overlap_scene / _overlap_scene_jit (204-320) of
// the JAX package, with closestuv_line, closestuv_triangle, overlap_point,
// overlap_line and overlap_triangle (37-129) as its per-pair math.
//
// One thread per query walks the instances in order. For each instance it
// moves the query into the instance frame (transform_vector_inverse(axes,
// pos - o); distances stay local, as the reference's) and tests only that
// instance's own prim range [lo, hi), where the JAX function tests the whole
// pool and masks by range: the answer is the same. The semantics are JAX's:
//   * an element is accepted when d^2 <= (dist_max + r)^2, with the query's
//     initial dist_max, not a shrinking best;
//   * within an instance the winner is the smallest d, the last prim on ties;
//   * across instances the winner is accepted when d <= (found ? dist :
//     dist_max), the last instance on ties;
//   * the winner's euv is (w0, w1, w2, 0) for a triangle, (1 - u, u, 0, 0)
//     for a line, (1, 0, 0, 0) for a point, each plus 0.0 (JAX sums the
//     one-hot row, which turns -0 into +0);
//   * unmatched queries get found 0, dist FLT_MAX, inst = prim = -1 and a
//     zero euv.
// closestuv_triangle keeps JAX's first-true-wins case cascade and its safe
// (0 -> 1) divisors, closestuv_line its 0 -> 1 divisor; square roots are
// safe_sqrt. Only IEEE + - * / sqrt and compares, in the plain version's
// order, built with --fmad=false: bit-equal to the plain torch version.
//
// What bounds K11 on an H100: every thread reads every prim of every
// instance, but a warp's threads read the same prim at the same time, so
// the prim data (a few tens of KB) is served from L1/L2 and the work is
// arithmetic: about 130 (triangle), 45 (line) or 15 (point) operations per
// (query, prim) pair, counted from this source (chip_smoke.py counts the
// pairs of its run). The triangle cascade diverges within a warp.
#include <cstdint>

#include "common.cuh"

namespace yrt::simple {

constexpr int kOverlapPoint = 0, kOverlapLine = 1, kOverlapTriangle = 2;

__device__ __forceinline__ float safe_div_den(float x) {
  return x == 0.0f ? 1.0f : x;
}
__device__ __forceinline__ float overlap_sqrt(float x) {  // safe_sqrt
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// Closest point on segment v0-v1 as (1 - u, u); returns u.
__device__ __forceinline__ float closestuv_line(V3 p, V3 v0, V3 v1) {
  const V3 ab = sub(v1, v0);
  const float d = dot(ab, ab);
  return clamp01(dot(sub(p, v0), ab) / safe_div_den(d));
}

// Closest point on triangle v0 v1 v2, barycentric (w0, w1, w2).
__device__ __forceinline__ V3 closestuv_triangle(V3 p, V3 v0, V3 v1, V3 v2) {
  const V3 ab = sub(v1, v0);
  const V3 ac = sub(v2, v0);
  const V3 ap = sub(p, v0);
  const float d1 = dot(ab, ap);
  const float d2 = dot(ac, ap);
  const V3 bp = sub(p, v1);
  const float d3 = dot(ab, bp);
  const float d4 = dot(ac, bp);
  const V3 cp = sub(p, v2);
  const float d5 = dot(ab, cp);
  const float d6 = dot(ac, cp);
  const float vc = d1 * d4 - d3 * d2;
  const float vb = d5 * d2 - d1 * d6;
  const float va = d3 * d6 - d5 * d4;
  // first true case wins (yocto_math.h:5877-5915)
  if (d1 <= 0.0f && d2 <= 0.0f) return make(1.0f, 0.0f, 0.0f);
  if (d3 >= 0.0f && d4 <= d3) return make(0.0f, 1.0f, 0.0f);
  if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {
    const float t = d1 / safe_div_den(d1 - d3);
    return make(1.0f - t, t, 0.0f);
  }
  if (d6 >= 0.0f && d5 <= d6) return make(0.0f, 0.0f, 1.0f);
  if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {
    const float t = d2 / safe_div_den(d2 - d6);
    return make(1.0f - t, 0.0f, t);
  }
  if (va <= 0.0f && d4 - d3 >= 0.0f && d5 - d6 >= 0.0f) {
    const float t = (d4 - d3) / safe_div_den((d4 - d3) + (d5 - d6));
    return make(0.0f, 1.0f - t, t);
  }
  const float denom = 1.0f / safe_div_den(va + vb + vc);
  const float fv = vb * denom;
  const float fw = vc * denom;
  return make(1.0f - fv - fw, fv, fw);
}

// d^2 test and distance of p against the element point q with radius r.
__device__ __forceinline__ bool accept(V3 p, V3 q, float r, float dmax,
                                       float* dist) {
  const V3 d = sub(p, q);
  const float d2 = dot(d, d);
  *dist = overlap_sqrt(d2);
  return d2 <= (dmax + r) * (dmax + r);
}

__global__ void overlap_kernel(
    const float* __restrict__ queries, const float* __restrict__ dist_max,
    int nq, const float* __restrict__ inst_axes,
    const float* __restrict__ inst_o, const int* __restrict__ inst_lo,
    const int* __restrict__ inst_hi, int num_inst,
    const int* __restrict__ prim_v, const int* __restrict__ prim_type,
    const float* __restrict__ pos, const float* __restrict__ radius,
    uint8_t* __restrict__ found_out, float* __restrict__ dist_out,
    int* __restrict__ inst_out, int* __restrict__ prim_out,
    float* __restrict__ euv_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nq) return;
  const V3 p = load3(queries, k);
  const float dmax = dist_max[k];
  bool found = false;
  float best = kFltMax;
  int best_inst = -1, best_prim = -1;
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, e3 = 0.0f;
  for (int ii = 0; ii < num_inst; ++ii) {
    const int lo = __ldg(inst_lo + ii), hi = __ldg(inst_hi + ii);
    if (lo >= hi) continue;
    const V3 a0 = load3(inst_axes, 3 * ii);
    const V3 a1 = load3(inst_axes, 3 * ii + 1);
    const V3 a2 = load3(inst_axes, 3 * ii + 2);
    const V3 q = sub(p, load3(inst_o, ii));
    const V3 lp = make(dot(a0, q), dot(a1, q), dot(a2, q));
    float dmin = kFltMax;
    int win = -1;
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    for (int pr = lo; pr < hi; ++pr) {
      const int t = __ldg(prim_type + pr);
      const int i0 = __ldg(prim_v + 3 * pr);
      const V3 v0 = load3(pos, i0);
      const float r0 = __ldg(radius + i0);
      bool ok;
      float d, x, y = 0.0f, z = 0.0f;
      if (t == kOverlapTriangle) {
        const int i1 = __ldg(prim_v + 3 * pr + 1);
        const int i2 = __ldg(prim_v + 3 * pr + 2);
        const V3 v1 = load3(pos, i1), v2 = load3(pos, i2);
        const V3 uv = closestuv_triangle(lp, v0, v1, v2);
        const V3 c = add(add(mul(v0, uv.x), mul(v1, uv.y)), mul(v2, uv.z));
        const float r = r0 * uv.x + __ldg(radius + i1) * uv.y +
                        __ldg(radius + i2) * uv.z;
        ok = accept(lp, c, r, dmax, &d);
        x = uv.x;
        y = uv.y;
        z = uv.z;
      } else if (t == kOverlapLine) {
        const int i1 = __ldg(prim_v + 3 * pr + 1);
        const V3 v1 = load3(pos, i1);
        const float u = closestuv_line(lp, v0, v1);
        const V3 c = add(mul(v0, 1.0f - u), mul(v1, u));
        const float r = r0 * (1.0f - u) + __ldg(radius + i1) * u;
        ok = accept(lp, c, r, dmax, &d);
        x = 1.0f - u;
        y = u;
      } else if (t == kOverlapPoint) {
        ok = accept(lp, v0, r0, dmax, &d);
        x = 1.0f;
      } else {
        continue;
      }
      if (ok && d <= dmin) {  // the last prim wins ties
        dmin = d;
        win = pr;
        w0 = x;
        w1 = y;
        w2 = z;
      }
    }
    if (win >= 0 && dmin <= (found ? best : dmax)) {
      found = true;
      best = dmin;
      best_inst = ii;
      best_prim = win;
      e0 = w0 + 0.0f;
      e1 = w1 + 0.0f;
      e2 = w2 + 0.0f;
      e3 = 0.0f;
    }
  }
  found_out[k] = found ? 1 : 0;
  dist_out[k] = found ? best : kFltMax;
  inst_out[k] = best_inst;
  prim_out[k] = best_prim;
  euv_out[4 * k] = e0;
  euv_out[4 * k + 1] = e1;
  euv_out[4 * k + 2] = e2;
  euv_out[4 * k + 3] = e3;
}

}  // namespace yrt::simple

extern "C" int yrt_overlap_simple(const float* queries,
                                  const float* dist_max, int nq,
                                  const float* inst_axes, const float* inst_o,
                                  const int* inst_lo, const int* inst_hi,
                                  int num_inst, const int* prim_v,
                                  const int* prim_type, const float* pos,
                                  const float* radius, uint8_t* found,
                                  float* dist, int* inst, int* prim,
                                  float* euv, void* stream) {
  if (nq > 0) {
    constexpr int kThreads = 128;
    yrt::simple::overlap_kernel<<<yrt::blocks_for(nq, kThreads), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        queries, dist_max, nq, inst_axes, inst_o, inst_lo, inst_hi, num_inst,
        prim_v, prim_type, pos, radius, found, dist, inst, prim, euv);
  }
  return static_cast<int>(cudaGetLastError());
}
