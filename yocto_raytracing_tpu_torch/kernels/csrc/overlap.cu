// K11: the overlap query: per query point, the closest scene element within
// dist_max (plus the element's radius), in instance-local space.
//
// Replaces ops/overlap.py::overlap_scene / _overlap_scene_jit (204-320) of
// the JAX package, with closestuv_line, closestuv_triangle, overlap_point,
// overlap_line and overlap_triangle (37-129) as its per-pair math.
//
// The semantics are JAX's:
//   * an element is accepted when d^2 <= (dist_max + r)^2, with the query's
//     initial dist_max, not a shrinking best;
//   * within an instance the winner is the smallest d, the last prim (the
//     largest pool index) on ties;
//   * across instances, in index order, the winner is accepted when
//     d <= (found ? dist : dist_max), the last instance on ties;
//   * the winner's euv is (w0, w1, w2, 0) for a triangle, (1 - u, u, 0, 0)
//     for a line, (1, 0, 0, 0) for a point, each plus 0.0 (JAX sums the
//     one-hot row, which turns -0 into +0);
//   * unmatched queries get found 0, dist FLT_MAX, inst = prim = -1 and a
//     zero euv.
// closestuv_triangle keeps JAX's first-true-wins case cascade and its safe
// (0 -> 1) divisors, closestuv_line its 0 -> 1 divisor; square roots are
// safe_sqrt. Only IEEE + - * / sqrt and compares, in the plain version's
// order, built with --fmad=false: bit-equal to the plain torch versions.
//
// The walk. One thread per query visits the instances in order, moves the
// query into the instance frame (lp) and walks that instance's shape BVH in
// K1's threaded order (internal node -> its second child, else node_skip),
// testing the prims of the leaves it reaches. Nearly every prim of the pool
// is too far to decide the answer: the fold rejects an instance winner with
// d > (found ? dist : dist_max), and within the instance a prim with
// d > dmin (the instance's best so far) cannot win. So a subtree whose
// distance from lp exceeds L = min(found ? dist : dist_max, dmin) is
// skipped. Equal distances are never skipped (ties decide prim and inst),
// and the tie rule, d < dmin or (d == dmin and prim > win), picks the same
// winner in any visit order as JAX's "smallest d, largest index".
//
// Why the skip is conservative. The cull is made in the local frame, where
// d is measured, so it holds for any instance axes, scaled ones included.
// Let B be a node's box (refit from the current pos and radius, below) and
// M the sum of the magnitudes of its six coordinates. A prim under the node
// computes c, a combination of its vertices with weights w, and
// d = fl(|lp - c|). Two error sources:
//   (a) c lies in B up to rounding: the corner and edge cases give weights
//       in [0, 1] exactly (clamped, or t = a / (a + b) with a, b >= 0), and
//       the face case's within a few ULP of [0, 1] unless the triangle is
//       thin (below); c = v0 w0 + v1 w1 (+ v2 w2) in f32 is then within
//       about 6 ULP of max|v| <= M of the exact combination, which lies in
//       the vertices' box up to the weights' excursion, a few ULP more.
//       Points' and lines' boxes are grown by their radii, which only
//       enlarges them;
//   (b) the f32 distances: d >= (1 - 4 ULP) |lp - c|, and the computed box
//       distance lb (per-axis gap, squares, sum, sqrt) <= (1 + 4 ULP) of
//       the exact one.
// Together d >= lb (1 - 8 ULP) - 16 ULP * M. The face case of the cascade
// may also take a query whose projection lies just outside the triangle,
// by a band of about (ULP * |lp - v|) / sin(smallest angle); d still
// exceeds the query's height over the plane, so this costs lb at most the
// band, which a relative slack of 2^-12 covers up to |lp - v| / sin of
// 2^11. The walk skips a node when
//     lb * (1 - 2^-12) - 2^-16 * M > L,
// 2^-12 against 8 ULP and 2^-16 M against 16 ULP M: a margin of 256x on
// (a) and 64x on (b), at a cost in culling that does not show (2^-16 of a
// box's magnitude). A NaN anywhere (lp, box) makes the comparison false: no
// skip. A thin triangle, a2 <= 2^-14 e2^2 with a2 = |ab x ac|^2 and e2 its
// longest edge squared, and distinct vertices, may reach the face case with
// weights that are quotients of rounding noise: the refit flags it (a bit of
// its record's tag) and every node above it (nocull). The walk enters a
// flagged node even when its box is out of reach, and in a leaf out of
// reach tests only the flagged prims. A triangle with two equal vertices
// takes a corner or an edge case, never the face.
//
// The records. yrt_overlap_refit writes them on every call, from the
// current pos and radius (pos may have moved since the build, in training
// or in a test; JAX reads only pos and radius):
//   * nodes (M, 8): box min xyz, box max xyz, start * 16 + min(count, 15)
//     (a count of 15 is read from node_count), skip * 4 + nocull * 2 +
//     isleaf. A leaf's box is the build's (bvh.py:_shape_prim_bounds):
//     points p -/+ r, lines min/max(p0 -/+ r0, p1 -/+ r1), triangles the
//     vertices' min/max, folded over the leaf's prims in slot order; an
//     internal node folds its two children. Min and max are exact, so an
//     unmoved scene's boxes equal node_bbox_min/max. Scene-tree rows copy
//     the build's boxes (K11 never reads them);
//   * prims (K - I, 16), one row per shape-leaf slot (slot s at row s - I):
//     v0 xyz, r0, v1 xyz, r1, v2 xyz, r2, the tag (prim * 4 +
//     type, plus kThinBit for a thin triangle), three zero words (K1's
//     12-word record, hit_records.py, has no r2, which a triangle's
//     acceptance radius needs). A leaf is tested with every one of its
//     prims (its full count), where K1 tests at most 4.
// The refit runs bottom-up in one launch after the parent pointers: each
// shape leaf's thread writes its leaf, then climbs; at each parent the
// first of the two children's threads to arrive stops, the second merges
// both children's records (read through L2) and climbs on.
//
// What bounds K11 on an H100: operations, per query a few tens of node
// visits (about 50 operations each) and a few prim tests (25 to 110), now
// that the walk no longer tests every prim of every instance; chip_smoke.py
// counts the walk's work with the plain walk's stats. A warp runs as long
// as its longest walk, so queries in spatially coherent order (points
// along a strand, a mesh's vertices) run up to 4x faster than scattered
// ones, which mix short walks (far from everything) with long ones (inside
// a cluster of prims). Thread k takes query k, in the caller's order: a
// Morton sort in the wrapper cost more than it saved on coherent queries
// (PERF.md). Any order gives the same answers: each query's walk depends
// on that query alone.
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr int kOverlapPoint = 0, kOverlapLine = 1, kOverlapTriangle = 2;
constexpr int kOverlapCountSat = 15;          // the packed count saturates
constexpr float kCullRel = 0.999755859375f;   // 1 - 2^-12
constexpr float kCullAbs = 1.52587890625e-05f;  // 2^-16
constexpr float kThinTriangle = 6.103515625e-05f;  // 2^-14
constexpr int kThinBit = 1 << 30;             // a record tag's thin flag
constexpr int kOverlapThreads = 128;  // timed against 64 and 256: PERF.md
constexpr int kRefitThreads = 128;

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

// The gap from p to [lo, hi] on one axis, 0 inside (a NaN gives 0).
__device__ __forceinline__ float axis_gap(float p, float lo, float hi) {
  float g = lo - p;
  const float t = p - hi;
  g = t > g ? t : g;
  return g > 0.0f ? g : 0.0f;
}

// The conservative skip test of the header: true when nothing under the box
// (lo, hi) can lie within `limit` of lp.
__device__ __forceinline__ bool cull_box(V3 lp, V3 lo, V3 hi, float limit) {
  const float gx = axis_gap(lp.x, lo.x, hi.x);
  const float gy = axis_gap(lp.y, lo.y, hi.y);
  const float gz = axis_gap(lp.z, lo.z, hi.z);
  const float lb = sqrtf(gx * gx + gy * gy + gz * gz);
  const float m = fabsf(lo.x) + fabsf(lo.y) + fabsf(lo.z) + fabsf(hi.x) +
                  fabsf(hi.y) + fabsf(hi.z);
  return lb * kCullRel - kCullAbs * m > limit;
}

__device__ __forceinline__ float fmin_sel(float a, float b) {
  return b < a ? b : a;
}
__device__ __forceinline__ float fmax_sel(float a, float b) {
  return b > a ? b : a;
}
__device__ __forceinline__ V3 vmin(V3 a, V3 b) {
  return make(fmin_sel(a.x, b.x), fmin_sel(a.y, b.y), fmin_sel(a.z, b.z));
}
__device__ __forceinline__ V3 vmax(V3 a, V3 b) {
  return make(fmax_sel(a.x, b.x), fmax_sel(a.y, b.y), fmax_sel(a.z, b.z));
}
__device__ __forceinline__ V3 splat_add(V3 a, float r) {
  return make(a.x + r, a.y + r, a.z + r);
}
__device__ __forceinline__ V3 splat_sub(V3 a, float r) {
  return make(a.x - r, a.y - r, a.z - r);
}
__device__ __forceinline__ bool is_zero(V3 a) {
  return a.x == 0.0f && a.y == 0.0f && a.z == 0.0f;
}

// --------------------------------------------------------------------------
// refit
// --------------------------------------------------------------------------

struct RefitView {
  const int* __restrict__ node_start;
  const int* __restrict__ node_count;
  const int* __restrict__ node_isleaf;
  const int* __restrict__ node_kind;
  const int* __restrict__ node_skip;
  const float* __restrict__ node_bbox_min;
  const float* __restrict__ node_bbox_max;
  const int* __restrict__ leaf_items;
  const int* __restrict__ prim_v;
  const int* __restrict__ prim_type;
  const float* __restrict__ pos;
  const float* __restrict__ radius;
  int num_nodes, slot0;
};

__device__ __forceinline__ void store_node(float* __restrict__ nodes, int n,
                                           V3 lo, V3 hi, int w6, int w7) {
  float4* rec = reinterpret_cast<float4*>(nodes) + 2 * n;
  rec[0] = make_float4(lo.x, lo.y, lo.z, hi.x);
  rec[1] = make_float4(hi.y, hi.z, __int_as_float(w6), __int_as_float(w7));
}

__device__ __forceinline__ int node_word6(const RefitView& v, int n) {
  const int c = __ldg(v.node_count + n);
  return __ldg(v.node_start + n) * 16 +
         (c < kOverlapCountSat ? c : kOverlapCountSat);
}
__device__ __forceinline__ int node_word7(const RefitView& v, int n,
                                          bool nocull) {
  return __ldg(v.node_skip + n) * 4 + (nocull ? 2 : 0) +
         (__ldg(v.node_isleaf + n) ? 1 : 0);
}

// Parent pointers of the shape trees (parent[] holds -1 beforehand), and the
// scene tree's rows as copies of the build's boxes.
__global__ void overlap_parent_kernel(RefitView v, int* __restrict__ parent,
                                      float* __restrict__ nodes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= v.num_nodes) return;
  if (__ldg(v.node_kind + n) == 0) {
    store_node(nodes, n, load3(v.node_bbox_min, n), load3(v.node_bbox_max, n),
               node_word6(v, n), node_word7(v, n, false));
  } else if (!__ldg(v.node_isleaf + n)) {
    const int c = __ldg(v.node_start + n);
    parent[c] = n;
    parent[c + 1] = n;
  }
}

__device__ __forceinline__ void refit_leaf_and_climb(
    const RefitView& v, const int* __restrict__ parent,
    int* __restrict__ arrivals, float* __restrict__ nodes,
    float* __restrict__ prims, int n) {
  const int start = __ldg(v.node_start + n);
  const int count = __ldg(v.node_count + n);
  V3 lo = make(kFltMax, kFltMax, kFltMax);  // an empty leaf: the build's
  V3 hi = make(-kFltMax, -kFltMax, -kFltMax);
  bool nocull = false;
  for (int j = 0; j < count; ++j) {
    const int s = start + j;
    const int prim = __ldg(v.leaf_items + s);
    const int t = __ldg(v.prim_type + prim);
    const int i0 = __ldg(v.prim_v + 3 * prim);
    const int i1 = __ldg(v.prim_v + 3 * prim + 1);
    const int i2 = __ldg(v.prim_v + 3 * prim + 2);
    const V3 v0 = load3(v.pos, i0), v1 = load3(v.pos, i1),
             v2 = load3(v.pos, i2);
    const float r0 = __ldg(v.radius + i0), r1 = __ldg(v.radius + i1),
                r2 = __ldg(v.radius + i2);
    V3 plo, phi;
    bool thin = false;
    if (t == kOverlapPoint) {
      plo = splat_sub(v0, r0);
      phi = splat_add(v0, r0);
    } else if (t == kOverlapLine) {
      plo = vmin(splat_sub(v0, r0), splat_sub(v1, r1));
      phi = vmax(splat_add(v0, r0), splat_add(v1, r1));
    } else {
      plo = vmin(vmin(v0, v1), v2);
      phi = vmax(vmax(v0, v1), v2);
      if (t == kOverlapTriangle) {
        const V3 ab = sub(v1, v0), ac = sub(v2, v0), bc = sub(v2, v1);
        const V3 nrm = cross(ab, ac);
        const float a2 = dot(nrm, nrm);
        const float e2 = fmax_sel(fmax_sel(dot(ab, ab), dot(ac, ac)),
                                  dot(bc, bc));
        thin = !(a2 > kThinTriangle * (e2 * e2)) && !is_zero(ab) &&
               !is_zero(ac) && !is_zero(bc);
        nocull = nocull || thin;
      }
    }
    if (j == 0) {
      lo = plo;
      hi = phi;
    } else {
      lo = vmin(lo, plo);
      hi = vmax(hi, phi);
    }
    float4* row = reinterpret_cast<float4*>(prims) + 4LL * (s - v.slot0);
    const float tag = __int_as_float(prim * 4 + t + (thin ? kThinBit : 0));
    row[0] = make_float4(v0.x, v0.y, v0.z, r0);
    row[1] = make_float4(v1.x, v1.y, v1.z, r1);
    row[2] = make_float4(v2.x, v2.y, v2.z, r2);
    row[3] = make_float4(tag, 0.0f, 0.0f, 0.0f);
  }
  store_node(nodes, n, lo, hi, node_word6(v, n), node_word7(v, n, nocull));

  int cur = n;
  for (;;) {
    const int p = parent[cur];
    if (p < 0) return;
    __threadfence();                              // this subtree's records
    if (atomicAdd(arrivals + p, 1) == 0) return;  // the sibling merges
    __threadfence();
    const int c = __ldg(v.node_start + p);
    const float4* rec = reinterpret_cast<const float4*>(nodes);
    const float4 a0 = __ldcg(rec + 2 * c), a1 = __ldcg(rec + 2 * c + 1);
    const float4 b0 = __ldcg(rec + 2 * c + 2), b1 = __ldcg(rec + 2 * c + 3);
    lo = vmin(make(a0.x, a0.y, a0.z), make(b0.x, b0.y, b0.z));
    hi = vmax(make(a0.w, a1.x, a1.y), make(b0.w, b1.x, b1.y));
    nocull = ((__float_as_int(a1.w) | __float_as_int(b1.w)) & 2) != 0;
    store_node(nodes, p, lo, hi, node_word6(v, p), node_word7(v, p, nocull));
    cur = p;
  }
}

__global__ void __launch_bounds__(kRefitThreads)
    overlap_refit_kernel(RefitView v, const int* __restrict__ parent,
                         int* __restrict__ arrivals,
                         float* __restrict__ nodes,
                         float* __restrict__ prims) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= v.num_nodes || __ldg(v.node_kind + n) != 1 ||
      !__ldg(v.node_isleaf + n))
    return;
  refit_leaf_and_climb(v, parent, arrivals, nodes, prims, n);
}

// --------------------------------------------------------------------------
// query
// --------------------------------------------------------------------------

struct OverlapView {
  const float* __restrict__ queries;
  const float* __restrict__ dist_max;
  const float* __restrict__ inst_axes;
  const float* __restrict__ inst_o;
  const int* __restrict__ inst_shape_root;
  const float4* __restrict__ nodes;
  const int* __restrict__ node_count;
  const float4* __restrict__ prims;
  int nq, num_inst, slot0;
};

__global__ void __launch_bounds__(kOverlapThreads)
    overlap_kernel(OverlapView s, uint8_t* __restrict__ found_out,
                   float* __restrict__ dist_out, int* __restrict__ inst_out,
                   int* __restrict__ prim_out, float* __restrict__ euv_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= s.nq) return;
  const V3 p = load3(s.queries, k);
  const float dmax = __ldg(s.dist_max + k);
  bool found = false;
  float best = kFltMax;
  int best_inst = -1, best_prim = -1;
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, e3 = 0.0f;
  for (int ii = 0; ii < s.num_inst; ++ii) {
    const V3 a0 = load3(s.inst_axes, 3 * ii);
    const V3 a1 = load3(s.inst_axes, 3 * ii + 1);
    const V3 a2 = load3(s.inst_axes, 3 * ii + 2);
    const V3 q = sub(p, load3(s.inst_o, ii));
    const V3 lp = make(dot(a0, q), dot(a1, q), dot(a2, q));
    const float fold = found ? best : dmax;
    float dmin = kFltMax;
    int win = -1;
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
    int node = __ldg(s.inst_shape_root + ii);
    while (node >= 0) {
      const float4 n0 = __ldg(s.nodes + 2 * node);
      const float4 n1 = __ldg(s.nodes + 2 * node + 1);
      const int w6 = __float_as_int(n1.z), w7 = __float_as_int(n1.w);
      const float limit = dmin < fold ? dmin : fold;
      const bool out = cull_box(lp, make(n0.x, n0.y, n0.z),
                                make(n0.w, n1.x, n1.y), limit);
      if (out && !(w7 & 2)) {
        node = w7 >> 2;
        continue;
      }
      if (!(w7 & 1)) {
        node = (w6 >> 4) + 1;  // the second child first
        continue;
      }
      int cnt = w6 & kOverlapCountSat;
      if (cnt == kOverlapCountSat) cnt = __ldg(s.node_count + node);
      const float4* rec = s.prims + 4LL * ((w6 >> 4) - s.slot0);
      for (int j = 0; j < cnt; ++j, rec += 4) {
        const float4 q0 = __ldg(rec);
        const int tag = __float_as_int(__ldg(rec + 3).x);
        if (out && !(tag & kThinBit)) continue;  // only thin ones, out of reach
        const int t = tag & 3, prim = (tag & ~kThinBit) >> 2;
        const V3 v0 = make(q0.x, q0.y, q0.z);
        bool ok;
        float d, x, y = 0.0f, z = 0.0f;
        if (t == kOverlapTriangle) {
          const float4 q1 = __ldg(rec + 1), q2 = __ldg(rec + 2);
          const V3 v1 = make(q1.x, q1.y, q1.z), v2 = make(q2.x, q2.y, q2.z);
          const V3 uv = closestuv_triangle(lp, v0, v1, v2);
          const V3 c = add(add(mul(v0, uv.x), mul(v1, uv.y)), mul(v2, uv.z));
          const float r = q0.w * uv.x + q1.w * uv.y + q2.w * uv.z;
          ok = accept(lp, c, r, dmax, &d);
          x = uv.x;
          y = uv.y;
          z = uv.z;
        } else if (t == kOverlapLine) {
          const float4 q1 = __ldg(rec + 1);
          const V3 v1 = make(q1.x, q1.y, q1.z);
          const float u = closestuv_line(lp, v0, v1);
          const V3 c = add(mul(v0, 1.0f - u), mul(v1, u));
          const float r = q0.w * (1.0f - u) + q1.w * u;
          ok = accept(lp, c, r, dmax, &d);
          x = 1.0f - u;
          y = u;
        } else if (t == kOverlapPoint) {
          ok = accept(lp, v0, q0.w, dmax, &d);
          x = 1.0f;
        } else {
          continue;
        }
        // smallest d, the largest prim index on ties, in any visit order
        if (ok && (d < dmin || (d == dmin && prim > win))) {
          dmin = d;
          win = prim;
          w0 = x;
          w1 = y;
          w2 = z;
        }
      }
      node = w7 >> 2;
    }
    if (win >= 0 && dmin <= fold) {
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
  reinterpret_cast<float4*>(euv_out)[k] = make_float4(e0, e1, e2, e3);
}

}  // namespace yrt

// Records of the current pos and radius (see the header). parent and
// arrivals are (num_nodes,) i32 scratch.
extern "C" int yrt_overlap_refit(
    const int* node_start, const int* node_count, const int* node_isleaf,
    const int* node_kind, const int* node_skip, const float* node_bbox_min,
    const float* node_bbox_max, const int* leaf_items, const int* prim_v,
    const int* prim_type, const float* pos, const float* radius,
    int num_nodes, int slot0, int* parent, int* arrivals, float* nodes,
    float* prims, void* stream) {
  if (num_nodes <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const yrt::RefitView v{node_start, node_count, node_isleaf, node_kind,
                         node_skip, node_bbox_min, node_bbox_max, leaf_items,
                         prim_v, prim_type, pos, radius, num_nodes, slot0};
  const size_t bytes = sizeof(int) * static_cast<size_t>(num_nodes);
  cudaError_t err = cudaMemsetAsync(parent, 0xff, bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(arrivals, 0, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = yrt::blocks_for(num_nodes, yrt::kRefitThreads);
  yrt::overlap_parent_kernel<<<grid, yrt::kRefitThreads, 0, st>>>(v, parent,
                                                                  nodes);
  yrt::overlap_refit_kernel<<<grid, yrt::kRefitThreads, 0, st>>>(
      v, parent, arrivals, nodes, prims);
  return static_cast<int>(cudaGetLastError());
}

// The query on the records of yrt_overlap_refit.
extern "C" int yrt_overlap(const float* queries, const float* dist_max,
                           int nq, const float* inst_axes,
                           const float* inst_o, const int* inst_shape_root,
                           int num_inst, const float* nodes,
                           const int* node_count, const float* prims,
                           int slot0, uint8_t* found,
                           float* dist, int* inst, int* prim, float* euv,
                           void* stream) {
  if (nq > 0) {
    const yrt::OverlapView s{
        queries, dist_max, inst_axes, inst_o, inst_shape_root,
        reinterpret_cast<const float4*>(nodes), node_count,
        reinterpret_cast<const float4*>(prims), nq, num_inst, slot0};
    yrt::overlap_kernel<<<yrt::blocks_for(nq, yrt::kOverlapThreads),
                          yrt::kOverlapThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        s, found, dist, inst, prim, euv);
  }
  return static_cast<int>(cudaGetLastError());
}
