// K8: area-light sample points: one shape-space point per (light, ray); and
// K10, its reverse.
//
// Replaces render/lights.py::sample_light_points (82-116) of the JAX package
// with its variates (render/renderer.py:271-275: per_ray_uniform keyed by
// ray id under `seed ^ 0x85EBCA6B`, three columns) and
// ops/sampling.py::sample_triangle (92-104). The tables (cdf, n, prim_lo,
// deg) come from render/lights.py::build_light_sampler, on the host.
// lights_simple.cu keeps both kernels' first forms, for comparison only.
//
// K8, a thread per kPointsRays (2) rays i (32-bit indices), each over
// every light l:
//   1. the ray's variates r0, r1, r2, once: the top 24 bits of
//      pcg(id ^ h_k) times 2^-24, with h_k = pcg(lseed + k) and
//      lseed = seed ^ 0x85EBCA6B; h_k depends on the seed alone and is
//      computed once per thread (the seed is the launch argument, or the
//      caller's device seed word, read once per thread where it is given);
//   2. slot = the count of cdf[l, :] < r0 * cdf[l, E-1], by binary search
//      (below);
//   3. prim = clip(prim_lo[l] + min(slot, n[l] - 1), 0, P - 1), its type
//      and vertices;
//   4. a triangle gives v0 * w0 + v1 * a + v2 * b with a = 1 - sqrt(r1),
//      b = r2 * sqrt(r1), w0 = (1 - a) - b, added left to right; a line
//      v0 * (1 - r1) + v1 * r1; a point v0 itself;
//   5. a light whose shape has no element (deg[l]) gives light_pos[l];
//   6. row l * N + i of the (L, N, 3) output: a warp's stores cover 384
//      contiguous bytes per light.
// Only IEEE + - * sqrt and compares, built with --fmad=false: bit-equal to
// the plain torch version.
//
// Staging. When L * (E + 1) <= kStageSlots (256, one record per thread of
// a block), each block first copies the CDF rows and, per light and slot
// j in [0, E], the element that slot picks (its type and vertex
// positions; light_pos for a deg light) into shared memory in one pass,
// and the rays then read shared memory only. Larger tables (a mesh light)
// are read from global memory, where the search's first compares hit the
// same few words in every thread. The test depends on L and E alone, so
// the branch is uniform over the launch.
//
// The search equals the dense count on every row build_light_sampler
// makes. A row is the f32 cumsum of non-negative weights (element counts,
// segment lengths, triangle areas: norms), padded with its last value. So
//   * without NaN it is non-decreasing (an inf weight keeps it so): for a
//     non-NaN x the predicate cdf[m] < x holds on a prefix [0, c) and fails
//     after it, and the lower bound of the predicate is the count c;
//   * a NaN weight makes every later entry NaN, the last one too, so
//     x = r0 * NaN is NaN; x is NaN too when r0 = 0 and the total is inf.
//     At a NaN x no compare holds: the count is 0, and the search, which
//     only moves right where cdf[m] < x holds, returns 0.
// The search uses the predicate cdf[m] < x itself, never its negation
// !(cdf[m] >= x), which differs at NaN. Its loop runs a fixed number of
// steps for a given E (ceil(log2 E), then one compare), so no warp
// diverges in it. There is no dense-scan branch for small E.
//
// What bounds K8 on an H100: 4 bytes read per ray and 12 bytes written per
// (light, ray), 14.7 MB for 524,288 rays and two lights, about 4.4 us at
// 3.35 TB/s; with the tables staged a ray's work is a few dozen integer
// and float operations per light. The block size and rays per thread of
// K8 and K10 were chosen on an H100 with lights_ablation.py (PERF.md).
//
// K10 is K8's reverse (the adjoint of sample_light_points): the (L, N, 3)
// cotangent g of the points goes back to the vertices the points were made
// from, with the weights of step 4 (triangle (w0, a, b), line (1 - r1, r1),
// point 1), and, for a deg light, to light_pos[l]. It repeats K8's pick, so
// it sees the forward's exact element. Each term is t = g * w in f32 (as
// the gather's reverse forms it), added in f64; rays whose g is zero and,
// on the atomic paths, zero terms are skipped, which changes no sum. Every
// sum is rounded to f32 once. Three launches, no host sync,
// every output word written once:
//   1. light_span_kernel, one block per light: the light's vertex span
//      [base, base + span) over every element its pick can reach (warp and
//      block min/max), and its path below; it zeroes the light's sums, its
//      block counter and, on the atomic paths, its rows of the f64 scratch.
//   2. light_points_bwd_kernel, grid (blocks, L): a block takes kBwdRays
//      rays of one light, kBwdRaysPerThread per thread, and first lists in
//      ray order those whose cotangent row is not zero (a training step's
//      g is zero on unlit and dead rays: 90% of the area hair frame's);
//      its threads then take the listed rays in turn.
//      - A deg light, or a span of at most kRegSlots (8) vertices (a
//        triangle has 3, the quad 4, a 4-segment polyline 5): each thread
//        keeps 3 x 8 f64 sums in registers, at compile-time slots with
//        predicated adds (a term is converted to f64 once, and the slots
//        past the span are skipped by a branch uniform over the block).
//        Each warp sums its lanes with a shuffle tree, the block's warps
//        go into the block's partial row in warp order, and the light's
//        last block to finish (a fence and a counter) sums the partial
//        rows column by column in block order. These sums repeat bit for
//        bit from run to run.
//      - A span of at most kAccVerts (256): the lanes add into an f64 row
//        in shared memory with atomics, then the row goes to the f64
//        scratch with one atomic per non-zero word (on an 81-vertex panel
//        25x faster than sending every term to the global atomics, where
//        all of a launch's terms meet on a few hundred words: PERF.md).
//      - A larger span (a mesh light): each lane's terms go to the f64
//        scratch with atomics; picks scatter over many vertices, so few
//        lanes meet on a word. On these two paths the order of the atomics
//        varies, so the last bit of a sum may differ between runs.
//   3. light_points_bwd_finish_kernel, one thread per output word:
//      d_pos[v] = the register-path sums of the lights whose span holds v,
//      added in light order (lights that share a shape share the rows),
//      plus the scratch word where an atomic-path light holds v, rounded to
//      f32; d_light_pos[l] = a deg light's sum, else 0.
// What bounds K10: the (L, N, 3) cotangent and the ids read once, 8.78 us
// for 2 x 2^20 rays; the register path issues 3 x (its span) predicated
// f64 adds per term.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr unsigned int kLightSeedXor = 0x85EBCA6Bu;
constexpr int kLightLine = 1, kLightTriangle = 2;  // scene.PRIM_*
constexpr int kDegRec = -1;           // a staged deg light: light_pos in v[0]
constexpr int kStageSlots = 256;      // staged element records (and CDF words)
constexpr int kPointsThreads = 256;   // K8's block
constexpr int kPointsRays = 2;        // K8's rays per thread
constexpr int kPointsBlockRays = kPointsThreads * kPointsRays;

constexpr int kBwdThreads = 256;      // K10's block
constexpr int kBwdRaysPerThread = 16;
constexpr int kBwdRays = kBwdThreads * kBwdRaysPerThread;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kRegSlots = 8;          // vertices summed in registers
constexpr int kRowWords = 3 * kRegSlots;
constexpr int kAccVerts = 256;        // vertices in the shared f64 row
static_assert(kStageSlots <= kPointsThreads, "staging is one pass");
static_assert(kBwdWarps * kRowWords <= 3 * kAccVerts,
              "the warp rows fit the shared row");

// K10's path for a light (light_span_kernel decides it)
enum : int { kSpanDeg = 0, kSpanRegisters = 1, kSpanShared = 2,
             kSpanGlobal = 3 };

// The sampler's tables and the scene's topology, as the wrapper passes them.
struct LightTables {
  const float* cdf;     // (L, E)
  const int* elem_n;    // (L,)
  const int* prim_lo;   // (L,)
  const uint8_t* deg;   // (L,)
  const int* prim_v;    // (P, 3)
  const int* prim_type; // (P,)
  int num_lights, num_elems, num_prims;
};

// The element a slot picks: its type (scene.PRIM_*) and vertex ids.
struct Elem {
  int type;
  int vid[3];
};

// K8's record of a slot: the element's type (or kDegRec) and the positions
// of its vertices.
struct ElemPoints {
  int type;
  V3 v[3];
};

// The point's weights on the element's vertices; `count` is 3 (triangle),
// 2 (line) or 1.
struct Weights {
  float w[3];
  int count;
};

// The seed-only inner hashes h_k = pcg(lseed + k) of the three variates.
struct LightSeed {
  unsigned int h[3];
};

__device__ __forceinline__ LightSeed light_seed(unsigned int seed) {
  const unsigned int lseed = seed ^ kLightSeedXor;
  LightSeed s;
  s.h[0] = pcg_hash(lseed);
  s.h[1] = pcg_hash(lseed + 1u);
  s.h[2] = pcg_hash(lseed + 2u);
  return s;
}

// per_ray_uniform's variate with its inner hash given
__device__ __forceinline__ float variate(unsigned int h, int id) {
  return static_cast<float>(pcg_hash(static_cast<unsigned int>(id) ^ h) >>
                            8u) *
         5.9604644775390625e-08f;
}

// The count of row[m] < x over m in [0, e), e >= 1, by binary search: the
// dense count on every row build_light_sampler makes (header). `row` may
// point to shared or global memory.
__device__ __forceinline__ int cdf_count(const float* row, int e, float x) {
  int lo = 0;
  while (e > 1) {
    const int half = e >> 1;
    lo = row[lo + half] < x ? lo + half : lo;
    e -= half;
  }
  return lo + (row[lo] < x ? 1 : 0);
}

// clip(prim_lo[l] + min(slot, n[l] - 1), 0, P - 1)
__device__ __forceinline__ int pick_prim(const LightTables& t, int l,
                                         int slot) {
  const int hi = __ldg(t.elem_n + l) - 1;
  const int prim = __ldg(t.prim_lo + l) + (slot < hi ? slot : hi);
  return prim < 0 ? 0 : (prim > t.num_prims - 1 ? t.num_prims - 1 : prim);
}

__device__ __forceinline__ int vertex_count(int type) {
  return type == kLightTriangle ? 3 : (type == kLightLine ? 2 : 1);
}

__device__ __forceinline__ Elem load_elem(const LightTables& t, int prim) {
  Elem el;
  el.type = __ldg(t.prim_type + prim);
  el.vid[0] = __ldg(t.prim_v + 3 * prim);
  el.vid[1] = __ldg(t.prim_v + 3 * prim + 1);
  el.vid[2] = __ldg(t.prim_v + 3 * prim + 2);
  return el;
}

// The positions of the element's vertices (the first, repeated, where it
// has fewer than three).
__device__ __forceinline__ ElemPoints elem_points(const Elem& el,
                                                  const float* __restrict__
                                                      pos) {
  const int k = vertex_count(el.type);
  ElemPoints r;
  r.type = el.type;
  r.v[0] = load3(pos, el.vid[0]);
  r.v[1] = k > 1 ? load3(pos, el.vid[1]) : r.v[0];
  r.v[2] = k > 2 ? load3(pos, el.vid[2]) : r.v[0];
  return r;
}

// Stage every light's CDF row into s_cdf and, per light and slot j in
// [0, E], the record of the element that slot picks into
// s_rec[l * (E + 1) + j] (a deg light's records hold light_pos); every
// thread of the block takes part. The caller checks L * (E + 1) <=
// kStageSlots and syncs the block after.
__device__ void stage_tables(const LightTables& t,
                             const float* __restrict__ pos,
                             const float* __restrict__ light_pos,
                             float* s_cdf, ElemPoints* s_rec) {
  const int e = t.num_elems;
  for (int k = threadIdx.x; k < t.num_lights * e; k += blockDim.x)
    s_cdf[k] = __ldg(t.cdf + k);
  for (int k = threadIdx.x; k < t.num_lights * (e + 1); k += blockDim.x) {
    const int l = k / (e + 1);
    if (__ldg(t.deg + l) != 0) {
      ElemPoints r;
      r.type = kDegRec;
      r.v[0] = r.v[1] = r.v[2] = load3(light_pos, l);
      s_rec[k] = r;
    } else {
      s_rec[k] = elem_points(load_elem(t, pick_prim(t, l, k % (e + 1))), pos);
    }
  }
}

__device__ __forceinline__ Weights elem_weights(int type, float r1,
                                                float r2) {
  Weights w;
  if (type == kLightTriangle) {
    const float sq = sqrtf(r1);
    const float a = 1.0f - sq;
    const float b = r2 * sq;
    w.w[0] = 1.0f - a - b;
    w.w[1] = a;
    w.w[2] = b;
    w.count = 3;
  } else if (type == kLightLine) {
    w.w[0] = 1.0f - r1;
    w.w[1] = r1;
    w.w[2] = 0.0f;
    w.count = 2;
  } else {
    w.w[0] = 1.0f;
    w.w[1] = w.w[2] = 0.0f;
    w.count = 1;
  }
  return w;
}

// Step 4: the point on the element, in the plain version's order.
__device__ __forceinline__ V3 elem_point(const ElemPoints& r, float r1,
                                         float r2) {
  if (r.type == kLightTriangle) {
    const Weights w = elem_weights(r.type, r1, r2);
    return add(add(mul(r.v[0], w.w[0]), mul(r.v[1], w.w[1])),
               mul(r.v[2], w.w[2]));
  }
  if (r.type == kLightLine)
    return add(mul(r.v[0], 1.0f - r1), mul(r.v[1], r1));
  return r.v[0];  // a point (or a deg light's light_pos)
}

__global__ void __launch_bounds__(kPointsThreads) light_points_kernel(
    const int* __restrict__ ids, int n, unsigned int seed, LightTables t,
    const float* __restrict__ pos, const float* __restrict__ light_pos,
    const unsigned int* __restrict__ seed_word, float* __restrict__ out) {
  __shared__ float s_cdf[kStageSlots];
  __shared__ ElemPoints s_rec[kStageSlots];
  const int e = t.num_elems;
  const bool staged = t.num_lights * (e + 1) <= kStageSlots;
  // the rays' ids first: their loads overlap the staging
  const int i0 = blockIdx.x * kPointsBlockRays + threadIdx.x;
  int id[kPointsRays];
#pragma unroll
  for (int r = 0; r < kPointsRays; ++r) {
    const int i = i0 + r * kPointsThreads;
    id[r] = i < n ? __ldg(ids + i) : 0;
  }
  if (staged) {
    stage_tables(t, pos, light_pos, s_cdf, s_rec);
    __syncthreads();
  }
  const LightSeed ls =
      light_seed(seed_word != nullptr ? __ldg(seed_word) : seed);
  const long long stride = 3LL * n;
#pragma unroll
  for (int r = 0; r < kPointsRays; ++r) {
    const int i = i0 + r * kPointsThreads;
    if (i >= n) return;
    const float r0 = variate(ls.h[0], id[r]);
    const float r1 = variate(ls.h[1], id[r]);
    const float r2 = variate(ls.h[2], id[r]);
    float* o = out + 3LL * i;
    for (int l = 0; l < t.num_lights; ++l, o += stride) {
      V3 p;
      if (staged) {
        const float* row = s_cdf + l * e;
        const int slot = cdf_count(row, e, r0 * row[e - 1]);
        p = elem_point(s_rec[l * (e + 1) + slot], r1, r2);
      } else if (__ldg(t.deg + l) != 0) {
        p = load3(light_pos, l);
      } else {
        const float* row = t.cdf + static_cast<long long>(l) * e;
        const int slot = cdf_count(row, e, r0 * __ldg(row + e - 1));
        p = elem_point(elem_points(load_elem(t, pick_prim(t, l, slot)),
                                   pos),
                       r1, r2);
      }
      o[0] = p.x;
      o[1] = p.y;
      o[2] = p.z;
    }
  }
}

// ----------------------------------------------------------------------
// K10

struct LightSpan {
  int base, span, kind, pad;
};

// K10's scratch, carved from one buffer (bwd_layout).
struct BwdScratch {
  double* partials;    // (L, blocks, kRowWords): each block's partial row
  double* sums;        // (L, kRowWords): the register path's sums
  double* pos64;       // (V, 3): the atomic paths' sums
  LightSpan* spans;    // (L,)
  unsigned int* done;  // (L,): blocks of the light that have finished
};

__host__ __device__ inline long long align16(long long b) {
  return (b + 15) & ~15LL;
}

// Byte offsets of BwdScratch's arrays in one buffer; returns its size.
__host__ __device__ inline long long bwd_layout(int n, int num_lights,
                                                int num_verts,
                                                long long off[5]) {
  const long long blocks = blocks_for(n, kBwdRays);
  long long b = 0;
  off[0] = b;
  b = align16(b + 8LL * num_lights * blocks * kRowWords);
  off[1] = b;
  b = align16(b + 8LL * num_lights * kRowWords);
  off[2] = b;
  b = align16(b + 8LL * 3 * num_verts);
  off[3] = b;
  b = align16(b + static_cast<long long>(sizeof(LightSpan)) * num_lights);
  off[4] = b;
  return align16(b + 4LL * num_lights);
}

// Step 1 of K10: one block per light.
__global__ void __launch_bounds__(kBwdThreads) light_span_kernel(
    LightTables t, BwdScratch s) {
  __shared__ int s_min[kBwdWarps], s_max[kBwdWarps];
  __shared__ LightSpan s_span;
  const int l = blockIdx.x;
  const bool deg = __ldg(t.deg + l) != 0;
  int vmin = INT_MAX, vmax = INT_MIN;
  if (!deg) {
    // every prim that a slot in [0, E] picks
    for (int slot = threadIdx.x; slot <= t.num_elems; slot += kBwdThreads) {
      const int prim = pick_prim(t, l, slot);
      const int k = vertex_count(__ldg(t.prim_type + prim));
      for (int j = 0; j < k; ++j) {
        const int v = __ldg(t.prim_v + 3 * prim + j);
        vmin = v < vmin ? v : vmin;
        vmax = v > vmax ? v : vmax;
      }
    }
  }
  vmin = __reduce_min_sync(0xffffffffu, vmin);
  vmax = __reduce_max_sync(0xffffffffu, vmax);
  if ((threadIdx.x & 31) == 0) {
    s_min[threadIdx.x / 32] = vmin;
    s_max[threadIdx.x / 32] = vmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kBwdWarps; ++w) {
      vmin = s_min[w] < vmin ? s_min[w] : vmin;
      vmax = s_max[w] > vmax ? s_max[w] : vmax;
    }
    LightSpan sp;
    sp.pad = 0;
    if (deg) {
      sp.base = 0;
      sp.span = 1;
      sp.kind = kSpanDeg;
    } else {
      sp.base = vmin;
      sp.span = vmax - vmin + 1;
      sp.kind = sp.span <= kRegSlots
                    ? kSpanRegisters
                    : (sp.span <= kAccVerts ? kSpanShared : kSpanGlobal);
    }
    s.spans[l] = sp;
    s.done[l] = 0u;
    s_span = sp;
  }
  __syncthreads();
  if (threadIdx.x < kRowWords) s.sums[l * kRowWords + threadIdx.x] = 0.0;
  const LightSpan sp = s_span;
  if (sp.kind == kSpanShared || sp.kind == kSpanGlobal)
    for (int j = threadIdx.x; j < 3 * sp.span; j += kBwdThreads)
      s.pos64[3LL * sp.base + j] = 0.0;
}

// Add one term, converted to f64 once, into register slot q (q < span,
// uniform over the block). Every term is added: the sums start at +0 and
// are never -0, so a zero term leaves them as they are, as the atomic
// paths, which skip it, leave theirs.
__device__ __forceinline__ void add_slot(double (&acc)[kRowWords], int q,
                                         int span, V3 t) {
  const double x = t.x, y = t.y, z = t.z;
#pragma unroll
  for (int k = 0; k < kRegSlots; ++k) {
    if (k >= span) break;
    if (q == k) {
      acc[3 * k] += x;
      acc[3 * k + 1] += y;
      acc[3 * k + 2] += z;
    }
  }
}

// The register path's block sums: each warp's shuffle tree, then the
// block's warps in warp order into its partial row; the light's last block
// sums the partial rows column by column in block order into s.sums.
// `words` (3 x the span) is uniform over the block.
__device__ __forceinline__ void block_row_sums(
    const double (&acc)[kRowWords], int words, int l, const BwdScratch& s,
    double* s_warp) {  // kBwdWarps x kRowWords
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int w = 0; w < kRowWords; ++w) {
    if (w < words) {
      double v = acc[w];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) s_warp[warp * kRowWords + w] = v;
    }
  }
  __syncthreads();
  double* partials = s.partials + static_cast<long long>(l) * gridDim.x *
                                      kRowWords;
  if (static_cast<int>(threadIdx.x) < words) {
    double v = 0.0;
    for (int wi = 0; wi < kBwdWarps; ++wi)
      v += s_warp[wi * kRowWords + threadIdx.x];
    partials[blockIdx.x * kRowWords + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(s.done + l, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  const int nb = static_cast<int>(gridDim.x);
  for (int w = warp; w < words; w += kBwdWarps) {
    double v = 0.0;
    for (int b0 = lane; b0 < nb; b0 += 32 * 8) {
      double p[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int b = b0 + 32 * u;
        p[u] = b < nb ? __ldcg(partials + b * kRowWords + w) : 0.0;
      }
      v += ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
    }
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) s.sums[l * kRowWords + w] = v;
  }
}

// The block's rays [first, first + kBwdRays) whose cotangent row is not
// zero (a zero row adds no term), as offsets from `first` in ray order into
// s_live; returns their count. Round r holds rays r * kBwdThreads + tid:
// each warp's ballot, then warp 0 scans the (round, warp) counts in that
// order. Every thread of the block calls it.
__device__ __forceinline__ int live_rays(const float* __restrict__ gl, int n,
                                         int first, int* s_live) {
  constexpr int kCounts = kBwdRaysPerThread * kBwdWarps;
  static_assert(kCounts % 32 == 0, "warp 0 scans whole words");
  __shared__ int s_off[kCounts + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  unsigned int mask[kBwdRaysPerThread];
#pragma unroll
  for (int r = 0; r < kBwdRaysPerThread; ++r) {
    const int i = first + r * kBwdThreads + static_cast<int>(threadIdx.x);
    bool live = false;
    if (i < n) {
      const V3 gi = load3(gl, i);
      live = gi.x != 0.0f || gi.y != 0.0f || gi.z != 0.0f;
    }
    mask[r] = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_off[r * kBwdWarps + warp] = __popc(mask[r]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan, kCounts / 32 consecutive counts a lane
    constexpr int kPer = kCounts / 32;
    int c[kPer], sum = 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      c[u] = s_off[lane * kPer + u];
      sum += c[u];
    }
    int scan = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, scan, off);
      if (lane >= off) scan += v;
    }
    int base = scan - sum;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      s_off[lane * kPer + u] = base;
      base += c[u];
    }
    if (lane == 31) s_off[kCounts] = scan;
  }
  __syncthreads();
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kBwdRaysPerThread; ++r)
    if ((mask[r] >> lane) & 1u)
      s_live[s_off[r * kBwdWarps + warp] + __popc(mask[r] & below)] =
          r * kBwdThreads + static_cast<int>(threadIdx.x);
  __syncthreads();
  return s_off[kCounts];
}

// Step 2 of K10: grid (blocks, L), blockIdx.y the light.
__global__ void __launch_bounds__(kBwdThreads) light_points_bwd_kernel(
    const int* __restrict__ ids, int n, unsigned int seed, LightTables t,
    const float* __restrict__ g, BwdScratch s) {
  __shared__ double s_acc[3 * kAccVerts];
  __shared__ int s_live[kBwdRays];
  const int l = blockIdx.y;
  const LightSpan sp = s.spans[l];
  if (sp.kind == kSpanShared)
    for (int j = threadIdx.x; j < 3 * sp.span; j += kBwdThreads)
      s_acc[j] = 0.0;
  const float* gl = g + 3LL * n * l;
  const int e = t.num_elems;
  const float* row = t.cdf + static_cast<long long>(l) * e;
  const float total = __ldg(row + e - 1);
  const LightSeed ls = light_seed(seed);
  const int first = blockIdx.x * kBwdRays;
  const int m = live_rays(gl, n, first, s_live);  // syncs the block
  const bool registers = sp.kind == kSpanDeg || sp.kind == kSpanRegisters;
  double acc[kRowWords];
#pragma unroll
  for (int w = 0; w < kRowWords; ++w) acc[w] = 0.0;
  for (int k = threadIdx.x; k < m; k += kBwdThreads) {
    const int i = first + s_live[k];
    const V3 gi = load3(gl, i);
    if (sp.kind == kSpanDeg) {
      add_slot(acc, 0, 1, gi);
      continue;
    }
    const int id = __ldg(ids + i);
    const float r1 = variate(ls.h[1], id);
    const float r2 = variate(ls.h[2], id);
    const int slot = cdf_count(row, e, variate(ls.h[0], id) * total);
    const Elem el = load_elem(t, pick_prim(t, l, slot));
    const Weights w = elem_weights(el.type, r1, r2);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j >= w.count) break;
      const V3 tj = mul(gi, w.w[j]);  // f32, as torch's gather reverse
      const int q = el.vid[j] - sp.base;
      if (registers) {
        add_slot(acc, q, sp.span, tj);
      } else {
        double* dst = sp.kind == kSpanShared ? s_acc + 3 * q
                                             : s.pos64 + 3LL * el.vid[j];
        if (tj.x != 0.0f) atomicAdd(dst, static_cast<double>(tj.x));
        if (tj.y != 0.0f) atomicAdd(dst + 1, static_cast<double>(tj.y));
        if (tj.z != 0.0f) atomicAdd(dst + 2, static_cast<double>(tj.z));
      }
    }
  }
  if (registers) {
    block_row_sums(acc, 3 * sp.span, l, s, s_acc);
    return;
  }
  if (sp.kind != kSpanShared) return;
  __syncthreads();
  for (int j = threadIdx.x; j < 3 * sp.span; j += kBwdThreads)
    if (s_acc[j] != 0.0) atomicAdd(s.pos64 + 3LL * sp.base + j, s_acc[j]);
}

// Step 3 of K10: one thread per word of d_pos (V, 3), then of d_light_pos.
__global__ void light_points_bwd_finish_kernel(int num_lights,
                                               int num_verts, BwdScratch s,
                                               float* __restrict__ d_pos,
                                               float* __restrict__
                                                   d_light_pos) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv3 = 3 * num_verts;
  if (w < nv3) {
    const int v = w / 3, c = w - 3 * (w / 3);
    double sum = 0.0;
    bool atomics = false;
    for (int l = 0; l < num_lights; ++l) {
      const LightSpan sp = s.spans[l];
      if (sp.kind == kSpanDeg || v < sp.base || v - sp.base >= sp.span)
        continue;
      if (sp.kind == kSpanRegisters)
        sum += s.sums[l * kRowWords + 3 * (v - sp.base) + c];
      else
        atomics = true;
    }
    if (atomics) sum += s.pos64[w];
    d_pos[w] = static_cast<float>(sum);
  } else if (w < nv3 + 3 * num_lights) {
    const int k = w - nv3, l = k / 3;
    d_light_pos[k] = s.spans[l].kind == kSpanDeg
                         ? static_cast<float>(
                               s.sums[l * kRowWords + k - 3 * l])
                         : 0.0f;
  }
}

}  // namespace yrt

namespace {

yrt::LightTables light_tables(const float* cdf, int num_lights,
                              int num_elems, const int* elem_n,
                              const int* prim_lo, const uint8_t* deg,
                              const int* prim_v, const int* prim_type,
                              int num_prims) {
  yrt::LightTables t;
  t.cdf = cdf;
  t.elem_n = elem_n;
  t.prim_lo = prim_lo;
  t.deg = deg;
  t.prim_v = prim_v;
  t.prim_type = prim_type;
  t.num_lights = num_lights;
  t.num_elems = num_elems;
  t.num_prims = num_prims;
  return t;
}

}  // namespace

// K8. seed_word, where not null, is a device word holding the seed's 32
// bits, read in place of `seed` when the kernel runs (the device loop's kept
// graph, whose launch arguments are fixed at capture).
extern "C" int yrt_light_points(const int* ids, int n, unsigned int seed,
                                const float* cdf, int num_lights,
                                int num_elems, const int* elem_n,
                                const int* prim_lo, const uint8_t* deg,
                                const int* prim_v, const int* prim_type,
                                int num_prims, const float* pos,
                                const float* light_pos,
                                const unsigned int* seed_word, float* out,
                                void* stream) {
  if (n > 0 && num_lights > 0) {
    yrt::light_points_kernel<<<yrt::blocks_for(n, yrt::kPointsBlockRays),
                               yrt::kPointsThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        ids, n, seed,
        light_tables(cdf, num_lights, num_elems, elem_n, prim_lo, deg,
                     prim_v, prim_type, num_prims),
        pos, light_pos, seed_word, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of K10's scratch for n rays, num_lights lights and num_verts
// vertices.
extern "C" long long yrt_light_points_bwd_scratch(int n, int num_lights,
                                                  int num_verts) {
  long long off[5];
  return yrt::bwd_layout(n, num_lights, num_verts, off);
}

// K10. g is the (L, N, 3) cotangent of yrt_light_points's output; scratch
// holds yrt_light_points_bwd_scratch(n, num_lights, num_verts) bytes, 16-byte
// aligned, in any state; every word of d_pos (V, 3) and d_light_pos (L, 3),
// f32, is written.
extern "C" int yrt_light_points_bwd(const int* ids, int n, unsigned int seed,
                                    const float* cdf, int num_lights,
                                    int num_elems, const int* elem_n,
                                    const int* prim_lo, const uint8_t* deg,
                                    const int* prim_v, const int* prim_type,
                                    int num_prims, const float* g,
                                    int num_verts, void* scratch,
                                    float* d_pos, float* d_light_pos,
                                    void* stream) {
  const int words = 3 * (num_verts + num_lights);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long off[5];
  yrt::bwd_layout(n, num_lights, num_verts, off);
  char* base = static_cast<char*>(scratch);
  yrt::BwdScratch s;
  s.partials = reinterpret_cast<double*>(base + off[0]);
  s.sums = reinterpret_cast<double*>(base + off[1]);
  s.pos64 = reinterpret_cast<double*>(base + off[2]);
  s.spans = reinterpret_cast<yrt::LightSpan*>(base + off[3]);
  s.done = reinterpret_cast<unsigned int*>(base + off[4]);
  const yrt::LightTables t =
      light_tables(cdf, num_lights, num_elems, elem_n, prim_lo, deg, prim_v,
                   prim_type, num_prims);
  if (num_lights > 0) {
    yrt::light_span_kernel<<<num_lights, yrt::kBwdThreads, 0, st>>>(t, s);
    if (n > 0) {
      const dim3 grid(yrt::blocks_for(n, yrt::kBwdRays), num_lights);
      yrt::light_points_bwd_kernel<<<grid, yrt::kBwdThreads, 0, st>>>(
          ids, n, seed, t, g, s);
    }
  }
  if (words == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kFinishThreads = 256;
  yrt::light_points_bwd_finish_kernel<<<
      yrt::blocks_for(words, kFinishThreads), kFinishThreads, 0, st>>>(
      num_lights, num_verts, s, d_pos, d_light_pos);
  return static_cast<int>(cudaGetLastError());
}
