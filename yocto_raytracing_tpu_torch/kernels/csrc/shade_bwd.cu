// K5: reverse of one shading bounce (the adjoint of K4).
//
// Replaces the XLA-generated adjoint of render/shade.py::shade_step under
// jax.checkpoint in the JAX package's differentiable depth loop
// (render/renderer.py:313-342): the forward saves only the hit topology and
// the shadow visibility, and the backward recomputes the bounce.
//
// One thread per ray recomputes the bounce in registers with the forward's
// own functions (shade.cuh), from the saved ray, (inst, prim), mask and (L, N)
// occlusion, then runs the adjoint by hand. Cotangents of (color, kr, p,
// refl_dir) come in; out go dense d_ro / d_rd (N, 3) and scatter-adds into
// the gradients of pos, norm, texcoord (through prim_v), inst_axes, inst_o,
// mat_kd, mat_ks, mat_kr, mat_rs, light_pos, light_axes, light_o and
// light_ke. Texels are integers: only d_uv flows, through the bilinear
// weights and d s / d u = w.
//
// With per-ray light positions (area lights, ShadeScene::light_pos_ray) the
// bounce reads light l's position for ray i from row l * N + i, and the
// gradient of that position is written densely into the (L, N, 3) f32
// ShadeGrads::light_pos_ray, each ray's thread its own rows, no atomics;
// unlit and masked lanes get exact zeros, and the per-light light_pos
// gradient stays zero (the bounce does not read light_pos). The light
// frame and emission sums go as on the point-light path.
//
// Derivative conventions are torch autograd's of the plain version:
// safe_sqrt, safe_normalize and safe_pow have zero gradient where their
// guard is false (JAX ops/intersect.py:40-70); clamp passes the gradient at
// its bounds, abs has zero slope at 0. Masked lanes contribute exactly 0:
// their p and refl_dir are garbage the depth loop discards, and their
// cotangents are ignored.
//
// The sums accumulate in f64 (the caller rounds each leaf to f32 once): a
// scene gradient is a sum of up to millions of signed per-ray terms, which
// f32 accumulation would round at every step. On an NVIDIA H100 80GB HBM3
// (700 W) at 2^20 rays, per-lane atomics alone made the first form ~10x
// slower on the hair scene (10.3 ms against 1.0 ms), where every ray adds to
// the same lights and materials; f32 accumulation was 5-40% faster, but ~80x
// further from an f64 reference on mat_kd and not reproducible run to run.
//
// What bounds it on an H100: the recompute (the forward's gathers and
// flops), ~3x the forward's arithmetic for the adjoint, the registers that
// hold both (the first form, shade_bwd_simple.cu, kept for comparison, uses
// 245 a thread: 8 warps an SM), and the f64 sums: per live ray 10 material,
// 12 instance and 24 vertex values, and 18 values per light. The redesign:
//
// * Records. The hit, the material and the texel quads are read from the
//   shade records (ops/shade_records.py, as K4 reads them), and read again
//   (an L1/L2 hit, through opaque()) where they are needed after the light
//   loop, instead of being held in registers through it: the light loop
//   keeps p, n, vvec, the effective material and the cotangent sums; the
//   material reverse reloads the material row and texels; the geometry
//   reverse recomputes the hit from its records.
// * Dead warps retire first. A warp with no live lane writes its exact
//   zeros (d_ro, d_rd, and the per-ray light positions' gradient) and
//   returns before any recompute. The light-sum barrier counts only the
//   block's live warps, which every warp reads from the mask.
// * Sums by columns. A warp sums K values of its lanes (18 per light, 10 for
//   a material row, 12 for an instance row, 18 + 6 for a prim's vertices)
//   through a shared buffer: the lanes store them, then lane k adds column
//   k in lane order, in f64 (K + 96 instructions for the warp, against
//   15 K for K shuffle trees).
// * Light sums per block, then in a fixed order. A light's 18 values, the
//   same rows for every ray, go per warp (by columns), then per block in
//   warp order, into an f64 scratch of block partials (a block's row
//   stored whole); light_sum_kernel adds each column in a fixed order. So
//   the light gradients are deterministic and take no atomic.
// * Material and instance rows per block. Neighbouring pixels mostly share
//   one material and one instance: a warp whose live lanes all add to one
//   row sums it by columns into shared memory, and the block adds its
//   warps' rows in warp order, one atomicAdd per row and value.
// * Vertex rows per warp. A warp whose live lanes all hit one prim sums its
//   18 pos and norm values by columns and adds each with one atomicAdd,
//   then its 6 texcoord values the same way where they are not all 0.
//   Else the lanes that add to the same vertex row are found with
//   __match_any_sync, each run of neighbouring lanes in one row is summed
//   in f64 by one segmented shuffle tree (five steps for all runs at
//   once), and the run's first lane issues one atomicAdd (a row whose
//   lanes are not neighbours takes one atomic per run); a warp whose
//   material or instance rows differ adds them the same way. So these sums
//   stay atomic, and the last bit of their f32 rounding can change from
//   run to run. d_ro and d_rd are deterministic.
// * Registers. __launch_bounds__ asks for 4 blocks of 128 threads an SM,
//   which caps the registers at 128 a thread (16 warps an SM; the first
//   form held 245, 8 warps); ptxas spills nothing.
// The block's light and row sums meet at a named barrier that counts only
// its live warps (live_barrier), so a dead warp can leave first.
#include <cstdint>

#include "shade.cuh"

namespace yrt {

// Gradient buffers of a K5 launch: f64, zero-filled by the caller, except
// light_pos_ray, the dense (L, N, 3) f32 gradient of the per-ray light
// positions (written in full when ShadeScene::light_pos_ray is set, else
// null). Mirrors kernels/_build.py::ShadeGrads.
struct ShadeGrads {
  double* pos;
  double* norm;
  double* texcoord;
  double* inst_axes;
  double* inst_o;
  double* mat_kd;
  double* mat_ks;
  double* mat_kr;
  double* mat_rs;
  double* light_pos;
  double* light_axes;
  double* light_o;
  double* light_ke;
  float* light_pos_ray;
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBwdThreads = 128;  // a multiple of the warp size
constexpr int kBwdWarps = kBwdThreads / 32;
// blocks an SM that __launch_bounds__ asks for: 4 x 128 threads caps the
// registers at 128 a thread (ptxas reports no spill; PERF.md)
constexpr int kBwdMinBlocks = 4;
// per light: light_pos xyz, light_axes rows 0-2, light_o xyz, light_ke xyz
constexpr int kLightVals = 18;
// per material row: mat_kd xyz, mat_ks xyz, mat_kr xyz, mat_rs; per
// instance row: inst_axes rows 0-2, inst_o xyz
constexpr int kMatVals = 10;
constexpr int kInstVals = 12;
// the most values a warp sums at once by columns (a light's)
constexpr int kColVals = 18;
constexpr int kSumThreads = 1024;

__device__ __forceinline__ V3 neg(V3 a) { return make(-a.x, -a.y, -a.z); }

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Adjoint of safe_normalize at v for cotangent g.
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 g) {
  const float n2 = dot(v, v);
  if (!(n2 > 0.0f)) return g;  // identity branch of the where
  const float sq = sqrtf(n2);
  const float inv = 1.0f / sq;
  const float g_inv = dot(g, v);
  const float g_n2 = (-g_inv * inv * inv) / (2.0f * sq);
  return add(mul(g, inv), mul(v, 2.0f * g_n2));
}

// Adjoint of one bilinear sample: cotangent of its value -> (d u, d v).
__device__ __forceinline__ void texture_bwd(const TexSample& ts, V3 g,
                                            float* g_u, float* g_v) {
  const float ui = 1.0f - ts.wi, uj = 1.0f - ts.wj;
  const V3 dwi = add(mul(sub(ts.t1, ts.t0), uj), mul(sub(ts.t3, ts.t2), ts.wj));
  const V3 dwj = add(mul(sub(ts.t2, ts.t0), ui), mul(sub(ts.t3, ts.t1), ts.wi));
  *g_u += dot(g, dwi) * ts.w;
  *g_v += dot(g, dwj) * ts.h;
}

// The run of a lane: the neighbouring lanes that add to the same row as it,
// from the lane's peers (__match_any_sync on the row; dead lanes form runs
// of their own, which add nothing). `last` is the run's last lane, `head`
// marks its first.
struct Run {
  int last;
  bool head;
};

__device__ __forceinline__ Run run_of(unsigned peers) {
  const int lane = threadIdx.x & 31;
  const unsigned out_above = ~peers & (0xfffffffeu << lane);
  Run r;
  r.last = out_above ? __ffs(out_above) - 2 : 31;
  r.head = lane == 0 || !((peers >> (lane - 1)) & 1u);
  return r;
}

__device__ __forceinline__ unsigned row_peers(bool live, int row) {
  return __match_any_sync(kFull, live ? row : -1);
}

// *dst += x over each run (x is 0 on dead lanes): a segmented shuffle tree
// in f64 leaves each lane the sum of its run from itself to the run's end,
// and the run's head adds that to its row. A value that is 0 on every lane
// takes no tree.
__device__ __forceinline__ void run_add(double* dst, const Run& r, float x) {
  if (!__any_sync(kFull, x != 0.0f)) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  double t = static_cast<double>(x);
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_down_sync(kFull, t, off);
    if (lane + off <= r.last) t += y;
  }
  if (r.head && t != 0.0) atomicAdd(dst, t);
}

__device__ __forceinline__ void run_add3(double* dst, const Run& r, V3 v) {
  run_add(dst, r, v.x);
  run_add(dst + 1, r, v.y);
  run_add(dst + 2, r, v.z);
}

// A warp's K per-lane values summed by columns: the lanes store them in the
// warp's shared buffer, then lane k adds column k in f64, in four chains of
// every fourth lane, then the chains in order (K + 96 instructions for the
// warp, against 15 K for K shuffle trees). Lane k < K returns the warp's
// sum of value k, the others 0.
template <int K>
__device__ __forceinline__ double warp_columns(const float (&v)[K],
                                               float (*buf)[33]) {
  static_assert(K <= kColVals, "a column per lane");
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the last call's reads of buf are done
#pragma unroll
  for (int k = 0; k < K; ++k) buf[k][lane] = v[k];
  __syncwarp();
  if (lane >= K) return 0.0;
  // four chains (lanes j = 4 m + r), added in a fixed order
  double t[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int j = 0; j < 32; ++j) t[j & 3] += static_cast<double>(buf[lane][j]);
  return (t[0] + t[1]) + (t[2] + t[3]);
}

// Value k of material row m (kMatVals order) and of instance row r
// (kInstVals order).
__device__ __forceinline__ double* mat_dst(const ShadeGrads& G, int m,
                                           int k) {
  return k < 3   ? G.mat_kd + 3LL * m + k
         : k < 6 ? G.mat_ks + 3LL * m + (k - 3)
         : k < 9 ? G.mat_kr + 3LL * m + (k - 6)
                 : G.mat_rs + m;
}
__device__ __forceinline__ double* inst_dst(const ShadeGrads& G, int r,
                                            int k) {
  return k < 9 ? G.inst_axes + 9LL * r + k : G.inst_o + 3LL * r + (k - 9);
}

// A warp's K values per lane for a per-row leaf (material or instance). If
// every live lane adds to one row (the usual case: neighbouring pixels see
// one material and instance), the warp sums each value in f64 (shuffle
// tree) into its shared `slot` and publishes the row in `slot_row`, to be
// added once per block (block_add_rows); else it adds them by runs now and
// publishes -1.
template <int K>
__device__ __forceinline__ void warp_rows(const ShadeGrads& G, bool is_mat,
                                          unsigned live_bits, bool live,
                                          int row, const float (&v)[K],
                                          float (*buf)[33], double* slot,
                                          int* slot_row) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = row_peers(live, row);
  const int first = __ffs(live_bits) - 1;
  if (__shfl_sync(kFull, peers, first) == live_bits) {  // warp-uniform
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = live ? v[k] : 0.0f;
    const double t = warp_columns(x, buf);
    if (lane < K) slot[lane] = t;
    const int row0 = __shfl_sync(kFull, row, first);
    if (lane == 0) *slot_row = row0;
  } else {
    const Run r = run_of(peers);
#pragma unroll
    for (int k = 0; k < K; ++k)
      run_add(is_mat ? mat_dst(G, row, k) : inst_dst(G, row, k), r,
              live ? v[k] : 0.0f);
    if (lane == 0) *slot_row = -1;
  }
}

// The block's published rows (after the live barrier, in its lead warp):
// for each distinct row, the slots of the warps that publish it summed in
// warp order, one atomicAdd per value (lane k adds value k).
template <int K>
__device__ __forceinline__ void block_add_rows(const ShadeGrads& G,
                                               bool is_mat,
                                               double (*slot)[K], int* rows,
                                               unsigned block_live) {
  const int lane = threadIdx.x & 31;
  for (int w = 0; w < kBwdWarps; ++w) {
    if (!((block_live >> w) & 1u) || rows[w] < 0) continue;
    const int r = rows[w];
    bool seen = false;
    for (int u = 0; u < w; ++u)
      seen = seen || (((block_live >> u) & 1u) && rows[u] == r);
    if (seen || lane >= K) continue;
    double t = 0.0;
    for (int u = w; u < kBwdWarps; ++u)
      if (((block_live >> u) & 1u) && rows[u] == r) t += slot[u][lane];
    if (t != 0.0)
      atomicAdd(is_mat ? mat_dst(G, r, lane) : inst_dst(G, r, lane), t);
  }
}

// Named barrier 1 over the block's `threads` live threads (its live warps).
__device__ __forceinline__ void live_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    shade_bwd_kernel(ShadeScene s, ShadeGrads G,
                     const float* __restrict__ ro_p,
                     const float* __restrict__ rd_p,
                     const int* __restrict__ inst_p,
                     const int* __restrict__ prim_p,
                     const uint8_t* __restrict__ mask_p,
                     const uint8_t* __restrict__ occ, int n,
                     const float* __restrict__ gcol_p,
                     const float* __restrict__ gkr_p,
                     const float* __restrict__ gp_p,
                     const float* __restrict__ grefl_p,
                     float* __restrict__ d_ro, float* __restrict__ d_rd,
                     double* __restrict__ part) {
  __shared__ __align__(16) float stage[kBwdWarps][96];
  __shared__ float colbuf[kBwdWarps][kColVals][33];
  __shared__ double wpart[2][kBwdWarps][kLightVals];
  __shared__ double mat_slot[kBwdWarps][kMatVals];
  __shared__ double inst_slot[kBwdWarps][kInstVals];
  __shared__ int mat_row[kBwdWarps], inst_row[kBwdWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long block0 = static_cast<long long>(blockIdx.x) * kBwdThreads;
  const long long base = block0 + 32 * warp;
  const int i = static_cast<int>(base) + lane;
  const bool valid = base + lane < n;
  const bool live = valid && mask_p[i] != 0;
  const unsigned live_bits = __ballot_sync(kFull, live);
  const bool per_ray = s.light_pos_ray != nullptr;  // uniform
  float* buf = stage[warp];
  // the block's warps that hold a live lane: the same bits in every warp
  unsigned block_live = 0;
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w) {
    const long long j = block0 + 32 * w + lane;
    if (__any_sync(kFull, j < n && mask_p[j] != 0)) block_live |= 1u << w;
  }

  if (live_bits == 0) {
    // a dead warp: every output of its rays is an exact 0
    store3_warp(d_ro, base, n, zero3(), buf);
    store3_warp(d_rd, base, n, zero3(), buf);
    if (per_ray)
      for (int l = 0; l < s.num_lights; ++l)
        store3_warp(G.light_pos_ray + 3LL * l * n, base, n, zero3(), buf);
    if (block_live == 0 && warp == 0)  // a dead block: its light partials
      for (int c = lane; c < s.num_lights * kLightVals; c += 32)
        part[static_cast<long long>(blockIdx.x) * s.num_lights * kLightVals +
             c] = 0.0;
    return;
  }
  const int live_threads = 32 * __popc(block_live);
  const int lead_warp = __ffs(block_live) - 1;

  // --- forward: what the light loop reads (dead lanes of a live warp
  // recompute a harmless dummy hit and add nothing)
  const int inst = live ? inst_p[i] : 0;
  const int prim = live ? prim_p[i] : 0;
  V3 p, nrm, vvec;
  float hu, hv;
  int mat;
  bool is_lines;
  {
    const V3 ro = live ? load3(ro_p, i) : zero3();
    const V3 rd = live ? load3(rd_p, i) : make(0.0f, 0.0f, 1.0f);
    HitGeom g;
    eval_hit_record(s.inst_rec, s.prim_rec, ro, rd, inst, prim, g);
    p = g.p;
    nrm = g.n;
    hu = g.u;
    hv = g.v;
    mat = g.mat;
    is_lines = g.is_lines;
    vvec = safe_normalize(sub(ro, p));
  }
  V3 kd_eff, ks_eff;
  float ns, rs;
  {
    MatEval m;
    load_material_record(s.mat_rec + 3 * mat, m);
    material_eval(s, hu, hv, m);
    kd_eff = m.kd_eff;
    ks_eff = m.ks_eff;
    ns = m.ns;
    rs = m.rs;
  }

  // refl_dir = n * (2 dot(n, vvec)) - vvec
  V3 g_n, g_vvec;
  {
    const V3 grefl = live ? load3(grefl_p, i) : zero3();
    const float k2 = 2.0f * dot(nrm, vvec);
    g_n = mul(grefl, k2);
    g_vvec = neg(grefl);
    const float g_dot = 2.0f * dot(grefl, nrm);
    g_n = add(g_n, mul(vvec, g_dot));
    g_vvec = add(g_vvec, mul(nrm, g_dot));
  }

  // color += amb * kd_eff
  const V3 gcol = live ? load3(gcol_p, i) : zero3();
  V3 g_kde = vmul(gcol, load3(s.amb, 0));
  V3 g_kse = zero3();
  float g_ns = 0.0f;
  V3 g_p = live ? load3(gp_p, i) : zero3();

  for (int l = 0; l < s.num_lights; ++l) {
    const bool lit = live && occ[static_cast<long long>(l) * n + i] == 0;
    V3 gl_pos = zero3(), gl_o = zero3(), gl_ke = zero3();
    V3 gl_a0 = zero3(), gl_a1 = zero3(), gl_a2 = zero3();
    if (lit) {
      LightGeom lg;
      light_geom(s, l, light_position(s, l, i, n), p, lg);
      const V3 ke = load3(s.light_ke, l);
      const float r2 = lg.rdist * lg.rdist;
      const float den2 = r2 < kMinR2 ? kMinR2 : r2;
      const V3 ke_r2 = make(ke.x / den2, ke.y / den2, ke.z / den2);
      const V3 hsum = add(vvec, lg.ldir);
      const V3 hh = safe_normalize(hsum);
      const float ndl = dot(nrm, lg.ldir);
      const float ndh = dot(nrm, hh);
      float dw, sw, ml = 0.0f, mh = 0.0f, sinnh = 0.0f, bh = 0.0f;
      if (is_lines) {
        ml = max0(1.0f - fabsf(ndl));
        dw = safe_sqrt(ml);
        mh = max0(1.0f - fabsf(ndh));
        sinnh = safe_sqrt(mh);
        sw = safe_pow(sinnh, ns);
      } else {
        dw = max0(ndl);
        bh = max0(ndh);
        sw = safe_pow(bh, ns);
      }
      // contrib = (kd_eff * ke_r2) * dw + (ks_eff * ke_r2) * sw
      g_kde = add(g_kde, mul(vmul(gcol, ke_r2), dw));
      g_kse = add(g_kse, mul(vmul(gcol, ke_r2), sw));
      const V3 g_ker2 = vmul(gcol, add(mul(kd_eff, dw), mul(ks_eff, sw)));
      const float g_dw = dot(vmul(gcol, kd_eff), ke_r2);
      const float g_sw = dot(vmul(gcol, ks_eff), ke_r2);
      gl_ke = make(g_ker2.x / den2, g_ker2.y / den2, g_ker2.z / den2);
      const float g_den2 = -dot(g_ker2, ke_r2) / den2;
      const float g_rdist = r2 >= kMinR2 ? g_den2 * 2.0f * lg.rdist : 0.0f;

      float g_ndl = 0.0f, g_ndh = 0.0f;
      if (is_lines) {
        if (ml > 0.0f) {
          const float sgn = ndl > 0.0f ? 1.0f : (ndl < 0.0f ? -1.0f : 0.0f);
          g_ndl -= sgn * (g_dw / (2.0f * dw));
        }
        if (sinnh > 0.0f) {
          const float g_sinnh = g_sw * (ns * powf(sinnh, ns - 1.0f));
          g_ns += g_sw * (sw * logf(sinnh));
          if (mh > 0.0f) {
            const float sgn =
                ndh > 0.0f ? 1.0f : (ndh < 0.0f ? -1.0f : 0.0f);
            g_ndh -= sgn * (g_sinnh / (2.0f * sinnh));
          }
        }
      } else {
        if (ndl >= 0.0f) g_ndl += g_dw;
        if (bh > 0.0f) {
          g_ndh += g_sw * (ns * powf(bh, ns - 1.0f));
          g_ns += g_sw * (sw * logf(bh));
        }
      }
      // ndl = dot(n, ldir), ndh = dot(n, hh), hh = normalize(vvec + ldir)
      g_n = add(g_n, add(mul(lg.ldir, g_ndl), mul(hh, g_ndh)));
      const V3 g_hsum = normalize_bwd(hsum, mul(nrm, g_ndh));
      g_vvec = add(g_vvec, g_hsum);
      const V3 g_ldir = add(mul(nrm, g_ndl), g_hsum);
      // ldir = normalize(lvec), rdist = safe_sqrt(|lvec|^2)
      V3 g_lvec = normalize_bwd(lg.lvec, g_ldir);
      if (lg.dd > 0.0f) g_lvec = add(g_lvec, mul(lg.lvec, g_rdist / lg.rdist));
      // lvec = diff @ light_axes + light_o, diff = light_pos - p
      gl_a0 = mul(g_lvec, lg.diff.x);
      gl_a1 = mul(g_lvec, lg.diff.y);
      gl_a2 = mul(g_lvec, lg.diff.z);
      gl_o = g_lvec;
      gl_pos = make(dot(lg.a0, g_lvec), dot(lg.a1, g_lvec), dot(lg.a2, g_lvec));
      g_p = sub(g_p, gl_pos);
    }
    if (per_ray)
      store3_warp(G.light_pos_ray + 3LL * l * n, base, n, gl_pos, buf);
    // this light's sums: per warp, then per block in warp order
    double* wp = wpart[l & 1][warp];
    if (__any_sync(kFull, lit)) {
      const float v[kLightVals] = {
          per_ray ? 0.0f : gl_pos.x, per_ray ? 0.0f : gl_pos.y,
          per_ray ? 0.0f : gl_pos.z, gl_a0.x, gl_a0.y, gl_a0.z, gl_a1.x,
          gl_a1.y, gl_a1.z, gl_a2.x, gl_a2.y, gl_a2.z, gl_o.x, gl_o.y,
          gl_o.z, gl_ke.x, gl_ke.y, gl_ke.z};
      const double t = warp_columns(v, colbuf[warp]);
      if (lane < kLightVals) wp[lane] = t;
    } else if (lane < kLightVals) {
      wp[lane] = 0.0;
    }
    __syncwarp();
    live_barrier(live_threads);
    if (warp == lead_warp && lane < kLightVals) {
      double t = 0.0;
      for (int w = 0; w < kBwdWarps; ++w)
        if ((block_live >> w) & 1u) t += wpart[l & 1][w][lane];
      part[static_cast<long long>(blockIdx.x) * s.num_lights * kLightVals +
           l * kLightVals + lane] = t;
    }
  }

  // --- material reverse
  // ns = 2 / rs^4 - 2 where rs != 0
  float g_rs = 0.0f;
  if (rs != 0.0f) {
    const float x4 = powf(rs, s.rs_exp);
    const float g_x4 = -g_ns * ((2.0f / x4) / x4);
    g_rs = g_x4 * (s.rs_exp * powf(rs, s.rs_exp - 1.0f));
  }
  // kd_eff = kd * texel value (or kd); texels carry d_uv only. The row
  // and texels are read again here rather than held through the lights.
  float g_u = 0.0f, g_v = 0.0f;
  V3 g_kd = g_kde, g_ks = g_kse;
  if (s.has_kd_tex || s.has_ks_tex) {  // uniform
    ShadeScene t = s;
    t.tex_quad = opaque(s.tex_quad);
    MatEval m;
    load_material_record(opaque(s.mat_rec) + 3 * mat, m);
    material_eval(t, hu, hv, m);
    if (m.kd_tex) {
      g_kd = vmul(g_kde, m.tkd.val);
      texture_bwd(m.tkd, vmul(g_kde, m.kd), &g_u, &g_v);
    }
    if (m.ks_tex) {
      g_ks = vmul(g_kse, m.tks.val);
      texture_bwd(m.tks, vmul(g_kse, m.ks), &g_u, &g_v);
    }
  }
  {
    const V3 gkr = live ? load3(gkr_p, i) : zero3();
    const float v[kMatVals] = {g_kd.x, g_kd.y, g_kd.z, g_ks.x, g_ks.y,
                               g_ks.z, gkr.x,  gkr.y,  gkr.z,  g_rs};
    warp_rows(G, true, live_bits, live, mat, v, colbuf[warp],
              mat_slot[warp], &mat_row[warp]);
  }

  // --- eval_hit reverse, on the hit recomputed from its records
  const V3 ro = live ? load3(opaque(ro_p), i) : zero3();
  const V3 rd = live ? load3(opaque(rd_p), i) : make(0.0f, 0.0f, 1.0f);
  HitGeom g;
  eval_hit_record(opaque(s.inst_rec), opaque(s.prim_rec), ro, rd, inst, prim,
                  g);
  // vvec = normalize(ro - p)
  const V3 g_vq = normalize_bwd(sub(ro, g.p), g_vvec);
  V3 g_ro = g_vq;
  g_p = sub(g_p, g_vq);
  // n = normalize(nl @ axes), p = pl @ axes + io
  const V3 g_nv = normalize_bwd(g.nv, g_n);
  V3 g_a0 = add(mul(g_nv, g.nl.x), mul(g_p, g.pl.x));
  V3 g_a1 = add(mul(g_nv, g.nl.y), mul(g_p, g.pl.y));
  V3 g_a2 = add(mul(g_nv, g.nl.z), mul(g_p, g.pl.z));
  V3 g_io = g_p;
  const V3 g_nl = make(dot(g.a0, g_nv), dot(g.a1, g_nv), dot(g.a2, g_nv));
  const V3 g_pl = make(dot(g.a0, g_p), dot(g.a1, g_p), dot(g.a2, g_p));
  // lerps of vertex attributes by ew
  V3 g_v0 = mul(g_pl, g.ew0), g_v1 = mul(g_pl, g.ew1), g_v2 = mul(g_pl, g.ew2);
  V3 g_n0 = mul(g_nl, g.ew0), g_n1 = mul(g_nl, g.ew1),
      g_n2 = mul(g_nl, g.ew2);
  const float g_ew0 = dot(g_pl, g.v0) + dot(g_nl, g.n0) + (g_u * g.t0u + g_v * g.t0v);
  const float g_ew1 = dot(g_pl, g.v1) + dot(g_nl, g.n1) + (g_u * g.t1u + g_v * g.t1v);
  const float g_ew2 = dot(g_pl, g.v2) + dot(g_nl, g.n2) + (g_u * g.t2u + g_v * g.t2v);
  V3 g_lo = zero3(), g_ld = zero3();
  if (g.ptype == kShadeTriangle) {
    // ew = (1 - w1 - w2, w1, w2)
    const float g_w1 = g_ew1 - g_ew0, g_w2 = g_ew2 - g_ew0;
    const V3 e1 = sub(g.v1, g.v0), e2 = sub(g.v2, g.v0);
    const V3 r = cross(g.ld, e2);
    const float den = dot(r, e1);
    const float inv_den = 1.0f / (den == 0.0f ? 1.0f : den);
    const V3 cvec = sub(g.lo, g.v0);
    const V3 svec = cross(cvec, e1);
    const float g_inv = g_w1 * dot(r, cvec) + g_w2 * dot(svec, g.ld);
    V3 g_r = mul(cvec, g_w1 * inv_den);
    V3 g_cvec = mul(r, g_w1 * inv_den);
    const V3 g_svec = mul(g.ld, g_w2 * inv_den);
    g_ld = mul(svec, g_w2 * inv_den);
    V3 g_e1 = zero3();
    if (den != 0.0f) {
      const float g_den = -g_inv * inv_den * inv_den;
      g_r = add(g_r, mul(e1, g_den));
      g_e1 = mul(r, g_den);
    }
    // svec = cross(cvec, e1), r = cross(ld, e2)
    g_cvec = add(g_cvec, cross(e1, g_svec));
    g_e1 = add(g_e1, cross(g_svec, cvec));
    g_ld = add(g_ld, cross(e2, g_r));
    const V3 g_e2 = cross(g_r, g.ld);
    g_lo = g_cvec;
    g_v0 = sub(sub(sub(g_v0, g_cvec), g_e1), g_e2);
    g_v1 = add(g_v1, g_e1);
    g_v2 = add(g_v2, g_e2);
  } else if (g.ptype == kShadeLine) {
    // ew = (1 - s, s, 0), s = clamp(num / det, 0, 1)
    const float g_s = g_ew1 - g_ew0;
    const V3 vv = sub(g.v1, g.v0), ww = sub(g.lo, g.v0);
    const float a = dot(g.ld, g.ld), b = dot(g.ld, vv), c = dot(vv, vv),
                d = dot(g.ld, ww), e = dot(vv, ww);
    const float det = a * c - b * b;
    const float sdet = det == 0.0f ? 1.0f : det;
    const float q = (a * e - b * d) / sdet;
    const float g_q = (q >= 0.0f && q <= 1.0f) ? g_s : 0.0f;
    const float g_num = g_q / sdet;
    const float g_det = det != 0.0f ? -g_q * (q / sdet) : 0.0f;
    const float g_a = g_num * e + g_det * c;
    const float g_b = -g_num * d - 2.0f * g_det * b;
    const float g_c = g_det * a;
    const float g_d = -g_num * b;
    const float g_e = g_num * a;
    g_ld = add(add(mul(g.ld, 2.0f * g_a), mul(vv, g_b)), mul(ww, g_d));
    const V3 g_vv = add(add(mul(g.ld, g_b), mul(vv, 2.0f * g_c)), mul(ww, g_e));
    const V3 g_ww = add(mul(g.ld, g_d), mul(vv, g_e));
    g_lo = g_ww;
    g_v0 = sub(sub(g_v0, g_vv), g_ww);
    g_v1 = add(g_v1, g_vv);
  }
  // ld = normalize(rd @ axes.T), lo = (ro - io) @ axes.T
  const V3 g_dm = normalize_bwd(g.dm, g_ld);
  // rd read again rather than held through the reverse
  const V3 rd_l = live ? load3(opaque(rd_p), i) : make(0.0f, 0.0f, 1.0f);
  const V3 q = sub(ro, g.io);
  g_a0 = add(g_a0, add(mul(rd_l, g_dm.x), mul(q, g_lo.x)));
  g_a1 = add(g_a1, add(mul(rd_l, g_dm.y), mul(q, g_lo.y)));
  g_a2 = add(g_a2, add(mul(rd_l, g_dm.z), mul(q, g_lo.z)));
  const V3 g_rd =
      add(add(mul(g.a0, g_dm.x), mul(g.a1, g_dm.y)), mul(g.a2, g_dm.z));
  const V3 g_q =
      add(add(mul(g.a0, g_lo.x), mul(g.a1, g_lo.y)), mul(g.a2, g_lo.z));
  g_ro = add(g_ro, g_q);
  g_io = sub(g_io, g_q);

  if (!live) {  // a dead lane of a live warp adds exact zeros from here on
    g_ro = g_io = g_a0 = g_a1 = g_a2 = zero3();
    g_v0 = g_v1 = g_v2 = zero3();
    g_n0 = g_n1 = g_n2 = zero3();
    g_u = g_v = 0.0f;
  }
  store3_warp(d_ro, base, n, g_ro, buf);
  store3_warp(d_rd, base, n, live ? g_rd : zero3(), buf);

  {
    const float v[kInstVals] = {g_a0.x, g_a0.y, g_a0.z, g_a1.x,
                                g_a1.y, g_a1.z, g_a2.x, g_a2.y,
                                g_a2.z, g_io.x, g_io.y, g_io.z};
    warp_rows(G, false, live_bits, live, inst, v, colbuf[warp],
              inst_slot[warp], &inst_row[warp]);
  }
  const int vids[3] = {g.vi0, g.vi1, g.vi2};
  const float ews[3] = {g.ew0, g.ew1, g.ew2};
  const V3 gps[3] = {g_v0, g_v1, g_v2};
  const V3 gns[3] = {g_n0, g_n1, g_n2};
  unsigned peers[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) peers[j] = row_peers(live, vids[j]);
  const int first = __ffs(live_bits) - 1;
  if ((__shfl_sync(kFull, peers[0] & peers[1] & peers[2], first)) ==
      live_bits) {
    // every live lane on the same prim (warp-uniform): the 18 pos and norm
    // values by columns, lane k adding value k % 6 of vertex k / 6, then
    // the 6 texcoord values alike where a lane has one
    const int u0 = __shfl_sync(kFull, vids[0], first);
    const int u1 = __shfl_sync(kFull, vids[1], first);
    const int u2 = __shfl_sync(kFull, vids[2], first);
    {
      const float v[18] = {gps[0].x, gps[0].y, gps[0].z, gns[0].x, gns[0].y,
                           gns[0].z, gps[1].x, gps[1].y, gps[1].z, gns[1].x,
                           gns[1].y, gns[1].z, gps[2].x, gps[2].y, gps[2].z,
                           gns[2].x, gns[2].y, gns[2].z};
      const double t = warp_columns(v, colbuf[warp]);
      if (lane < 18 && t != 0.0) {
        const int j = lane / 6, k = lane % 6;
        const long long u = j == 0 ? u0 : (j == 1 ? u1 : u2);
        atomicAdd(k < 3 ? G.pos + 3 * u + k : G.norm + 3 * u + (k - 3), t);
      }
    }
    if (__any_sync(kFull, g_u != 0.0f || g_v != 0.0f)) {
      const float v[6] = {g_u * ews[0], g_v * ews[0], g_u * ews[1],
                          g_v * ews[1], g_u * ews[2], g_v * ews[2]};
      const double t = warp_columns(v, colbuf[warp]);
      if (lane < 6 && t != 0.0) {
        const int j = lane / 2;
        const long long u = j == 0 ? u0 : (j == 1 ? u1 : u2);
        atomicAdd(G.texcoord + 2 * u + (lane & 1), t);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const Run r = run_of(peers[j]);
      const long long v = vids[j];
      run_add3(G.pos + 3 * v, r, gps[j]);
      run_add3(G.norm + 3 * v, r, gns[j]);
      run_add(G.texcoord + 2 * v, r, g_u * ews[j]);
      run_add(G.texcoord + 2 * v + 1, r, g_v * ews[j]);
    }
  }

  // the block's material and instance rows, one atomic per row and value
  __syncwarp();
  live_barrier(live_threads);
  if (warp == lead_warp) {
    block_add_rows(G, true, mat_slot, mat_row, block_live);
    block_add_rows(G, false, inst_slot, inst_row, block_live);
  }
}

// Light gradients: column c of the (blocks, L * 18) partials, summed in a
// fixed order (thread-strided, then warp trees, then warps in order) and
// added to its leaf (c = 18 l + k: light_pos, light_axes rows, light_o,
// light_ke, as kLightVals orders them).
__global__ void __launch_bounds__(kSumThreads)
    light_sum_kernel(const double* __restrict__ part, int nblocks, int cols,
                     ShadeGrads G) {
  __shared__ double ws[kSumThreads / 32];
  const int c = blockIdx.x;
  double t = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += kSumThreads)
    t += part[static_cast<long long>(b) * cols + c];
  t = warp_sum(t);
  if ((threadIdx.x & 31) == 0) ws[threadIdx.x >> 5] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w = 0; w < kSumThreads / 32; ++w) sum += ws[w];
    const int l = c / kLightVals, k = c % kLightVals;
    double* dst = k < 3    ? G.light_pos + 3 * l + k
                  : k < 12 ? G.light_axes + 9 * l + (k - 3)
                  : k < 15 ? G.light_o + 3 * l + (k - 12)
                           : G.light_ke + 3 * l + (k - 15);
    *dst += sum;
  }
}

}  // namespace yrt

// Doubles of scratch that a launch over n rays needs: a row of L * 18
// light partials a block.
extern "C" long long yrt_shade_bwd_scratch(int n, int num_lights) {
  return static_cast<long long>(yrt::blocks_for(n, yrt::kBwdThreads)) *
         num_lights * yrt::kLightVals;
}

extern "C" int yrt_shade_bwd(const yrt::ShadeScene* s,
                             const yrt::ShadeGrads* grads, const float* ro,
                             const float* rd, const int* inst,
                             const int* prim, const uint8_t* mask,
                             const uint8_t* occ, int n, const float* g_color,
                             const float* g_kr, const float* g_p,
                             const float* g_refl, float* d_ro, float* d_rd,
                             double* part, void* stream) {
  // per-ray light positions need their dense gradient buffer
  if ((s->light_pos_ray != nullptr) != (grads->light_pos_ray != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s->prim_rec == nullptr || s->inst_rec == nullptr ||
      s->mat_rec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned blocks = yrt::blocks_for(n, yrt::kBwdThreads);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    yrt::shade_bwd_kernel<<<blocks, yrt::kBwdThreads, 0, st>>>(
        *s, *grads, ro, rd, inst, prim, mask, occ, n, g_color, g_kr, g_p,
        g_refl, d_ro, d_rd, part);
    const cudaError_t err = cudaGetLastError();
    const int cols = s->num_lights * yrt::kLightVals;
    if (err != cudaSuccess || cols == 0) return static_cast<int>(err);
    yrt::light_sum_kernel<<<cols, yrt::kSumThreads, 0, st>>>(
        part, static_cast<int>(blocks), cols, *grads);
  }
  return static_cast<int>(cudaGetLastError());
}
