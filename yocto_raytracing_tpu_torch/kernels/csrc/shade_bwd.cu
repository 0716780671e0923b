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
// frame and emission sums are warp-summed as on the point-light path, whose
// code and results are unchanged.
//
// Derivative conventions are torch autograd's of the plain version:
// safe_sqrt, safe_normalize and safe_pow have zero gradient where their
// guard is false (JAX ops/intersect.py:40-70); clamp passes the gradient at
// its bounds, abs has zero slope at 0. Masked lanes contribute exactly 0:
// their p and refl_dir are garbage the depth loop discards, and their
// cotangents are ignored.
//
// The scatter-adds accumulate in f64 (the caller rounds each leaf to f32
// once): a scene gradient is a sum of up to millions of signed per-ray
// terms, which f32 accumulation would round at every step. The order of the
// atomics still changes from run to run, so the f32 result can differ in its
// last bit between runs; d_ro and d_rd are deterministic. A warp whose live
// lanes share an index (one light, or one material or instance across
// neighbouring pixels) first sums in registers (shuffle tree) and issues one
// atomic; otherwise each lane adds its own. On an NVIDIA H100 80GB HBM3
// (700 W) at 2^20 rays, per-lane atomics alone made the backward ~10x slower
// on the hair scene (10.3 ms against 1.0 ms), where every ray adds to the
// same lights and materials; f32 accumulation was 5-40% faster, but ~80x
// further from an f64 reference on mat_kd and not reproducible run to run.
//
// What bounds it on an H100: the recompute (the forward's gathers and
// flops), ~3x the forward's arithmetic for the adjoint, and the atomics:
// per live ray up to 10 material, 12 instance and 24 vertex values, and
// 18 values per light per warp. Register pressure is high; one thread per
// ray keeps the code a transcription of the math.
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

// Warp-level scatter: one atomic per warp when every live lane adds to the
// same row, else one per lane with a non-zero value.
struct Scatter {
  bool uniform;
  int row0;
};

__device__ __forceinline__ Scatter scatter_plan(unsigned live_bits, bool live,
                                                int row) {
  const int leader = __ffs(live_bits) - 1;
  const int row0 = __shfl_sync(kFull, row, leader);
  return Scatter{__all_sync(kFull, !live || row == row0) != 0, row0};
}

__device__ __forceinline__ void scatter_add(double* dst, const Scatter& sc,
                                            int row, int stride, int k,
                                            float v) {
  if (sc.uniform) {
    const double s = warp_sum(static_cast<double>(v));
    if ((threadIdx.x & 31) == 0 && s != 0.0)
      atomicAdd(dst + static_cast<long long>(sc.row0) * stride + k, s);
  } else if (v != 0.0f) {
    atomicAdd(dst + static_cast<long long>(row) * stride + k,
              static_cast<double>(v));
  }
}

__device__ __forceinline__ void scatter3(double* dst, const Scatter& sc,
                                         int row, int stride, int k, V3 v) {
  scatter_add(dst, sc, row, stride, k, v.x);
  scatter_add(dst, sc, row, stride, k + 1, v.y);
  scatter_add(dst, sc, row, stride, k + 2, v.z);
}

// Sum over the warp, one atomic from lane 0 (every lane adds to `off`).
__device__ __forceinline__ void warp_add3(double* dst, long long off, V3 v) {
  const double x = warp_sum(static_cast<double>(v.x));
  const double y = warp_sum(static_cast<double>(v.y));
  const double z = warp_sum(static_cast<double>(v.z));
  if ((threadIdx.x & 31) == 0) {
    if (x != 0.0) atomicAdd(dst + off, x);
    if (y != 0.0) atomicAdd(dst + off + 1, y);
    if (z != 0.0) atomicAdd(dst + off + 2, z);
  }
}

__global__ void __launch_bounds__(128)
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
                     float* __restrict__ d_ro, float* __restrict__ d_rd) {
  // no early return: every lane of a warp reaches the warp reductions
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  const bool live = valid && mask_p[i] != 0;
  const unsigned live_bits = __ballot_sync(kFull, live);

  // dead lanes recompute a harmless dummy hit and add nothing
  const V3 ro = live ? load3(ro_p, i) : zero3();
  const V3 rd = live ? load3(rd_p, i) : make(0.0f, 0.0f, 1.0f);
  const int inst = live ? inst_p[i] : 0;
  const int prim = live ? prim_p[i] : 0;
  const V3 gcol = live ? load3(gcol_p, i) : zero3();
  const V3 gkr = live ? load3(gkr_p, i) : zero3();
  V3 g_p = live ? load3(gp_p, i) : zero3();
  const V3 grefl = live ? load3(grefl_p, i) : zero3();

  HitGeom g;
  eval_hit(s, ro, rd, inst, prim, g);
  MatEval m;
  eval_material(s, g, m);
  const V3 vq = sub(ro, g.p);
  const V3 vvec = safe_normalize(vq);

  // refl_dir = n * (2 dot(n, vvec)) - vvec
  const float k2 = 2.0f * dot(g.n, vvec);
  V3 g_n = mul(grefl, k2);
  V3 g_vvec = neg(grefl);
  const float g_dot = 2.0f * dot(grefl, g.n);
  g_n = add(g_n, mul(vvec, g_dot));
  g_vvec = add(g_vvec, mul(g.n, g_dot));

  // color += amb * kd_eff
  V3 g_kde = vmul(gcol, load3(s.amb, 0));
  V3 g_kse = zero3();
  float g_ns = 0.0f;

  const bool per_ray = s.light_pos_ray != nullptr;  // uniform
  for (int l = 0; l < s.num_lights; ++l) {
    const bool lit = live && occ[static_cast<long long>(l) * n + i] == 0;
    V3 gl_pos = zero3(), gl_o = zero3(), gl_ke = zero3();
    V3 gl_a0 = zero3(), gl_a1 = zero3(), gl_a2 = zero3();
    if (lit) {
      LightGeom lg;
      light_geom(s, l, light_position(s, l, i, n), g.p, lg);
      const V3 ke = load3(s.light_ke, l);
      const float r2 = lg.rdist * lg.rdist;
      const float den2 = r2 < kMinR2 ? kMinR2 : r2;
      const V3 ke_r2 = make(ke.x / den2, ke.y / den2, ke.z / den2);
      const V3 hsum = add(vvec, lg.ldir);
      const V3 hh = safe_normalize(hsum);
      const float ndl = dot(g.n, lg.ldir);
      const float ndh = dot(g.n, hh);
      float dw, sw, ml = 0.0f, mh = 0.0f, sinnh = 0.0f, bh = 0.0f;
      if (g.is_lines) {
        ml = max0(1.0f - fabsf(ndl));
        dw = safe_sqrt(ml);
        mh = max0(1.0f - fabsf(ndh));
        sinnh = safe_sqrt(mh);
        sw = safe_pow(sinnh, m.ns);
      } else {
        dw = max0(ndl);
        bh = max0(ndh);
        sw = safe_pow(bh, m.ns);
      }
      // contrib = (kd_eff * ke_r2) * dw + (ks_eff * ke_r2) * sw
      g_kde = add(g_kde, mul(vmul(gcol, ke_r2), dw));
      g_kse = add(g_kse, mul(vmul(gcol, ke_r2), sw));
      const V3 g_ker2 = vmul(gcol, add(mul(m.kd_eff, dw), mul(m.ks_eff, sw)));
      const float g_dw = dot(vmul(gcol, m.kd_eff), ke_r2);
      const float g_sw = dot(vmul(gcol, m.ks_eff), ke_r2);
      gl_ke = make(g_ker2.x / den2, g_ker2.y / den2, g_ker2.z / den2);
      const float g_den2 = -dot(g_ker2, ke_r2) / den2;
      const float g_rdist = r2 >= kMinR2 ? g_den2 * 2.0f * lg.rdist : 0.0f;

      float g_ndl = 0.0f, g_ndh = 0.0f;
      if (g.is_lines) {
        if (ml > 0.0f) {
          const float sgn = ndl > 0.0f ? 1.0f : (ndl < 0.0f ? -1.0f : 0.0f);
          g_ndl -= sgn * (g_dw / (2.0f * dw));
        }
        if (sinnh > 0.0f) {
          const float g_sinnh = g_sw * (m.ns * powf(sinnh, m.ns - 1.0f));
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
          g_ndh += g_sw * (m.ns * powf(bh, m.ns - 1.0f));
          g_ns += g_sw * (sw * logf(bh));
        }
      }
      // ndl = dot(n, ldir), ndh = dot(n, hh), hh = normalize(vvec + ldir)
      g_n = add(g_n, add(mul(lg.ldir, g_ndl), mul(hh, g_ndh)));
      const V3 g_hsum = normalize_bwd(hsum, mul(g.n, g_ndh));
      g_vvec = add(g_vvec, g_hsum);
      const V3 g_ldir = add(mul(g.n, g_ndl), g_hsum);
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
    if (per_ray) {
      if (valid) {
        float* dst = G.light_pos_ray + 3 * (static_cast<long long>(l) * n + i);
        dst[0] = gl_pos.x;
        dst[1] = gl_pos.y;
        dst[2] = gl_pos.z;
      }
    } else if (live_bits) {
      warp_add3(G.light_pos, 3LL * l, gl_pos);
    }
    if (live_bits) {
      warp_add3(G.light_axes, 9LL * l, gl_a0);
      warp_add3(G.light_axes, 9LL * l + 3, gl_a1);
      warp_add3(G.light_axes, 9LL * l + 6, gl_a2);
      warp_add3(G.light_o, 3LL * l, gl_o);
      warp_add3(G.light_ke, 3LL * l, gl_ke);
    }
  }

  // ns = 2 / rs^4 - 2 where rs != 0
  float g_rs = 0.0f;
  if (m.rs != 0.0f) {
    const float x4 = powf(m.rs, s.rs_exp);
    const float g_x4 = -g_ns * ((2.0f / x4) / x4);
    g_rs = g_x4 * (s.rs_exp * powf(m.rs, s.rs_exp - 1.0f));
  }
  // kd_eff = kd * texel value (or kd); texels carry d_uv only
  float g_u = 0.0f, g_v = 0.0f;
  V3 g_kd = g_kde, g_ks = g_kse;
  if (m.kd_tex) {
    g_kd = vmul(g_kde, m.tkd.val);
    texture_bwd(m.tkd, vmul(g_kde, m.kd), &g_u, &g_v);
  }
  if (m.ks_tex) {
    g_ks = vmul(g_kse, m.tks.val);
    texture_bwd(m.tks, vmul(g_kse, m.ks), &g_u, &g_v);
  }

  // vvec = normalize(ro - p)
  const V3 g_vq = normalize_bwd(vq, g_vvec);
  V3 g_ro = g_vq;
  g_p = sub(g_p, g_vq);

  // --- eval_hit reverse ---
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
  const V3 g_n0 = mul(g_nl, g.ew0), g_n1 = mul(g_nl, g.ew1),
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
  const V3 q = sub(ro, g.io);
  g_a0 = add(g_a0, add(mul(rd, g_dm.x), mul(q, g_lo.x)));
  g_a1 = add(g_a1, add(mul(rd, g_dm.y), mul(q, g_lo.y)));
  g_a2 = add(g_a2, add(mul(rd, g_dm.z), mul(q, g_lo.z)));
  const V3 g_rd =
      add(add(mul(g.a0, g_dm.x), mul(g.a1, g_dm.y)), mul(g.a2, g_dm.z));
  const V3 g_q =
      add(add(mul(g.a0, g_lo.x), mul(g.a1, g_lo.y)), mul(g.a2, g_lo.z));
  g_ro = add(g_ro, g_q);
  g_io = sub(g_io, g_q);

  if (valid) {
    const V3 oro = live ? g_ro : zero3();
    const V3 ord = live ? g_rd : zero3();
    d_ro[3 * i] = oro.x;
    d_ro[3 * i + 1] = oro.y;
    d_ro[3 * i + 2] = oro.z;
    d_rd[3 * i] = ord.x;
    d_rd[3 * i + 1] = ord.y;
    d_rd[3 * i + 2] = ord.z;
  }
  if (live_bits == 0) return;  // warp-uniform

  // dead lanes hold exact zeros from here on
  if (!live) {
    g_kd = g_ks = zero3();
    g_rs = 0.0f;
    g_a0 = g_a1 = g_a2 = g_io = zero3();
    g_v0 = g_v1 = g_v2 = zero3();
  }
  const V3 g_krm = gkr;
  {
    const Scatter sc = scatter_plan(live_bits, live, g.mat);
    scatter3(G.mat_kd, sc, g.mat, 3, 0, g_kd);
    scatter3(G.mat_ks, sc, g.mat, 3, 0, g_ks);
    scatter3(G.mat_kr, sc, g.mat, 3, 0, g_krm);
    scatter_add(G.mat_rs, sc, g.mat, 1, 0, g_rs);
  }
  {
    const Scatter sc = scatter_plan(live_bits, live, inst);
    scatter3(G.inst_axes, sc, inst, 9, 0, g_a0);
    scatter3(G.inst_axes, sc, inst, 9, 3, g_a1);
    scatter3(G.inst_axes, sc, inst, 9, 6, g_a2);
    scatter3(G.inst_o, sc, inst, 3, 0, g_io);
  }
  const int vids[3] = {g.vi0, g.vi1, g.vi2};
  const float ews[3] = {g.ew0, g.ew1, g.ew2};
  const V3 gps[3] = {g_v0, g_v1, g_v2};
  const V3 gns[3] = {g_n0, g_n1, g_n2};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const bool on = live;
    const V3 gn = on ? gns[j] : zero3();
    const float gtu = on ? g_u * ews[j] : 0.0f;
    const float gtv = on ? g_v * ews[j] : 0.0f;
    const Scatter sc = scatter_plan(live_bits, live, vids[j]);
    scatter3(G.pos, sc, vids[j], 3, 0, gps[j]);
    scatter3(G.norm, sc, vids[j], 3, 0, gn);
    scatter_add(G.texcoord, sc, vids[j], 2, 0, gtu);
    scatter_add(G.texcoord, sc, vids[j], 2, 1, gtv);
  }
}

}  // namespace yrt

extern "C" int yrt_shade_bwd(const yrt::ShadeScene* s,
                             const yrt::ShadeGrads* grads, const float* ro,
                             const float* rd, const int* inst,
                             const int* prim, const uint8_t* mask,
                             const uint8_t* occ, int n, const float* g_color,
                             const float* g_kr, const float* g_p,
                             const float* g_refl, float* d_ro, float* d_rd,
                             void* stream) {
  // per-ray light positions need their dense gradient buffer
  if ((s->light_pos_ray != nullptr) != (grads->light_pos_ray != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    constexpr int kThreads = 128;  // a multiple of the warp size
    yrt::shade_bwd_kernel<<<yrt::blocks_for(n, kThreads), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        *s, *grads, ro, rd, inst, prim, mask, occ, n, g_color, g_kr, g_p,
        g_refl, d_ro, d_rd);
  }
  return static_cast<int>(cudaGetLastError());
}
