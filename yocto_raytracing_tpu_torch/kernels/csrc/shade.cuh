// Shared forward math of one shading bounce, for K4 (shade.cu) and K5
// (shade_bwd.cu).
//
// Every function repeats render/shade.py and render/texture.py of this
// package op for op: the packed instance and prim rows, Möller-Trumbore
// barycentrics or the line parameter, explicit frame multiply-adds, the
// bilinear sRGB texel quad, the quirk-exact point-light vector and the
// Blinn-Phong/hair weights. K4 is held bit-equal to the plain version and K5
// recomputes the bounce with these same functions before it runs the
// adjoint, so forward and backward see the same bits. Exponents and the
// texel scale arrive at run time (ShadeScene), as they do in torch's kernels,
// so no powf or division is specialised for a literal.
//
// Two readers feed the same math. K4 (shade.cu) and K5 (shade_bwd.cu) read
// the packed shade records of ops/shade_records.py (ShadeScene::prim_rec,
// inst_rec, mat_rec) with 16-byte loads: load_hit_record and
// load_material_record. K4's and K5's first forms (shade_simple.cu,
// shade_bwd_simple.cu, kept for comparison) read the scene's own arrays with
// scalar loads: eval_hit and eval_material. The records are bit copies of
// the arrays, so both readers give hit_geometry and material_eval the same
// bits.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace yrt {

// Scene arrays and constants of a shading launch. Mirrors
// kernels/_build.py::ShadeScene field for field (ctypes layout).
struct ShadeScene {
  const float* pos;         // (V, 3)
  const float* norm;        // (V, 3)
  const float* texcoord;    // (V, 2)
  const int* prim_v;        // (P, 3)
  const int* prim_type;     // (P,)
  const float* inst_axes;   // (I, 3, 3)
  const float* inst_o;      // (I, 3)
  const int* inst_mat;      // (I,)
  const int* inst_is_lines; // (I,)
  const float* mat_kd;      // (Mt, 3)
  const float* mat_ks;      // (Mt, 3)
  const float* mat_kr;      // (Mt, 3)
  const float* mat_rs;      // (Mt,)
  const int* mat_kd_txt;    // (Mt,)
  const int* mat_ks_txt;    // (Mt,)
  const int* tex_quad;      // (T, th, tw, 4) packed 2x2 texels
  const int* tex_w;         // (T,)
  const int* tex_h;         // (T,)
  const float* light_pos;   // (L, 3)
  const float* light_axes;  // (L, 3, 3)
  const float* light_o;     // (L, 3)
  const float* light_ke;    // (L, 3)
  const float* amb;         // (3,)
  // (L, N, 3) per-ray light positions (row l * N + i), replacing light_pos
  // (area-light samples, render/lights.py); null on the point-light path
  const float* light_pos_ray;
  // ops/shade_records.py: (P, 7), (I, 4) and (Mt, 3) float4 records; null
  // for the first forms, which read the arrays above
  const float4* prim_rec;
  const float4* inst_rec;
  const float4* mat_rec;
  int tex_th, tex_tw, num_lights, has_kd_tex, has_ks_tex;
  float gamma;        // 2.2: texel sRGB decode exponent
  float rs_exp;       // 4.0: ns = 2 / rs^4 - 2
  float texel_scale;  // 255.0
};

constexpr int kShadeLine = 1;
constexpr int kShadeTriangle = 2;
constexpr float kShadowTmin = 0.01f;    // raytrace.cpp:131-133
constexpr float kShadowEps = 0.01f;
constexpr float kMinR2 = 1e-38f;        // clamp of r^2 before 1/r^2
constexpr float kNsNoRoughness = 1e6f;  // raytrace.cpp:144

// torch.clamp(x, min=0): a NaN passes through
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}
__device__ __forceinline__ float safe_pow(float b, float e) {
  return b > 0.0f ? powf(b, e) : 0.0f;
}
// isect.safe_normalize: v * (1 / sqrt(|v|^2)), 0 -> 0
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float n2 = dot(v, v);
  if (n2 > 0.0f) return mul(v, 1.0f / sqrtf(n2));
  return v;
}
// transform_vector: v @ axes as explicit multiply-adds (rows a0, a1, a2)
__device__ __forceinline__ V3 xform(V3 a0, V3 a1, V3 a2, V3 v) {
  return make(v.x * a0.x + v.y * a1.x + v.z * a2.x,
              v.x * a0.y + v.y * a1.y + v.z * a2.y,
              v.x * a0.z + v.y * a1.z + v.z * a2.z);
}
__device__ __forceinline__ V3 zero3() { return make(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return make(a.x * b.x, a.y * b.y, a.z * b.z);
}

// eval_hit: instance frame, local ray, prim row, barycentrics or line s,
// world p / n and uv (render/shade.py::eval_hit).
struct HitGeom {
  V3 a0, a1, a2, io;  // instance frame rows and origin
  V3 lo, dm, ld;      // local origin, local direction before/after normalize
  int vi0, vi1, vi2, ptype;
  V3 v0, v1, v2, n0, n1, n2;
  float t0u, t0v, t1u, t1v, t2u, t2v;
  float ew0, ew1, ew2;
  V3 pl, nl, nv;  // local p, local n, n after the frame (before normalize)
  float u, v;
  V3 p, n;
  int mat;
  bool is_lines;
};

// The same pointer, hidden from the compiler: a load through it after a
// stretch of code is made again instead of being kept in registers across
// it (K5 reloads its records after the light loop, an L1/L2 hit).
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  unsigned long long a = reinterpret_cast<unsigned long long>(p);
  asm volatile("" : "+l"(a));
  return reinterpret_cast<const T*>(a);
}

// The scalar reads of a hit from the scene's arrays (the first forms).
__device__ __forceinline__ void load_hit_arrays(const ShadeScene& s, int inst,
                                                int prim, HitGeom& g) {
  g.a0 = load3(s.inst_axes, 3 * inst);
  g.a1 = load3(s.inst_axes, 3 * inst + 1);
  g.a2 = load3(s.inst_axes, 3 * inst + 2);
  g.io = load3(s.inst_o, inst);
  g.vi0 = __ldg(s.prim_v + 3 * prim);
  g.vi1 = __ldg(s.prim_v + 3 * prim + 1);
  g.vi2 = __ldg(s.prim_v + 3 * prim + 2);
  g.ptype = __ldg(s.prim_type + prim);
  g.v0 = load3(s.pos, g.vi0);
  g.v1 = load3(s.pos, g.vi1);
  g.v2 = load3(s.pos, g.vi2);
  g.n0 = load3(s.norm, g.vi0);
  g.n1 = load3(s.norm, g.vi1);
  g.n2 = load3(s.norm, g.vi2);
  g.t0u = __ldg(s.texcoord + 2 * g.vi0);
  g.t0v = __ldg(s.texcoord + 2 * g.vi0 + 1);
  g.t1u = __ldg(s.texcoord + 2 * g.vi1);
  g.t1v = __ldg(s.texcoord + 2 * g.vi1 + 1);
  g.t2u = __ldg(s.texcoord + 2 * g.vi2);
  g.t2v = __ldg(s.texcoord + 2 * g.vi2 + 1);
  g.mat = __ldg(s.inst_mat + inst);
  g.is_lines = __ldg(s.inst_is_lines + inst) == 1;
}

// The same fields from one 64-byte instance record and one 112-byte prim
// record (ops/shade_records.py), eleven 16-byte loads with no dependent
// chain: [a0 a1.x] [a1.yz a2.xy] [a2.z io] [mat lines - -]; [vi0 vi1 vi2
// type], then per vertex [pos n.x] [n.yz uv].
__device__ __forceinline__ void load_hit_record(const float4* __restrict__ ir,
                                                const float4* __restrict__ pr,
                                                HitGeom& g) {
  const float4 i0 = __ldg(ir), i1 = __ldg(ir + 1), i2 = __ldg(ir + 2),
               i3 = __ldg(ir + 3);
  g.a0 = make(i0.x, i0.y, i0.z);
  g.a1 = make(i0.w, i1.x, i1.y);
  g.a2 = make(i1.z, i1.w, i2.x);
  g.io = make(i2.y, i2.z, i2.w);
  g.mat = __float_as_int(i3.x);
  g.is_lines = __float_as_int(i3.y) == 1;
  const float4 h = __ldg(pr);
  g.vi0 = __float_as_int(h.x);
  g.vi1 = __float_as_int(h.y);
  g.vi2 = __float_as_int(h.z);
  g.ptype = __float_as_int(h.w);
  float4 a = __ldg(pr + 1), b = __ldg(pr + 2);
  g.v0 = make(a.x, a.y, a.z);
  g.n0 = make(a.w, b.x, b.y);
  g.t0u = b.z;
  g.t0v = b.w;
  a = __ldg(pr + 3);
  b = __ldg(pr + 4);
  g.v1 = make(a.x, a.y, a.z);
  g.n1 = make(a.w, b.x, b.y);
  g.t1u = b.z;
  g.t1v = b.w;
  a = __ldg(pr + 5);
  b = __ldg(pr + 6);
  g.v2 = make(a.x, a.y, a.z);
  g.n2 = make(a.w, b.x, b.y);
  g.t2u = b.z;
  g.t2v = b.w;
}

// The arithmetic of eval_hit on the loaded fields of g.
__device__ __forceinline__ void hit_geometry(V3 ro, V3 rd, HitGeom& g) {
  const V3 q = sub(ro, g.io);
  g.lo = make(dot(g.a0, q), dot(g.a1, q), dot(g.a2, q));
  g.dm = make(dot(g.a0, rd), dot(g.a1, rd), dot(g.a2, rd));
  g.ld = safe_normalize(g.dm);
  // triangle barycentrics (Möller-Trumbore solve, scene.cpp:229-263)
  const V3 e1 = sub(g.v1, g.v0);
  const V3 e2 = sub(g.v2, g.v0);
  const V3 r = cross(g.ld, e2);
  const float den = dot(r, e1);
  const float inv_den = 1.0f / (den == 0.0f ? 1.0f : den);
  const V3 cvec = sub(g.lo, g.v0);
  const float w1 = dot(r, cvec) * inv_den;
  const V3 svec = cross(cvec, e1);
  const float w2 = dot(svec, g.ld) * inv_den;

  // line parameter s (scene.cpp:285-307)
  const V3 vv = sub(g.v1, g.v0);
  const V3 ww = sub(g.lo, g.v0);
  const float a = dot(g.ld, g.ld);
  const float b = dot(g.ld, vv);
  const float c = dot(vv, vv);
  const float d = dot(g.ld, ww);
  const float e = dot(vv, ww);
  const float det = a * c - b * b;
  const float sl = clamp01((a * e - b * d) / (det == 0.0f ? 1.0f : det));

  const bool is_tri = g.ptype == kShadeTriangle;
  const bool is_line = g.ptype == kShadeLine;
  g.ew0 = is_tri ? 1.0f - w1 - w2 : (is_line ? 1.0f - sl : 1.0f);
  g.ew1 = is_tri ? w1 : (is_line ? sl : 0.0f);
  g.ew2 = is_tri ? w2 : 0.0f;

  g.pl = add(add(mul(g.v0, g.ew0), mul(g.v1, g.ew1)), mul(g.v2, g.ew2));
  g.nl = add(add(mul(g.n0, g.ew0), mul(g.n1, g.ew1)), mul(g.n2, g.ew2));
  g.u = g.t0u * g.ew0 + g.t1u * g.ew1 + g.t2u * g.ew2;
  g.v = g.t0v * g.ew0 + g.t1v * g.ew1 + g.t2v * g.ew2;

  // instance-space eval (src/scene.h:210-218)
  g.p = add(xform(g.a0, g.a1, g.a2, g.pl), g.io);
  g.nv = xform(g.a0, g.a1, g.a2, g.nl);
  g.n = safe_normalize(g.nv);
}

__device__ __forceinline__ void eval_hit(const ShadeScene& s, V3 ro, V3 rd,
                                         int inst, int prim, HitGeom& g) {
  load_hit_arrays(s, inst, prim, g);
  hit_geometry(ro, rd, g);
}

// eval_hit on the records: ShadeScene::inst_rec and prim_rec (through
// opaque() where a kernel reloads them).
__device__ __forceinline__ void eval_hit_record(const float4* inst_rec,
                                                const float4* prim_rec,
                                                V3 ro, V3 rd, int inst,
                                                int prim, HitGeom& g) {
  load_hit_record(inst_rec + 4 * inst, prim_rec + 7 * prim, g);
  hit_geometry(ro, rd, g);
}

// One bilinear sRGB texture sample (render/texture.py::eval_texture).
struct TexSample {
  V3 t0, t1, t2, t3;  // decoded texels of the 2x2 quad
  float wi, wj;       // bilinear weights
  float w, h;         // texture extent as f32 (d s / d u = w)
  V3 val;
};

__device__ __forceinline__ V3 decode_texel(const ShadeScene& s, int packed) {
  const float r = static_cast<float>(packed & 0xFF);
  const float g = static_cast<float>((packed >> 8) & 0xFF);
  const float b = static_cast<float>((packed >> 16) & 0xFF);
  const float k = s.texel_scale;
  float x = powf(r / k, s.gamma), y = powf(g / k, s.gamma),
        z = powf(b / k, s.gamma);
  // torch.clamp(max=1): a NaN passes through
  return make(x > 1.0f ? 1.0f : x, y > 1.0f ? 1.0f : y, z > 1.0f ? 1.0f : z);
}

__device__ __forceinline__ void sample_texture(const ShadeScene& s, int tid,
                                               float u, float v,
                                               TexSample& ts) {
  ts.w = static_cast<float>(__ldg(s.tex_w + tid));
  ts.h = static_cast<float>(__ldg(s.tex_h + tid));
  const float sx = fmodf(u, 1.0f) * ts.w;
  const float tx = fmodf(v, 1.0f) * ts.h;
  const float fi = floorf(sx);
  const float fj = floorf(tx);
  ts.wi = sx - fi;
  ts.wj = tx - fj;
  const int i = static_cast<int>(fi);
  const int j = static_cast<int>(fj);
  const int w32 = static_cast<int>(ts.w);
  const int h32 = static_cast<int>(ts.h);
  // flat pixels[j*w + i] addressing clamped into the image
  int flat = j * w32 + i;
  flat = flat < 0 ? 0 : flat;
  const int last = w32 * h32 - 1;
  flat = flat < last ? flat : last;
  const int wsafe = w32 < 1 ? 1 : w32;
  // floor division and modulo (torch semantics), index wrap like torch's
  int jj = flat / wsafe;
  int ii = flat - jj * wsafe;
  if (ii < 0) {
    ii += wsafe;
    jj -= 1;
  }
  if (jj < 0) jj += s.tex_th;
  const int* q =
      s.tex_quad +
      ((static_cast<long long>(tid) * s.tex_th + jj) * s.tex_tw + ii) * 4;
  ts.t0 = decode_texel(s, __ldg(q));
  ts.t1 = decode_texel(s, __ldg(q + 1));
  ts.t2 = decode_texel(s, __ldg(q + 2));
  ts.t3 = decode_texel(s, __ldg(q + 3));
  const float ui = 1.0f - ts.wi, uj = 1.0f - ts.wj;
  ts.val = add(add(add(mul(mul(ts.t0, ui), uj), mul(mul(ts.t1, ts.wi), uj)),
                   mul(mul(ts.t2, ui), ts.wj)),
               mul(mul(ts.t3, ts.wi), ts.wj));
}

// Material row, textures and the Blinn-Phong exponent of a hit.
struct MatEval {
  V3 kd, ks, kr, kd_eff, ks_eff;
  float rs, ns;
  int kd_txt, ks_txt;   // texture ids of the row (-1: none)
  bool kd_tex, ks_tex;  // texture slot used
  TexSample tkd, tks;
};

// The material row from the scene's arrays (the first forms).
__device__ __forceinline__ void load_material_arrays(const ShadeScene& s,
                                                     int mat, MatEval& m) {
  m.kd = load3(s.mat_kd, mat);
  m.ks = load3(s.mat_ks, mat);
  m.kr = load3(s.mat_kr, mat);
  m.rs = __ldg(s.mat_rs + mat);
  m.kd_txt = __ldg(s.mat_kd_txt + mat);
  m.ks_txt = __ldg(s.mat_ks_txt + mat);
}

// The same row from one 48-byte material record, three 16-byte loads:
// [kd ks.x] [ks.yz kr.xy] [kr.z rs kd_txt ks_txt].
__device__ __forceinline__ void load_material_record(
    const float4* __restrict__ mr, MatEval& m) {
  const float4 a = __ldg(mr), b = __ldg(mr + 1), c = __ldg(mr + 2);
  m.kd = make(a.x, a.y, a.z);
  m.ks = make(a.w, b.x, b.y);
  m.kr = make(b.z, b.w, c.x);
  m.rs = c.y;
  m.kd_txt = __float_as_int(c.z);
  m.ks_txt = __float_as_int(c.w);
}

// Textures at (u, v) and the exponent of a loaded row.
__device__ __forceinline__ void material_eval(const ShadeScene& s, float u,
                                              float v, MatEval& m) {
  m.kd_tex = s.has_kd_tex && m.kd_txt >= 0;
  m.ks_tex = s.has_ks_tex && m.ks_txt >= 0;
  m.kd_eff = m.kd;
  m.ks_eff = m.ks;
  if (m.kd_tex) {
    sample_texture(s, m.kd_txt, u, v, m.tkd);
    m.kd_eff = vmul(m.kd, m.tkd.val);
  }
  if (m.ks_tex) {
    sample_texture(s, m.ks_txt, u, v, m.tks);
    m.ks_eff = vmul(m.ks, m.tks.val);
  }
  const float two = 2.0f;
  m.ns = m.rs != 0.0f ? two / powf(m.rs, s.rs_exp) - 2.0f : kNsNoRoughness;
}

__device__ __forceinline__ void eval_material(const ShadeScene& s,
                                              const HitGeom& g, MatEval& m) {
  load_material_arrays(s, g.mat, m);
  material_eval(s, g.u, g.v, m);
}

// Shape-space position of light l for ray i of n: the per-ray sample
// light_pos_ray[l, i] where one is given, else the light's light_pos[l].
__device__ __forceinline__ V3 light_position(const ShadeScene& s, int l,
                                             int i, int n) {
  return s.light_pos_ray != nullptr
             ? load3(s.light_pos_ray, static_cast<int>(
                                          static_cast<long long>(l) * n + i))
             : load3(s.light_pos, l);
}

// Light l at shape-space position lpos seen from p: the quirk-exact light
// vector transform_point(light_frame, lpos - p) (raytrace.cpp:129-130).
struct LightGeom {
  V3 a0, a1, a2, diff, lvec, ldir;
  float dd, rdist;
};

__device__ __forceinline__ void light_geom(const ShadeScene& s, int l,
                                           V3 lpos, V3 p, LightGeom& lg) {
  lg.a0 = load3(s.light_axes, 3 * l);
  lg.a1 = load3(s.light_axes, 3 * l + 1);
  lg.a2 = load3(s.light_axes, 3 * l + 2);
  lg.diff = sub(lpos, p);
  lg.lvec = add(xform(lg.a0, lg.a1, lg.a2, lg.diff), load3(s.light_o, l));
  lg.dd = dot(lg.lvec, lg.lvec);
  lg.rdist = safe_sqrt(lg.dd);
  lg.ldir = safe_normalize(lg.lvec);
}

// Unshadowed contribution of light l (raytrace.cpp:121-185): hair
// (sqrt(1 - |n.l|) pseudo-sines) or Blinn-Phong.
__device__ __forceinline__ V3 light_contrib(const ShadeScene& s, int l,
                                            const LightGeom& lg, V3 n,
                                            V3 vvec, const MatEval& m,
                                            bool is_lines) {
  const V3 ke = load3(s.light_ke, l);
  float den2 = lg.rdist * lg.rdist;
  den2 = den2 < kMinR2 ? kMinR2 : den2;
  const V3 ke_r2 = make(ke.x / den2, ke.y / den2, ke.z / den2);
  const V3 hh = safe_normalize(add(vvec, lg.ldir));
  const float ndl = dot(n, lg.ldir);
  const float ndh = dot(n, hh);
  float dw, sw;
  if (is_lines) {
    dw = safe_sqrt(max0(1.0f - fabsf(ndl)));
    sw = safe_pow(safe_sqrt(max0(1.0f - fabsf(ndh))), m.ns);
  } else {
    dw = max0(ndl);
    sw = safe_pow(max0(ndh), m.ns);
  }
  return add(mul(vmul(m.kd_eff, ke_r2), dw), mul(vmul(m.ks_eff, ke_r2), sw));
}

// One V3 per lane into rows [base, base + 32) of an (n, 3) f32 array, the
// rows of the calling warp's 32 rays. Where the 32 rows are whole
// (warp_whole) and the destination 16-byte aligned, the warp stages them
// in its 96-float shared buffer `buf` (16-byte aligned; stage3) and writes
// them with 24 16-byte stores (flush3, which can write one staging to
// several arrays); else each lane stores its own row with 3 scalar
// stores. Every lane of the warp calls these. The bits stored are the same
// either way.
__device__ __forceinline__ bool warp_whole(long long base, int n) {
  return base + 32 <= n;
}

__device__ __forceinline__ void stage3(float* __restrict__ buf, V3 v) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the last flush's reads of buf are done
  buf[3 * lane] = v.x;
  buf[3 * lane + 1] = v.y;
  buf[3 * lane + 2] = v.z;
  __syncwarp();
}

__device__ __forceinline__ void flush3(float* __restrict__ out,
                                       long long base, int n, V3 v,
                                       const float* __restrict__ buf) {
  const int lane = threadIdx.x & 31;
  float* dst = out + 3 * base;
  if (warp_whole(base, n) && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    if (lane < 24)
      reinterpret_cast<float4*>(dst)[lane] =
          reinterpret_cast<const float4*>(buf)[lane];
  } else if (base + lane < n) {
    dst[3 * lane] = v.x;
    dst[3 * lane + 1] = v.y;
    dst[3 * lane + 2] = v.z;
  }
}

__device__ __forceinline__ void store3_warp(float* __restrict__ out,
                                            long long base, int n, V3 v,
                                            float* __restrict__ buf) {
  if (warp_whole(base, n)) stage3(buf, v);
  flush3(out, base, n, v, buf);
}

}  // namespace yrt
