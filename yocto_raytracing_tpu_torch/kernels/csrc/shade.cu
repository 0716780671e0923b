// K4: one shading bounce, forward (fused eval_hit + eval_texture +
// shade_step).
//
// Replaces render/shade.py::eval_hit (51-156) and shade_step (159-284) and
// render/texture.py::eval_texture (31-69) of the JAX package, which XLA
// lowers to a few hundred fused device loops per bounce (in the port's plain
// torch version, ~300 eager launches per bounce).
//
// Two launches around K1's any-hit query, so that K1 stays the one traversal:
//
// * yrt_shade_prep: per ray, the packed instance and prim rows, barycentrics
//   or line s, world p, and per light the shadow ray (p, l, 0.01, r - 0.01),
//   stacked (L, N) in light-major order; masked lanes get tmax = -FLT_MAX,
//   which retires them at K1's root;
// * K1 any-hit on the L*N shadow rays (launched by the caller);
// * yrt_shade_finish: recomputes the hit, then material row, kd/ks texel
//   quads, per-light hair or Blinn-Phong weights accumulated in light order,
//   ambient, kr and the mirror ray.
//
// With area lights (ShadeScene::light_pos_ray, JAX render/shade.py:242-243)
// every ray reads its own (L, 3) light positions, 12 bytes per light in each
// launch, instead of the per-light light_pos; nothing else changes.
//
// Recomputing the hit in the second launch costs a few hundred flops per ray
// and saves writing and re-reading ~20 floats per ray of intermediates.
//
// Reads and writes (the redesign for the H100; shade_simple.cu keeps the
// first form for comparison). A ray's instance, prim and material come from
// the packed shade records of ops/shade_records.py: one 64-byte instance
// record, one 112-byte prim record that holds the three vertices' pos, norm
// and texcoord, and one 48-byte material record, fourteen 16-byte loads in
// all, in place of ~50 scalar loads along the chain inst -> prim_v -> pos /
// norm / texcoord and inst -> inst_mat -> mat_*. The (N, 3) outputs (the
// shadow rays' origins and directions, light by light, and color, kr, p and
// refl_dir) go out through the warp's shared buffer as 16-byte stores
// (store3_warp), with the same layout as before: K1 reads sh_o, sh_d,
// sh_tmin and sh_tmax as it did. The bits are the first form's: the records
// are bit copies of the leaves and the math (shade.cuh) is the same.
//
// Numerics: the same op order as the plain torch version (shade.cuh), built
// with --fmad=false and no fast-math; sqrtf, IEEE divides, powf with run-time
// exponents, as torch's CUDA kernels compute them. Masked lanes shade inst 0
// / prim 0 like the plain version, so p and refl_dir are bit-equal there too.
//
// What bounds it on an H100: per ray a 64-byte instance record, a 112-byte
// prim record, a 48-byte material record and up to 8 texel quads, gathers
// that stay in L2 for this repository's scenes, and ~500-1000 flops per ray
// and light. One thread per ray, 128 threads per block.
#include <cstdint>

#include "shade.cuh"

namespace yrt {

constexpr int kShadeThreads = 128;  // a multiple of the warp size
constexpr int kShadeWarps = kShadeThreads / 32;

__global__ void __launch_bounds__(kShadeThreads)
    shade_prep_kernel(ShadeScene s, const float* __restrict__ ro_p,
                      const float* __restrict__ rd_p,
                      const int* __restrict__ inst_p,
                      const int* __restrict__ prim_p,
                      const uint8_t* __restrict__ mask_p, int n,
                      float* __restrict__ sh_o, float* __restrict__ sh_d,
                      float* __restrict__ sh_tmin,
                      float* __restrict__ sh_tmax) {
  __shared__ __align__(16) float stage_p[kShadeWarps][96];
  __shared__ __align__(16) float stage_d[kShadeWarps][96];
  const int lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * kShadeThreads + (threadIdx.x - lane);
  if (base >= n) return;  // the whole warp is past the end
  const int i = static_cast<int>(base) + lane;
  const bool valid = i < n;
  const int ic = valid ? i : n - 1;  // lanes past the end store nothing
  const bool mask = valid && mask_p[i] != 0;
  HitGeom g;
  eval_hit_record(s.inst_rec, s.prim_rec, load3(ro_p, ic), load3(rd_p, ic),
                  mask ? inst_p[i] : 0, mask ? prim_p[i] : 0, g);
  // p, the same origin for every light, is staged once
  const bool whole = warp_whole(base, n);
  float* bp = stage_p[threadIdx.x >> 5];
  float* bd = stage_d[threadIdx.x >> 5];
  if (whole) stage3(bp, g.p);
  for (int l = 0; l < s.num_lights; ++l) {
    LightGeom lg;
    light_geom(s, l, light_position(s, l, ic, n), g.p, lg);
    const long long row = static_cast<long long>(l) * n;
    flush3(sh_o + 3 * row, base, n, g.p, bp);
    store3_warp(sh_d + 3 * row, base, n, lg.ldir, bd);
    if (valid) {
      sh_tmin[row + i] = kShadowTmin;
      sh_tmax[row + i] = mask ? lg.rdist - kShadowEps : -kFltMax;
    }
  }
}

__global__ void __launch_bounds__(kShadeThreads)
    shade_finish_kernel(ShadeScene s, const float* __restrict__ ro_p,
                        const float* __restrict__ rd_p,
                        const int* __restrict__ inst_p,
                        const int* __restrict__ prim_p,
                        const uint8_t* __restrict__ mask_p,
                        const uint8_t* __restrict__ occ, int n,
                        float* __restrict__ color_o, float* __restrict__ kr_o,
                        float* __restrict__ p_o, float* __restrict__ refl_o) {
  __shared__ __align__(16) float stage[kShadeWarps][96];
  const int lane = threadIdx.x & 31;
  const long long base =
      static_cast<long long>(blockIdx.x) * kShadeThreads + (threadIdx.x - lane);
  if (base >= n) return;  // the whole warp is past the end
  const int i = static_cast<int>(base) + lane;
  const bool valid = i < n;
  const int ic = valid ? i : n - 1;  // lanes past the end store nothing
  const bool mask = valid && mask_p[i] != 0;
  const V3 ro = load3(ro_p, ic);
  HitGeom g;
  eval_hit_record(s.inst_rec, s.prim_rec, ro, load3(rd_p, ic),
                  mask ? inst_p[i] : 0, mask ? prim_p[i] : 0, g);
  const V3 vvec = safe_normalize(sub(ro, g.p));
  V3 color = zero3(), kr = zero3();
  if (mask) {
    MatEval m;
    load_material_record(s.mat_rec + 3 * g.mat, m);
    material_eval(s, g.u, g.v, m);
    V3 acc = zero3();
    for (int l = 0; l < s.num_lights; ++l) {
      LightGeom lg;
      light_geom(s, l, light_position(s, l, i, n), g.p, lg);
      const bool lit = occ[static_cast<long long>(l) * n + i] == 0;
      // unlit lanes add +0, as torch.where(lit, contrib, 0) does
      acc = add(acc, lit ? light_contrib(s, l, lg, g.n, vvec, m, g.is_lines)
                         : zero3());
    }
    const V3 amb = load3(s.amb, 0);
    color = add(acc, vmul(amb, m.kd_eff));
    kr = m.kr;
  }
  const float k2 = 2.0f * dot(g.n, vvec);
  const V3 refl = make(g.n.x * k2 - vvec.x, g.n.y * k2 - vvec.y,
                       g.n.z * k2 - vvec.z);
  float* buf = stage[threadIdx.x >> 5];
  store3_warp(color_o, base, n, color, buf);
  store3_warp(kr_o, base, n, kr, buf);
  store3_warp(p_o, base, n, g.p, buf);
  store3_warp(refl_o, base, n, refl, buf);
}

}  // namespace yrt

extern "C" int yrt_shade_prep(const yrt::ShadeScene* s, const float* ro,
                              const float* rd, const int* inst,
                              const int* prim, const uint8_t* mask, int n,
                              float* sh_o, float* sh_d, float* sh_tmin,
                              float* sh_tmax, void* stream) {
  if (s->prim_rec == nullptr || s->inst_rec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && s->num_lights > 0) {
    yrt::shade_prep_kernel<<<yrt::blocks_for(n, yrt::kShadeThreads),
                             yrt::kShadeThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        *s, ro, rd, inst, prim, mask, n, sh_o, sh_d, sh_tmin, sh_tmax);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int yrt_shade_finish(const yrt::ShadeScene* s, const float* ro,
                                const float* rd, const int* inst,
                                const int* prim, const uint8_t* mask,
                                const uint8_t* occ, int n, float* color,
                                float* kr, float* p, float* refl,
                                void* stream) {
  if (s->prim_rec == nullptr || s->inst_rec == nullptr ||
      s->mat_rec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    yrt::shade_finish_kernel<<<yrt::blocks_for(n, yrt::kShadeThreads),
                               yrt::kShadeThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        *s, ro, rd, inst, prim, mask, occ, n, color, kr, p, refl);
  }
  return static_cast<int>(cudaGetLastError());
}
