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
// Numerics: the same op order as the plain torch version (shade.cuh), built
// with --fmad=false and no fast-math; sqrtf, IEEE divides, powf with run-time
// exponents, as torch's CUDA kernels compute them. Masked lanes shade inst 0
// / prim 0 like the plain version, so p and refl_dir are bit-equal there too.
//
// What bounds it on an H100: per ray one 56-byte instance row, a prim row of
// three vertices (3 x 32 bytes), a material row and up to 8 texel quads, all
// gathers that stay in L2 for this repository's scenes; ~500-1000 flops per
// ray and light. One thread per ray, 128 threads per block.
#include <cstdint>

#include "shade.cuh"

namespace yrt {

__global__ void shade_prep_kernel(ShadeScene s, const float* __restrict__ ro_p,
                                  const float* __restrict__ rd_p,
                                  const int* __restrict__ inst_p,
                                  const int* __restrict__ prim_p,
                                  const uint8_t* __restrict__ mask_p, int n,
                                  float* __restrict__ sh_o,
                                  float* __restrict__ sh_d,
                                  float* __restrict__ sh_tmin,
                                  float* __restrict__ sh_tmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool mask = mask_p[i] != 0;
  HitGeom g;
  eval_hit(s, load3(ro_p, i), load3(rd_p, i), mask ? inst_p[i] : 0,
           mask ? prim_p[i] : 0, g);
  for (int l = 0; l < s.num_lights; ++l) {
    LightGeom lg;
    light_geom(s, l, light_position(s, l, i, n), g.p, lg);
    const long long k = static_cast<long long>(l) * n + i;
    sh_o[3 * k] = g.p.x;
    sh_o[3 * k + 1] = g.p.y;
    sh_o[3 * k + 2] = g.p.z;
    sh_d[3 * k] = lg.ldir.x;
    sh_d[3 * k + 1] = lg.ldir.y;
    sh_d[3 * k + 2] = lg.ldir.z;
    sh_tmin[k] = kShadowTmin;
    sh_tmax[k] = mask ? lg.rdist - kShadowEps : -kFltMax;
  }
}

__global__ void shade_finish_kernel(ShadeScene s,
                                    const float* __restrict__ ro_p,
                                    const float* __restrict__ rd_p,
                                    const int* __restrict__ inst_p,
                                    const int* __restrict__ prim_p,
                                    const uint8_t* __restrict__ mask_p,
                                    const uint8_t* __restrict__ occ, int n,
                                    float* __restrict__ color_o,
                                    float* __restrict__ kr_o,
                                    float* __restrict__ p_o,
                                    float* __restrict__ refl_o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool mask = mask_p[i] != 0;
  const V3 ro = load3(ro_p, i);
  HitGeom g;
  eval_hit(s, ro, load3(rd_p, i), mask ? inst_p[i] : 0, mask ? prim_p[i] : 0,
           g);
  const V3 vvec = safe_normalize(sub(ro, g.p));
  V3 color = zero3(), kr = zero3();
  if (mask) {
    MatEval m;
    eval_material(s, g, m);
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
  color_o[3 * i] = color.x;
  color_o[3 * i + 1] = color.y;
  color_o[3 * i + 2] = color.z;
  kr_o[3 * i] = kr.x;
  kr_o[3 * i + 1] = kr.y;
  kr_o[3 * i + 2] = kr.z;
  p_o[3 * i] = g.p.x;
  p_o[3 * i + 1] = g.p.y;
  p_o[3 * i + 2] = g.p.z;
  refl_o[3 * i] = g.n.x * k2 - vvec.x;
  refl_o[3 * i + 1] = g.n.y * k2 - vvec.y;
  refl_o[3 * i + 2] = g.n.z * k2 - vvec.z;
}

}  // namespace yrt

namespace {
constexpr int kShadeThreads = 128;
}

extern "C" int yrt_shade_prep(const yrt::ShadeScene* s, const float* ro,
                              const float* rd, const int* inst,
                              const int* prim, const uint8_t* mask, int n,
                              float* sh_o, float* sh_d, float* sh_tmin,
                              float* sh_tmax, void* stream) {
  if (n > 0 && s->num_lights > 0) {
    yrt::shade_prep_kernel<<<yrt::blocks_for(n, kShadeThreads), kShadeThreads,
                             0, static_cast<cudaStream_t>(stream)>>>(
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
  if (n > 0) {
    yrt::shade_finish_kernel<<<yrt::blocks_for(n, kShadeThreads),
                               kShadeThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        *s, ro, rd, inst, prim, mask, occ, n, color, kr, p, refl);
  }
  return static_cast<int>(cudaGetLastError());
}
