// K1's first, simple form, kept for comparison only.
//
// One thread per ray runs the threaded walk of
// ops/traverse.py::intersect_scene_plain, reading the scene's
// structure-of-arrays leaves with scalar loads, with the any-hit choice a
// runtime argument. chip_smoke.py times it in turns with the packed-record
// kernels of hit.cu, on the same rays and the same card, and holds the two
// equal; no path of the package launches it.
#include <cstdint>

#include "common.cuh"

namespace yrt {

struct SceneView {
  const float* __restrict__ node_bbox_min;
  const float* __restrict__ node_bbox_max;
  const int* __restrict__ node_start;
  const int* __restrict__ node_count;
  const int* __restrict__ node_isleaf;
  const int* __restrict__ node_kind;
  const int* __restrict__ node_skip;
  const int* __restrict__ leaf_items;
  const float* __restrict__ inst_axes;
  const float* __restrict__ inst_o;
  const int* __restrict__ inst_shape_root;
  const int* __restrict__ prim_v;
  const int* __restrict__ prim_type;
  const float* __restrict__ pos;
  const float* __restrict__ radius;
};

constexpr int kPrimPoint = 0;
constexpr int kPrimLine = 1;

__device__ __forceinline__ Ray ray_in_frame(const SceneView& s, int inst,
                                            V3 ro, V3 rd) {
  if (inst < 0) {
    return local_ray(make(1.0f, 0.0f, 0.0f), make(0.0f, 1.0f, 0.0f),
                     make(0.0f, 0.0f, 1.0f), make(0.0f, 0.0f, 0.0f), ro, rd);
  }
  return local_ray(load3(s.inst_axes, 3 * inst), load3(s.inst_axes, 3 * inst + 1),
                   load3(s.inst_axes, 3 * inst + 2), load3(s.inst_o, inst), ro,
                   rd);
}

__global__ void hit_simple_kernel(SceneView s,
                                  const float* __restrict__ ro_p,
                                  const float* __restrict__ rd_p,
                                  const float* __restrict__ tmin_p,
                                  const float* __restrict__ tmax_p, int n,
                                  int any_hit,
                                  uint8_t* __restrict__ out_hit,
                                  int* __restrict__ out_inst,
                                  int* __restrict__ out_prim,
                                  float* __restrict__ out_t) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 ro = load3(ro_p, i);
  const V3 rd = load3(rd_p, i);
  const float tmin = tmin_p[i];
  float t = tmax_p[i];
  int node = 0, inst = -1, sleaf = -1, slot = 0;
  int hit_inst = -1, hit_prim = -1;
  Ray r = ray_in_frame(s, -1, ro, rd);

  while (node >= 0) {
    const bool bhit = hit_bbox(r, tmin, t, load3(s.node_bbox_min, node),
                               load3(s.node_bbox_max, node));
    const int nstart = __ldg(s.node_start + node);
    const bool nleaf = __ldg(s.node_isleaf + node) == 1;
    const int nkind = __ldg(s.node_kind + node);
    bool got_hit = false;

    if (bhit && nleaf && nkind == 1) {
      // shape leaf: up to 4 prims in forward order, last equal t wins
      const int ncount = min(__ldg(s.node_count + node), 4);
      for (int k = 0; k < ncount; ++k) {
        const int prim = __ldg(s.leaf_items + nstart + k);
        const int ptype = __ldg(s.prim_type + prim);
        const int i0 = __ldg(s.prim_v + 3 * prim);
        const int i1 = __ldg(s.prim_v + 3 * prim + 1);
        float tk;
        bool h;
        if (ptype == kPrimPoint) {
          h = hit_point(r, tmin, t, load3(s.pos, i0), __ldg(s.radius + i0), &tk);
        } else if (ptype == kPrimLine) {
          h = hit_line(r, tmin, t, load3(s.pos, i0), load3(s.pos, i1),
                       __ldg(s.radius + i0), __ldg(s.radius + i1), &tk);
        } else {
          const int i2 = __ldg(s.prim_v + 3 * prim + 2);
          h = hit_triangle(r, tmin, t, load3(s.pos, i0), load3(s.pos, i1),
                           load3(s.pos, i2), &tk);
        }
        if (h) {
          t = tk;
          hit_inst = inst;
          hit_prim = prim;
          got_hit = true;
        }
      }
    }

    // next node: internal hit -> start + 1 (the threaded order visits the
    // second child first); scene-leaf hit -> first instance's shape root;
    // otherwise the skip pointer
    int nxt;
    int new_inst = inst;
    if (bhit && !nleaf) {
      nxt = nstart + 1;
    } else if (bhit && nkind == 0) {
      const int item0 = __ldg(s.leaf_items + nstart);
      nxt = __ldg(s.inst_shape_root + item0);
      new_inst = item0;
      sleaf = node;
      slot = 0;
    } else {
      nxt = __ldg(s.node_skip + node);
    }
    // shape tree exhausted: next instance of the scene leaf, else resume
    // at the scene leaf's skip pointer
    if (nxt < 0 && new_inst >= 0) {
      const int next_slot = slot + 1;
      if (next_slot < __ldg(s.node_count + sleaf)) {
        const int item = __ldg(s.leaf_items + __ldg(s.node_start + sleaf) + next_slot);
        nxt = __ldg(s.inst_shape_root + item);
        new_inst = item;
        slot = next_slot;
      } else {
        nxt = __ldg(s.node_skip + sleaf);
        new_inst = -1;
        sleaf = -1;
      }
    }
    if (any_hit && got_hit) nxt = -1;
    if (new_inst != inst && nxt >= 0) r = ray_in_frame(s, new_inst, ro, rd);
    inst = new_inst;
    node = nxt;
  }
  out_hit[i] = hit_prim >= 0 ? 1 : 0;
  out_inst[i] = hit_inst;
  out_prim[i] = hit_prim;
  out_t[i] = t;
}

}  // namespace yrt

extern "C" int yrt_hit_simple(
    const float* node_bbox_min, const float* node_bbox_max,
    const int* node_start, const int* node_count, const int* node_isleaf,
    const int* node_kind, const int* node_skip, const int* leaf_items,
    const float* inst_axes, const float* inst_o, const int* inst_shape_root,
    const int* prim_v, const int* prim_type, const float* pos,
    const float* radius, const float* ro, const float* rd, const float* tmin,
    const float* tmax, int n, int any_hit, uint8_t* out_hit, int* out_inst,
    int* out_prim, float* out_t, void* stream) {
  if (n > 0) {
    yrt::SceneView s{node_bbox_min, node_bbox_max, node_start, node_count,
                     node_isleaf,   node_kind,     node_skip,  leaf_items,
                     inst_axes,     inst_o,        inst_shape_root,
                     prim_v,        prim_type,     pos,        radius};
    constexpr int kThreads = 128;
    yrt::hit_simple_kernel<<<yrt::blocks_for(n, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        s, ro, rd, tmin, tmax, n, any_hit, out_hit, out_inst, out_prim, out_t);
  }
  return static_cast<int>(cudaGetLastError());
}
