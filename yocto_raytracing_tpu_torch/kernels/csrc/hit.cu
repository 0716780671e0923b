// K1: nearest-hit and any-hit query of a ray batch against the two-level
// BVH, on packed records.
//
// Replaces the JAX package's device loops for the hit query:
// ops/traverse.py::intersect_scene (the threaded stackless walk, with
// _leaf_prims_hit and the math of ops/intersect.py) and
// ops/stream.py::intersect_stream, which gives the same answers through
// TPU-shaped instance shortlists and 128-prim cluster scans.
//
// Invariant. For every ray, these kernels do the same slab tests and the
// same prim tests, in the same order, each seeing the same current t, as
// the threaded walk of ops/traverse.py::intersect_scene_plain (JAX
// ops/traverse.py:82-186): internal hit -> start + 1 (the second child
// first), scene leaf -> its instances' shape trees in slot order, shape
// leaf -> up to 4 prims in slot order, miss -> the skip pointer; any-hit
// stops after the leaf where the ray first hits. The arithmetic is
// common.cuh's (the slab test's without its redundant NaN guards, below),
// built with --fmad=false. So hit, inst, prim and t are
// bit-equal to the plain walk on every ray, equal-t ties (the last
// accepted hit wins: acceptance is t <= best), NaN directions and dead rays
// included. Nothing here reorders a walk; what changed from the simple
// kernel (hit_simple.cu, kept for comparison) is where a walk reads from
// and which lanes run one.
//
// What bounds K1 on an H100. Each step of a walk depends on the step
// before: the next node is known only once the node's data has arrived
// and its slab test is done. Neighbouring rays take different paths, so a
// warp's loads scatter over many cache lines, and each load instruction
// costs the L1 one pass per line it touches; a warp runs as long as its
// longest walk. The scenes stay in L1/L2 (the hair frame's records are
// 111 KB, the 10,004-instance scene's 875 KB), so bytes do not bound K1:
// the chain of dependent loads, the instructions a step issues, and the
// lanes of a warp that wait while others walk on do. PERF.md holds one
// launch's device time against its operation bound, for each kind.
//
// What the design does about it:
// * Packed records (ops/hit_records.py). A node visit reads one 32-byte
//   record with two 16-byte loads (the simple kernel: 11 scalar loads
//   from 7 arrays). A prim test reads one 48-byte record that holds the
//   prim's own vertices, radii, type and id (the simple kernel: a chain of
//   four dependent loads through leaf_items, prim_v, pos and radius), and
//   a leaf's prims are adjacent. A frame change reads one 64-byte record
//   per scene-leaf slot: the instance's axes, origin, shape root and id
//   (the simple kernel: leaf_items, then 13 scalar loads).
// * The world-frame ray is computed once and kept for the returns from
//   instances (the same bits as recomputing it), and the slab test drops
//   NaN guards that fmaxf/fminf make redundant for a live ray
//   (hit_bbox_live: the same bits).
// * An instance whose 12 frame words are the identity's bits is entered on
//   that kept world ray (enter_slot): local_ray of the identity is `world`
//   itself, so the entry skips its 9 dot products, IEEE sqrt, divide and
//   three reciprocals for 12 integer compares of words already loaded.
//   Scenes loaded from OBJ are identity-instanced: a live lane of the
//   benchmark's frames enters 4.00-4.61 instances a nearest walk and
//   3.64-4.43 an any-hit walk (rtbench/ref/walk.py's counts on the CPU),
//   each one identity; K1's device time there fell 8-11% (PERF.md). Other
//   frames take local_ray as before; the choice is per entry, from the
//   record's bits alone.
// * Two kernels, nearest and any hit: a template parameter, so each
//   compiles without the other's branch and the profiler names them
//   apart.
// * Dead lanes retire before the walk. A ray with !(tmax >= tmin) can
//   accept no prim (every prim test needs tmin <= t <= tmax), so its exact
//   result is (0, -1, -1, tmax), NaN tmax included; it is written without
//   touching the BVH.
// * __launch_bounds__ at the block size chosen on the card (kHitThreads,
//   128; 64 and 256 were measured, PERF.md): 63-64 registers a thread, no
//   spills, 1,024 resident threads per SM.
// Tried on the card and not kept (PERF.md): a persistent-warp any-hit loop
// over a device-built list of live lanes (slower: the shadow launches' dead
// lanes come in whole warps), and a 48-register cap for more resident
// warps (slower: it spills).
#include <cstdint>

#include "common.cuh"

namespace yrt {

struct HitView {
  const float4* __restrict__ nodes;  // 2 per node
  const float4* __restrict__ prims;  // 3 per shape-leaf slot, from n_inst
  const float4* __restrict__ insts;  // 4 per scene-leaf slot
  const int* __restrict__ node_count;
  int n_inst;
};

struct HitIO {
  const float* __restrict__ ro;
  const float* __restrict__ rd;
  const float* __restrict__ tmin;
  const float* __restrict__ tmax;
  uint8_t* __restrict__ hit;
  int* __restrict__ inst;
  int* __restrict__ prim;
  float* __restrict__ t;
};

constexpr int kHitPoint = 0;
constexpr int kHitLine = 1;
constexpr int kCountSat = 7;  // hit_records.COUNT_SAT
constexpr int kHitThreads = 128;

__device__ __forceinline__ V3 xyz(float4 a) { return make(a.x, a.y, a.z); }

constexpr int kOneBits = 0x3f800000;  // 1.0f; +0.0f is 0

// Into the instance of scene-leaf slot `slot`: its local ray, shape root
// and instance id. Where the 12 frame words are the identity's bits (axes
// rows 1 0 0, 0 1 0, 0 0 1, origin +0 +0 +0), local_ray would compute
// `world` from the same inputs, so the walk's `world` is taken. The test is
// on bits: a -0.0 origin word changes the sign of a zero in the local
// origin, and a NaN word is no identity; both take local_ray.
__device__ __forceinline__ Ray enter_slot(const HitView& s, int slot, V3 ro,
                                          V3 rd, const Ray& world, int* root,
                                          int* item) {
  const float4* q = s.insts + 4 * slot;
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2),
               d = __ldg(q + 3);
  *root = __float_as_int(d.x);
  *item = __float_as_int(d.y);
  const int off = (__float_as_int(a.x) ^ kOneBits) | __float_as_int(a.y) |
                  __float_as_int(a.z) | __float_as_int(a.w) |
                  (__float_as_int(b.x) ^ kOneBits) | __float_as_int(b.y) |
                  __float_as_int(b.z) | __float_as_int(b.w) |
                  (__float_as_int(c.x) ^ kOneBits) | __float_as_int(c.y) |
                  __float_as_int(c.z) | __float_as_int(c.w);
  if (off == 0) return world;
  return local_ray(xyz(a), make(a.w, b.x, b.y), make(b.z, b.w, c.x),
                   make(c.y, c.z, c.w), ro, rd);
}

// common.cuh's hit_bbox for a live ray, without its six NaN guards. A
// live ray's tmin and current t are never NaN (tmin <= t holds, and a prim
// is accepted only where t_k >= tmin). fmaxf and fminf return the other
// operand when one is NaN, so a NaN slab bound drops out of the max (min)
// exactly as the guard's -inf (+inf) does, and a chain that is all NaN ends
// at tmin (t) either way: the same bits, 12 fewer instructions a visit.
__device__ __forceinline__ bool hit_bbox_live(const Ray& r, float tmin,
                                              float tmax, V3 bmin, V3 bmax) {
  const float t0x = (bmin.x - r.o.x) * r.inv.x;
  const float t1x = (bmax.x - r.o.x) * r.inv.x;
  const float t0y = (bmin.y - r.o.y) * r.inv.y;
  const float t1y = (bmax.y - r.o.y) * r.inv.y;
  const float t0z = (bmin.z - r.o.z) * r.inv.z;
  const float t1z = (bmax.z - r.o.z) * r.inv.z;
  const float lx = r.inv.x < 0.0f ? t1x : t0x, hx = r.inv.x < 0.0f ? t0x : t1x;
  const float ly = r.inv.y < 0.0f ? t1y : t0y, hy = r.inv.y < 0.0f ? t0y : t1y;
  const float lz = r.inv.z < 0.0f ? t1z : t0z, hz = r.inv.z < 0.0f ? t0z : t1z;
  const float lo = fmaxf(fmaxf(fmaxf(lx, ly), lz), tmin);
  const float hi = fminf(fminf(fminf(hx, hy), hz), tmax) * kBBoxSlack;
  return lo <= hi;
}

// The walk of one live ray; t enters as tmax and leaves as the answer.
template <bool kAnyHit>
__device__ __forceinline__ void walk(const HitView& s, V3 ro, V3 rd,
                                     float tmin, float& t, int& hit_inst,
                                     int& hit_prim) {
  const Ray world = local_ray(make(1.0f, 0.0f, 0.0f), make(0.0f, 1.0f, 0.0f),
                              make(0.0f, 0.0f, 1.0f), make(0.0f, 0.0f, 0.0f),
                              ro, rd);
  Ray r = world;
  int node = 0, inst = -1;
  int slot = 0, slot_end = 0, leaf_skip = -1;  // the scene leaf expanded
  while (node >= 0) {
    const float4 na = __ldg(s.nodes + 2 * node);
    const float4 nb = __ldg(s.nodes + 2 * node + 1);
    const int w_start = __float_as_int(nb.z);
    const int w_flags = __float_as_int(nb.w);
    const int nstart = w_start >> 3;
    const int nskip = w_flags >> 2;
    const bool nleaf = (w_flags & 2) != 0;
    const bool bhit =
        hit_bbox_live(r, tmin, t, xyz(na), make(na.w, nb.x, nb.y));
    int nxt;
    if (bhit && !nleaf) {
      nxt = nstart + 1;
    } else if (bhit && (w_flags & 1)) {
      // shape leaf: up to 4 prims in slot order, last equal t wins
      const int ncount = min(w_start & kCountSat, 4);
      bool got_hit = false;
      for (int k = 0; k < ncount; ++k) {
        const float4* q = s.prims + 3 * (nstart + k - s.n_inst);
        const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
        const int w = __float_as_int(c.w);
        const int ptype = w & 3;
        float tk;
        bool h;
        if (ptype == kHitPoint) {
          h = hit_point(r, tmin, t, xyz(a), a.w, &tk);
        } else if (ptype == kHitLine) {
          h = hit_line(r, tmin, t, xyz(a), xyz(b), a.w, b.w, &tk);
        } else {
          h = hit_triangle(r, tmin, t, xyz(a), xyz(b), xyz(c), &tk);
        }
        if (h) {
          t = tk;
          hit_inst = inst;
          hit_prim = w >> 2;
          got_hit = true;
        }
      }
      if (kAnyHit && got_hit) return;
      nxt = nskip;
    } else if (bhit) {
      // scene leaf: the first instance's shape tree
      const int c = w_start & kCountSat;
      slot = nstart;
      slot_end = nstart + (c == kCountSat ? __ldg(s.node_count + node) : c);
      leaf_skip = nskip;
      r = enter_slot(s, slot, ro, rd, world, &nxt, &inst);
    } else {
      nxt = nskip;
    }
    // shape tree exhausted: the scene leaf's next instance, else resume at
    // the scene leaf's skip pointer
    if (nxt < 0 && inst >= 0) {
      if (++slot < slot_end) {
        r = enter_slot(s, slot, ro, rd, world, &nxt, &inst);
      } else {
        nxt = leaf_skip;
        inst = -1;
        r = world;
      }
    }
    node = nxt;
  }
}

template <bool kAnyHit>
__device__ __forceinline__ void hit_ray(const HitView& s, const HitIO& io,
                                        int i) {
  const float tmin = __ldg(io.tmin + i);
  float t = __ldg(io.tmax + i);
  int hit_inst = -1, hit_prim = -1;
  if (t >= tmin)  // else dead: no prim test can accept
    walk<kAnyHit>(s, load3(io.ro, i), load3(io.rd, i), tmin, t, hit_inst,
                  hit_prim);
  io.hit[i] = hit_prim >= 0 ? 1 : 0;
  io.inst[i] = hit_inst;
  io.prim[i] = hit_prim;
  io.t[i] = t;
}

// `alive`: the device loop's alive word of this bounce (bounce.cu), or
// null; a launch that reads 0 returns at once and writes nothing.
__global__ void __launch_bounds__(kHitThreads)
    hit_nearest_kernel(HitView s, HitIO io, int n,
                       const int* __restrict__ alive) {
  if (alive != nullptr && *alive == 0) return;
  const int i = blockIdx.x * kHitThreads + threadIdx.x;
  if (i < n) hit_ray<false>(s, io, i);
}

__global__ void __launch_bounds__(kHitThreads)
    hit_any_kernel(HitView s, HitIO io, int n, const int* __restrict__ alive) {
  if (alive != nullptr && *alive == 0) return;
  const int i = blockIdx.x * kHitThreads + threadIdx.x;
  if (i < n) hit_ray<true>(s, io, i);
}

}  // namespace yrt

extern "C" const char* yrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int yrt_hit(const float* nodes, const float* prims,
                       const float* insts, const int* node_count, int n_inst,
                       const float* ro, const float* rd, const float* tmin,
                       const float* tmax, int n, int any_hit,
                       uint8_t* out_hit, int* out_inst, int* out_prim,
                       float* out_t, const int* alive, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const yrt::HitView s{reinterpret_cast<const float4*>(nodes),
                       reinterpret_cast<const float4*>(prims),
                       reinterpret_cast<const float4*>(insts), node_count,
                       n_inst};
  const yrt::HitIO io{ro, rd, tmin, tmax, out_hit, out_inst, out_prim, out_t};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = yrt::blocks_for(n, yrt::kHitThreads);
  if (any_hit != 0) {
    yrt::hit_any_kernel<<<blocks, yrt::kHitThreads, 0, st>>>(s, io, n, alive);
  } else {
    yrt::hit_nearest_kernel<<<blocks, yrt::kHitThreads, 0, st>>>(s, io, n,
                                                                alive);
  }
  return static_cast<int>(cudaGetLastError());
}
