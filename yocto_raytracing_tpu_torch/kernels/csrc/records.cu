// K13: K1's and K4's records, packed from the scene's leaves in one launch.
//
// The device loops (render/renderer.py::frame_device, loss_grads_device)
// keep their records across calls and bring them up to date from their
// copies of the leaves on every call; the plain version is the two
// packers' torch ops, ops/hit_records.py::pack and ops/shade_records.py::
// pack (about 35 ops), which ops/records.py::pack_into runs on the CPU.
// The JAX package reads its leaves directly (render/renderer.py::
// trace_rays), so this kernel replaces no JAX function of its own: it is
// part of B5's port.
//
// Six tables, each row a whole number of 16-byte quads:
//   hit nodes  (M, 8):  bbox_min, bbox_max, min(count, 7) + 8 * start,
//                       kind + 2 * isleaf + 4 * skip
//   hit prims  (K - I, 12), slot s = I + j, prim = leaf_items[s]:
//                       pos[v0], radius[v0], pos[v1], radius[v1], pos[v2],
//                       prim_type[prim] + 4 * prim  (v = prim_v[prim])
//   hit insts  (I, 16), item = leaf_items[j]: inst_axes[item] (9),
//                       inst_o[item], inst_shape_root[item], item x 3
//   shade prims (P, 28): prim_v (3), prim_type, then per vertex pos,
//                       norm, texcoord (8 words)
//   shade insts (I, 16): inst_axes (9), inst_o, inst_mat, inst_is_lines,
//                       0, 0
//   shade mats (Mt, 12): kd, ks, kr, rs, kd_txt, ks_txt
// Every word is a bit copy of a leaf word, or the packers' int32 sums (in
// 32-bit two's complement, as torch's int32 adds wrap), so the records are
// bit-equal to the packers'.
//
// What bounds it on an H100: bytes, a few hundred KB to a few MB (the
// 10,004-instance scene's 2.5 MB is 0.75 us at the memory rate), so a
// launch's own floor and the latency of its dependent loads are its time.
// An earlier design (a thread a row, words copied one by one through
// pointers that may alias, so each load waited for the store
// before it, 4-28 round trips a row; a warp could straddle two tables)
// took 7.63 us on the hair scene. The design:
//   * a thread per 16-byte quad of an output row, quad q of a table at
//     row q / Q, quad q % Q (Q = 2, 3, 4, 7, 4, 3 quads a row): 4x the
//     threads in flight of a thread a row, and a warp's stores one
//     contiguous 512-byte run;
//   * every load first (at most 7 words beside the index chain, through
//     read-only loads), then one int4 store: a thread waits for its
//     loads once, or for each link of its chain of indices (leaf_items
//     -> prim_v -> pos for a hit prim, prim_v -> pos for a shade prim);
//   * one table a block: ops/records.py::block_plan gives each table its
//     first block on the host, once a configuration, so no warp takes two
//     tables' paths and an empty table takes no block;
//   * ops/records.py::prepare refuses a table that is not contiguous and
//     16-byte aligned.
// records_empty_kernel takes the same grid and arguments and does
// nothing: chip_smoke.py times it as the floor of such a launch.
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr int kRecordThreads = 256;
constexpr int kRecordTables = 6;
constexpr int kCountSat = 7;  // ops/hit_records.py::COUNT_SAT

struct RecordLeaves {
  const int32_t* __restrict__ node_bbox_min;  // (M, 3) f32 bits
  const int32_t* __restrict__ node_bbox_max;  // (M, 3)
  const int32_t* __restrict__ node_count;     // (M,)
  const int32_t* __restrict__ node_start;
  const int32_t* __restrict__ node_kind;
  const int32_t* __restrict__ node_isleaf;
  const int32_t* __restrict__ node_skip;
  const int32_t* __restrict__ leaf_items;     // (K,)
  const int32_t* __restrict__ prim_v;         // (P, 3)
  const int32_t* __restrict__ prim_type;      // (P,)
  const int32_t* __restrict__ pos;            // (V, 3) f32 bits
  const int32_t* __restrict__ radius;         // (V,)
  const int32_t* __restrict__ norm;           // (V, 3)
  const int32_t* __restrict__ texcoord;       // (V, 2)
  const int32_t* __restrict__ inst_axes;      // (I, 9)
  const int32_t* __restrict__ inst_o;         // (I, 3)
  const int32_t* __restrict__ inst_shape_root;
  const int32_t* __restrict__ inst_mat;
  const int32_t* __restrict__ inst_is_lines;
  const int32_t* __restrict__ mat_kd;         // (Mt, 3)
  const int32_t* __restrict__ mat_ks;
  const int32_t* __restrict__ mat_kr;
  const int32_t* __restrict__ mat_rs;         // (Mt,)
  const int32_t* __restrict__ mat_kd_txt;
  const int32_t* __restrict__ mat_ks_txt;
};

// hit nodes, hit prims, hit insts, shade prims, shade insts, shade mats:
// each 16-byte aligned, rows of 2, 3, 4, 7, 4, 3 quads
struct RecordTables {
  int4* table[kRecordTables];
};

// ops/records.py::block_plan: the rows of each table, and the first block
// of each (start[t] <= blockIdx.x < start[t + 1] serves table t; start[6]
// is the grid)
struct RecordPlan {
  int rows[kRecordTables];
  int start[kRecordTables + 1];
};

// a + k * b in int32 as torch.add(a, b, alpha=k) gives it: wrapping
__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b, int k) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(k) *
                                  static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t ld(const int32_t* __restrict__ p,
                                      long long i) {
  return __ldg(p + i);
}

// quad c < 3 of an instance frame's 12 words: axes (9), o (3)
__device__ __forceinline__ int4 frame_quad(const RecordLeaves& in, int item,
                                           int c) {
  const long long a = 9LL * item + 4 * c, o = 3LL * item;
  if (c < 2)
    return make_int4(ld(in.inst_axes, a), ld(in.inst_axes, a + 1),
                     ld(in.inst_axes, a + 2), ld(in.inst_axes, a + 3));
  return make_int4(ld(in.inst_axes, a), ld(in.inst_o, o), ld(in.inst_o, o + 1),
                   ld(in.inst_o, o + 2));
}

// table 0, hit nodes: 2 quads a row
__device__ __forceinline__ int4 hit_node_quad(const RecordLeaves& in, int q) {
  const int i = q >> 1;
  const long long b = 3LL * i;
  if ((q & 1) == 0)
    return make_int4(ld(in.node_bbox_min, b), ld(in.node_bbox_min, b + 1),
                     ld(in.node_bbox_min, b + 2), ld(in.node_bbox_max, b));
  const int32_t count = ld(in.node_count, i), start = ld(in.node_start, i);
  const int32_t kind = ld(in.node_kind, i), leaf = ld(in.node_isleaf, i);
  const int32_t skip = ld(in.node_skip, i);
  return make_int4(ld(in.node_bbox_max, b + 1), ld(in.node_bbox_max, b + 2),
                   add_wrap(min(count, kCountSat), start, 8),
                   add_wrap(add_wrap(kind, leaf, 2), skip, 4));
}

// table 1, hit prims: 3 quads a row, quad c the vertex c's pos and radius
// (the last quad's fourth word the prim's type and index)
__device__ __forceinline__ int4 hit_prim_quad(const RecordLeaves& in, int q,
                                              int ni) {
  const int j = q / 3, c = q - 3 * j;
  const int prim = ld(in.leaf_items, static_cast<long long>(ni) + j);
  const int v = ld(in.prim_v, 3LL * prim + c);
  const long long b = 3LL * v;
  const int32_t w = c < 2 ? ld(in.radius, v)
                          : add_wrap(ld(in.prim_type, prim), prim, 4);
  return make_int4(ld(in.pos, b), ld(in.pos, b + 1), ld(in.pos, b + 2), w);
}

// table 2, hit insts: 4 quads a row
__device__ __forceinline__ int4 hit_inst_quad(const RecordLeaves& in, int q) {
  const int j = q >> 2, c = q & 3;
  const int item = ld(in.leaf_items, j);
  if (c < 3) return frame_quad(in, item, c);
  return make_int4(ld(in.inst_shape_root, item), item, item, item);
}

// table 3, shade prims: 7 quads a row; quad 0 prim_v and prim_type, then
// two a vertex: pos and norm[0], norm[1..2] and texcoord
__device__ __forceinline__ int4 shade_prim_quad(const RecordLeaves& in,
                                                int q) {
  const int p = q / 7, k = q - 7 * p;
  const long long b = 3LL * p;
  if (k == 0)
    return make_int4(ld(in.prim_v, b), ld(in.prim_v, b + 1),
                     ld(in.prim_v, b + 2), ld(in.prim_type, p));
  const int v = ld(in.prim_v, b + ((k - 1) >> 1));
  const long long v3 = 3LL * v, v2 = 2LL * v;
  if ((k & 1) != 0)
    return make_int4(ld(in.pos, v3), ld(in.pos, v3 + 1), ld(in.pos, v3 + 2),
                     ld(in.norm, v3));
  return make_int4(ld(in.norm, v3 + 1), ld(in.norm, v3 + 2),
                   ld(in.texcoord, v2), ld(in.texcoord, v2 + 1));
}

// table 4, shade insts: 4 quads a row
__device__ __forceinline__ int4 shade_inst_quad(const RecordLeaves& in,
                                                int q) {
  const int i = q >> 2, c = q & 3;
  if (c < 3) return frame_quad(in, i, c);
  return make_int4(ld(in.inst_mat, i), ld(in.inst_is_lines, i), 0, 0);
}

// table 5, shade mats: 3 quads a row
__device__ __forceinline__ int4 shade_mat_quad(const RecordLeaves& in, int q) {
  const int i = q / 3, c = q - 3 * i;
  const long long b = 3LL * i;
  if (c == 0)
    return make_int4(ld(in.mat_kd, b), ld(in.mat_kd, b + 1),
                     ld(in.mat_kd, b + 2), ld(in.mat_ks, b));
  if (c == 1)
    return make_int4(ld(in.mat_ks, b + 1), ld(in.mat_ks, b + 2),
                     ld(in.mat_kr, b), ld(in.mat_kr, b + 1));
  return make_int4(ld(in.mat_kr, b + 2), ld(in.mat_rs, i),
                   ld(in.mat_kd_txt, i), ld(in.mat_ks_txt, i));
}

__constant__ int kRecordQuads[kRecordTables] = {2, 3, 4, 7, 4, 3};

__global__ void __launch_bounds__(kRecordThreads)
    records_kernel(const __grid_constant__ RecordLeaves in,
                   const __grid_constant__ RecordTables out,
                   const __grid_constant__ RecordPlan plan) {
  const int b = blockIdx.x;
  int t = 0;  // the block's table: the same for all its threads
  while (b >= plan.start[t + 1]) ++t;
  const int q = (b - plan.start[t]) * kRecordThreads +
                static_cast<int>(threadIdx.x);
  if (q >= plan.rows[t] * kRecordQuads[t]) return;
  int4 v;
  switch (t) {
    case 0: v = hit_node_quad(in, q); break;
    case 1: v = hit_prim_quad(in, q, plan.rows[2]); break;
    case 2: v = hit_inst_quad(in, q); break;
    case 3: v = shade_prim_quad(in, q); break;
    case 4: v = shade_inst_quad(in, q); break;
    default: v = shade_mat_quad(in, q); break;
  }
  out.table[t][q] = v;
}

__global__ void __launch_bounds__(kRecordThreads)
    records_empty_kernel(RecordLeaves, RecordTables, RecordPlan) {}

// ``leaves``, ``tables``: the fields of RecordLeaves and RecordTables, in
// order, as pointer arrays; ``rows`` and ``start``: RecordPlan's
cudaError_t launch_records(const void* const* leaves, void* const* tables,
                           const int* rows, const int* start, bool empty,
                           cudaStream_t stream) {
  RecordLeaves in;
  const int32_t** pin = reinterpret_cast<const int32_t**>(&in);
  for (size_t f = 0; f < sizeof(in) / sizeof(void*); ++f)
    pin[f] = static_cast<const int32_t*>(leaves[f]);
  RecordTables out;
  RecordPlan plan;
  for (int t = 0; t < kRecordTables; ++t) {
    out.table[t] = static_cast<int4*>(tables[t]);
    plan.rows[t] = rows[t];
  }
  for (int t = 0; t <= kRecordTables; ++t) plan.start[t] = start[t];
  const int grid = plan.start[kRecordTables];
  if (grid > 0) {
    if (empty)
      records_empty_kernel<<<grid, kRecordThreads, 0, stream>>>(in, out,
                                                                plan);
    else
      records_kernel<<<grid, kRecordThreads, 0, stream>>>(in, out, plan);
  }
  return cudaGetLastError();
}

}  // namespace yrt

extern "C" int yrt_records(const void* const* leaves, void* const* tables,
                           const int* rows, const int* start, void* stream) {
  return static_cast<int>(yrt::launch_records(
      leaves, tables, rows, start, false, static_cast<cudaStream_t>(stream)));
}

// records_empty_kernel on yrt_records' grid and arguments (chip_smoke.py's
// launch floor)
extern "C" int yrt_records_empty(const void* const* leaves,
                                 void* const* tables, const int* rows,
                                 const int* start, void* stream) {
  return static_cast<int>(yrt::launch_records(
      leaves, tables, rows, start, true, static_cast<cudaStream_t>(stream)));
}
