// K13: K1's and K4's records, packed from the scene's leaves in one launch.
//
// The device loop (render/renderer.py::frame_device) keeps its records
// across calls and brings them up to date from its copies of the leaves on
// every call; the plain version is the two packers' torch ops,
// ops/hit_records.py::pack and ops/shade_records.py::pack (about 35 ops),
// which ops/records.py::pack_into runs on the CPU. The JAX package reads
// its leaves directly (render/renderer.py::trace_rays), so this kernel
// replaces no JAX function of its own: it is part of B5's port.
//
// Six tables, a thread a row, the rows of the tables one after another:
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
// What bounds it on an H100: bytes, a few hundred KB for the port's scenes,
// so the launch itself (a few us) is its time. The design: one launch in
// place of the packers' ~35 ops, so the device loop's call stages its
// records with one launch and no graph of its own.
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr int kRecordThreads = 256;
constexpr int kCountSat = 7;  // ops/hit_records.py::COUNT_SAT

struct RecordLeaves {
  const int32_t* node_bbox_min;  // (M, 3) f32 bits
  const int32_t* node_bbox_max;  // (M, 3)
  const int32_t* node_count;     // (M,)
  const int32_t* node_start;
  const int32_t* node_kind;
  const int32_t* node_isleaf;
  const int32_t* node_skip;
  const int32_t* leaf_items;     // (K,)
  const int32_t* prim_v;         // (P, 3)
  const int32_t* prim_type;      // (P,)
  const int32_t* pos;            // (V, 3) f32 bits
  const int32_t* radius;         // (V,)
  const int32_t* norm;           // (V, 3)
  const int32_t* texcoord;       // (V, 2)
  const int32_t* inst_axes;      // (I, 9)
  const int32_t* inst_o;         // (I, 3)
  const int32_t* inst_shape_root;
  const int32_t* inst_mat;
  const int32_t* inst_is_lines;
  const int32_t* mat_kd;         // (Mt, 3)
  const int32_t* mat_ks;
  const int32_t* mat_kr;
  const int32_t* mat_rs;         // (Mt,)
  const int32_t* mat_kd_txt;
  const int32_t* mat_ks_txt;
};

struct RecordTables {
  int32_t* hit_nodes;     // (M, 8)
  int32_t* hit_prims;     // (K - I, 12)
  int32_t* hit_insts;     // (I, 16)
  int32_t* shade_prims;   // (P, 28)
  int32_t* shade_insts;   // (I, 16)
  int32_t* shade_mats;    // (Mt, 12)
};

// a + k * b in int32 as torch.add(a, b, alpha=k) gives it: wrapping
__device__ __forceinline__ int32_t add_wrap(int32_t a, int32_t b, int k) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(k) *
                                  static_cast<uint32_t>(b));
}

__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src,
                                           int n) {
  for (int w = 0; w < n; ++w) dst[w] = src[w];
}

__global__ void __launch_bounds__(kRecordThreads)
    records_kernel(RecordLeaves in, RecordTables out, int m, int k, int ni,
                   int np, int nmat) {
  long long r = static_cast<long long>(blockIdx.x) * kRecordThreads +
                threadIdx.x;
  if (r < m) {
    const int i = static_cast<int>(r);
    int32_t* o = out.hit_nodes + 8LL * i;
    copy_words(o, in.node_bbox_min + 3LL * i, 3);
    copy_words(o + 3, in.node_bbox_max + 3LL * i, 3);
    o[6] = add_wrap(min(in.node_count[i], kCountSat), in.node_start[i], 8);
    o[7] = add_wrap(add_wrap(in.node_kind[i], in.node_isleaf[i], 2),
                    in.node_skip[i], 4);
    return;
  }
  r -= m;
  if (r < k - ni) {
    const int j = static_cast<int>(r);
    const int prim = in.leaf_items[ni + j];
    const int32_t* v = in.prim_v + 3LL * prim;
    int32_t* o = out.hit_prims + 12LL * j;
    for (int c = 0; c < 3; ++c) {
      copy_words(o + 4 * c, in.pos + 3LL * v[c], 3);
      if (c < 2) o[4 * c + 3] = in.radius[v[c]];
    }
    o[11] = add_wrap(in.prim_type[prim], prim, 4);
    return;
  }
  r -= k - ni;
  if (r < ni) {
    const int j = static_cast<int>(r);
    const int item = in.leaf_items[j];
    int32_t* o = out.hit_insts + 16LL * j;
    copy_words(o, in.inst_axes + 9LL * item, 9);
    copy_words(o + 9, in.inst_o + 3LL * item, 3);
    o[12] = in.inst_shape_root[item];
    o[13] = o[14] = o[15] = item;
    return;
  }
  r -= ni;
  if (r < np) {
    const int p = static_cast<int>(r);
    const int32_t* v = in.prim_v + 3LL * p;
    int32_t* o = out.shade_prims + 28LL * p;
    copy_words(o, v, 3);
    o[3] = in.prim_type[p];
    for (int c = 0; c < 3; ++c) {
      int32_t* ov = o + 4 + 8 * c;
      copy_words(ov, in.pos + 3LL * v[c], 3);
      copy_words(ov + 3, in.norm + 3LL * v[c], 3);
      copy_words(ov + 6, in.texcoord + 2LL * v[c], 2);
    }
    return;
  }
  r -= np;
  if (r < ni) {
    const int i = static_cast<int>(r);
    int32_t* o = out.shade_insts + 16LL * i;
    copy_words(o, in.inst_axes + 9LL * i, 9);
    copy_words(o + 9, in.inst_o + 3LL * i, 3);
    o[12] = in.inst_mat[i];
    o[13] = in.inst_is_lines[i];
    o[14] = o[15] = 0;
    return;
  }
  r -= ni;
  if (r < nmat) {
    const int i = static_cast<int>(r);
    int32_t* o = out.shade_mats + 12LL * i;
    copy_words(o, in.mat_kd + 3LL * i, 3);
    copy_words(o + 3, in.mat_ks + 3LL * i, 3);
    copy_words(o + 6, in.mat_kr + 3LL * i, 3);
    o[9] = in.mat_rs[i];
    o[10] = in.mat_kd_txt[i];
    o[11] = in.mat_ks_txt[i];
  }
}

}  // namespace yrt

// ``leaves`` and ``tables``: the fields of yrt::RecordLeaves and
// yrt::RecordTables, in order, as pointer arrays.
extern "C" int yrt_records(const void* const* leaves, void* const* tables,
                           int m, int k, int ni, int np, int nmat,
                           void* stream) {
  yrt::RecordLeaves in;
  const int32_t** pin = reinterpret_cast<const int32_t**>(&in);
  for (size_t f = 0; f < sizeof(in) / sizeof(void*); ++f)
    pin[f] = static_cast<const int32_t*>(leaves[f]);
  yrt::RecordTables out;
  int32_t** pout = reinterpret_cast<int32_t**>(&out);
  for (size_t f = 0; f < sizeof(out) / sizeof(void*); ++f)
    pout[f] = static_cast<int32_t*>(tables[f]);
  const long long rows = static_cast<long long>(m) + (k - ni) + ni + np + ni +
                         nmat;
  if (rows > 0)
    yrt::records_kernel<<<yrt::blocks_for(rows, yrt::kRecordThreads),
                          yrt::kRecordThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        in, out, m, k, ni, np, nmat);
  return static_cast<int>(cudaGetLastError());
}
