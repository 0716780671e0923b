// Shared device math for the port's kernels.
//
// Every function repeats the plain torch arithmetic of
// yocto_raytracing_tpu_torch/ops/intersect.py op for op: left-associative
// dots, jnp.cross's order, explicit multiply-adds for frames, IEEE division
// and sqrt. The library is built with --fmad=false and without fast-math, so
// nothing here is contracted into an FMA or approximated, and the kernels
// reproduce the plain versions bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace yrt {

constexpr float kFltMax = 3.402823466e+38f;
constexpr float kBBoxSlack = 1.00000024f;  // src/scene.cpp:370-382

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 make(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return make(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return make(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return make(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 mul(V3 a, float s) {
  return make(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return make(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}
// torch.clamp(x, 0, 1): NaN stays NaN (fminf/fmaxf would drop it)
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Local ray of an instance frame (axes rows a0, a1, a2, origin o): the
// origin goes through (ro - o) @ axes.T, the direction through rd @ axes.T
// and is re-normalized (transform_ray_inverse). At scene level the frame
// is the identity and the direction is still re-normalized.
struct Ray {
  V3 o, d, inv;  // inv = 1 / d, for the slab test
};

__device__ __forceinline__ Ray local_ray(V3 a0, V3 a1, V3 a2, V3 org, V3 ro,
                                         V3 rd) {
  V3 q = sub(ro, org);
  Ray r;
  r.o = make(dot(a0, q), dot(a1, q), dot(a2, q));
  V3 d = make(dot(a0, rd), dot(a1, rd), dot(a2, rd));
  float n2 = dot(d, d);
  if (n2 > 0.0f) d = mul(d, 1.0f / sqrtf(n2));
  r.d = d;
  r.inv = make(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  return r;
}

// Slab test with the reference's NaN drop and far-bound slack.
__device__ __forceinline__ bool hit_bbox(const Ray& r, float tmin, float tmax,
                                         V3 bmin, V3 bmax) {
  float t0x = (bmin.x - r.o.x) * r.inv.x, t1x = (bmax.x - r.o.x) * r.inv.x;
  float t0y = (bmin.y - r.o.y) * r.inv.y, t1y = (bmax.y - r.o.y) * r.inv.y;
  float t0z = (bmin.z - r.o.z) * r.inv.z, t1z = (bmax.z - r.o.z) * r.inv.z;
  float lx = r.inv.x < 0.0f ? t1x : t0x, hx = r.inv.x < 0.0f ? t0x : t1x;
  float ly = r.inv.y < 0.0f ? t1y : t0y, hy = r.inv.y < 0.0f ? t0y : t1y;
  float lz = r.inv.z < 0.0f ? t1z : t0z, hz = r.inv.z < 0.0f ? t0z : t1z;
  if (isnan(lx)) lx = -INFINITY;
  if (isnan(ly)) ly = -INFINITY;
  if (isnan(lz)) lz = -INFINITY;
  if (isnan(hx)) hx = INFINITY;
  if (isnan(hy)) hy = INFINITY;
  if (isnan(hz)) hz = INFINITY;
  float lo = fmaxf(fmaxf(fmaxf(lx, ly), lz), tmin);
  float hi = fminf(fminf(fminf(hx, hy), hz), tmax) * kBBoxSlack;
  return lo <= hi;
}

// Möller-Trumbore with inclusive bounds (src/scene.cpp:229-263).
__device__ __forceinline__ bool hit_triangle(const Ray& r, float tmin,
                                             float tmax, V3 v0, V3 v1, V3 v2,
                                             float* t_out) {
  V3 e1 = sub(v1, v0);
  V3 e2 = sub(v2, v0);
  V3 rv = cross(r.d, e2);
  float den = dot(rv, e1);
  float inv_den = 1.0f / (den == 0.0f ? 1.0f : den);
  V3 c = sub(r.o, v0);
  float w1 = dot(rv, c) * inv_den;
  V3 s = cross(c, e1);
  float w2 = dot(s, r.d) * inv_den;
  float t = dot(s, e2) * inv_den;
  *t_out = t;
  return den != 0.0f && w1 >= 0.0f && w1 <= 1.0f && w2 >= 0.0f &&
         w1 + w2 <= 1.0f && t >= tmin && t <= tmax;
}

// Point as a disk at the closest approach (src/scene.cpp:267-281).
__device__ __forceinline__ bool hit_point(const Ray& r, float tmin, float tmax,
                                          V3 p, float rad, float* t_out) {
  V3 w = sub(p, r.o);
  float t = dot(w, r.d) / dot(r.d, r.d);
  V3 rp = add(r.o, mul(r.d, t));
  V3 prp = sub(p, rp);
  *t_out = t;
  return t >= tmin && t <= tmax && dot(prp, prp) <= rad * rad;
}

// Capsule segment, radius lerped by s (src/scene.cpp:285-307).
__device__ __forceinline__ bool hit_line(const Ray& r, float tmin, float tmax,
                                         V3 v0, V3 v1, float r0, float r1,
                                         float* t_out) {
  V3 v = sub(v1, v0);
  V3 w = sub(r.o, v0);
  float a = dot(r.d, r.d);
  float b = dot(r.d, v);
  float c = dot(v, v);
  float d = dot(r.d, w);
  float e = dot(v, w);
  float det = a * c - b * b;
  float sdet = det == 0.0f ? 1.0f : det;
  float t = (b * e - c * d) / sdet;
  float s = clamp01((a * e - b * d) / sdet);
  V3 p0 = add(r.o, mul(r.d, t));
  V3 p1 = add(v0, mul(v, s));
  V3 p01 = sub(p0, p1);
  float rad = r0 * (1.0f - s) + r1 * s;
  *t_out = t;
  return det != 0.0f && t >= tmin && t <= tmax && dot(p01, p01) <= rad * rad;
}

// PCG output permutation (Jarzynski & Olano, "Hash Functions for GPU
// Rendering", JCGT 2020), as render/camera.py::pcg_hash computes it: u32
// arithmetic that wraps.
__device__ __forceinline__ unsigned int pcg_hash(unsigned int x) {
  x = x * 747796405u + 2891336453u;
  const unsigned int w = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (w >> 22u) ^ w;
}

// Variate k of ray id `id` under `seed` (render/camera.py::per_ray_uniform):
// the top 24 bits of pcg(id ^ pcg(seed + k)), times 2^-24 (both exact).
__device__ __forceinline__ float per_ray_uniform(unsigned int seed, int id,
                                                 unsigned int k) {
  const unsigned int h =
      pcg_hash(static_cast<unsigned int>(id) ^ pcg_hash(seed + k));
  return static_cast<float>(h >> 8u) * 5.9604644775390625e-08f;
}

__host__ __device__ inline unsigned int blocks_for(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// Deterministic batch sums of the camera reverses K6 and K9: kCamSlots
// values a ray (K6 leaves its 16th at 0), summed over n rays in one launch,
// in an order that depends on n alone, so the result repeats bit for bit on
// any card. A block of kCamThreads threads covers a tile of kCamThreads *
// kCamRays rays; thread t takes rays tile + t + kCamThreads * r, r <
// kCamRays (coalesced loads), and adds each ray's slots into registers in r
// order (camera_add_ray). camera_block_sums then reduces the block:
//   1. across the warp by recursive halving: against lane ^ 16 a lane trades
//      8 of its 16 slots and keeps the other 8, then 4 against lane ^ 8, 2
//      against lane ^ 4, 1 against lane ^ 2 and 1 against lane ^ 1: 16
//      shuffles where one tree a slot takes 80. Lanes 2s and 2s + 1 end with
//      slot s's warp sum, the sum of the tree lane + (lane ^ 16), then ^ 8,
//      ^ 4, ^ 2, ^ 1 (a float add is commutative, so every lane of a pair
//      holds the same bits);
//   2. the warps' sums, in warp order, into the block's partial, written
//      column-major, partials[slot * gridDim.x + block];
//   3. after a __threadfence each block adds 1 to *counter; the block that
//      comes last sums every column in block order (lane l the blocks l,
//      l + 32, ..., then the tree ^ 16, ..., ^ 1), one warp a column,
//      writes out[16] and sets *counter back to 0 for the next launch, so
//      two launches that share a counter must not overlap.
// The grid is ceil(n / (kCamThreads * kCamRays)) blocks, at least one, so
// n = 0 writes zeros. render/camera.py::ordered_camera_sums repeats this
// order with torch adds. 8 rays a thread and at most 64 registers (4
// blocks an SM) make 2^20 rays one wave of 512 blocks on an H100's 4 x 132
// places (PERF.md: 1 to 16 rays and 1 to 6 blocks were timed).
constexpr int kCamSlots = 16;
constexpr int kCamThreads = 256;
constexpr int kCamRays = 8;
constexpr int kCamMinBlocks = 4;
constexpr int kCamWarps = kCamThreads / 32;

__host__ __device__ inline int camera_blocks(int n) {
  const long long tile = static_cast<long long>(kCamThreads) * kCamRays;
  return n > 0 ? static_cast<int>((n + tile - 1) / tile) : 1;
}

// The id of ray r (< kCamRays) of this thread.
__device__ __forceinline__ int camera_ray(int r) {
  return blockIdx.x * (kCamThreads * kCamRays) + r * kCamThreads +
         static_cast<int>(threadIdx.x);
}

__device__ __forceinline__ void camera_add_ray(float (&acc)[kCamSlots],
                                               const float (&t)[kCamSlots]) {
#pragma unroll
  for (int j = 0; j < kCamSlots; ++j) acc[j] += t[j];
}

// One step of the warp's recursive halving: each lane keeps kHalf of its
// 2 kHalf slots (the upper ones where lane & 2 kHalf is set) and adds the
// lane ^ 2 kHalf's copy of them, which it trades for the other kHalf.
template <int kHalf>
__device__ __forceinline__ void camera_halve(float (&v)[kCamSlots], int lane) {
  const bool upper = (lane & (2 * kHalf)) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float send = upper ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * kHalf);
  }
}

__device__ __forceinline__ void camera_block_sums(float (&v)[kCamSlots],
                                                  float* __restrict__ partials,
                                                  float* __restrict__ out,
                                                  int* __restrict__ counter) {
  __shared__ float warp_sums[kCamWarps][kCamSlots];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // 1. 16 slots -> 8 -> 4 -> 2 -> 1 a lane, then the pair's sum
  camera_halve<8>(v, lane);
  camera_halve<4>(v, lane);
  camera_halve<2>(v, lane);
  camera_halve<1>(v, lane);
  const float s = v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
  if ((lane & 1) == 0) warp_sums[warp][lane >> 1] = s;
  __syncthreads();
  // 2. the block's partial, warps in order
  const int nb = gridDim.x;
  if (threadIdx.x < kCamSlots) {
    float p = 0.0f;
#pragma unroll
    for (int w = 0; w < kCamWarps; ++w) p += warp_sums[w][threadIdx.x];
    partials[threadIdx.x * nb + blockIdx.x] = p;
    __threadfence();
  }
  __syncthreads();
  // 3. the last block sums the partials
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == nb - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int c = warp; c < kCamSlots; c += kCamWarps) {
    const float* col = partials + c * nb;
    float t = 0.0f;
    for (int b = lane; b < nb; b += 32) t += __ldcg(col + b);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) out[c] = t;
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace yrt
