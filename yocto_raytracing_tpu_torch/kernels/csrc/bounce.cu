// K12: the glue of one bounce of the depth loop, on the device.
//
// Replaces the state update of the JAX package's depth loop,
// render/renderer.py::trace_rays' body (297-304: acc, cont, thr and the
// next ray) and its loop condition, jnp.any(st["active"]) (the
// while_loop's cond, 344-346, and the scan's lax.cond, 337-342). In the
// port's eager loop these are about eight torch ops and a host sync a
// bounce (render/renderer.py::bounce_update_plain and the loop's
// active.any()).
//
// One launch, one thread per ray, in place on the loop's state:
//   acc    = acc + thr * color             (two roundings: --fmad=false)
//   cont   = mask & any(kr > 0)            (-0.0 and NaN are not > 0)
//   thr    = cont ? thr * kr : thr
//   ro, rd = cont ? (p, refl_dir) : (0.0, 1.0)
//   tmax   = cont ? FLT_MAX : -FLT_MAX     (the next nearest-hit query's)
// which is bounce_update_plain's arithmetic, so every output is bit-equal
// to it, and *alive_out = 1 where any lane continues. The device loop
// keeps no active flags: tmax is where(active, FLT_MAX, -FLT_MAX), and K1
// answers a lane with tmax < tmin with no hit, so the next bounce's mask
// is its hit flag.
//
// The alive words. The device loop (render/renderer.py::frame_device)
// keeps one int a bounce, alive[0..max_depth], zeroed at the start of
// each chunk with alive[0] = 1. Every launch of bounce k (K1 nearest, K4
// prep, K1 any hit, K4 finish and this kernel) reads alive[k] and returns
// at once when it is 0: a bounce with no active ray writes nothing, which
// is jax.lax.cond(any(active), body, identity) by construction, so a fixed
// max_depth of bounces gives the bits of the eager loop's early break,
// with no host sync. This kernel sets alive[k + 1]: a flag, which the
// order of the writes cannot change.
//
// What bounds it on an H100: bytes. Per ray it reads color, kr, p,
// refl_dir, acc and thr (72 bytes) and mask (1), and writes acc, thr, ro
// and rd (48) and tmax (4); no reuse, so one pass over 125 bytes a ray at
// the memory rate. A skipped launch reads one word a block. The design: a
// thread per ray, the warp's loads of an (N, 3) array fall in 384
// contiguous bytes, one vote per block for the alive word.
#include <cstdint>

#include "common.cuh"

namespace yrt {

constexpr int kBounceThreads = 256;

struct BounceIO {
  const float* __restrict__ color;
  const float* __restrict__ kr;
  const float* __restrict__ p;
  const float* __restrict__ refl;
  const uint8_t* __restrict__ mask;
  float* acc;
  float* thr;
  float* ro;
  float* rd;
  float* tmax;
};

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__global__ void __launch_bounds__(kBounceThreads)
    bounce_kernel(BounceIO io, int n, const int* __restrict__ alive_in,
                  int* __restrict__ alive_out) {
  if (alive_in != nullptr && *alive_in == 0) return;  // a dead bounce
  const int i = blockIdx.x * kBounceThreads + threadIdx.x;
  bool cont = false;
  if (i < n) {
    const V3 color = load3(io.color, i);
    const V3 kr = load3(io.kr, i);
    const V3 thr = make(io.thr[3 * i], io.thr[3 * i + 1], io.thr[3 * i + 2]);
    const V3 acc = make(io.acc[3 * i], io.acc[3 * i + 1], io.acc[3 * i + 2]);
    const V3 tc = make(thr.x * color.x, thr.y * color.y, thr.z * color.z);
    store3(io.acc, i, add(acc, tc));
    cont = io.mask[i] != 0 && (kr.x > 0.0f || kr.y > 0.0f || kr.z > 0.0f);
    if (cont) {
      store3(io.thr, i, make(thr.x * kr.x, thr.y * kr.y, thr.z * kr.z));
      store3(io.ro, i, load3(io.p, i));
      store3(io.rd, i, load3(io.refl, i));
    } else {
      store3(io.ro, i, make(0.0f, 0.0f, 0.0f));
      store3(io.rd, i, make(1.0f, 1.0f, 1.0f));
    }
    io.tmax[i] = cont ? kFltMax : -kFltMax;
  }
  // the block votes (threads past n with false), and one thread stores,
  // only where the word is not yet set: stores of every warp to one word
  // queue at its L2 slice (on an H100, a store per warp took a launch on
  // 524,288 random rays from 21 to 83 us)
  if (__syncthreads_or(cont) && threadIdx.x == 0 && alive_out != nullptr &&
      *alive_out == 0)
    *alive_out = 1;
}

}  // namespace yrt

extern "C" int yrt_bounce(const float* color, const float* kr,
                          const float* p, const float* refl,
                          const uint8_t* mask, int n, float* acc, float* thr,
                          float* ro, float* rd, float* tmax,
                          const int* alive_in, int* alive_out, void* stream) {
  if (n > 0) {
    const yrt::BounceIO io{color, kr, p, refl, mask, acc, thr, ro, rd, tmax};
    yrt::bounce_kernel<<<yrt::blocks_for(n, yrt::kBounceThreads),
                         yrt::kBounceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(io, n, alive_in,
                                                              alive_out);
  }
  return static_cast<int>(cudaGetLastError());
}
