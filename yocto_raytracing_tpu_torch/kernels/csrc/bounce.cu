// K12: the glue of one bounce of the depth loop, on the device; K14: its
// reverse.
//
// Replaces the state update of the JAX package's depth loop,
// render/renderer.py::trace_rays' body (297-304: acc, cont, thr and the
// next ray) and its loop condition, jnp.any(st["active"]) (the
// while_loop's cond, 344-346, and the scan's lax.cond, 337-342). In the
// port's eager loop these are about eight torch ops and a host sync a
// bounce (render/renderer.py::bounce_update_plain and the loop's
// active.any()).
//
// One launch, one thread per ray:
//   acc    = acc + thr * color             (two roundings: --fmad=false)
//   cont   = mask & any(kr > 0)            (-0.0 and NaN are not > 0)
//   thr'   = cont ? thr * kr : thr
//   ro, rd = cont ? (p, refl_dir) : (0.0, 1.0)
//   tmax   = cont ? FLT_MAX : -FLT_MAX     (the next nearest-hit query's)
// which is bounce_update_plain's arithmetic, so every output is bit-equal
// to it, and *alive_out = 1 where any lane continues. The device loop
// keeps no active flags: tmax is where(active, FLT_MAX, -FLT_MAX), and K1
// answers a lane with tmax < tmin with no hit, so the next bounce's mask
// is its hit flag. Two forms: in place (yrt_bounce: thr' over thr, the
// next ray over the bounce's own; the frame's loop), and out of place
// (yrt_bounce_out: thr read from bounce k's slot, thr', ro and rd written
// into bounce k + 1's; the training step's loop, whose reverse reads every
// bounce's thr, ro and rd). acc and tmax are in place in both.
//
// The alive words. The device loop (render/renderer.py::frame_device)
// keeps one int a bounce, alive[0..max_depth], zeroed at the start of
// each chunk with alive[0] = 1; this kernel sets alive[k + 1] where any
// lane of bounce k goes on (a flag, which the order of the writes cannot
// change). Every launch of bounce k (K1 nearest, K4 prep, K1 any hit, K4
// finish and this kernel) reads alive[k] and returns at once when it is
// 0: a bounce with no active ray writes nothing, which is
// jax.lax.cond(any(active), body, identity) by construction, so a fixed
// max_depth of bounces gives the bits of the eager loop's early break,
// with no host sync.
//
// The chunk's CUDA graph skips a dead bounce whole. Bounce k >= 1 is
// captured into the body of a conditional IF node of its own (the nodes
// follow one another at the graph's top level), whose handle this kernel
// sets in bounce k - 1, where it sets alive[k]:
// cudaGraphSetConditional(next, 1), by the block that finds the word still
// 0. The handle resets to 0 at every launch of the graph
// (cudaGraphCondAssignDefault), so a bounce whose predecessor had no live
// lane, or did not run, launches nothing: no block of K1, K4 or K12 is
// scheduled. The handle is an argument (set_next = 0 outside a graph: an
// eager launch sets none). The training step's graph
// (render/renderer.py::loss_grads_device) has a second IF node for each
// bounce k >= 1, its reverse; the out-of-place form sets that handle
// (``rev``) beside the forward one, at the same point, so the reverse of a
// bounce runs exactly where its forward ran, and takes no launch of its
// own to decide. yrt_if_handle, yrt_if_begin and yrt_if_end below make
// the node inside a stream capture (CUDA 12.4 or later; before that they
// return cudaErrorNotSupported, and the frame raises).
//
// K14 (yrt_bounce_bwd) is the adjoint of the same glue, for the reverse of
// the training step's loop: from the cotangents of bounce k + 1's state
// (g_acc, the loss's, is the same at every bounce; g_thr', g_ro', g_rd')
// and bounce k's saved thr, color, kr and mask, one thread a ray writes,
// with g_sel = cont ? g_thr' : 0 (the transpose of the select, taken
// before the products, as JAX's transpose of thr' takes it):
//   g_color = g_acc * thr
//   g_kr    = g_sel * thr
//   g_p     = cont ? g_ro' : 0,   g_refl = cont ? g_rd' : 0
//   g_thr   = g_acc * color + (g_sel * kr + (cont ? 0 : g_thr'))  (in place)
// which K5 (shade_bwd.cu) takes as the cotangents of the bounce's shading.
// A lane that does not go on with an infinite thr or a NaN kr gets 0 * inf
// or 0 * NaN, NaN, where jax.vjp of the body's update and torch autograd
// of bounce_update_plain give NaN. It launches only in a live bounce (an
// IF node), so it reads no alive word.
//
// What bounds them on an H100: bytes. K12 reads color, kr, p, refl_dir,
// acc and thr (72 bytes) and mask (1) a ray, and writes acc, thr, ro and
// rd (48) and tmax (4); no reuse, so one pass over 125 bytes a ray at the
// memory rate. A launch under a zero word reads one word a block. K14
// reads g_acc, thr, color, kr and g_thr' (60 bytes) and mask (1) a ray,
// and g_ro' and g_rd' (24) where the lane goes on, and writes its five
// (N, 3) cotangents (60). The design: a thread per ray, the warp's loads
// of an (N, 3) array fall in 384 contiguous bytes, one vote per block for
// the alive word.
#include <cstdint>

#include "common.cuh"

#if CUDART_VERSION >= 12040
#define YRT_IF_NODES 1
#endif

namespace yrt {

constexpr int kBounceThreads = 256;

struct BounceIO {
  const float* __restrict__ color;
  const float* __restrict__ kr;
  const float* __restrict__ p;
  const float* __restrict__ refl;
  const uint8_t* __restrict__ mask;
  float* acc;
  const float* thr_in;  // bounce k's throughput
  float* thr;           // bounce k + 1's: thr_in itself in place
  float* ro;
  float* rd;
  float* tmax;
};

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ``set``: bit 0 sets the IF handle ``next`` (the next forward bounce's),
// bit 1 ``rev`` (its reverse's), where the launch sets alive_out
__global__ void __launch_bounds__(kBounceThreads)
    bounce_kernel(BounceIO io, int n, const int* __restrict__ alive_in,
                  int* __restrict__ alive_out, unsigned long long next,
                  unsigned long long rev, int set) {
  if (alive_in != nullptr && *alive_in == 0) return;  // a dead bounce
  const int i = blockIdx.x * kBounceThreads + threadIdx.x;
  bool cont = false;
  if (i < n) {
    const V3 color = load3(io.color, i);
    const V3 kr = load3(io.kr, i);
    const V3 thr = make(io.thr_in[3 * i], io.thr_in[3 * i + 1],
                        io.thr_in[3 * i + 2]);
    const V3 acc = make(io.acc[3 * i], io.acc[3 * i + 1], io.acc[3 * i + 2]);
    const V3 tc = make(thr.x * color.x, thr.y * color.y, thr.z * color.z);
    store3(io.acc, i, add(acc, tc));
    cont = io.mask[i] != 0 && (kr.x > 0.0f || kr.y > 0.0f || kr.z > 0.0f);
    if (cont) {
      store3(io.thr, i, make(thr.x * kr.x, thr.y * kr.y, thr.z * kr.z));
      store3(io.ro, i, load3(io.p, i));
      store3(io.rd, i, load3(io.refl, i));
    } else {
      if (io.thr != io.thr_in) store3(io.thr, i, thr);  // out of place
      store3(io.ro, i, make(0.0f, 0.0f, 0.0f));
      store3(io.rd, i, make(1.0f, 1.0f, 1.0f));
    }
    io.tmax[i] = cont ? kFltMax : -kFltMax;
  }
  // the block votes (threads past n with false), and one thread stores,
  // only where the word is not yet set: stores of every warp to one word
  // queue at its L2 slice (on an H100, a store per warp took a launch on
  // 524,288 random rays from 21 to 83 us). The block that sets the word
  // also sets the next bounce's IF nodes; a block that finds it set leaves
  // the handles to the block that set it.
  if (__syncthreads_or(cont) && threadIdx.x == 0 && alive_out != nullptr &&
      *alive_out == 0) {
    *alive_out = 1;
#ifdef YRT_IF_NODES
    if (set & 1) cudaGraphSetConditional(next, 1u);
    if (set & 2) cudaGraphSetConditional(rev, 1u);
#endif
  }
}

struct BounceBwdIO {
  const float* __restrict__ g_acc;
  const float* __restrict__ thr;
  const float* __restrict__ color;
  const float* __restrict__ kr;
  const uint8_t* __restrict__ mask;
  const float* __restrict__ g_ro;  // of bounce k + 1's ro, rd
  const float* __restrict__ g_rd;
  float* g_thr;  // in: of bounce k + 1's thr; out: of bounce k's
  float* __restrict__ g_color;
  float* __restrict__ g_kr;
  float* __restrict__ g_p;
  float* __restrict__ g_refl;
};

__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return make(a.x * b.x, a.y * b.y, a.z * b.z);
}

__global__ void __launch_bounds__(kBounceThreads)
    bounce_bwd_kernel(BounceBwdIO io, int n) {
  const int i = blockIdx.x * kBounceThreads + threadIdx.x;
  if (i >= n) return;
  const V3 ga = load3(io.g_acc, i);
  const V3 thr = load3(io.thr, i);
  const V3 color = load3(io.color, i);
  const V3 kr = load3(io.kr, i);
  const V3 gt = make(io.g_thr[3 * i], io.g_thr[3 * i + 1],
                     io.g_thr[3 * i + 2]);
  const bool cont =
      io.mask[i] != 0 && (kr.x > 0.0f || kr.y > 0.0f || kr.z > 0.0f);
  const V3 zero = make(0.0f, 0.0f, 0.0f);
  const V3 gsel = cont ? gt : zero;
  store3(io.g_color, i, vmul(ga, thr));
  store3(io.g_kr, i, vmul(gsel, thr));
  store3(io.g_p, i, cont ? load3(io.g_ro, i) : zero);
  store3(io.g_refl, i, cont ? load3(io.g_rd, i) : zero);
  store3(io.g_thr, i,
         add(vmul(ga, color), add(vmul(gsel, kr), cont ? zero : gt)));
}

#ifdef YRT_IF_NODES
// The graph that ``stream`` captures into, and its open ends.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, ndeps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorIllegalState;  // not capturing
  return err;
}
#endif

}  // namespace yrt

extern "C" int yrt_bounce(const float* color, const float* kr,
                          const float* p, const float* refl,
                          const uint8_t* mask, int n, float* acc, float* thr,
                          float* ro, float* rd, float* tmax,
                          const int* alive_in, int* alive_out,
                          unsigned long long next, int set_next,
                          void* stream) {
  if (n > 0) {
    const yrt::BounceIO io{color, kr,  p,  refl, mask, acc,
                           thr,   thr, ro, rd,   tmax};
    yrt::bounce_kernel<<<yrt::blocks_for(n, yrt::kBounceThreads),
                         yrt::kBounceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        io, n, alive_in, alive_out, next, 0, set_next ? 1 : 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// The out-of-place form: thr_in is bounce k's slot; thr_out, ro and rd are
// bounce k + 1's. ``set``: bit 0 sets ``next``, bit 1 ``rev``.
extern "C" int yrt_bounce_out(const float* color, const float* kr,
                              const float* p, const float* refl,
                              const uint8_t* mask, int n, float* acc,
                              const float* thr_in, float* thr_out, float* ro,
                              float* rd, float* tmax, const int* alive_in,
                              int* alive_out, unsigned long long next,
                              unsigned long long rev, int set,
                              void* stream) {
  if (thr_in == thr_out) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const yrt::BounceIO io{color,  kr,      p,  refl, mask, acc,
                           thr_in, thr_out, ro, rd,   tmax};
    yrt::bounce_kernel<<<yrt::blocks_for(n, yrt::kBounceThreads),
                         yrt::kBounceThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        io, n, alive_in, alive_out, next, rev, set);
  }
  return static_cast<int>(cudaGetLastError());
}

// K14: the reverse of a bounce's glue; g_thr in place.
extern "C" int yrt_bounce_bwd(const float* g_acc, const float* thr,
                              const float* color, const float* kr,
                              const uint8_t* mask, const float* g_ro,
                              const float* g_rd, float* g_thr,
                              float* g_color, float* g_kr, float* g_p,
                              float* g_refl, int n, void* stream) {
  if (n > 0) {
    const yrt::BounceBwdIO io{g_acc, thr,     color, kr,  mask, g_ro,
                              g_rd,  g_thr,   g_color, g_kr, g_p, g_refl};
    yrt::bounce_bwd_kernel<<<yrt::blocks_for(n, yrt::kBounceThreads),
                             yrt::kBounceThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(io, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// A handle for an IF node in the graph that ``stream`` captures into, 0
// at every launch of the graph until a kernel sets it.
extern "C" int yrt_if_handle(void* stream, unsigned long long* handle) {
#ifdef YRT_IF_NODES
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = yrt::capture_info(static_cast<cudaStream_t>(stream),
                                      &graph, &deps, &ndeps);
  cudaGraphConditionalHandle h = 0;
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                           cudaGraphCondAssignDefault);
  *handle = h;
  return static_cast<int>(err);
#else
  *handle = 0;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// Add an IF node on ``handle`` after what ``stream`` captured so far, make
// ``stream``'s next capture depend on it, and start capturing ``body`` (a
// stream of its own) into the node's body graph.
extern "C" int yrt_if_begin(void* stream, unsigned long long handle,
                            void* body) {
#ifdef YRT_IF_NODES
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = yrt::capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err == cudaSuccess)
    err = cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  return static_cast<int>(err);
#else
  (void)stream;
  (void)handle;
  (void)body;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

// End the capture of an IF node's body (the node keeps its graph).
extern "C" int yrt_if_end(void* body) {
#ifdef YRT_IF_NODES
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
#else
  (void)body;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
