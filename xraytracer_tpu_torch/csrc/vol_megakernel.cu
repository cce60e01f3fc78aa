// Whole-path kernels of the homogeneous volume path tracer: one thread
// carries one volume path (or one pixel's whole run of samples) from the
// camera ray to its end without leaving registers.
//
// Replaces, in xraytracer_tpu/integrators/vol_megakernel.py:
//   vol_path            <- the kernel of try_make_fused_volume_integrator
//                          (over _vol_trace_body)
//   vol_spp             <- try_make_fused_volume_spp_render(persistent=False)
//                          (megakernel.py::_mega_spp_kernel over
//                          _vol_trace_body)
//   vol_spp_persistent  <- the same with persistent=True
//                          (_mega_spp_persistent_kernel over
//                          _make_vol_iteration)
// The lane code (the scene, `vol_bounce`, the two sample loops) is in
// vol_path.cuh; this file holds the three kernels and their extern "C"
// launchers.
//
// What bounds it on an H100: float32 operations (a pixel moves 12 B in and
// 16 B out per launch whatever the sample count; an iteration is ~400
// flops with two intersections and six expf), and of those the divisions,
// transcendentals and divergent branches the lanes of a warp serialise.
// vol_spp_persistent merges the sample loop into the iteration loop so that
// a lane starts its next sample at once; each lane still adds its own
// samples in ascending order, so its sums are those of vol_spp.
//
// K6a (vol_path) runs one thread per ray. Its launch on the vpt camera
// rays lasts about as long as its longest path (a chain of up to 22
// dependent iterations: the longest warp 0.0195 ms of a 0.024 ms launch,
// PERF.md section 6), so no order of the rays can shorten it much; a queue
// of rays taken by resident lanes measured 21% slower (a refill mixes rays
// that miss the box with rays that enter it in one warp). It reads the path
// keys as the callers hold them (uint32 values in int64, each one's low
// word), so they need no conversion around the launch: five tensor
// operations that took as long as the launch itself (PERF.md, section 6).
//
// A pixel's samples are one lane's sum in order, so a pixel is the smallest
// unit of work, and on the vpt preset 56% of the pixels reach the medium
// (paths of ~2.4 iterations a sample) while the others end after one. The
// spp launchers therefore take the lanes in a work order (order[i] = the
// view lane that grid lane i carries; integrators/vol_megakernel.py::
// work_order): the pixels with the longest chord through the medium first,
// those that cannot reach it last. A block then holds pixels of one kind,
// the long blocks are dispatched in the first waves and the short ones fill
// the last; each lane writes its own view lane, so the outputs are those of
// any other order, bit for bit. A queue of pixels taken by persistent lanes
// or warps, lanes that start samples at a warp vote, other block sizes and
// other register budgets were measured slower (PERF.md §6). No shared
// memory and no barrier.
//
// VOL_TIMELINE (a measurement build, compiled by chip_smoke.py only): every
// warp of the last launch writes the %globaltimer at its start and end and
// its %smid into a device buffer that vol_timeline copies out; vol_empty
// launches an empty kernel of a given grid (a launch's fixed cost).

#include "vol_path.cuh"

namespace xrt {

#ifdef VOL_TIMELINE
constexpr int VOL_TL_WARPS = 1 << 14;
__device__ unsigned long long vol_tl_time[2 * VOL_TL_WARPS];
__device__ unsigned vol_tl_sm[VOL_TL_WARPS];

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// lane 0 of a warp stamps its start (end = false) or its end
__device__ __forceinline__ void timeline_stamp(bool end) {
  __syncwarp();
  const int w = (blockIdx.x * VOL_BLOCK + threadIdx.x) >> 5;
  if ((threadIdx.x & 31) == 0 && w < VOL_TL_WARPS) {
    vol_tl_time[2 * w + (end ? 1 : 0)] = global_timer();
    if (!end) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      vol_tl_sm[w] = sm;
    }
  }
}
#define VOL_STAMP(end) timeline_stamp(end)

__global__ void __launch_bounds__(VOL_BLOCK) vol_empty_kernel() {}
#else
#define VOL_STAMP(end)
#endif

// K6a: one volume path per ray, one thread per ray. ``keys`` holds the
// rays' path keys as int32 words, one every ``key_stride`` words: 1 for
// int32 bits, 2 for the uint32 values the port keeps in int64 (the low word
// of each, little-endian as the card is: the same 32 bits).
__global__ void __launch_bounds__(VOL_BLOCK)
vol_path_kernel(VolScene S, const float* __restrict__ o,
                const float* __restrict__ d, const int32_t* __restrict__ keys,
                int key_stride, int n, float* __restrict__ out) {
  VOL_STAMP(false);
  const int i = blockIdx.x * VOL_BLOCK + threadIdx.x;
  if (i < n) {
    VolPath p;
    start_path(p);
    p.key = (uint32_t)keys[(size_t)i * key_stride];
    p.o = load3(o, i);
    p.d = load3(d, i);
    while (p.act && p.it < S.n_iterations) vol_bounce(S, p);
    out[3 * i + 0] = p.L.x;
    out[3 * i + 1] = p.L.y;
    out[3 * i + 2] = p.L.z;
  }
  VOL_STAMP(true);
}

// K6b: grid lane i carries the pixel of view lane order[i] and writes that
// view lane's sum.
__global__ void __launch_bounds__(VOL_BLOCK)
vol_spp_kernel(VolScene S, MegaCamera C, int s0, int n_spp,
               const int32_t* __restrict__ pixfold,
               const float* __restrict__ px, const float* __restrict__ py,
               const int32_t* __restrict__ order, int n,
               float* __restrict__ out_sum, int* __restrict__ out_rej) {
  VOL_STAMP(false);
  const int i = blockIdx.x * VOL_BLOCK + threadIdx.x;
  if (i < n) {
    const int j = order[i];
    float3 acc;
    int rej;
    vol_pixel_per_sample(S, C, (uint32_t)pixfold[j], px[j], py[j], s0, n_spp,
                         acc, rej);
    out_sum[3 * j + 0] = acc.x;
    out_sum[3 * j + 1] = acc.y;
    out_sum[3 * j + 2] = acc.z;
    out_rej[j] = rej;
  }
  VOL_STAMP(true);
}

// K6c: the same lane -> pixel map, each lane running the merged loop's
// passes for its pixel (vol_path.cuh: vol_lane_pass).
__global__ void __launch_bounds__(VOL_BLOCK)
vol_spp_persistent_kernel(VolScene S, MegaCamera C, int s0, int n_spp,
                          const int32_t* __restrict__ pixfold,
                          const float* __restrict__ px,
                          const float* __restrict__ py,
                          const int32_t* __restrict__ order, int n,
                          float* __restrict__ out_sum,
                          int* __restrict__ out_rej) {
  VOL_STAMP(false);
  const int i = blockIdx.x * VOL_BLOCK + threadIdx.x;
  if (i < n) {
    const int j = order[i];
    VolLane l;
    vol_lane_init(l, (uint32_t)pixfold[j], px[j], py[j]);
    const long long limit = vol_pass_limit(S, n_spp);
    while (!vol_lane_done(l, n_spp, limit)) vol_lane_pass(S, C, s0, l);
    out_sum[3 * j + 0] = l.acc.x;
    out_sum[3 * j + 1] = l.acc.y;
    out_sum[3 * j + 2] = l.acc.z;
    out_rej[j] = l.rej;
  }
  VOL_STAMP(true);
}

}  // namespace xrt

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = accepted).
// ``fc``, ``ic`` and ``cam16`` are HOST arrays (vol_scene_from; camera_from
// of path_common.cuh).

// ``key_stride``: 1 (int32 keys) or 2 (int64 keys, their low words).
int vol_path(const float* o, const float* d, const int32_t* keys,
             int key_stride, int n, const float* fc, const int* ic, float* out,
             void* stream) {
  if (n <= 0) return 0;
  if (key_stride != 1 && key_stride != 2) return (int)cudaErrorInvalidValue;
  const xrt::VolScene S = xrt::vol_scene_from(fc, ic);
  const int grid = (n + xrt::VOL_BLOCK - 1) / xrt::VOL_BLOCK;
  xrt::vol_path_kernel<<<grid, xrt::VOL_BLOCK, 0, (cudaStream_t)stream>>>(
      S, o, d, keys, key_stride, n, out);
  return (int)cudaGetLastError();
}

// ``order``: the work order, a permutation of the n view lanes (lane slot ->
// view lane).
int vol_spp(int s0, int n_spp, const int32_t* pixfold, const float* px,
            const float* py, int n, const float* cam16, unsigned cam_site,
            const float* fc, const int* ic, const int32_t* order,
            float* out_sum, int* out_rej, void* stream) {
  if (n <= 0) return 0;
  const xrt::VolScene S = xrt::vol_scene_from(fc, ic);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::VOL_BLOCK - 1) / xrt::VOL_BLOCK;
  xrt::vol_spp_kernel<<<grid, xrt::VOL_BLOCK, 0, (cudaStream_t)stream>>>(
      S, C, s0, n_spp, pixfold, px, py, order, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

int vol_spp_persistent(int s0, int n_spp, const int32_t* pixfold,
                       const float* px, const float* py, int n,
                       const float* cam16, unsigned cam_site, const float* fc,
                       const int* ic, const int32_t* order, float* out_sum,
                       int* out_rej, void* stream) {
  if (n <= 0) return 0;
  const xrt::VolScene S = xrt::vol_scene_from(fc, ic);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::VOL_BLOCK - 1) / xrt::VOL_BLOCK;
  xrt::vol_spp_persistent_kernel<<<grid, xrt::VOL_BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      S, C, s0, n_spp, pixfold, px, py, order, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

// The launchers' interface: 1 = the spp launchers take the work order; 2 =
// vol_path takes the keys' stride.
int vol_abi() { return 2; }

#ifdef VOL_TIMELINE
// The stamps of the last launch's first n_warps warps: t (2 per warp: start,
// end; ns) and sm (1 per warp); returns a cudaError_t.
int vol_timeline(unsigned long long* t, unsigned* sm, int n_warps) {
  if (n_warps > xrt::VOL_TL_WARPS) n_warps = xrt::VOL_TL_WARPS;
  cudaError_t e = cudaMemcpyFromSymbol(t, xrt::vol_tl_time,
                                       sizeof(unsigned long long) * 2 * n_warps);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(sm, xrt::vol_tl_sm, sizeof(unsigned) * n_warps);
  return (int)e;
}

// Resident blocks per SM of kernel ``which`` (0 vol_path, 1 vol_spp, 2
// vol_spp_persistent) at VOL_BLOCK threads; returns a cudaError_t.
int vol_occupancy(int which, int* blocks) {
  const void* k = which == 0 ? (const void*)xrt::vol_path_kernel
                : which == 1 ? (const void*)xrt::vol_spp_kernel
                             : (const void*)xrt::vol_spp_persistent_kernel;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k,
                                                            xrt::VOL_BLOCK, 0);
}

// An empty kernel on the grid of n lanes (VOL_BLOCK threads a block): the
// fixed cost of a launch of that shape; returns cudaGetLastError().
int vol_empty(int n, void* stream) {
  const int grid = (n + xrt::VOL_BLOCK - 1) / xrt::VOL_BLOCK;
  xrt::vol_empty_kernel<<<grid, xrt::VOL_BLOCK, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
