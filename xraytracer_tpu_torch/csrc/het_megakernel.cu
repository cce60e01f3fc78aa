// Whole-path kernels of the heterogeneous volume path tracer: one thread
// carries one volume path (or one pixel's whole run of samples) through the
// cloud, from the camera ray to its end.
//
// Replaces, in xraytracer_tpu/integrators/het_megakernel.py:
//   het_path            <- the kernel of try_make_fused_het_path_integrator
//                          (over _het_trace_body)
//   het_spp             <- try_make_fused_het_spp_render(persistent=False)
//                          (megakernel.py::_mega_spp_kernel over
//                          _het_trace_body)
//   het_spp_persistent  <- the same with persistent=True
//                          (_mega_spp_persistent_kernel over
//                          _make_het_iteration)
//   het_grad_path       <- the kernel of try_make_fused_het_value_and_grad
//                          (over _make_het_grad_iteration): pass B of the
//                          analytic volume gradient, below
// The lane's arithmetic (one iteration cut into phases, the per-lane
// loops) is het_path.cuh; this file holds the kernels around it and their
// extern "C" launchers, as vol_megakernel.cu does for the homogeneous box.
//
// The scene such a kernel takes: no triangles, exactly one box carrying the
// scene's one heterogeneous medium, at most 16 spheres, each purely emissive,
// at most 16 lights, all spheres. Spheres, box, lights and options travel BY
// VALUE as a launch argument (HetScene, under 1 KB); the density grid, its
// corner-packed rows and the supergrid stay in device memory and go by
// pointer (MediaGrid of media.cuh, as for the tracking kernels). Nothing is
// compiled per scene.
//
// What bounds it on an H100: float32 operations (a pixel moves 12 B in and
// 16 B out per launch whatever the sample count; the 1 MB grid and the
// supergrid stay in the 50 MB L2). An iteration in the cloud costs the
// supergrid walk of the tracking (~32 flop per supergrid cell the ray
// crosses) and ~150 flop per collision candidate, and about as much again
// for the shadow ray's transmittance. What keeps it from that bound is latency and
// divergence: every candidate is a dependent chain of logf, its segment, a
// 32-byte row load and expf; the lanes of a warp take different numbers of
// candidates, iterations and samples. The design: one thread per lane; the
// supergrid walk stops where the ray leaves the box, its segments sit in
// the thread's column of a block-wide frame in shared memory (38,912 bytes
// a block; media.cuh's Walk: no frame in local memory), and a candidate
// finds its segment by a forward cursor; no barrier; and in
// het_spp_persistent the sample loop merged into the iteration loop, so a
// lane whose path ends starts its next sample at once, while a warp steps a
// chain of candidates only while a quarter of its lanes are in it and the
// longer chains go on at the next turn (het_path.cuh). Each lane adds its
// own samples in ascending order, so het_spp and het_spp_persistent give
// the same sums.

// The analytic volume gradient (het_grad_path). Pass A is het_path under
// grad_sampling (roulette off, uniform channel pick): the image img of the
// rays. Pass B replays the same draws through the same het_bounce with a
// Replay hook that carries, per lane, the residual rfac_c = d loss / d img_c
// and the SUFFIX s_c = img_c minus the contributions emitted so far. Every
// factor of a tracking event multiplies exactly the contributions still to
// come, so the event's share of d loss / d density is sum_c rfac_c s_c
// d log(factor_c) / d density (media.cuh's SampleGrad, added into a dense
// float32 gradient grid by atomicAdd of the eight trilinear corners); a
// next-event contribution's transmittance events carry rfac_c x that
// contribution (TransGrad, on a second walk of the same candidates once tr
// is known); and d img_c / d Le_l sums T_c at an emission and
// T_c w_c tr_c f / pdf at a light sample, in the lane's column of 3L
// plane-major outputs (no atomics). The grad-sampling estimator is what
// makes the suffix form exact: a roulette or a throughput-weighted channel
// pick would make every later probability depend on the whole history.
// The replay takes every decision pass A took, by the same explicit
// rounding; chip_smoke.py holds pass B's recomputed radiance against pass
// A's on every lane. The grid is summed with atomics, so its last bits
// vary from run to run.

#include "het_path.cuh"

// Blocks per SM the compiler must leave room for (the second argument of
// __launch_bounds__): 5, the most blocks the segment frames (38,912 bytes a
// block, media.cuh) leave room for in an SM's shared memory; 5 blocks of
// 128 threads cap a thread at 96 registers (K9c and K10 spill 72 and 48
// bytes). PERF.md records what other caps measured.
#ifndef HET_MIN_BLOCKS
#define HET_MIN_BLOCKS 5
#endif

namespace xrt {

constexpr int HET_BLOCK = 128;
static_assert(HET_BLOCK == SEG_BLOCK, "the segment frames are laid out per block");

__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_path_kernel(HetScene S, MediaGrid G, const float* __restrict__ o,
                const float* __restrict__ d, const int32_t* __restrict__ keys,
                int n, float* __restrict__ out) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  NoReplay none;
  const float3 L =
      het_path_lane(S, G, (uint32_t)keys[i], load3(o, i), load3(d, i), none);
  out[3 * i + 0] = L.x;
  out[3 * i + 1] = L.y;
  out[3 * i + 2] = L.z;
}

__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_spp_kernel(HetScene S, MediaGrid G, MegaCamera C, int s0, int n_spp,
               const int32_t* __restrict__ pixfold,
               const float* __restrict__ px, const float* __restrict__ py,
               int n, float* __restrict__ out_sum, int* __restrict__ out_rej) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  het_spp_lane(S, G, C, s0, n_spp, (uint32_t)pixfold[i], px[i], py[i], acc,
               rej);
  out_sum[3 * i + 0] = acc.x;
  out_sum[3 * i + 1] = acc.y;
  out_sum[3 * i + 2] = acc.z;
  out_rej[i] = rej;
}

__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_spp_persistent_kernel(HetScene S, MediaGrid G, MegaCamera C, int s0,
                          int n_spp, const int32_t* __restrict__ pixfold,
                          const float* __restrict__ px,
                          const float* __restrict__ py, int n,
                          float* __restrict__ out_sum,
                          int* __restrict__ out_rej) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  het_spp_persistent_lane(S, G, C, s0, n_spp, (uint32_t)pixfold[i], px[i],
                          py[i], acc, rej);
  out_sum[3 * i + 0] = acc.x;
  out_sum[3 * i + 1] = acc.y;
  out_sum[3 * i + 2] = acc.z;
  out_rej[i] = rej;
}

// Pass B of the analytic volume gradient: one path per ray, replayed from
// pass A's radiance ``img`` with the residual ``rfac`` (both (n, 3)); writes
// the recomputed radiance, the lane's column of the (3 n_lights, n)
// d img / d Le planes and adds into ``grad`` (the grid's shape, zeroed by
// the caller).
__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_grad_path_kernel(HetScene S, MediaGrid G, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const int32_t* __restrict__ keys,
                     const float* __restrict__ img,
                     const float* __restrict__ rfac, int n,
                     float* __restrict__ out, float* __restrict__ dE,
                     float* __restrict__ grad) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  Replay rep;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rep.rfac[c] = rfac[3 * i + c];
    rep.suffix[c] = img[3 * i + c];
  }
  rep.dE = dE + i;
  rep.n = (size_t)n;
  rep.n_lights = S.n_lights;
  rep.grad = grad;
  for (int k = 0; k < 3 * S.n_lights; ++k) rep.dE[(size_t)k * n] = 0.f;
  const float3 L =
      het_path_lane(S, G, (uint32_t)keys[i], load3(o, i), load3(d, i), rep);
  out[3 * i + 0] = L.x;
  out[3 * i + 1] = L.y;
  out[3 * i + 2] = L.z;
}

}  // namespace xrt

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = accepted).
// ``fc``, ``ic``, ``mfc``, ``mic`` and ``cam16`` are HOST arrays
// (het_scene_from; grid_from of media.cuh; camera_from of path_common.cuh);
// ``density``, ``packed`` and ``super`` are the grid's device tables.

int het_path(const float* o, const float* d, const int32_t* keys, int n,
             const float* fc, const int* ic, const float* mfc, const int* mic,
             const float* density, const float* packed, const float* super,
             float* out, void* stream) {
  if (n <= 0) return 0;
  const xrt::HetScene S = xrt::het_scene_from(fc, ic);
  const xrt::MediaGrid G = xrt::grid_from(mfc, mic, density, packed, super);
  const int grid = (n + xrt::HET_BLOCK - 1) / xrt::HET_BLOCK;
  xrt::het_path_kernel<<<grid, xrt::HET_BLOCK, 0, (cudaStream_t)stream>>>(
      S, G, o, d, keys, n, out);
  return (int)cudaGetLastError();
}

int het_spp(int s0, int n_spp, const int32_t* pixfold, const float* px,
            const float* py, int n, const float* cam16, unsigned cam_site,
            const float* fc, const int* ic, const float* mfc, const int* mic,
            const float* density, const float* packed, const float* super,
            float* out_sum, int* out_rej, void* stream) {
  if (n <= 0) return 0;
  const xrt::HetScene S = xrt::het_scene_from(fc, ic);
  const xrt::MediaGrid G = xrt::grid_from(mfc, mic, density, packed, super);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::HET_BLOCK - 1) / xrt::HET_BLOCK;
  xrt::het_spp_kernel<<<grid, xrt::HET_BLOCK, 0, (cudaStream_t)stream>>>(
      S, G, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

int het_spp_persistent(int s0, int n_spp, const int32_t* pixfold,
                       const float* px, const float* py, int n,
                       const float* cam16, unsigned cam_site, const float* fc,
                       const int* ic, const float* mfc, const int* mic,
                       const float* density, const float* packed,
                       const float* super, float* out_sum, int* out_rej,
                       void* stream) {
  if (n <= 0) return 0;
  const xrt::HetScene S = xrt::het_scene_from(fc, ic);
  const xrt::MediaGrid G = xrt::grid_from(mfc, mic, density, packed, super);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::HET_BLOCK - 1) / xrt::HET_BLOCK;
  xrt::het_spp_persistent_kernel<<<grid, xrt::HET_BLOCK, 0,
                                   (cudaStream_t)stream>>>(
      S, G, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

int het_grad_path(const float* o, const float* d, const int32_t* keys,
                  const float* img, const float* rfac, int n, const float* fc,
                  const int* ic, const float* mfc, const int* mic,
                  const float* density, const float* packed,
                  const float* super, float* out, float* dE, float* grad,
                  void* stream) {
  if (n <= 0) return 0;
  const xrt::HetScene S = xrt::het_scene_from(fc, ic);
  const xrt::MediaGrid G = xrt::grid_from(mfc, mic, density, packed, super);
  const int grid = (n + xrt::HET_BLOCK - 1) / xrt::HET_BLOCK;
  xrt::het_grad_path_kernel<<<grid, xrt::HET_BLOCK, 0,
                              (cudaStream_t)stream>>>(
      S, G, o, d, keys, img, rfac, n, out, dE, grad);
  return (int)cudaGetLastError();
}

// What the compiler gave kernel ``which`` (0 het_path, 1 het_spp,
// 2 het_spp_persistent, 3 het_grad_path): out = registers per thread,
// local memory (stack) bytes per thread, static shared bytes per block,
// the largest block size it can launch. Returns cudaFuncGetAttributes'
// error code.
int het_kernel_attrs(int which, int* out) {
  const void* fns[4] = {(const void*)xrt::het_path_kernel,
                        (const void*)xrt::het_spp_kernel,
                        (const void*)xrt::het_spp_persistent_kernel,
                        (const void*)xrt::het_grad_path_kernel};
  if (which < 0 || which > 3) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t rc = cudaFuncGetAttributes(&a, fns[which]);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  return 0;
}

}  // extern "C"
