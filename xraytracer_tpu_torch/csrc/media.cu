// Wavefront tracking kernels for one heterogeneous medium: one thread per
// lane runs its whole tracking loop.
//
// Replaces, in xraytracer_tpu/media_pallas.py:
//   track_sample         <- _sample_kernel        (over track_sample)
//   track_transmittance  <- _transmittance_kernel (over track_transmittance)
// The per-lane arithmetic is media.cuh (shared with any whole-path kernel
// that tracks); this file adds the loads, the stores and the launchers.
//
// track_sample: per lane, ray (o, d), the medium span [t0, t1], the path
// throughput (3), the path key and a mask -> where the lane stopped (t), its
// throughput multiplier (3), whether it scattered, and the loop step of the
// scatter (the caller draws the phase direction at that step's site). Masked
// lanes pass through: t = t1 + RAY_EPS, weight 1, no scatter.
// track_transmittance: per lane, two points, key and mask -> ratio-tracked
// transmittance (3); masked lanes get 1.
//
// What bounds them on an H100: of the two roofline bounds the float32
// operations one (a lane moves 49 B in and 21 B out, resp. 29 B and 12 B;
// the 64^3 grid is 1 MB, its corner rows 8 MB, both resident in the 50 MB
// L2; a lane that tracks costs ~32 flop per supergrid cell its span
// crosses and ~150 resp. ~70 per collision candidate). What keeps them away from that
// bound is latency: every candidate is a dependent chain of logf, its
// segment, one scattered 32-byte row load and expf, and the lanes of a warp
// leave the loop at different candidates. The design does the obvious
// things about that and no more: the supergrid walk stops where the ray
// leaves the span and its segments sit in the thread's column of a
// block-wide frame in shared memory, where a candidate finds its segment by
// a forward cursor (media.cuh's Walk; no frame in local memory), a density
// fetch is ONE 32-byte row of the corner-packed table (two float4 loads)
// instead of eight scattered loads, and there is no barrier, so a lane that
// is done costs nothing but its slot in the warp. Times against the
// operations bound are in PERF.md.

#include "media.cuh"

namespace xrt {

constexpr int MEDIA_BLOCK = 128;
static_assert(MEDIA_BLOCK == SEG_BLOCK, "the segment frames are laid out per block");

__global__ void __launch_bounds__(MEDIA_BLOCK)
track_sample_kernel(MediaGrid G, const float* __restrict__ o,
                    const float* __restrict__ d, const float* __restrict__ t0,
                    const float* __restrict__ t1, const float* __restrict__ tp,
                    const int32_t* __restrict__ keys,
                    const uint8_t* __restrict__ mask, int n, uint32_t site,
                    float* __restrict__ out_t, float* __restrict__ out_w,
                    uint8_t* __restrict__ out_scat,
                    int32_t* __restrict__ out_step) {
  const int i = blockIdx.x * MEDIA_BLOCK + threadIdx.x;
  if (i >= n) return;
  TrackResult R;
  if (mask[i]) {
    const float tpv[3] = {tp[3 * i], tp[3 * i + 1], tp[3 * i + 2]};
    R = track_sample(G, load3(o, i), load3(d, i), t0[i], t1[i], tpv,
                     (uint32_t)keys[i], site);
  } else {
    R.t = t1[i] + RAY_EPS_F;
    R.w[0] = R.w[1] = R.w[2] = 1.0f;
    R.scattered = 0;
    R.scat_step = 0;
  }
  out_t[i] = R.t;
  out_w[3 * i + 0] = R.w[0];
  out_w[3 * i + 1] = R.w[1];
  out_w[3 * i + 2] = R.w[2];
  out_scat[i] = (uint8_t)R.scattered;
  out_step[i] = R.scat_step;
}

__global__ void __launch_bounds__(MEDIA_BLOCK)
track_transmittance_kernel(MediaGrid G, const float* __restrict__ p1,
                           const float* __restrict__ p2,
                           const int32_t* __restrict__ keys,
                           const uint8_t* __restrict__ mask, int n,
                           uint32_t site, float* __restrict__ out_tr) {
  const int i = blockIdx.x * MEDIA_BLOCK + threadIdx.x;
  if (i >= n) return;
  float tr[3] = {1.0f, 1.0f, 1.0f};
  if (mask[i])
    track_transmittance(G, load3(p1, i), load3(p2, i), (uint32_t)keys[i], site,
                        tr);
  out_tr[3 * i + 0] = tr[0];
  out_tr[3 * i + 1] = tr[1];
  out_tr[3 * i + 2] = tr[2];
}

// The corner table of a live density grid (the analytic volume gradient's
// step packs its grid once and both passes read one 32-byte row per
// lookup): one thread per cell, eight loads (seven of them cached: the
// neighbours' cells), two float4 stores. No TPU kernel: it replaces the
// scene builder's packing (xraytracer_tpu/scene/builder.py:411-428), done
// on the host once per scene. Bound by bytes: 9 x cells x 4 B.
__global__ void __launch_bounds__(MEDIA_BLOCK)
pack_corners_kernel(const float* __restrict__ g, int nx, int ny, int nz,
                    float4* __restrict__ out) {
  const int cell = blockIdx.x * MEDIA_BLOCK + threadIdx.x;
  if (cell >= nx * ny * nz) return;
  float c[8];
  corner_row(g, nx, ny, nz, cell, c);
  out[2 * cell] = make_float4(c[0], c[1], c[2], c[3]);
  out[2 * cell + 1] = make_float4(c[4], c[5], c[6], c[7]);
}

}  // namespace xrt

extern "C" {

// Each launcher returns cudaGetLastError() after its launch (0 = accepted).
// ``fc`` and ``ic`` are HOST arrays (see grid_from).

int track_sample(const float* o, const float* d, const float* t0,
                 const float* t1, const float* tp, const int32_t* keys,
                 const uint8_t* mask, int n, unsigned site, const float* fc,
                 const int* ic, const float* density, const float* packed,
                 const float* super, float* out_t, float* out_w,
                 uint8_t* out_scat, int32_t* out_step, void* stream) {
  if (n <= 0) return 0;
  const xrt::MediaGrid G = xrt::grid_from(fc, ic, density, packed, super);
  const int grid = (n + xrt::MEDIA_BLOCK - 1) / xrt::MEDIA_BLOCK;
  xrt::track_sample_kernel<<<grid, xrt::MEDIA_BLOCK, 0, (cudaStream_t)stream>>>(
      G, o, d, t0, t1, tp, keys, mask, n, site, out_t, out_w, out_scat,
      out_step);
  return (int)cudaGetLastError();
}

int track_transmittance(const float* p1, const float* p2, const int32_t* keys,
                        const uint8_t* mask, int n, unsigned site,
                        const float* fc, const int* ic, const float* density,
                        const float* packed, const float* super, float* out_tr,
                        void* stream) {
  if (n <= 0) return 0;
  const xrt::MediaGrid G = xrt::grid_from(fc, ic, density, packed, super);
  const int grid = (n + xrt::MEDIA_BLOCK - 1) / xrt::MEDIA_BLOCK;
  xrt::track_transmittance_kernel<<<grid, xrt::MEDIA_BLOCK, 0,
                                    (cudaStream_t)stream>>>(
      G, p1, p2, keys, mask, n, site, out_tr);
  return (int)cudaGetLastError();
}

// ``out``: (nx * ny * nz, 8) float32, 16-byte aligned.
int pack_corners(const float* density, int nx, int ny, int nz, float* out,
                 void* stream) {
  const int cells = nx * ny * nz;
  if (cells <= 0) return 0;
  const int grid = (cells + xrt::MEDIA_BLOCK - 1) / xrt::MEDIA_BLOCK;
  xrt::pack_corners_kernel<<<grid, xrt::MEDIA_BLOCK, 0, (cudaStream_t)stream>>>(
      density, nx, ny, nz, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
