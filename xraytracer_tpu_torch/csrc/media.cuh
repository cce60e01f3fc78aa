// Heterogeneous-medium tracking on one lane: trilinear density, the
// supergrid DDA, the optical-depth inversion, weighted delta tracking and
// ratio-tracked transmittance. Device functions, and the host function that
// assembles a MediaGrid; media.cu wraps them into the wavefront kernels, and
// the whole-path heterogeneous kernels of het_megakernel.cu include this
// header for the same arithmetic.
//
// Replaces, in xraytracer_tpu/media_pallas.py: _density_rows, _super_rows,
// _dda_segments, _tau_to_t, _pick_channel, track_sample and
// track_transmittance. What those did only for the TPU has no counterpart
// here: the bf16 brick table and its one-hot matmul extraction (a corner is
// a load from the float32 grid), the one-hot selects over the 25 segments
// and their fixed-length walk (here the walk stops where the ray leaves the
// span, and a candidate finds its segment by a forward cursor: Walk below),
// (8, 512) planes and tile-uniform loop exits (a lane is a thread and
// leaves when it is done).
//
// Parity with the plain version (xraytracer_tpu_torch/media.py) is by
// construction, not by tolerance, wherever a DISCRETE decision hangs on the
// value: escape (tau_new > tau_total), scatter or null (u < p_s), the
// channel pick (c1 < u), the DDA's exit axis and the segment a candidate
// falls in. nvcc contracts a * b + c into one fused multiply-add, which
// rounds once where the plain version's separate tensor operations round
// twice; one flipped decision moves a whole path. So every product that
// feeds an addition or a subtraction on the way to such a decision is
// written with __fmul_rn (and the sums that the plain version writes out in
// an order with __fadd_rn in that order; XM and XA of path_common.cuh): those
// are never contracted.
// Divisions, logf, expf, sqrtf and floorf are the accurate ones (no
// fast-math). The weights only follow the decisions; they take the same
// care where it is free and are compared at a tolerance.
//
// Both tracking loops are cut into a set-up and one collision candidate per
// call (sample_begin / sample_step, trans_begin / trans_step), so that a
// whole-path kernel can hold a lane's chain between two candidates and take
// it up later; track_sample and track_transmittance run the whole loop. What bounds a loop on an H100 is
// the dependent chain of each candidate (logf, the segment, a 32-byte row
// load, expf) and the lanes' different chain lengths, not bytes or
// operations. The walk's segments (76 floats a thread) are a column of a
// block-wide frame in shared memory; the loops' state lives in registers.
//
// Both tracking loops are templates over a per-event hook. NoTrackGrad's
// hook is empty and compiles away (K7, K8 and K9 instantiate it); the
// gradient hooks of the analytic volume gradient (het_megakernel.cu's
// het_grad_path) add, at every collision candidate, the event's closed-form
// d log(factor) / d density times a per-channel coefficient into a dense
// float32 gradient grid, by atomicAdd of the eight trilinear corners. They
// replace, in xraytracer_tpu/media_pallas.py: track_sample_grad,
// track_transmittance_grad, _dps_channels and _scatter_rows (the one-hot
// matmul scatter into a brick accumulator, unbricked afterwards: here one
// atomic add per corner into the grid itself).
#pragma once

#include "path_common.cuh"

namespace xrt {

constexpr int DDA_SEGMENTS = 24;    // media.py::_DDA_SEGMENTS
constexpr int SITES_PER_STEP = 4;   // media.py::SITES_PER_STEP

// One heterogeneous medium over the scene's density grid. The float fields
// are computed on the host in float32 by the same operations as the plain
// version computes them on tensors.
struct MediaGrid {
  const float* density;  // (nx, ny, nz)
  const float* packed;   // (nx * ny * nz, 8) corner rows, or null
  const float* super;    // (nbx * nby * nbz,) block max density
  float gmin[3], gmax[3];
  float ext[3];     // gmax - gmin
  float res_m1[3];  // resolution - 1
  float scale[3];   // res_m1 / (ext == 0 ? 1 : ext)
  float bs[3];      // supergrid block edge in index units
  float nbf_m1[3];  // block count - 1
  int res[3];
  int nb[3];
  float sigma_a[3], sigma_s[3];
  float sigma_t[3];  // sigma_a + sigma_s
  float sigma_t_max;
  float majorant;
  float dm;  // density multiplier
  int chan_uniform;
  int max_steps;
};

__device__ __forceinline__ float grid_axis(const MediaGrid& G, int k, float p,
                                           int& i0) {
  float x = (p - G.gmin[k]) / G.ext[k] * G.res_m1[k];
  x = fminf(fmaxf(x, 0.f), G.res_m1[k]);
  const float x0 = floorf(x);
  i0 = (int)x0;
  return x - x0;
}

// media.py::density_lookup: corner d = dx*4 + dy*2 + dz, weight
// (wx[dx] * wy[dy]) * wz[dz], the eight products added for d = 0 .. 7.
__device__ __forceinline__ float density(const MediaGrid& G, float3 p) {
  const bool inside = (p.x >= G.gmin[0]) & (p.x <= G.gmax[0]) &
                      (p.y >= G.gmin[1]) & (p.y <= G.gmax[1]) &
                      (p.z >= G.gmin[2]) & (p.z <= G.gmax[2]);
  if (!inside) return 0.f;
  int ix, iy, iz;
  const float fx = grid_axis(G, 0, p.x, ix);
  const float fy = grid_axis(G, 1, p.y, iy);
  const float fz = grid_axis(G, 2, p.z, iz);
  float c[8];
  if (G.packed != nullptr) {
    const size_t row = ((size_t)ix * G.res[1] + iy) * G.res[2] + iz;
    const float4* r = reinterpret_cast<const float4*>(G.packed) + row * 2;
    const float4 a = __ldg(r), b = __ldg(r + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  } else {
    const int jx = min(ix + 1, G.res[0] - 1);
    const int jy = min(iy + 1, G.res[1] - 1);
    const int jz = min(iz + 1, G.res[2] - 1);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int x = (d & 4) ? jx : ix, y = (d & 2) ? jy : iy,
                z = (d & 1) ? jz : iz;
      c[d] = __ldg(G.density + ((size_t)x * G.res[1] + y) * G.res[2] + z);
    }
  }
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
  float val = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const float w = XM(XM(wx[(d >> 2) & 1], wy[(d >> 1) & 1]), wz[d & 1]);
    const float term = XM(c[d], w);
    val = d == 0 ? term : XA(val, term);
  }
  return val;
}

__device__ __forceinline__ float exit_time(float v, float v_safe, float lo,
                                           float hi, float a) {
  if (v > 1e-20f) return (hi - a) / v_safe;
  if (v < -1e-20f) return (lo - a) / v_safe;
  return INFINITY;
}

// Threads per block of every kernel that tracks (media.cu, het_megakernel.cu
// assert it): the segment frames are laid out by it.
constexpr int SEG_BLOCK = 128;
constexpr int SEG_FLOATS = 3 * (DDA_SEGMENTS + 1) + 1;  // t, m: 25; tau: 26

// This thread's segment frame: a column of a block-wide array in shared
// memory, element j at [j][threadIdx.x], so that a warp's 32 lanes hit 32
// banks (38,912 bytes per block). One frame serves all of a thread's walks,
// one walk at a time.
__device__ __forceinline__ float* seg_frame() {
  __shared__ float frame[SEG_FLOATS * SEG_BLOCK];
  return frame + threadIdx.x;
}

// media.py::_majorant_segments and _tau_to_t: the integer-walk DDA through
// the supergrid over [t0f, t1f] (24 segments and a global-majorant tail;
// tau is the left-to-right running sum of majorant x length) into the
// thread's frame, and a cursor over it.
//
// The walk stops where the ray leaves the span: once a segment starts at
// t1f, it and every later one (the tail included) has length 0 and
// majorant 0, so the plain version's later edges all equal this one's tau,
// and its segment search, "the last edge <= tau", gives this segment's t,
// m and tau for any tau at or past it; segment n is the walk's last. Within
// one tracking loop the queried tau never decreases (a candidate adds
// -log(1 - u) >= 0), so the search is a cursor that only moves forward,
// across runs of equal edges too (empty supercells, m = 0).
struct Walk {
  float* f;  // the frame
  int k;     // the cursor: the segment of the last query
  int n;     // the last segment (its end is t1f)

  __device__ __forceinline__ float& t(int j) const { return f[j * SEG_BLOCK]; }
  __device__ __forceinline__ float& m(int j) const {
    return f[(DDA_SEGMENTS + 1 + j) * SEG_BLOCK];
  }
  __device__ __forceinline__ float& tau(int j) const {
    return f[(2 * (DDA_SEGMENTS + 1) + j) * SEG_BLOCK];
  }

  // Returns the walk's whole optical depth.
  __device__ __forceinline__ float begin(const MediaGrid& G, float3 o,
                                         float3 d, float t0f, float t1f) {
    f = seg_frame();
    const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
    float a[3], v[3], v_safe[3], b[3], sgn[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = XM(oo[c] - G.gmin[c], G.scale[c]);
      v[c] = XM(dd[c], G.scale[c]);
      v_safe[c] = fabsf(v[c]) < 1e-20f ? 1e-20f : v[c];
      sgn[c] = v[c] >= 0.f ? 1.0f : -1.0f;
      const float x0 = XA(a[c], XM(t0f, v[c]));
      b[c] = fminf(fmaxf(floorf(x0 / G.bs[c]), 0.f), G.nbf_m1[c]);
    }
    float t_cur = t0f, tau_cur = 0.f;
    tau(0) = 0.f;
    n = DDA_SEGMENTS;
    for (int s = 0; s < DDA_SEGMENTS; ++s) {
      if (!(t_cur < t1f)) {  // the ray has left the span: the rest is empty
        n = s;
        break;
      }
      const int flat = ((int)b[0] * G.nb[1] + (int)b[1]) * G.nb[2] + (int)b[2];
      const float m_loc = XM(XM(__ldg(G.super + flat), G.dm), G.sigma_t_max);
      float e[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        e[c] = exit_time(v[c], v_safe[c], XM(b[c], G.bs[c]),
                         XM(b[c] + 1.0f, G.bs[c]), a[c]);
      const float t_hi = fminf(fminf(e[0], e[1]), e[2]);
      // exit axis: the first minimum (x, then y, then z)
      const bool step_x = (e[0] <= e[1]) & (e[0] <= e[2]);
      const bool step_y = !step_x & (e[1] <= e[2]);
      const int ax = step_x ? 0 : (step_y ? 1 : 2);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (c == ax) b[c] = fminf(fmaxf(b[c] + sgn[c], 0.f), G.nbf_m1[c]);
      const float t_nxt = fminf(fmaxf(t_hi, t_cur), t1f);
      t(s) = t_cur;
      m(s) = m_loc;
      tau_cur = XA(tau_cur, XM(m_loc, fmaxf(t_nxt - t_cur, 0.f)));
      tau(s + 1) = tau_cur;
      t_cur = t_nxt;
    }
    // the last segment: the global-majorant tail over what the 24 left,
    // or the empty rest of the span
    const float m_last = (n == DDA_SEGMENTS && t_cur < t1f) ? G.majorant : 0.f;
    t(n) = t_cur;
    m(n) = m_last;
    tau_cur = XA(tau_cur, XM(m_last, fmaxf(t1f - t_cur, 0.f)));
    tau(n + 1) = tau_cur;
    k = 0;
    return tau_cur;
  }

  // The point of optical depth tau_q (>= every earlier query of this walk)
  // and its segment's majorant.
  __device__ __forceinline__ float locate(float tau_q, float& m_loc) {
    while (k < n && tau(k + 1) <= tau_q) ++k;
    m_loc = m(k);
    return t(k) + (tau_q - tau(k)) / (m_loc <= 0.f ? 1.0f : m_loc);
  }
};

__device__ __forceinline__ float3 ray_at(float3 o, float3 d, float t) {
  return make_float3(XA(o.x, XM(t, d.x)), XA(o.y, XM(t, d.y)),
                     XA(o.z, XM(t, d.z)));
}

// The hook of a tracking loop that computes no gradient.
struct NoTrackGrad {
  static constexpr bool on = false;
};

// grad[corner] += trilinear weight x coeff for the eight corners of the
// lookup at p (density()'s corners and weights); nothing outside the grid.
__device__ __forceinline__ void scatter_corners(const MediaGrid& G,
                                                float* __restrict__ grad,
                                                float3 p, float coeff) {
  const bool inside = (p.x >= G.gmin[0]) & (p.x <= G.gmax[0]) &
                      (p.y >= G.gmin[1]) & (p.y <= G.gmax[1]) &
                      (p.z >= G.gmin[2]) & (p.z <= G.gmax[2]);
  if (!inside || coeff == 0.f) return;
  int ix, iy, iz;
  const float fx = grid_axis(G, 0, p.x, ix);
  const float fy = grid_axis(G, 1, p.y, iy);
  const float fz = grid_axis(G, 2, p.z, iz);
  const int jx = min(ix + 1, G.res[0] - 1);
  const int jy = min(iy + 1, G.res[1] - 1);
  const int jz = min(iz + 1, G.res[2] - 1);
  const float wx[2] = {1.0f - fx, fx};
  const float wy[2] = {1.0f - fy, fy};
  const float wz[2] = {1.0f - fz, fz};
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int x = (d & 4) ? jx : ix, y = (d & 2) ? jy : iy,
              z = (d & 1) ? jz : iz;
    const float w = XM(XM(wx[(d >> 2) & 1], wy[(d >> 1) & 1]), wz[d & 1]);
    atomicAdd(grad + ((size_t)x * G.res[1] + y) * G.res[2] + z, w * coeff);
  }
}

// The gradient hook of track_sample (media_pallas.py::track_sample_grad):
// rs[c] = residual_c x suffix_c, the loss's weight on every contribution
// this event's factor multiplies. At a scatter or null collision at p with
// picked channel c*, coeff = sum_c rs[c] * slog_c, the derivative w.r.t.
// the raw trilinear value (dens = value x D) of
//   scatter: log(sig_s_c / pdf_sc) + log ratio(p_s_c*)
//   null:    log(sig_n_c / pdf_nl) + log ratio(1 - p_s_c*)
// where ratio is media.py::_score_ratio (no score at or below 1e-5) and the
// derivatives follow the clamp sig_n = max(., 0) (0 where it clamps; the
// plain version's torch.maximum gives 1/2 at an exact tie, sig_n == 0).
// Escapes depend on the majorants alone and add nothing.
struct SampleGrad {
  static constexpr bool on = true;
  float* grad;
  float rs[3];

  __device__ __forceinline__ void event(const MediaGrid& G, float3 p,
                                        bool scat, int channel,
                                        const float base[3],
                                        const float sig_s[3],
                                        const float sig_n[3],
                                        const float q[3], float p_s_c,
                                        float pdf_safe) const {
    const float D = G.dm;
    float dps[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dps[k] = sig_n[k] > 0.f
                   ? (G.sigma_s[k] * D * q[k] + G.sigma_a[k] * D * sig_s[k]) /
                         (q[k] * q[k])
                   : 0.f;
    const float dpdf_sc = base[0] * dps[0] + base[1] * dps[1] + base[2] * dps[2];
    const float dps_c = channel == 0 ? dps[0] : (channel == 1 ? dps[1] : dps[2]);
    float coeff = 0.f;
    if (scat) {
      const float score = p_s_c > 1e-5f ? dps_c / p_s_c : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float dlog = (sig_s[k] > 0.f ? G.sigma_s[k] * D / sig_s[k] : 0.f) -
                           dpdf_sc / pdf_safe + score;
        coeff += rs[k] * dlog;
      }
    } else {
      const float one_m = 1.0f - p_s_c;
      const float score = one_m > 1e-5f ? -dps_c / one_m : 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float dlog =
            (sig_n[k] > 0.f ? -(G.sigma_t[k] * D) / sig_n[k] : 0.f) +
            dpdf_sc / pdf_safe + score;
        coeff += rs[k] * dlog;
      }
    }
    scatter_corners(G, grad, p, coeff);
  }
};

// The gradient hook of track_transmittance
// (media_pallas.py::track_transmittance_grad): pend[c] = residual_c x the
// whole contribution this transmittance multiplies (tr included). Per
// candidate that does not escape, coeff = sum_c pend[c] * d log
// max(m - sigma_t_c dens, 0) / d value = -sigma_t_c D / sig_n_c where
// sig_n_c > 0, else 0 (the factor, and so the contribution, is 0 there).
// Ratio tracking samples from the majorant alone: no score terms.
struct TransGrad {
  static constexpr bool on = true;
  float* grad;
  float pend[3];

  __device__ __forceinline__ void event(const MediaGrid& G, float3 p,
                                        float m_loc, float dens) const {
    float coeff = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sig_n = m_loc - XM(G.sigma_t[k], dens);
      coeff += pend[k] * (sig_n > 0.f ? -(G.sigma_t[k] * G.dm) / sig_n : 0.f);
    }
    scatter_corners(G, grad, p, coeff);
  }
};

struct TrackResult {
  float t;        // scatter point, or t1 + RAY_EPS after an escape
  float w[3];     // throughput multiplier, 0 for an exhausted lane
  int scattered;  // a real in-scatter event
  int scat_step;  // the loop step of the scatter, 0 where none
};

// media.py::_track_sample for one lane: weighted delta tracking with
// spectral MIS over collision candidates in optical-depth space. Draws:
// site + step * 4 + {0 wavelength, 1 distance, 2 event}. ``hook.event``
// sees every scatter and null collision (SampleGrad).
//
// The loop is cut into a set-up (sample_begin) and one collision candidate
// per call (sample_step); track_sample below runs the loop. The walk is
// passed beside the loop's state, so that one walk (one frame) serves the
// tracking and then the shadow ray's transmittance.
struct SampleLoop {
  float sig_a[3];  // at the last candidate, for the channel pick
  float m_prev;    // majorant at the last candidate
  float tau_total;  // the walk's optical depth less RAY_EPS x majorant
  float tau;
  int step;
  uint32_t site;
  TrackResult R;
};

__device__ __forceinline__ void sample_begin(const MediaGrid& G, Walk& W,
                                             SampleLoop& K, float3 o,
                                             float3 d, float t0, float t1,
                                             uint32_t site) {
  const float t0f = isfinite(t0) ? t0 : 0.f;
  const float t1f = isfinite(t1) ? fmaxf(t1, t0f) : t0f;
  K.tau_total = W.begin(G, o, d, t0f, t1f) - XM(RAY_EPS_F, G.majorant);
  // sigma_a at the entry point, for the first channel pick
  const float dens0 = density(G, ray_at(o, d, t0)) * G.dm;
#pragma unroll
  for (int c = 0; c < 3; ++c) K.sig_a[c] = XM(G.sigma_a[c], dens0);
  W.locate(0.f, K.m_prev);
  K.m_prev = fmaxf(K.m_prev, 0.f);
  K.tau = 0.f;
  K.step = 0;
  K.site = site;
  K.R.t = t1 + RAY_EPS_F;
  K.R.w[0] = K.R.w[1] = K.R.w[2] = 1.0f;
  K.R.scattered = 0;
  K.R.scat_step = 0;
}

// One collision candidate of the loop (``tp``: the path throughput, o and
// d the ray given to sample_begin). Returns false once the lane is done:
// escaped, scattered, or exhausted (weight 0, the bounded-loop policy).
template <class Hook>
__device__ __forceinline__ bool sample_step(const MediaGrid& G, Walk& W,
                                            SampleLoop& K, float3 o, float3 d,
                                            const float tp[3], uint32_t key,
                                            const Hook& hook) {
  TrackResult& R = K.R;
  if (K.step >= G.max_steps) {
    R.w[0] = R.w[1] = R.w[2] = 0.f;
    return false;
  }
  const uint32_t offs = K.site + (uint32_t)(K.step * SITES_PER_STEP);
  const float u_wl = u1(key, offs);
  const float u_dist = u1(key, offs + 1u);
  const float u_ev = u1(key, offs + 2u);

  float pmf[3];
  int channel;
  if (G.chan_uniform) {
    channel = pick_channel(1.0f, 1.0f, 1.0f, u_wl, pmf);
  } else {
    const float m_prev_s = K.m_prev <= 0.f ? 1.0f : K.m_prev;
    float pw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      pw[c] = XM(XM(tp[c], R.w[c]),
                 fmaxf((K.m_prev - K.sig_a[c]) / m_prev_s, 0.f));
    channel = pick_channel(pw[0], pw[1], pw[2], u_wl, pmf);
  }

  const float dtau = -logf(fmaxf(1.0f - u_dist, TINY));
  const float tau_new = K.tau + dtau;
  if (tau_new > K.tau_total) {  // escape
    const float tr_esc = expf(-(K.tau_total - K.tau));
    const float pdf_esc =
        XA(XA(XM(pmf[0], tr_esc), XM(pmf[1], tr_esc)), XM(pmf[2], tr_esc));
    const float pe = safe1(pdf_esc);
#pragma unroll
    for (int c = 0; c < 3; ++c) R.w[c] = XM(R.w[c], tr_esc) / pe;
    return false;
  }
  float m_loc;
  const float t_new = W.locate(tau_new, m_loc);
  const float m_safe = m_loc <= 0.f ? 1.0f : m_loc;
  const float3 pt = ray_at(o, d, t_new);
  const float dens = density(G, pt) * G.dm;
  float sig_s[3], sig_n[3], p_s[3], p_n[3], q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sig_s[c] = XM(G.sigma_s[c], dens);
    K.sig_a[c] = XM(G.sigma_a[c], dens);
    sig_n[c] = fmaxf((m_loc - K.sig_a[c]) - sig_s[c], 0.f);
    q[c] = safe1(XA(sig_s[c], sig_n[c]));
    p_s[c] = sig_s[c] / q[c];
    p_n[c] = sig_n[c] / q[c];
  }
  const float p_s_c = channel == 0 ? p_s[0] : (channel == 1 ? p_s[1] : p_s[2]);
  const float tr_s = expf(-dtau);
  const float base[3] = {XM(XM(pmf[0], m_safe), tr_s),
                         XM(XM(pmf[1], m_safe), tr_s),
                         XM(XM(pmf[2], m_safe), tr_s)};
  if (u_ev < p_s_c) {  // a real scatter
    const float pdf_sc = safe1(XA(XA(XM(base[0], p_s[0]), XM(base[1], p_s[1])),
                                  XM(base[2], p_s[2])));
    if constexpr (Hook::on)
      hook.event(G, pt, true, channel, base, sig_s, sig_n, q, p_s_c, pdf_sc);
    R.t = t_new;
    R.scattered = 1;
    R.scat_step = K.step;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      R.w[c] = XM(XM(R.w[c], tr_s), sig_s[c]) / pdf_sc;
    return false;
  }
  const float pdf_nl = safe1(XA(XA(XM(base[0], p_n[0]), XM(base[1], p_n[1])),
                                XM(base[2], p_n[2])));
  if constexpr (Hook::on)
    hook.event(G, pt, false, channel, base, sig_s, sig_n, q, p_s_c, pdf_nl);
#pragma unroll
  for (int c = 0; c < 3; ++c) R.w[c] = XM(XM(R.w[c], tr_s), sig_n[c]) / pdf_nl;
  K.tau = tau_new;
  K.m_prev = m_loc;
  K.step += 1;
  return true;
}

template <class Hook>
__device__ __forceinline__ TrackResult track_sample(const MediaGrid& G,
                                                    float3 o, float3 d,
                                                    float t0, float t1,
                                                    const float tp[3],
                                                    uint32_t key,
                                                    uint32_t site,
                                                    const Hook& hook) {
  Walk W;
  SampleLoop K;
  sample_begin(G, W, K, o, d, t0, t1, site);
  while (sample_step(G, W, K, o, d, tp, key, hook)) {
  }
  return K.R;
}

__device__ __forceinline__ TrackResult track_sample(const MediaGrid& G,
                                                    float3 o, float3 d,
                                                    float t0, float t1,
                                                    const float tp[3],
                                                    uint32_t key,
                                                    uint32_t site) {
  return track_sample(G, o, d, t0, t1, tp, key, site, NoTrackGrad{});
}

// media.py::_track_transmittance for one lane: ratio tracking from p1 to
// p2. Draws: site + step. ``hook.event`` sees every candidate that does
// not escape (TransGrad). Cut like the sample loop: trans_begin, then one
// candidate per trans_step.
struct TransLoop {
  float3 p1, d;
  float tau_total;
  float tau;
  int step;
  uint32_t site;
  float tr[3];
};

__device__ __forceinline__ void trans_begin(const MediaGrid& G, Walk& W,
                                            TransLoop& K, float3 p1, float3 p2,
                                            uint32_t site) {
  const float3 dv = sub3(p2, p1);
  const float dist =
      sqrtf(XA(XA(XM(dv.x, dv.x), XM(dv.y, dv.y)), XM(dv.z, dv.z)));
  const float sd = safe1(dist);
  K.d = make_float3(dv.x / sd, dv.y / sd, dv.z / sd);
  K.p1 = p1;
  const float t1f = isfinite(dist) ? fmaxf(dist, 0.f) : 0.f;
  K.tau_total = W.begin(G, p1, K.d, 0.f, t1f);
  K.tr[0] = K.tr[1] = K.tr[2] = 1.0f;
  K.tau = 0.f;
  K.step = 0;
  K.site = site;
}

// One candidate; false once the lane is done: escaped (tr final) or
// exhausted (tr = 0, never biased bright).
template <class Hook>
__device__ __forceinline__ bool trans_step(const MediaGrid& G, Walk& W,
                                           TransLoop& K, uint32_t key,
                                           const Hook& hook) {
  if (K.step >= G.max_steps) {
    K.tr[0] = K.tr[1] = K.tr[2] = 0.f;
    return false;
  }
  const float u = u1(key, K.site + (uint32_t)K.step);
  const float tau_new = K.tau - logf(fmaxf(1.0f - u, TINY));
  if (tau_new > K.tau_total) return false;  // escaped: tr is final
  float m_loc;
  const float t_new = W.locate(tau_new, m_loc);
  const float3 pt = ray_at(K.p1, K.d, t_new);
  const float dens = density(G, pt) * G.dm;
  if constexpr (Hook::on) hook.event(G, pt, m_loc, dens);
  const float m_safe = m_loc <= 0.f ? 1.0f : m_loc;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sig_n = fmaxf(m_loc - XM(G.sigma_t[c], dens), 0.f);
    K.tr[c] = XM(K.tr[c], sig_n) / m_safe;
  }
  K.tau = tau_new;
  K.step += 1;
  return true;
}

template <class Hook>
__device__ __forceinline__ void track_transmittance(const MediaGrid& G,
                                                    float3 p1, float3 p2,
                                                    uint32_t key,
                                                    uint32_t site,
                                                    float tr[3],
                                                    const Hook& hook) {
  Walk W;
  TransLoop K;
  trans_begin(G, W, K, p1, p2, site);
  while (trans_step(G, W, K, key, hook)) {
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) tr[c] = K.tr[c];
}

__device__ __forceinline__ void track_transmittance(const MediaGrid& G,
                                                    float3 p1, float3 p2,
                                                    uint32_t key,
                                                    uint32_t site,
                                                    float tr[3]) {
  track_transmittance(G, p1, p2, key, site, tr, NoTrackGrad{});
}


// The medium and its grid from the host arrays of media_kernels.py (host
// code, shared by the launchers of media.cu and het_megakernel.cu):
// fc = gmin, gmax, ext, res - 1, scale, block size, block count - 1,
// sigma_a, sigma_s, sigma_t (3 each), sigma_t_max, majorant, density
// multiplier; ic = resolution (3), block counts (3), chan_uniform,
// max_steps, use_packed.
static inline MediaGrid grid_from(const float* fc, const int* ic,
                                  const float* density, const float* packed,
                                  const float* super) {
  MediaGrid G;
  float* dst[10] = {G.gmin,   G.gmax,    G.ext,     G.res_m1,  G.scale,
                    G.bs,     G.nbf_m1,  G.sigma_a, G.sigma_s, G.sigma_t};
  for (int j = 0; j < 10; ++j)
    for (int k = 0; k < 3; ++k) dst[j][k] = fc[3 * j + k];
  G.sigma_t_max = fc[30];
  G.majorant = fc[31];
  G.dm = fc[32];
  for (int k = 0; k < 3; ++k) {
    G.res[k] = ic[k];
    G.nb[k] = ic[3 + k];
  }
  G.chan_uniform = ic[6];
  G.max_steps = ic[7];
  G.density = density;
  G.packed = ic[8] ? packed : nullptr;
  G.super = super;
  return G;
}

}  // namespace xrt
