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
// (a segment is an element of a local array), (8, 512) planes and
// tile-uniform loop exits (a lane is a thread and leaves when it is done).
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

struct Segments {
  float t[DDA_SEGMENTS + 1];    // segment start times
  float m[DDA_SEGMENTS + 1];    // local majorants
  float tau[DDA_SEGMENTS + 2];  // optical depth at segment starts + the end
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

// media.py::_majorant_segments: the integer-walk DDA through the supergrid
// over [t0f, t1f]; 24 segments and a global-majorant tail; tau is the
// left-to-right running sum of majorant x length.
__device__ __forceinline__ void dda_segments(const MediaGrid& G, float3 o,
                                             float3 d, float t0f, float t1f,
                                             Segments& S) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  float a[3], v[3], v_safe[3], b[3], sgn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a[k] = XM(oo[k] - G.gmin[k], G.scale[k]);
    v[k] = XM(dd[k], G.scale[k]);
    v_safe[k] = fabsf(v[k]) < 1e-20f ? 1e-20f : v[k];
    sgn[k] = v[k] >= 0.f ? 1.0f : -1.0f;
    const float x0 = XA(a[k], XM(t0f, v[k]));
    b[k] = fminf(fmaxf(floorf(x0 / G.bs[k]), 0.f), G.nbf_m1[k]);
  }
  float t_cur = t0f;
  for (int s = 0; s < DDA_SEGMENTS; ++s) {
    const int flat = ((int)b[0] * G.nb[1] + (int)b[1]) * G.nb[2] + (int)b[2];
    const float m_loc = XM(XM(__ldg(G.super + flat), G.dm), G.sigma_t_max);
    float e[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      e[k] = exit_time(v[k], v_safe[k], XM(b[k], G.bs[k]),
                       XM(b[k] + 1.0f, G.bs[k]), a[k]);
    const float t_hi = fminf(fminf(e[0], e[1]), e[2]);
    // exit axis: the first minimum (x, then y, then z)
    const bool step_x = (e[0] <= e[1]) & (e[0] <= e[2]);
    const bool step_y = !step_x & (e[1] <= e[2]);
    const int ax = step_x ? 0 : (step_y ? 1 : 2);
    S.t[s] = t_cur;
    S.m[s] = t_cur < t1f ? m_loc : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == ax) b[k] = fminf(fmaxf(b[k] + sgn[k], 0.f), G.nbf_m1[k]);
    t_cur = fminf(fmaxf(t_hi, t_cur), t1f);
  }
  const float t_tail = fminf(t_cur, t1f);
  S.t[DDA_SEGMENTS] = t_tail;
  S.m[DDA_SEGMENTS] = t_tail < t1f ? G.majorant : 0.f;
  S.tau[0] = 0.f;
  for (int k = 0; k <= DDA_SEGMENTS; ++k) {
    const float end = k == DDA_SEGMENTS ? t1f : S.t[k + 1];
    S.tau[k + 1] = XA(S.tau[k], XM(S.m[k], fmaxf(end - S.t[k], 0.f)));
  }
}

// media.py::_tau_to_t: the segment whose start is the last edge <= tau.
__device__ __forceinline__ float tau_to_t(const Segments& S, float tau,
                                          float& m_loc) {
  int k = -1;
  for (int j = 0; j <= DDA_SEGMENTS; ++j) k += S.tau[j] <= tau ? 1 : 0;
  k = min(max(k, 0), DDA_SEGMENTS);
  m_loc = S.m[k];
  return S.t[k] + (tau - S.tau[k]) / (m_loc <= 0.f ? 1.0f : m_loc);
}

__device__ __forceinline__ float3 ray_at(float3 o, float3 d, float t) {
  return make_float3(XA(o.x, XM(t, d.x)), XA(o.y, XM(t, d.y)),
                     XA(o.z, XM(t, d.z)));
}

struct TrackResult {
  float t;        // scatter point, or t1 + RAY_EPS after an escape
  float w[3];     // throughput multiplier, 0 for an exhausted lane
  int scattered;  // a real in-scatter event
  int scat_step;  // the loop step of the scatter, 0 where none
};

// media.py::_track_sample for one lane: weighted delta tracking with
// spectral MIS over collision candidates in optical-depth space. Draws:
// site + step * 4 + {0 wavelength, 1 distance, 2 event}.
__device__ __forceinline__ TrackResult track_sample(const MediaGrid& G,
                                                    float3 o, float3 d,
                                                    float t0, float t1,
                                                    const float tp[3],
                                                    uint32_t key,
                                                    uint32_t site) {
  const float t0f = isfinite(t0) ? t0 : 0.f;
  const float t1f = isfinite(t1) ? fmaxf(t1, t0f) : t0f;
  Segments S;
  dda_segments(G, o, d, t0f, t1f, S);
  const float tau_total = S.tau[DDA_SEGMENTS + 1] - XM(RAY_EPS_F, G.majorant);

  // sigma_a at the entry point, for the first channel pick
  const float dens0 = density(G, ray_at(o, d, t0)) * G.dm;
  float sig_a[3] = {XM(G.sigma_a[0], dens0), XM(G.sigma_a[1], dens0),
                    XM(G.sigma_a[2], dens0)};
  float m_prev;
  tau_to_t(S, 0.f, m_prev);
  m_prev = fmaxf(m_prev, 0.f);

  TrackResult R;
  R.t = t1 + RAY_EPS_F;
  R.w[0] = R.w[1] = R.w[2] = 1.0f;
  R.scattered = 0;
  R.scat_step = 0;
  float tau = 0.f;
  bool active = true;
  for (int step = 0; step < G.max_steps && active; ++step) {
    const uint32_t offs = site + (uint32_t)(step * SITES_PER_STEP);
    const float u_wl = u1(key, offs);
    const float u_dist = u1(key, offs + 1u);
    const float u_ev = u1(key, offs + 2u);

    float pmf[3];
    int channel;
    if (G.chan_uniform) {
      channel = pick_channel(1.0f, 1.0f, 1.0f, u_wl, pmf);
    } else {
      const float m_prev_s = m_prev <= 0.f ? 1.0f : m_prev;
      float pw[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        pw[c] = XM(XM(tp[c], R.w[c]),
                   fmaxf((m_prev - sig_a[c]) / m_prev_s, 0.f));
      channel = pick_channel(pw[0], pw[1], pw[2], u_wl, pmf);
    }

    const float dtau = -logf(fmaxf(1.0f - u_dist, TINY));
    const float tau_new = tau + dtau;

    const bool esc = tau_new > tau_total;
    const float tr_esc = expf(-(tau_total - tau));
    const float pdf_esc =
        XA(XA(XM(pmf[0], tr_esc), XM(pmf[1], tr_esc)), XM(pmf[2], tr_esc));
    const float pe = safe1(pdf_esc);

    float m_loc;
    const float t_new = tau_to_t(S, tau_new, m_loc);
    const float m_safe = m_loc <= 0.f ? 1.0f : m_loc;
    const float dens = density(G, ray_at(o, d, t_new)) * G.dm;
    float sig_s[3], sig_n[3], p_s[3], p_n[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sig_s[c] = XM(G.sigma_s[c], dens);
      sig_a[c] = XM(G.sigma_a[c], dens);
      sig_n[c] = fmaxf((m_loc - sig_a[c]) - sig_s[c], 0.f);
      const float denom = safe1(XA(sig_s[c], sig_n[c]));
      p_s[c] = sig_s[c] / denom;
      p_n[c] = sig_n[c] / denom;
    }
    const float p_s_c = channel == 0 ? p_s[0] : (channel == 1 ? p_s[1] : p_s[2]);
    const float tr_s = expf(-dtau);
    const float base[3] = {XM(XM(pmf[0], m_safe), tr_s),
                           XM(XM(pmf[1], m_safe), tr_s),
                           XM(XM(pmf[2], m_safe), tr_s)};
    const bool scat = !esc & (u_ev < p_s_c);
    if (esc) {
      R.t = t1 + RAY_EPS_F;
#pragma unroll
      for (int c = 0; c < 3; ++c) R.w[c] = XM(R.w[c], tr_esc) / pe;
      active = false;
    } else if (scat) {
      const float pdf_sc = safe1(XA(XA(XM(base[0], p_s[0]), XM(base[1], p_s[1])),
                                    XM(base[2], p_s[2])));
      R.t = t_new;
      R.scattered = 1;
      R.scat_step = step;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        R.w[c] = XM(XM(R.w[c], tr_s), sig_s[c]) / pdf_sc;
      active = false;
    } else {
      const float pdf_nl = safe1(XA(XA(XM(base[0], p_n[0]), XM(base[1], p_n[1])),
                                    XM(base[2], p_n[2])));
#pragma unroll
      for (int c = 0; c < 3; ++c)
        R.w[c] = XM(XM(R.w[c], tr_s), sig_n[c]) / pdf_nl;
      tau = tau_new;
      m_prev = m_loc;
    }
  }
  // exhausted lanes: weight 0 (bounded-loop policy)
  if (active) R.w[0] = R.w[1] = R.w[2] = 0.f;
  return R;
}

// media.py::_track_transmittance for one lane: ratio tracking from p1 to
// p2. Draws: site + step.
__device__ __forceinline__ void track_transmittance(const MediaGrid& G,
                                                    float3 p1, float3 p2,
                                                    uint32_t key,
                                                    uint32_t site,
                                                    float tr[3]) {
  const float3 dv = sub3(p2, p1);
  const float dist =
      sqrtf(XA(XA(XM(dv.x, dv.x), XM(dv.y, dv.y)), XM(dv.z, dv.z)));
  const float sd = safe1(dist);
  const float3 d = make_float3(dv.x / sd, dv.y / sd, dv.z / sd);
  const float t1f = isfinite(dist) ? fmaxf(dist, 0.f) : 0.f;
  Segments S;
  dda_segments(G, p1, d, 0.f, t1f, S);
  const float tau_total = S.tau[DDA_SEGMENTS + 1];
  tr[0] = tr[1] = tr[2] = 1.0f;
  float tau = 0.f;
  bool active = true;
  for (int step = 0; step < G.max_steps && active; ++step) {
    const float u = u1(key, site + (uint32_t)step);
    const float tau_new = tau - logf(fmaxf(1.0f - u, TINY));
    if (tau_new > tau_total) {
      active = false;
      continue;
    }
    float m_loc;
    const float t_new = tau_to_t(S, tau_new, m_loc);
    const float dens = density(G, ray_at(p1, d, t_new)) * G.dm;
    const float m_safe = m_loc <= 0.f ? 1.0f : m_loc;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float sig_n = fmaxf(m_loc - XM(G.sigma_t[c], dens), 0.f);
      tr[c] = XM(tr[c], sig_n) / m_safe;
    }
    tau = tau_new;
  }
  // exhausted lanes: 0 (never biased bright)
  if (active) tr[0] = tr[1] = tr[2] = 0.f;
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
