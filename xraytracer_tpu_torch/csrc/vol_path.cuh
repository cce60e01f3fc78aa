// One lane's homogeneous volume path: the scene a launch carries, the
// nearest hit over the triangles and the medium box, one iteration of a path
// (`vol_bounce`), and the two sample loops of a pixel (K6b's per-sample loop,
// K6c's merged loop cut into passes). No kernel and no launch: the kernels
// are in vol_megakernel.cu, and g++ compiles this header under a shim of the
// CUDA built-ins for the CPU rehearsal (tests/test_torch_csrc_vol.py).
//
// The scene such a kernel takes: at most 8 flat triangles, exactly one
// homogeneous medium in a box, at most 4 flat area lights, no spheres. It
// travels BY VALUE as a launch argument (VolScene, under 1 KB, read through
// the constant bank), so there is no table in device memory and nothing is
// compiled per scene; the medium variant and the |g| < 1e-3 branch of the
// Henyey-Greenstein warp, which the Pallas kernel resolves while tracing,
// are launch-uniform branches here.
//
// What an iteration computes (integrators/volume.py, line for line): end
// at depth == max_depth; nearest hit over the triangles (classic
// Moller-Trumbore, K_EPS) and the box slab (entry clamped to 0; a triangle
// wins an exact tie); miss ends the path; Russian roulette on the mean
// throughput for depth > 0; one-sided emitter radiance (only at depth 0
// with next-event estimation) and the path ends; the closed-form
// homogeneous medium sample with the spectral-MIS / achromatic / uniform
// channel pick (media.py::_sample_homogeneous): free flight from the box
// ENTRY, escape to t1 + RAY_EPS or scatter with a Henyey-Greenstein
// direction about the ray; next-event estimation at a scatter vertex: one
// uniformly picked light, one nearest-hit test from the vertex (a surface
// blocks, the box multiplies the analytic transmittance over its span);
// depth advances only on a real scatter. 2 * max_depth + 2 iterations by
// default. Draws: tof(pcg(key + site * GOLDEN)) with site = iteration *
// 2^16 + {0 roulette, 16.. medium (wavelength, distance, phase pair),
// pick, pick + 1} where pick comes from the host (volume.py::
// _nee_site_layout), so all routes draw the same numbers.
//
// The products that feed the channel pick's sums use XM / XA
// (path_common.cuh) so that the pick follows the plain version bit for bit,
// as do the box slab, the scattered direction and the phase value, which
// this file shares with het_megakernel.cu (path_common.cuh); everything else
// may contract (a * b + c -> one fused multiply-add). No fast-math: division,
// logf, expf, sqrtf, sinf and cosf are the accurate ones.
//
// Lines marked "// sass: NAME" open the regions by which chip_smoke.py
// counts the compiled instructions of an iteration (`--ab-csrc`).

#pragma once

#include "path_common.cuh"

namespace xrt {

constexpr int VOL_BLOCK = 128;
constexpr int VOL_MAX_TRIS = 8;
constexpr int VOL_MAX_LIGHTS = 4;
constexpr uint32_t VSITE_RR = 0, VSITE_MEDIUM = 16;

enum MedVariant { MED_MIS = 0, MED_ACHRO = 1, MED_NOMIS = 2 };

struct VolTri {
  float v0[3], e1[3], e2[3], ns[3];
  float lrow;   // area-light row, -1 = none
  float mtype;  // material type, -1 = none
};

struct VolLight {
  float type;  // 0 triangle, 1 quad
  float v0[3], e1[3], e2[3], ng[3], le[3];
};

struct VolScene {
  VolTri tris[VOL_MAX_TRIS];
  float lo[3], hi[3];  // the medium box
  float g;
  float sigma_a[3], sigma_s[3];
  float sigma_t[3];  // sigma_a + sigma_s
  float albedo[3];   // sigma_s / (sigma_t == 0 ? 1 : sigma_t)
  VolLight lights[VOL_MAX_LIGHTS];
  int n_tris, n_lights;
  int variant;  // MedVariant
  int max_depth, n_iterations;
  int nee;  // next-event estimation on (and n_lights > 0)
  uint32_t pick_site, light_site;
};

struct VolPath {
  uint32_t key;
  int it;     // iterations done
  int depth;  // real scatters so far
  bool act;
  float3 L, T, o, d;
};

struct VolHit {
  bool hit, box_win;
  float t, t1;
  float lrow, mtype;
  float3 ns;
};

// sass: intersect
// Nearest hit over the triangles and the box. Ties go to the triangle, as
// intersect_scene's argmin over [triangle, sphere, box] does.
__device__ __forceinline__ VolHit intersect(const VolScene& S, float3 o,
                                            float3 d) {
  VolHit h;
  float t_best = INF_T;
  h.lrow = -1.0f;
  h.mtype = -1.0f;
  h.ns = make_float3(0.f, 0.f, 0.f);
  // sass: triangle loop
#pragma unroll 1  // a loop, not eight guarded copies: smaller and faster
  for (int k = 0; k < S.n_tris; ++k) {
    const VolTri& tr = S.tris[k];
    const float3 e1 = f3(tr.e1), e2 = f3(tr.e2);
    const float3 pv = cross3(d, e2);
    const float det = dot3(e1, pv);
    const float inv = 1.0f / (det == 0.f ? 1.0f : det);
    const float3 tv = sub3(o, f3(tr.v0));
    const float u = dot3(tv, pv) * inv;
    const float3 qv = cross3(tv, e1);
    const float v = dot3(d, qv) * inv;
    const float t = dot3(e2, qv) * inv;
    const bool ok = (fabsf(det) >= K_EPS) & (u >= 0.f) & (v >= 0.f) &
                    (u + v <= 1.0f) & (t > K_EPS);
    if (ok && t < t_best) {
      t_best = t;
      h.lrow = tr.lrow;
      h.mtype = tr.mtype;
      h.ns = f3(tr.ns);
    }
  }
  // sass: intersect
  float ax, bx, ay, by, az, bz;
  slab(o.x, d.x, S.lo[0], S.hi[0], ax, bx);
  slab(o.y, d.y, S.lo[1], S.hi[1], ay, by);
  slab(o.z, d.z, S.lo[2], S.hi[2], az, bz);
  float b0 = fmaxf(fmaxf(ax, ay), az);
  const float b1 = fminf(fminf(bx, by), bz);
  const bool bok = (b0 <= b1) & (b1 > 0.f);
  b0 = fmaxf(b0, 0.f);
  h.box_win = bok & (b0 < t_best);  // strict: a triangle wins exact ties
  h.hit = h.box_win | (t_best < INF_T);
  h.t = h.box_win ? b0 : t_best;
  h.t1 = b1;
  if (h.box_win) {
    h.lrow = -1.0f;
    h.mtype = -1.0f;
    h.ns = make_float3(0.f, 0.f, 0.f);
  }
  return h;
}

// sass: advance
// path_common.cuh's hg_direction with the azimuth's sine and cosine from
// one sincosf (one range reduction; the same values as sinf and cosf)
__device__ __forceinline__ float3 vol_hg_direction(float g, float3 wo,
                                                   float u1_, float u2_) {
  float cos_t;
  if (fabsf(g) < 1e-3f) {
    cos_t = XS(XM(2.0f, u1_), 1.0f);
  } else {
    const float sqr = XS(1.0f, XM(g, g)) / XA(XS(1.0f, g), XM(XM(2.0f, g), u1_));
    cos_t = XS(XA(1.0f, XM(g, g)), XM(sqr, sqr)) / XM(2.0f, g);
  }
  const float sin_t = sqrtf(fmaxf(XS(1.0f, XM(cos_t, cos_t)), 0.f));
  const float phi = XM(TWO_PI, u2_);
  float sin_p, cos_p;
  sincosf(phi, &sin_p, &cos_p);
  float3 t, b;
  onb(wo, t, b);
  return to_world(XM(cos_p, sin_t), cos_t, XM(sin_p, sin_t), t, wo, b);
}

// sass: bounce
// One iteration of an active path. Ends the path (act = false) at the depth
// bound, on a miss, a roulette kill, an emitter, a surface without medium,
// or zero throughput.
__device__ __forceinline__ void vol_bounce(const VolScene& S, VolPath& p) {
  const uint32_t site = (uint32_t)p.it * SITES_PER_BOUNCE;
  p.it += 1;
  if (p.depth >= S.max_depth) {
    p.act = false;
    return;
  }
  const float3 o = p.o, d = p.d;
  const VolHit h = intersect(S, o, d);
  if (!h.hit) {  // miss: black background
    p.act = false;
    return;
  }

  // sass: roulette and emitter
  // Russian roulette for depth > 0
  if (p.depth > 0) {
    const float rr_prob = fminf((p.T.x + p.T.y + p.T.z) * THIRD, 1.0f);
    const float u_rr = u1(p.key, site + VSITE_RR);
    if (u_rr >= rr_prob) {
      p.act = false;
      return;
    }
    const float boost = 1.0f / fmaxf(rr_prob, 1e-12f);
    p.T = make_float3(p.T.x * boost, p.T.y * boost, p.T.z * boost);
  }

  // emitter hit: one-sided radiance, and the path ends
  if (h.lrow >= 0.f) {
    const float won = -(d.x * h.ns.x + d.y * h.ns.y + d.z * h.ns.z);
    const int li = (int)h.lrow;
    if (won > 0.f && li < S.n_lights && (!S.nee || p.depth == 0)) {
      const float* le = S.lights[li].le;
      p.L.x += p.T.x * le[0];
      p.L.y += p.T.y * le[1];
      p.L.z += p.T.z * le[2];
    }
    p.act = false;
    return;
  }
  // a plain surface with no medium and no light ends the path
  if (!h.box_win) {
    p.act = false;
    return;
  }

  // sass: medium sample
  // closed-form homogeneous medium sample; free flight from the box entry
  const uint32_t msite = site + VSITE_MEDIUM;
  const float u_wl = u1(p.key, msite);
  const float u_dist = u1(p.key, msite + 1u);
  float u_p1, u_p2;
  u2(p.key, msite + 2u, u_p1, u_p2);

  const float T3[3] = {p.T.x, p.T.y, p.T.z};
  float pmf[3] = {THIRD, THIRD, THIRD};
  int channel;
  if (S.variant == MED_MIS) {
    channel = pick_channel(XM(T3[0], S.albedo[0]), XM(T3[1], S.albedo[1]),
                           XM(T3[2], S.albedo[2]), u_wl, pmf);
  } else if (S.variant == MED_ACHRO) {
    channel = 0;
  } else {
    channel = min((int)(3.0f * u_wl), 2);
  }
  const float sig_c = safe1(S.sigma_t[channel]);
  const float t_free = -logf(fmaxf(1.0f - u_dist, TINY)) / sig_c;
  const float dist = h.t1 - h.t;
  const bool escaped = t_free > dist - RAY_EPS_F;

  // one set of exponentials serves both weights: each lane takes them at
  // the distance its own branch needs (the same arguments as two separate
  // sets, so the same bits), and a warp whose lanes split between escape
  // and scatter runs them once
  const float dd = escaped ? dist : t_free;
  float tr[3];
  for (int c = 0; c < 3; ++c) tr[c] = expf(-S.sigma_t[c] * dd);
  float w[3];
  if (escaped) {
    // sass: escape weight
    // escape weight (single-sample MIS over channels; achromatic = 1)
    const float pdf_esc =
        safe1((pmf[0] * tr[0] + pmf[1] * tr[1]) + pmf[2] * tr[2]);
    for (int c = 0; c < 3; ++c)
      w[c] = S.variant == MED_ACHRO ? 1.0f : tr[c] / pdf_esc;
  } else {
    // sass: scatter weight
    const float pdf_sc = safe1(((pmf[0] * S.sigma_t[0]) * tr[0] +
                                (pmf[1] * S.sigma_t[1]) * tr[1]) +
                               (pmf[2] * S.sigma_t[2]) * tr[2]);
    for (int c = 0; c < 3; ++c)
      w[c] = S.variant == MED_ACHRO ? S.albedo[c]
                                    : tr[c] * S.sigma_s[c] / pdf_sc;
  }
  // sass: medium sample
  const bool scattered = !escaped;
  const float t_hit = escaped ? h.t1 + RAY_EPS_F : h.t + t_free;
  const float3 mp =
      make_float3(o.x + t_hit * d.x, o.y + t_hit * d.y, o.z + t_hit * d.z);

  // sass: next-event estimation
  // next-event estimation at the scatter vertex
  if (S.nee && scattered) {
    const float u_pick = u1(p.key, site + S.pick_site);
    const int lidx = min((int)(u_pick * (float)S.n_lights), S.n_lights - 1);
    float lu, lv;
    u2(p.key, site + S.light_site, lu, lv);
    const VolLight& Lt = S.lights[lidx];
    const bool is_tri = Lt.type == 0.f;
    const float3 lp = light_point(is_tri, f3(Lt.v0), f3(Lt.e1), f3(Lt.e2), lu, lv);
    const float3 dl = sub3(lp, mp);
    const float tl = sqrtf(dl.x * dl.x + dl.y * dl.y + dl.z * dl.z);
    const float ddn = dl.x * Lt.ng[0] + dl.y * Lt.ng[1] + dl.z * Lt.ng[2];
    const bool front = ddn < 0.f;
    const float den = safe1(fabsf(ddn));
    const float t3 = tl * tl * tl;
    const float pdf =
        (is_tri ? 2.0f * t3 : t3) / den * (1.0f / (float)S.n_lights);
    if (pdf > 0.f && front) {
      const float ts = safe1(tl);
      const float3 wi = make_float3(dl.x / ts, dl.y / ts, dl.z / ts);
      // one nearest-hit test from the vertex: a surface blocks, the box
      // multiplies the analytic transmittance over its [t, t1] span
      const VolHit sh = intersect(S, mp, wi);
      const bool blocked = sh.hit & (sh.mtype >= 0.f);
      if (!blocked) {
        const float seg =
            sh.box_win ? (sh.t1 < INF_T ? sh.t1 : sh.t) - sh.t : 0.f;
        const float f = hg_phase(S.g, dot3x(d, wi));
        p.L.x += (p.T.x * w[0]) * (expf(-S.sigma_t[0] * seg) * f * Lt.le[0] / pdf);
        p.L.y += (p.T.y * w[1]) * (expf(-S.sigma_t[1] * seg) * f * Lt.le[1] / pdf);
        p.L.z += (p.T.z * w[2]) * (expf(-S.sigma_t[2] * seg) * f * Lt.le[2] / pdf);
      }
    }
  }

  // sass: advance
  // advance: depth only on a real scatter
  p.o = mp;
  if (scattered) {
    // Henyey-Greenstein direction about wo = d
    p.d = vol_hg_direction(S.g, d, u_p1, u_p2);
    p.depth += 1;
  }
  p.T = make_float3(p.T.x * w[0], p.T.y * w[1], p.T.z * w[2]);
  if (!((p.T.x > 0.f) | (p.T.y > 0.f) | (p.T.z > 0.f))) p.act = false;
}

// sass: sample loops
__device__ __forceinline__ void start_path(VolPath& p) {
  p.it = 0;
  p.depth = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
}

// K6b's lane: samples s0 .. s0 + n_spp - 1 of one pixel, each path run to
// its end before the next sample starts; the sum in sample order.
__device__ __forceinline__ void vol_pixel_per_sample(
    const VolScene& S, const MegaCamera& C, uint32_t fold, float x, float y,
    int s0, int n_spp, float3& acc, int& rej) {
  acc = make_float3(0.f, 0.f, 0.f);
  rej = 0;
  VolPath p;
  for (int s = 0; s < n_spp; ++s) {
    start_path(p);
    camera_sample(C, fold, x, y, (uint32_t)(s0 + s), p.key, p.o, p.d);
    while (p.act && p.it < S.n_iterations) vol_bounce(S, p);
    add_sample(p.L, acc, rej);
  }
}

// K6c's lane: the sample loop merged into the iteration loop, one pass per
// call, so that a lane whose path has ended starts its next sample at once.
// Its samples still join the sum in order, so the sums are K6b's.
struct VolLane {
  uint32_t fold;
  float x, y;
  int s;              // samples finished
  long long guard;    // passes taken
  float3 acc;
  int rej;
  VolPath p;
};

__device__ __forceinline__ void vol_lane_init(VolLane& l, uint32_t fold,
                                              float x, float y) {
  l.fold = fold;
  l.x = x;
  l.y = y;
  l.s = 0;
  l.guard = 0;
  l.acc = make_float3(0.f, 0.f, 0.f);
  l.rej = 0;
  l.p.act = false;
  l.p.it = 0;
}

// A lane needs one pass per iteration, so n_spp * (n_iterations + 1) + 1
// passes can only cut a loop that would otherwise not end.
__device__ __forceinline__ long long vol_pass_limit(const VolScene& S,
                                                    int n_spp) {
  return (long long)n_spp * (S.n_iterations + 1) + 1;
}

__device__ __forceinline__ bool vol_lane_done(const VolLane& l, int n_spp,
                                              long long limit) {
  return !(l.s < n_spp && l.guard < limit);
}

// One pass of a lane that is not done: start a sample if its path has
// ended, one iteration, and the sample's sum when its path ends.
__device__ __forceinline__ void vol_lane_pass(const VolScene& S,
                                              const MegaCamera& C, int s0,
                                              VolLane& l) {
  VolPath& p = l.p;
  if (!p.act) {
    start_path(p);
    camera_sample(C, l.fold, l.x, l.y, (uint32_t)(s0 + l.s), p.key, p.o, p.d);
  }
  vol_bounce(S, p);
  if (!p.act || p.it >= S.n_iterations) {
    add_sample(p.L, l.acc, l.rej);
    p.act = false;
    l.s += 1;
  }
  l.guard += 1;
}

// The scene from the host arrays of integrators/vol_megakernel.py:
// fc = 8 triangles x (v0, e1, e2, ns, light row, material type), box lo,
// hi, g, sigma_a, sigma_s, sigma_t, albedo, 4 lights x (type, v0, e1, e2,
// ng, Le); ic = n_tris, n_lights, variant, max_depth, n_iterations, nee,
// pick site, light site.
static inline VolScene vol_scene_from(const float* fc, const int* ic) {
  VolScene S;
  const float* f = fc;
  for (int k = 0; k < VOL_MAX_TRIS; ++k) {
    VolTri& t = S.tris[k];
    for (int j = 0; j < 3; ++j) {
      t.v0[j] = f[j];
      t.e1[j] = f[3 + j];
      t.e2[j] = f[6 + j];
      t.ns[j] = f[9 + j];
    }
    t.lrow = f[12];
    t.mtype = f[13];
    f += 14;
  }
  for (int j = 0; j < 3; ++j) {
    S.lo[j] = f[j];
    S.hi[j] = f[3 + j];
    S.sigma_a[j] = f[7 + j];
    S.sigma_s[j] = f[10 + j];
    S.sigma_t[j] = f[13 + j];
    S.albedo[j] = f[16 + j];
  }
  S.g = f[6];
  f += 19;
  for (int k = 0; k < VOL_MAX_LIGHTS; ++k) {
    VolLight& l = S.lights[k];
    l.type = f[0];
    for (int j = 0; j < 3; ++j) {
      l.v0[j] = f[1 + j];
      l.e1[j] = f[4 + j];
      l.e2[j] = f[7 + j];
      l.ng[j] = f[10 + j];
      l.le[j] = f[13 + j];
    }
    f += 16;
  }
  S.n_tris = ic[0];
  S.n_lights = ic[1];
  S.variant = ic[2];
  S.max_depth = ic[3];
  S.n_iterations = ic[4];
  S.nee = ic[5];
  S.pick_site = (uint32_t)ic[6];
  S.light_site = (uint32_t)ic[7];
  return S;
}

}  // namespace xrt
