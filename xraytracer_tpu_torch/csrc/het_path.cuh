// The heterogeneous volume path, one lane at a time: what the whole-path
// kernels of het_megakernel.cu run per thread. Device functions only (and
// the host function that assembles a HetScene), so that a C++ compiler can
// rehearse them on the host under a small shim of the CUDA built-ins
// (tests/test_torch_csrc_tracking.py); het_megakernel.cu adds the kernels
// and their launchers.
//
// What an iteration computes (integrators/volume.py, line for line): end at
// depth == max_depth; nearest hit over the spheres (the q-form quadratic of
// geometry/intersect.py::intersect_spheres) and the box slab (entry clamped
// to 0; a sphere wins an exact tie); a miss ends the path; Russian roulette
// on the mean throughput for depth > 0 (off under grad_sampling); a sphere
// hit adds its one-sided emission (only at depth 0 with next-event
// estimation) and ends the path; in the box, weighted delta tracking from
// the entry to the exit (media.cuh's sample loop; a uniform channel pick
// under grad_sampling) with the NaN guard on its weight; a scatter draws its
// Henyey-Greenstein direction at the recorded step's site; next-event
// estimation at a scatter vertex: one uniformly picked sphere light, its
// cone sample (lights.py, "cone"), one nearest-hit test from the vertex,
// and, where the box wins that test, the ratio-tracked transmittance from
// its entry to its exit (media.cuh's transmittance loop); a shadow ray is
// never blocked, since no sphere has a material. Depth advances only on a
// real scatter; 2 * max_depth + 2 iterations by default. Draws:
// tof(pcg(key + site * GOLDEN)) with site = iteration * 2^16 + {0 roulette,
// 16 + step * 4 + {0, 1, 2} tracking, 16 + scatter step * 4 + 3 phase, pick,
// pick + 1, pick + 16 + step (transmittance)}; pick comes from the host
// (volume.py::_nee_site_layout), so every route draws the same numbers.
//
// Parity with the plain version (the port's wavefront volume loop) is by
// construction, as in media.cuh: nvcc would contract a * b + c into one fused
// multiply-add where the plain version's tensor operations round twice, and a
// decision (a sphere or the box hit or missed, the roulette, the emitter's
// side, the light pick, the cone sample's side, the shadow ray's box) moves a
// whole path. So every product, sum and difference of this file's own
// arithmetic is XM / XA / XS (path_common.cuh), in the plain version's order;
// that includes the directions and points the next decision reads. The
// three-term dot products and the roulette's mean are ((x + y) + z), as
// PyTorch's reductions over 3 elements add and as volume.py spells out.
// Division, sqrtf, logf, expf, sinf and cosf are the accurate ones (no
// fast-math), which are the functions PyTorch calls on the card.
//
// An iteration is cut into five phases, each a function over the lane's
// state (HetLane): bounce_setup (depth bound, hit, roulette, emitter, the
// start of the tracking), media.cuh's sample_step (one collision candidate),
// nee_setup (NaN guard, vertex, light pick, cone sample, shadow hit, the
// start of the transmittance), trans_step (one candidate) and bounce_end
// (the contribution, the phase direction, the throughput). het_bounce runs
// them in order as one iteration (het_path, het_spp, het_grad_path);
// het_spp_persistent_lane runs them in the same order per turn of its loop
// but lets a warp leave a chain of candidates before its longest lane is
// done, the longer chains going on at the next turn.
#pragma once

#include "media.cuh"

namespace xrt {

constexpr int HET_MAX_SPHERES = 16;
constexpr int HET_MAX_LIGHTS = 16;
constexpr uint32_t HSITE_RR = 0, HSITE_MEDIUM = 16;

struct HetSphere {
  float c[3], r;
  int lrow;  // area-light row
};

struct HetLight {
  float c[3], r;
  float le[3];
};

struct HetScene {
  HetSphere sph[HET_MAX_SPHERES];
  HetLight lights[HET_MAX_LIGHTS];
  float lo[3], hi[3];  // the medium box
  float g;             // Henyey-Greenstein asymmetry
  float pick_prob;     // float32(1 / n_lights)
  int n_spheres, n_lights;
  int max_depth, n_iterations;
  int nee;            // next-event estimation (the integrator's flag)
  int grad_sampling;  // roulette off (G.chan_uniform picks uniformly)
  uint32_t pick_site, light_site, tr_site;
};

struct HetPath {
  uint32_t key;
  int it;     // iterations done
  int depth;  // real scatters so far
  bool act;
  float3 L, T, o, d;
};

struct HetHit {
  bool hit, box_win;
  float t, t1;
  int sph;  // winning sphere, -1 = none
};

// Nearest hit over the spheres (intersect_spheres; argmin's first index on
// exact ties = strict < in table order) and the box (intersect_boxes), and
// intersect_scene's combine: the box wins only strictly before the sphere.
__device__ __forceinline__ HetHit het_intersect(const HetScene& S, float3 o,
                                                float3 d) {
  HetHit h;
  float t_sph = INF_T;
  h.sph = -1;
  const float a = dot3x(d, d);
  for (int k = 0; k < S.n_spheres; ++k) {
    const HetSphere& sp = S.sph[k];
    const float3 ell =
        make_float3(XS(o.x, sp.c[0]), XS(o.y, sp.c[1]), XS(o.z, sp.c[2]));
    const float b = XM(2.0f, dot3x(d, ell));
    const float c = XS(dot3x(ell, ell), XM(sp.r, sp.r));
    const float disc = XS(XM(b, b), XM(XM(4.0f, a), c));
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float q = b > 0.f ? XM(-0.5f, XA(b, sq)) : XM(-0.5f, XS(b, sq));
    const float q_safe = q == 0.f ? 1.0f : q;
    const float x0 = q / a;
    const float x1 = q == 0.f ? x0 : c / q_safe;
    const float t0 = fminf(x0, x1), t1 = fmaxf(x0, x1);
    const float t = t0 > 0.f ? t0 : t1;
    if ((disc >= 0.f) & (t > 0.f) & (t < t_sph)) {
      t_sph = t;
      h.sph = k;
    }
  }
  float ax, bx, ay, by, az, bz;
  slab(o.x, d.x, S.lo[0], S.hi[0], ax, bx);
  slab(o.y, d.y, S.lo[1], S.hi[1], ay, by);
  slab(o.z, d.z, S.lo[2], S.hi[2], az, bz);
  float b0 = fmaxf(fmaxf(ax, ay), az);
  const float b1 = fminf(fminf(bx, by), bz);
  const bool bok = (b0 <= b1) & (b1 > 0.f);
  b0 = fmaxf(b0, 0.f);
  h.box_win = bok & (b0 < t_sph);  // strict: a sphere wins exact ties
  h.hit = h.box_win | (t_sph < INF_T);
  h.t = h.box_win ? b0 : t_sph;
  h.t1 = b1;
  if (h.box_win) h.sph = -1;
  return h;
}

// lights.py::sample_area_light, sphere light, "cone" strategy: a point in
// the cone the sphere subtends from mp. Returns the unit direction, the
// cone pdf and whether the point faces mp.
__device__ __forceinline__ float3 cone_sample(const HetLight& Lt, float3 mp,
                                              float lu, float lv, float& pdf,
                                              bool& front) {
  const float3 dz = make_float3(XS(Lt.c[0], mp.x), XS(Lt.c[1], mp.y),
                                XS(Lt.c[2], mp.z));
  const float len2 = dot3x(dz, dz);
  const float len = sqrtf(len2);
  const float safe_len = len == 0.f ? 1.0f : len;
  // the frame's axis points from the centre toward mp
  const float3 u = make_float3(-dz.x / safe_len, -dz.y / safe_len,
                               -dz.z / safe_len);
  float3 tx, bx;
  onb(u, tx, bx);
  const float safe_len2 = len2 == 0.f ? 1.0f : len2;
  const float sin_tm2 = XM(Lt.r, Lt.r) / safe_len2;
  const float sin_tm = sqrtf(sin_tm2);
  const float cos_tm = sqrtf(fmaxf(XS(1.0f, sin_tm2), 0.f));
  const float cos_t = XA(1.0f, XM(XS(cos_tm, 1.0f), lu));
  const float sin_t2 = XS(1.0f, XM(cos_t, cos_t));
  const float safe_sin_tm = sin_tm == 0.f ? 1.0f : sin_tm;
  const float safe_sin_tm2 = sin_tm2 == 0.f ? 1.0f : sin_tm2;
  const float cos_a = XA(
      sin_t2 / safe_sin_tm,
      XM(cos_t, sqrtf(fmaxf(XS(1.0f, sin_t2 / safe_sin_tm2), 0.f))));
  const float sin_a = sqrtf(fmaxf(XS(1.0f, XM(cos_a, cos_a)), 0.f));
  const float phi = XM(TWO_PI, lv);
  const float3 n = to_world(XM(cosf(phi), sin_a), XM(sinf(phi), sin_a), cos_a,
                            tx, bx, u);
  const float3 dv = make_float3(XS(XA(Lt.c[0], XM(n.x, Lt.r)), mp.x),
                                XS(XA(Lt.c[1], XM(n.y, Lt.r)), mp.y),
                                XS(XA(Lt.c[2], XM(n.z, Lt.r)), mp.z));
  const float t_max = sqrtf(dot3x(dv, dv));
  front = dot3x(dv, n) < 0.f;
  pdf = 1.0f / XM(TWO_PI, fmaxf(XS(1.0f, cos_tm), 1e-12f));
  const float ts = t_max == 0.f ? 1.0f : t_max;
  return make_float3(dv.x / ts, dv.y / ts, dv.z / ts);
}


// The replay hook of het_bounce that computes nothing (het_path, het_spp,
// het_spp_persistent).
struct NoReplay {
  static constexpr bool on = false;
  __device__ __forceinline__ NoTrackGrad sample_hook() const { return {}; }
};

// Pass B's per-lane state (het_megakernel.cu, the analytic volume
// gradient): residual, suffix, the lane's column of the d img / d Le
// planes, the gradient grid.
struct Replay {
  static constexpr bool on = true;
  float rfac[3], suffix[3];
  float* dE;  // plane (c * n_lights + l) at dE + (c * n_lights + l) * n
  size_t n;
  int n_lights;
  float* grad;

  __device__ __forceinline__ void add_dE(int l, const float v[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) dE[(size_t)(c * n_lights + l) * n] += v[c];
  }
  __device__ __forceinline__ SampleGrad sample_hook() const {
    SampleGrad h;
    h.grad = grad;
#pragma unroll
    for (int c = 0; c < 3; ++c) h.rs[c] = rfac[c] * suffix[c];
    return h;
  }
};

// One path and the iteration in progress. One walk serves the tracking and
// then the shadow ray's transmittance.
struct HetLane {
  HetPath p;
  uint32_t site;  // the iteration's first site
  Walk W;
  SampleLoop ks;
  TransLoop kt;
  float w[3];     // the tracking's weight after the NaN guard
  float3 mp;      // where the tracking stopped
  bool lit;       // a light sample adds a contribution at bounce_end
  bool box;       // ... through the box (kt.tr), else tr = 1
  int lidx;
  float pdf, f;
  float3 q1, q2;  // the shadow ray's box span (the replay walks it again)
};

__device__ __forceinline__ void start_path(HetPath& p) {
  p.it = 0;
  p.depth = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
}

// The iteration's set-up: depth bound, nearest hit, roulette, emitter, and
// the start of the tracking through the box. Returns false where the path
// ended (p.act = false) at the depth bound, on a miss, a roulette kill or
// an emitter.
template <class Rep>
__device__ __forceinline__ bool bounce_setup(const HetScene& S,
                                             const MediaGrid& G, HetLane& ln,
                                             Rep& rep) {
  HetPath& p = ln.p;
  ln.site = (uint32_t)p.it * SITES_PER_BOUNCE;
  p.it += 1;
  if (p.depth >= S.max_depth) {
    p.act = false;
    return false;
  }
  const float3 o = p.o, d = p.d;
  const HetHit h = het_intersect(S, o, d);
  if (!h.hit) {  // miss: black background
    p.act = false;
    return false;
  }

  // Russian roulette for depth > 0 on the mean throughput, ((r + g) + b) / 3
  // as volume.py spells it out
  if (p.depth > 0 && !S.grad_sampling) {
    const float rr_prob =
        fminf(XM(XA(XA(p.T.x, p.T.y), p.T.z), THIRD), 1.0f);
    const float u_rr = u1(p.key, ln.site + HSITE_RR);
    if (u_rr >= rr_prob) {
      p.act = false;
      return false;
    }
    const float boost = 1.0f / fmaxf(rr_prob, 1e-12f);
    p.T = make_float3(XM(p.T.x, boost), XM(p.T.y, boost), XM(p.T.z, boost));
  }

  // a sphere is an emitter: one-sided radiance about its normal at the hit
  // (lights.py::area_light_le), and the path ends
  if (h.sph >= 0) {
    const HetSphere& sp = S.sph[h.sph];
    const float3 v = make_float3(XS(XA(o.x, XM(h.t, d.x)), sp.c[0]),
                                 XS(XA(o.y, XM(h.t, d.y)), sp.c[1]),
                                 XS(XA(o.z, XM(h.t, d.z)), sp.c[2]));
    const float nl = sqrtf(dot3x(v, v));
    const float3 ns = make_float3(v.x / nl, v.y / nl, v.z / nl);
    const bool on = dot3x(make_float3(-d.x, -d.y, -d.z), ns) > 0.f;
    if (on && sp.lrow < S.n_lights && (!S.nee || p.depth == 0)) {
      const float* le = S.lights[sp.lrow].le;
      p.L = make_float3(XA(p.L.x, XM(p.T.x, le[0])),
                        XA(p.L.y, XM(p.T.y, le[1])),
                        XA(p.L.z, XM(p.T.z, le[2])));
      if constexpr (Rep::on) {  // emitted: T Le leaves the suffix
        const float T3[3] = {p.T.x, p.T.y, p.T.z};
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rep.suffix[c] = XS(rep.suffix[c], XM(T3[c], le[c]));
        rep.add_dE(sp.lrow, T3);
      }
    }
    p.act = false;
    return false;
  }

  // the box: weighted delta tracking from its entry to its exit
  sample_begin(G, ln.W, ln.ks, o, d, h.t, h.t1, ln.site + HSITE_MEDIUM);
  return true;
}

// One collision candidate of the tracking; false once it is done.
template <class Hook>
__device__ __forceinline__ bool bounce_sample_step(const MediaGrid& G,
                                                   HetLane& ln,
                                                   const Hook& hook) {
  const float T3[3] = {ln.p.T.x, ln.p.T.y, ln.p.T.z};
  return sample_step(G, ln.W, ln.ks, ln.p.o, ln.p.d, T3, ln.p.key, hook);
}

// After the tracking: the NaN guard on its weight, the vertex, and the
// set-up of next-event estimation there (light pick, cone sample, the
// shadow ray's nearest hit). Returns true where the shadow ray crosses the
// box, whose transmittance trans_step then walks.
__device__ __forceinline__ bool nee_setup(const HetScene& S,
                                          const MediaGrid& G, HetLane& ln) {
  const HetPath& p = ln.p;
  const TrackResult& R = ln.ks.R;
  const bool nan = isnan(R.w[0]) | isnan(R.w[1]) | isnan(R.w[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) ln.w[c] = nan ? 0.f : R.w[c];
  ln.mp = ray_at(p.o, p.d, R.t);
  ln.lit = false;
  if (!(S.nee && S.n_lights > 0 && R.scattered)) return false;
  const float u_pick = u1(p.key, ln.site + S.pick_site);
  const int lidx = min((int)XM(u_pick, (float)S.n_lights), S.n_lights - 1);
  float lu, lv;
  u2(p.key, ln.site + S.light_site, lu, lv);
  float pdf_cone;
  bool front;
  const float3 wi = cone_sample(S.lights[lidx], ln.mp, lu, lv, pdf_cone, front);
  const float pdf = XM(S.pick_prob, pdf_cone);
  if (!(pdf > 0.f && front)) return false;
  // one nearest-hit test from the vertex: no sphere blocks, the box
  // multiplies its ratio-tracked transmittance from entry to exit
  const HetHit sh = het_intersect(S, ln.mp, wi);
  ln.lit = true;
  ln.lidx = lidx;
  ln.pdf = pdf;
  ln.f = hg_phase(S.g, dot3x(p.d, wi));
  ln.box = sh.box_win;
  if (!sh.box_win) return false;
  ln.q1 = ray_at(ln.mp, wi, sh.t);
  ln.q2 = ray_at(ln.mp, wi, sh.t1);
  trans_begin(G, ln.W, ln.kt, ln.q1, ln.q2, ln.site + S.tr_site);
  return true;
}

// One candidate of the shadow ray's transmittance; false once it is done.
__device__ __forceinline__ bool bounce_trans_step(const MediaGrid& G,
                                                  HetLane& ln) {
  return trans_step(G, ln.W, ln.kt, ln.p.key, NoTrackGrad{});
}

// The iteration's end: the light sample's contribution, then the advance
// (the phase direction is drawn at the scatter step's site; depth only on
// a real scatter) and the throughput.
template <class Rep>
__device__ __forceinline__ void bounce_end(const HetScene& S,
                                           const MediaGrid& G, HetLane& ln,
                                           Rep& rep) {
  HetPath& p = ln.p;
  if (ln.lit) {
    const HetLight& Lt = S.lights[ln.lidx];
    float tr[3] = {1.0f, 1.0f, 1.0f};
    if (ln.box) {
#pragma unroll
      for (int c = 0; c < 3; ++c) tr[c] = ln.kt.tr[c];
    }
    // radiance += (T * w) * (((tr * f) * Le) / pdf)
    const float tw[3] = {XM(p.T.x, ln.w[0]), XM(p.T.y, ln.w[1]),
                         XM(p.T.z, ln.w[2])};
    float contrib[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      contrib[c] = XM(tw[c], XM(XM(tr[c], ln.f), Lt.le[c]) / ln.pdf);
    p.L = make_float3(XA(p.L.x, contrib[0]), XA(p.L.y, contrib[1]),
                      XA(p.L.z, contrib[2]));
    if constexpr (Rep::on) {
      float dle[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) dle[c] = tw[c] * (tr[c] * ln.f / ln.pdf);
      rep.add_dE(ln.lidx, dle);
      if (ln.box) {  // the transmittance's events, on the same walk
        TransGrad th;
        th.grad = rep.grad;
#pragma unroll
        for (int c = 0; c < 3; ++c) th.pend[c] = rep.rfac[c] * contrib[c];
        trans_begin(G, ln.W, ln.kt, ln.q1, ln.q2, ln.site + S.tr_site);
        while (trans_step(G, ln.W, ln.kt, p.key, th)) {
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) rep.suffix[c] = XS(rep.suffix[c], contrib[c]);
    }
  }

  const TrackResult& R = ln.ks.R;
  const float3 d = p.d;
  p.o = ln.mp;
  if (R.scattered) {
    float up1, up2;
    u2(p.key,
       ln.site + HSITE_MEDIUM + (uint32_t)R.scat_step * SITES_PER_STEP + 3u,
       up1, up2);
    p.d = hg_direction(S.g, d, up1, up2);
    p.depth += 1;
  }
  p.T = make_float3(XM(p.T.x, ln.w[0]), XM(p.T.y, ln.w[1]),
                    XM(p.T.z, ln.w[2]));
  if (!((p.T.x > 0.f) | (p.T.y > 0.f) | (p.T.z > 0.f))) p.act = false;
}

// One iteration of an active path, its phases in order. Ends the path
// (act = false) at the depth bound, on a miss, a roulette kill, an
// emitter, or zero throughput. ``rep`` is NoReplay for the forward kernels
// and Replay for het_grad_path.
template <class Rep>
__device__ __forceinline__ void het_bounce(const HetScene& S,
                                           const MediaGrid& G, HetLane& ln,
                                           Rep& rep) {
  if (!bounce_setup(S, G, ln, rep)) return;
  const auto hook = rep.sample_hook();
  while (bounce_sample_step(G, ln, hook)) {
  }
  if (nee_setup(S, G, ln))
    while (bounce_trans_step(G, ln)) {
    }
  bounce_end(S, G, ln, rep);
}

// One path per ray: its radiance (het_path; het_grad_path with a Replay).
template <class Rep>
__device__ __forceinline__ float3 het_path_lane(const HetScene& S,
                                                const MediaGrid& G,
                                                uint32_t key, float3 o,
                                                float3 d, Rep& rep) {
  HetLane ln;
  start_path(ln.p);
  ln.p.key = key;
  ln.p.o = o;
  ln.p.d = d;
  while (ln.p.act && ln.p.it < S.n_iterations) het_bounce(S, G, ln, rep);
  return ln.p.L;
}

// Samples s0 .. s0 + n_spp - 1 of one pixel, one after the other, each
// path iteration by iteration (het_spp).
__device__ __forceinline__ void het_spp_lane(const HetScene& S,
                                             const MediaGrid& G,
                                             const MegaCamera& C, int s0,
                                             int n_spp, uint32_t fold, float x,
                                             float y, float3& acc, int& rej) {
  NoReplay none;
  HetLane ln;
  for (int s = 0; s < n_spp; ++s) {
    start_path(ln.p);
    camera_sample(C, fold, x, y, (uint32_t)(s0 + s), ln.p.key, ln.p.o, ln.p.d);
    while (ln.p.act && ln.p.it < S.n_iterations) het_bounce(S, G, ln, none);
    add_sample(ln.p.L, acc, rej);
  }
}

// One step of the candidate chain PHASE (the tracking, or the shadow ray's
// transmittance) for every lane of the warp that is in it, repeated while
// at least a quarter of the warp's live lanes are; a lane whose chain ends
// moves on to NEXT. The vote is warp-uniform, so the loop ends for all
// lanes at once; the lanes still in their chain then wait, and take it up
// again at the next turn. (Releasing at a half made nee 1.4x slower,
// never releasing made volume 1.4x slower; PERF.md has both.)
template <int PHASE, int NEXT, class Step>
__device__ __forceinline__ void chain_while_quarter(int& phase,
                                                    long long& guard,
                                                    const Step& step) {
  for (;;) {
    const unsigned live = __activemask();
    const int n_in = __popc(__ballot_sync(live, phase == PHASE));
    if (n_in == 0 || 4 * n_in < __popc(live)) return;
    if (phase == PHASE) {
      ++guard;
      if (!step()) phase = NEXT;
    }
  }
}

// The same samples with the loops merged (het_spp_persistent). A turn of
// the loop is one iteration of the lane's path in program order: the
// set-up (and, after a path's end, the start of the lane's next sample),
// the tracking's candidates, the NEE set-up, the transmittance's
// candidates, the end; so the warp's lanes run each phase's code together,
// as in het_spp_lane. But a chain of candidates no longer holds the warp
// until its longest lane is done: the warp steps a chain while at least a
// quarter of its lanes are in it (chain_while_quarter), and a lane whose
// chain is longer carries it over to the next turn, where it steps it
// again while the others go on to their next iteration. Each lane takes
// the same steps in the same order whatever the schedule and adds its own
// samples in ascending order, so the sums are het_spp_lane's.
__device__ __forceinline__ void het_spp_persistent_lane(
    const HetScene& S, const MediaGrid& G, const MegaCamera& C, int s0,
    int n_spp, uint32_t fold, float x, float y, float3& acc, int& rej) {
  enum { SETUP, SAMPLE, NEE, TRANS, END };
  NoReplay none;
  HetLane ln;
  int phase = SETUP;
  bool fresh = true;  // the next set-up starts a sample
  int s = 0;
  // a sample takes at most n_iterations x (set-up, max_steps + 1 tracking
  // steps, NEE set-up, max_steps + 1 transmittance steps, end) and one
  // set-up that ends it; the bound (on the lane's own steps) can only cut a
  // loop that would otherwise not end
  const long long per_iteration = 2LL * (G.max_steps > 0 ? G.max_steps : 0) + 5;
  const long long limit =
      (long long)n_spp * ((long long)S.n_iterations * per_iteration + 1) + 1;
  for (long long guard = 0; s < n_spp && guard < limit;) {
    if (phase == SETUP) {
      ++guard;
      if (fresh) {
        start_path(ln.p);
        camera_sample(C, fold, x, y, (uint32_t)(s0 + s), ln.p.key, ln.p.o,
                      ln.p.d);
        fresh = false;
      }
      if (ln.p.act && ln.p.it < S.n_iterations &&
          bounce_setup(S, G, ln, none)) {
        phase = SAMPLE;
      } else {
        add_sample(ln.p.L, acc, rej);
        s += 1;
        fresh = true;
      }
    }
    if (s >= n_spp) break;
    chain_while_quarter<SAMPLE, NEE>(
        phase, guard, [&] { return bounce_sample_step(G, ln, NoTrackGrad{}); });
    if (phase == NEE) {
      ++guard;
      phase = nee_setup(S, G, ln) ? TRANS : END;
    }
    chain_while_quarter<TRANS, END>(phase, guard,
                                    [&] { return bounce_trans_step(G, ln); });
    if (phase == END) {
      ++guard;
      bounce_end(S, G, ln, none);
      phase = SETUP;
    }
  }
}

// The scene from the host arrays of integrators/het_megakernel.py:
// fc = 16 spheres x (centre, radius, light row), 16 lights x (centre,
// radius, Le), box lo, hi, g, pick probability; ic = n_spheres, n_lights,
// max_depth, n_iterations, nee, grad_sampling, pick site, light site,
// transmittance site.
static inline HetScene het_scene_from(const float* fc, const int* ic) {
  HetScene S;
  const float* f = fc;
  for (int k = 0; k < HET_MAX_SPHERES; ++k) {
    HetSphere& s = S.sph[k];
    for (int j = 0; j < 3; ++j) s.c[j] = f[j];
    s.r = f[3];
    s.lrow = (int)f[4];
    f += 5;
  }
  for (int k = 0; k < HET_MAX_LIGHTS; ++k) {
    HetLight& l = S.lights[k];
    for (int j = 0; j < 3; ++j) {
      l.c[j] = f[j];
      l.le[j] = f[4 + j];
    }
    l.r = f[3];
    f += 7;
  }
  for (int j = 0; j < 3; ++j) {
    S.lo[j] = f[j];
    S.hi[j] = f[3 + j];
  }
  S.g = f[6];
  S.pick_prob = f[7];
  S.n_spheres = ic[0];
  S.n_lights = ic[1];
  S.max_depth = ic[2];
  S.n_iterations = ic[3];
  S.nee = ic[4];
  S.grad_sampling = ic[5];
  S.pick_site = (uint32_t)ic[6];
  S.light_site = (uint32_t)ic[7];
  S.tr_site = (uint32_t)ic[8];
  return S;
}

}  // namespace xrt
