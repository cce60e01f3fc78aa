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
// One device function for an iteration (`het_bounce`), four kernels around
// it, four extern "C" launchers, as vol_megakernel.cu has for the
// homogeneous box.
//
// The scene such a kernel takes: no triangles, exactly one box carrying the
// scene's one heterogeneous medium, at most 16 spheres, each purely emissive,
// at most 16 lights, all spheres. Spheres, box, lights and options travel BY
// VALUE as a launch argument (HetScene, under 1 KB); the density grid, its
// corner-packed rows and the supergrid stay in device memory and go by
// pointer (MediaGrid of media.cuh, as for the tracking kernels). Nothing is
// compiled per scene.
//
// What an iteration computes (integrators/volume.py, line for line): end at
// depth == max_depth; nearest hit over the spheres (the q-form quadratic of
// geometry/intersect.py::intersect_spheres) and the box slab (entry clamped
// to 0; a sphere wins an exact tie); a miss ends the path; Russian roulette
// on the mean throughput for depth > 0 (off under grad_sampling); a sphere
// hit adds its one-sided emission (only at depth 0 with next-event
// estimation) and ends the path; in the box, weighted delta tracking from
// the entry to the exit (media.cuh::track_sample; a uniform channel pick
// under grad_sampling) with the NaN guard on its weight; a scatter draws its
// Henyey-Greenstein direction at the recorded step's site; next-event
// estimation at a scatter vertex: one uniformly picked sphere light, its
// cone sample (lights.py, "cone"), one nearest-hit test from the vertex,
// and, where the box wins that test, the ratio-tracked transmittance from
// its entry to its exit (media.cuh::track_transmittance); a shadow ray is
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
// What bounds it on an H100: float32 operations (a pixel moves 12 B in and
// 16 B out per launch whatever the sample count; the 1 MB grid and the
// supergrid stay in the 50 MB L2). An iteration in the cloud costs the
// supergrid walk of the tracking (~800 flop) and ~170 flop per collision
// candidate, and as much again for the shadow ray's transmittance. What
// keeps it from that bound is latency and divergence: every candidate is a
// dependent chain of logf, a 25-way search, a 32-byte row load and expf;
// the lanes of a warp take different numbers of candidates, iterations and
// samples. The design does the simple things: one thread per lane, the
// segments of each walk in a per-thread local array, no shared memory and
// no barrier (a lane that is done costs only its slot in the warp), and in
// het_spp_persistent the sample loop merged into the iteration loop, so a
// lane whose path ends starts its next sample at once. Each lane adds its
// own samples in ascending order, so het_spp and het_spp_persistent give the
// same sums.

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

#include "media.cuh"

// Blocks per SM the compiler must leave room for (the second argument of
// __launch_bounds__): 4 blocks of 128 threads caps a thread at 128
// registers. The path state, two 304-byte segment frames and the tracking
// loops need more than K7's 90; PERF.md records what the cap costs.
#ifndef HET_MIN_BLOCKS
#define HET_MIN_BLOCKS 4
#endif

namespace xrt {

constexpr int HET_BLOCK = 128;
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
};

// Pass B's per-lane state (see the top of this file): residual, suffix,
// the lane's column of the d img / d Le planes, the gradient grid.
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

// One iteration of an active path. Ends the path (act = false) at the depth
// bound, on a miss, a roulette kill, an emitter, or zero throughput. ``rep``
// is NoReplay for the forward kernels and Replay for het_grad_path.
template <class Rep>
__device__ __forceinline__ void het_bounce(const HetScene& S,
                                           const MediaGrid& G, HetPath& p,
                                           Rep& rep) {
  const uint32_t site = (uint32_t)p.it * SITES_PER_BOUNCE;
  p.it += 1;
  if (p.depth >= S.max_depth) {
    p.act = false;
    return;
  }
  const float3 o = p.o, d = p.d;
  const HetHit h = het_intersect(S, o, d);
  if (!h.hit) {  // miss: black background
    p.act = false;
    return;
  }

  // Russian roulette for depth > 0 on the mean throughput, ((r + g) + b) / 3
  // as volume.py spells it out
  if (p.depth > 0 && !S.grad_sampling) {
    const float rr_prob =
        fminf(XM(XA(XA(p.T.x, p.T.y), p.T.z), THIRD), 1.0f);
    const float u_rr = u1(p.key, site + HSITE_RR);
    if (u_rr >= rr_prob) {
      p.act = false;
      return;
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
    return;
  }

  // the box: weighted delta tracking from its entry to its exit
  const float T3[3] = {p.T.x, p.T.y, p.T.z};
  TrackResult R;
  if constexpr (Rep::on)
    R = track_sample(G, o, d, h.t, h.t1, T3, p.key, site + HSITE_MEDIUM,
                     rep.sample_hook());
  else
    R = track_sample(G, o, d, h.t, h.t1, T3, p.key, site + HSITE_MEDIUM);
  float w[3] = {R.w[0], R.w[1], R.w[2]};
  if (isnan(w[0]) | isnan(w[1]) | isnan(w[2])) w[0] = w[1] = w[2] = 0.f;
  const bool scattered = R.scattered != 0;
  const float3 mp = ray_at(o, d, R.t);

  // next-event estimation at the scatter vertex
  if (S.nee && S.n_lights > 0 && scattered) {
    const float u_pick = u1(p.key, site + S.pick_site);
    const int lidx =
        min((int)XM(u_pick, (float)S.n_lights), S.n_lights - 1);
    float lu, lv;
    u2(p.key, site + S.light_site, lu, lv);
    const HetLight& Lt = S.lights[lidx];
    float pdf_cone;
    bool front;
    const float3 wi = cone_sample(Lt, mp, lu, lv, pdf_cone, front);
    const float pdf = XM(S.pick_prob, pdf_cone);
    if (pdf > 0.f && front) {
      // one nearest-hit test from the vertex: no sphere blocks, the box
      // multiplies its ratio-tracked transmittance from entry to exit
      const HetHit sh = het_intersect(S, mp, wi);
      float tr[3] = {1.0f, 1.0f, 1.0f};
      const float3 q1 = ray_at(mp, wi, sh.t), q2 = ray_at(mp, wi, sh.t1);
      if (sh.box_win)
        track_transmittance(G, q1, q2, p.key, site + S.tr_site, tr);
      const float f = hg_phase(S.g, dot3x(d, wi));
      // radiance += (T * w) * (((tr * f) * Le) / pdf)
      const float tw[3] = {XM(p.T.x, w[0]), XM(p.T.y, w[1]), XM(p.T.z, w[2])};
      float contrib[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        contrib[c] = XM(tw[c], XM(XM(tr[c], f), Lt.le[c]) / pdf);
      p.L = make_float3(XA(p.L.x, contrib[0]), XA(p.L.y, contrib[1]),
                        XA(p.L.z, contrib[2]));
      if constexpr (Rep::on) {
        float dle[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) dle[c] = tw[c] * (tr[c] * f / pdf);
        rep.add_dE(lidx, dle);
        if (sh.box_win) {  // the transmittance's events, on the same walk
          TransGrad th;
          th.grad = rep.grad;
#pragma unroll
          for (int c = 0; c < 3; ++c) th.pend[c] = rep.rfac[c] * contrib[c];
          float tr2[3];
          track_transmittance(G, q1, q2, p.key, site + S.tr_site, tr2, th);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) rep.suffix[c] = XS(rep.suffix[c], contrib[c]);
      }
    }
  }

  // advance: the phase direction is drawn at the scatter step's site; depth
  // only on a real scatter
  p.o = mp;
  if (scattered) {
    float up1, up2;
    u2(p.key,
       site + HSITE_MEDIUM + (uint32_t)R.scat_step * SITES_PER_STEP + 3u,
       up1, up2);
    p.d = hg_direction(S.g, d, up1, up2);
    p.depth += 1;
  }
  p.T = make_float3(XM(p.T.x, w[0]), XM(p.T.y, w[1]), XM(p.T.z, w[2]));
  if (!((p.T.x > 0.f) | (p.T.y > 0.f) | (p.T.z > 0.f))) p.act = false;
}

__device__ __forceinline__ void het_bounce(const HetScene& S,
                                           const MediaGrid& G, HetPath& p) {
  NoReplay none;
  het_bounce(S, G, p, none);
}

__device__ __forceinline__ void start_path(HetPath& p) {
  p.it = 0;
  p.depth = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
}

__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_path_kernel(HetScene S, MediaGrid G, const float* __restrict__ o,
                const float* __restrict__ d, const int32_t* __restrict__ keys,
                int n, float* __restrict__ out) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  HetPath p;
  start_path(p);
  p.key = (uint32_t)keys[i];
  p.o = load3(o, i);
  p.d = load3(d, i);
  while (p.act && p.it < S.n_iterations) het_bounce(S, G, p);
  out[3 * i + 0] = p.L.x;
  out[3 * i + 1] = p.L.y;
  out[3 * i + 2] = p.L.z;
}

__global__ void __launch_bounds__(HET_BLOCK, HET_MIN_BLOCKS)
het_spp_kernel(HetScene S, MediaGrid G, MegaCamera C, int s0, int n_spp,
               const int32_t* __restrict__ pixfold,
               const float* __restrict__ px, const float* __restrict__ py,
               int n, float* __restrict__ out_sum, int* __restrict__ out_rej) {
  const int i = blockIdx.x * HET_BLOCK + threadIdx.x;
  if (i >= n) return;
  const uint32_t fold = (uint32_t)pixfold[i];
  const float x = px[i], y = py[i];
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  HetPath p;
  for (int s = 0; s < n_spp; ++s) {
    start_path(p);
    camera_sample(C, fold, x, y, (uint32_t)(s0 + s), p.key, p.o, p.d);
    while (p.act && p.it < S.n_iterations) het_bounce(S, G, p);
    add_sample(p.L, acc, rej);
  }
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
  const uint32_t fold = (uint32_t)pixfold[i];
  const float x = px[i], y = py[i];
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  HetPath p;
  p.act = false;
  p.it = 0;
  int s = 0;
  // a lane needs one pass per iteration; the bound can only cut a loop that
  // would otherwise not end
  const long long limit = (long long)n_spp * (S.n_iterations + 1) + 1;
  for (long long guard = 0; s < n_spp && guard < limit; ++guard) {
    if (!p.act) {
      start_path(p);
      camera_sample(C, fold, x, y, (uint32_t)(s0 + s), p.key, p.o, p.d);
    }
    het_bounce(S, G, p);
    if (!p.act || p.it >= S.n_iterations) {
      add_sample(p.L, acc, rej);
      p.act = false;
      s += 1;
    }
  }
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
  HetPath p;
  start_path(p);
  p.key = (uint32_t)keys[i];
  p.o = load3(o, i);
  p.d = load3(d, i);
  while (p.act && p.it < S.n_iterations) het_bounce(S, G, p, rep);
  out[3 * i + 0] = p.L.x;
  out[3 * i + 1] = p.L.y;
  out[3 * i + 2] = p.L.z;
}

// The scene from the host arrays of integrators/het_megakernel.py:
// fc = 16 spheres x (centre, radius, light row), 16 lights x (centre,
// radius, Le), box lo, hi, g, pick probability; ic = n_spheres, n_lights,
// max_depth, n_iterations, nee, grad_sampling, pick site, light site,
// transmittance site.
static HetScene het_scene_from(const float* fc, const int* ic) {
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

}  // extern "C"
