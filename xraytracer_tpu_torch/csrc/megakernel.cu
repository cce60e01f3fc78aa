// Whole-path kernels of the surface path tracer: one thread carries one path
// (or one pixel's whole run of samples) from the camera ray to its last
// bounce without leaving registers.
//
// Replaces, in xraytracer_tpu/integrators/megakernel.py:
//   mega_path            <- _mega_kernel                 (over _trace_body)
//   mega_spp             <- _mega_spp_kernel             (over _trace_body)
//   mega_spp_persistent  <- _mega_spp_persistent_kernel  (over
//                           _make_surface_iteration)
//   mega_grad_path       <- _mega_grad_kernel            (over _trace_body
//                           with ``grads``)
// One device function for a bounce (`bounce`), a template over a Jacobian
// accumulator, four kernels around it, four extern "C" launchers. The
// render kernels instantiate it with `NoGrad`, whose hooks are empty, so
// they compile to the bounce alone; mega_grad_path instantiates it with
// `Grad`.
//
// What a bounce computes (triangles only, Lambert only, flat area lights):
// nearest hit over the whole table; exact (t, u, v) of the winner by the
// classic form on record columns 15-23; geometric normal from the edges and
// shading normal from columns 0-8; Russian roulette on the mean throughput
// from the second bounce on; one-sided emitter radiance (only at the first
// bounce when next-event estimation is on); next-event estimation, either
// summed over every light with one shadow test each ("all") or for one
// light picked uniformly ("one") or by power ("power"); then a cosine- or
// uniformly-sampled Lambert direction in the copysign frame of the shading
// normal, which a path's last bounce skips. Every random number is
// tof(pcg(key + site * GOLDEN)) with the site layout of the wavefront
// integrator (RR 0, BSDF 1, lights 16+i, stride 2^16 per bounce), in native
// wrapping uint32 arithmetic, so all routes draw the same numbers.
//
// The three kernels.
//   mega_path            rays and keys in, radiance out: at most max_depth
//                        bounces per thread.
//   mega_spp             per pixel, a loop over samples s0 .. s0+n_spp-1:
//                        key = pcg(pixfold + s), jittered pinhole ray, the
//                        path, rejection of a NaN / Inf / negative sample,
//                        sum. A warp starts sample s+1 only when its slowest
//                        lane has finished sample s.
//   mega_spp_persistent  the same render with the sample loop and the bounce
//                        loop merged: each pass of the single loop runs one
//                        bounce, and a lane whose path has ended starts its
//                        next sample in the next pass, so the lanes of a
//                        warp sit at different samples and the warp waits
//                        only for its slowest lane's whole run. Each lane
//                        still adds its own samples in ascending order, so
//                        the sums are those of mega_spp.
//
// Design for this card, and what the Pallas kernels did only for theirs.
// The TPU kernels test 512-lane rows against 128-row chunks as one matmul
// with a packed integer key, extract the winner's record with a one-hot
// matmul and bake lights, camera and flags into the program. Here every
// lane walks the table itself, nothing is compiled per scene: lights sit in
// a device table (at most 64 rows), the camera and the flags are launch
// arguments. The triangle coefficients (tri_test.cuh, 64 B a row) are
// computed by a small preparation kernel that each launcher runs first, into
// scratch the caller owns; a second copy holds zero rows for triangles that
// do not block shadow rays. There is no shared-memory staging and therefore
// NO BARRIER in these kernels: lanes of a block leave the loops at
// different times, and a barrier would force every lane, finished or beyond
// n, to keep turning up. All lanes of a warp that are inside a table walk
// read the same row, so each load is one broadcast from L1 / L2 (4096 rows
// x 64 B x 2 copies stay far below the 50 MB L2).
//
// Winner rule: strict t < best while walking rows upwards, first index wins
// exact ties, as in sweep.cu (the Pallas key keeps the lowest row among hits
// within 2^-16 relative t instead). The per-chunk AABB culling of the Pallas
// kernels is work reduction and is not done here.
//
// mega_grad_path carries, beside the path, its Jacobians w.r.t. the
// material albedos and the light emissions (see `Grad` below): the gradient
// of the same estimator that autodiff of the wavefront integrator computes,
// in the forward pass. Its outputs are 3 + 9M + 3L planes of N floats
// (radiance, dL/dalbedo, dL/dLe); each lane owns its column, so there are no
// atomics and the stores of a warp are coalesced. Its 9 x MAX_GRAD_MATS
// throughput Jacobian lives in registers (every loop over materials is
// unrolled), its sums in the output planes, read and written in place; it
// moves 28 + 4 (3 + 9M + 3L) bytes per lane, so it is bound by operations
// for Cornell (M = 3, L = 1) and by bytes once the lights are many.
//
// What bounds it on an H100: float32 operations. A pixel moves 12 B in and
// 16 B out per launch whatever the sample count, while every ray costs T
// pair tests of ~38 flops. The kernels are brute force and far above that
// bound; most of the gap is the scalar shading between the table walks and
// warp divergence (lanes that died, lanes past the table walk).
//
// nvcc contracts a*b+c into FMAs; no fast-math flags, so division, sqrtf,
// sinf and cosf are the accurate ones.

#include "path_common.cuh"
#include "tri_test.cuh"

namespace xrt {

constexpr int MEGA_BLOCK = 128;
constexpr int LIGHT_STRIDE = 20;  // floats per light-table row, see below
constexpr uint32_t SITE_RR = 0, SITE_BSDF = 1, SITE_LIGHT0 = 16;
constexpr float SHADOW_BIAS = 0.01f;
constexpr float PI_INV = (float)(1.0 / 3.14159265359);

enum NeeKind { NEE_ALL = 0, NEE_ONE = 1, NEE_POWER = 2 };

// Light-table row: [0] type (0 triangle, 1 quad), [1..3] v0, [4..6] e1,
// [7..9] e2, [10..12] ng (unnormalised e1 x e2), [13..15] Le,
// [16] probability of picking this light ("one" / "power"), [17..19] unused.
struct MegaScene {
  const float4* coef;         // (T, 4) coefficients, zero rows never hit
  const float4* coef_blocks;  // the same, zero rows for non-blocking rows
  const float4* tri_rec;      // (T, 8) = (T, 32) floats
  const float* center;        // (3,) table centroid
  const float* lights;        // (n_lights, LIGHT_STRIDE)
  const float* pick_cdf;      // (n_lights + 1,), NEE_POWER only
  int t_total;
  int n_lights;
  int max_depth;
  int nee;       // next-event estimation on (and n_lights > 0)
  int le0;       // emitter radiance only at the first bounce
  int cosine;    // cosine-weighted instead of uniform hemisphere sampling
  int nee_kind;  // NeeKind
};

struct Path {
  uint32_t key;
  int it;  // bounces done
  bool act;
  float3 L, T, o, d;
};

// The hooks `bounce` calls at the points where the Jacobians change. For the
// render kernels every hook is empty and compiles to nothing.
struct NoGrad {
  __device__ __forceinline__ void hit(float) {}
  // the boosted throughput
  __device__ __forceinline__ float3 roulette(float3 t, float boost, float) {
    return make_float3(t.x * boost, t.y * boost, t.z * boost);
  }
  __device__ __forceinline__ void emit(float3, float3, int) {}
  __device__ __forceinline__ void nee(float3, float3, float3, float, int) {}
  __device__ __forceinline__ void scatter(float3, float3, float) {}
};

constexpr int MAX_GRAD_MATS = 8;  // integrators/megakernel.py::MAX_GRAD_MATS

// Per-lane Jacobians of the estimator w.r.t. mat_albedo (M x 3) and al_le
// (L x 3), the recursion of _trace_body(grads=...):
//   GT[c][cc][m] = dT_c / dalbedo_{m,cc}   (registers: every loop over m is
//                                           unrolled to MAX_GRAD_MATS and
//                                           predicated on n_mats)
//   dL[c][cc][m] = dL_c / dalbedo_{m,cc}   (plane 3 + (3c + cc) M + m)
//   dE[c][l]     = dL_c / dLe_{l,c}        (plane 3 + 9M + c L + l)
// Channels couple through the roulette's boost 1 / mean(T); Le enters no
// throughput, so dE has no cross-channel terms. dL and dE are summed in the
// lane's own column of the output, which the constructor zeroes.
struct Grad {
  const int32_t* __restrict__ obj_mat;  // object -> material row, -1 none
  int n_obj, n_mats, n_lights;
  float* __restrict__ out;  // (3 + 9M + 3L, n) plane-major
  int n, i;
  int mat;  // material of the current hit, -1 none
  float GT[3][3][MAX_GRAD_MATS];

  __device__ __forceinline__ float& dl(int c, int cc, int m) {
    return out[(size_t)(3 + (3 * c + cc) * n_mats + m) * n + i];
  }
  __device__ __forceinline__ float& de(int c, int l) {
    return out[(size_t)(3 + 9 * n_mats + c * n_lights + l) * n + i];
  }

  __device__ __forceinline__ Grad(const int32_t* om, int no, int nm, int nl,
                                  float* o, int n_, int i_)
      : obj_mat(om), n_obj(no), n_mats(nm), n_lights(nl), out(o), n(n_),
        i(i_), mat(-1) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
#pragma unroll
        for (int m = 0; m < MAX_GRAD_MATS; ++m) GT[c][cc][m] = 0.f;
    const int planes = 3 + 9 * n_mats + 3 * n_lights;
    for (int k = 3; k < planes; ++k) out[(size_t)k * n + i] = 0.f;
  }

  // the winner's record column 24 (object id) -> its material row
  __device__ __forceinline__ void hit(float obj_col) {
    const int obj = (int)obj_col;
    const int m = (obj >= 0 && obj < n_obj) ? __ldg(obj_mat + obj) : -1;
    mat = m < n_mats ? m : -1;
  }

  // T' = T * boost, boost = 1 / max(min(mean(T), 1), 1e-12): the product
  // rule with dboost = -boost^2 * gate * sum_c GT / 3, where gate is the
  // derivative of the two clamps: 1 inside, 0 outside and 1/2 AT a tie, as
  // autodiff's minimum / maximum. Ties are the rule, not the exception: a
  // white albedo of exactly 1 keeps the mean at 1, and so does a white
  // bounce right after a roulette, since mean(T / mean(T)) = 1. Whether the
  // rounded mean lands on 1 depends on every rounding before it, so the
  // mean is rounded as the plain version computes it, and the throughput is
  // returned as the plain version boosts it: divided by the probability
  // (the render kernels multiply by its reciprocal, an ulp apart).
  __device__ __forceinline__ float3 roulette(float3 t, float boost,
                                             float rr_prob) {
    const float mean_t = XM(XA(XA(t.x, t.y), t.z), THIRD);
    float gate = mean_t < 1.0f ? 1.0f : (mean_t == 1.0f ? 0.5f : 0.f);
    gate *= rr_prob > 1e-12f ? 1.0f : (rr_prob == 1e-12f ? 0.5f : 0.f);
    const float live = XM(XM(gate, -XM(boost, boost)), THIRD);
    const float tc[3] = {t.x, t.y, t.z};
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
#pragma unroll
      for (int m = 0; m < MAX_GRAD_MATS; ++m) {
        if (m >= n_mats) break;
        const float db = live * ((GT[0][cc][m] + GT[1][cc][m]) + GT[2][cc][m]);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          GT[c][cc][m] = GT[c][cc][m] * boost + tc[c] * db;
      }
    const float q = fmaxf(rr_prob, 1e-12f);
    return make_float3(t.x / q, t.y / q, t.z / q);
  }

  // L += T * Le on an emitter hit of light li
  __device__ __forceinline__ void emit(float3 t, float3 le, int li) {
    const float tc[3] = {t.x, t.y, t.z}, lc[3] = {le.x, le.y, le.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
#pragma unroll
        for (int m = 0; m < MAX_GRAD_MATS; ++m) {
          if (m >= n_mats) break;
          dl(c, cc, m) += GT[c][cc][m] * lc[c];
        }
      de(c, li) += tc[c];
    }
  }

  // L += T * albedo * Le * coef for a light sample of light li; the hit's
  // own albedo adds the same-channel term T * Le * coef
  __device__ __forceinline__ void nee(float3 t, float3 alb, float3 le,
                                      float coef, int li) {
    if (coef == 0.f) return;
    const float tc[3] = {t.x, t.y, t.z}, ac[3] = {alb.x, alb.y, alb.z};
    const float lc[3] = {le.x * coef, le.y * coef, le.z * coef};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
#pragma unroll
        for (int m = 0; m < MAX_GRAD_MATS; ++m) {
          if (m >= n_mats) break;
          float dd = GT[c][cc][m] * ac[c];
          if (cc == c && m == mat) dd += tc[c];
          dl(c, cc, m) += dd * lc[c];
        }
      de(c, li) += tc[c] * ac[c] * coef;
    }
  }

  // T' = T * w with w = albedo * f (f = 1 cosine, 2 cos(theta) uniform)
  __device__ __forceinline__ void scatter(float3 t, float3 w, float f) {
    const float tc[3] = {t.x, t.y, t.z}, wc[3] = {w.x, w.y, w.z};
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
#pragma unroll
        for (int m = 0; m < MAX_GRAD_MATS; ++m) {
          if (m >= n_mats) break;
          float g = GT[c][cc][m] * wc[c];
          if (cc == c && m == mat) g += tc[c] * f;
          GT[c][cc][m] = g;
        }
  }
};

__device__ __forceinline__ int nearest_row(const float4* __restrict__ coef,
                                           int t_total, float3 oc, float3 d,
                                           float3 m) {
  float best_t = BIG_T;
  int best_i = -1;
#pragma unroll 2
  for (int k = 0; k < t_total; ++k) {
    const PairTest r =
        pair_test(__ldg(coef + 4 * k), __ldg(coef + 4 * k + 1),
                  __ldg(coef + 4 * k + 2), __ldg(coef + 4 * k + 3), oc, d, m);
    if (r.ok) {
      const float t = r.t_num / r.det;
      if (t < best_t) {
        best_t = t;
        best_i = k;
      }
    }
  }
  return best_i;
}

__device__ __forceinline__ bool any_hit(const float4* __restrict__ coef,
                                        int t_total, float3 oc, float3 d,
                                        float3 m, float tm) {
  // t_s > eps*|det| > 0 can never be below t_max*|det| when t_max <= 0
  if (!(tm > 0.f)) return false;
#pragma unroll 2
  for (int k = 0; k < t_total; ++k) {
    const PairTest r =
        pair_test(__ldg(coef + 4 * k), __ldg(coef + 4 * k + 1),
                  __ldg(coef + 4 * k + 2), __ldg(coef + 4 * k + 3), oc, d, m);
    if (r.ok && r.t_s < tm * r.absd) return true;
  }
  return false;
}

// One light sample's weight cos / pdf / pi, 0 when it contributes nothing.
// The shadow test runs only for a sample that could contribute.
__device__ __forceinline__ float nee_coef(const MegaScene& S, float3 center,
                                          float3 P, float3 ng, float3 ns,
                                          float3 d, float3 lp, float3 gn,
                                          float pdf_scale, float prob) {
  const float3 dl = sub3(lp, P);
  const float tl = sqrtf(dl.x * dl.x + dl.y * dl.y + dl.z * dl.z);
  const float ddn = dl.x * gn.x + dl.y * gn.y + dl.z * gn.z;
  const bool front = ddn < 0.f;
  float denom = fabsf(ddn);
  denom = denom == 0.f ? 1.0f : denom;
  const float pdf = pdf_scale * tl * tl * tl / denom * prob;
  const bool ok = pdf > 0.f;
  const float ti = 1.0f / (tl == 0.f ? 1.0f : tl);
  const float3 wi = make_float3(dl.x * ti, dl.y * ti, dl.z * ti);
  const float cosv = fmaxf(0.f, ng.x * wi.x + ng.y * wi.y + ng.z * wi.z);
  const float wo_y = -(d.x * ns.x + d.y * ns.y + d.z * ns.z);
  const float wi_y = wi.x * ns.x + wi.y * ns.y + wi.z * ns.z;
  const bool above = (wo_y > 0.f) & (wi_y > 0.f);
  if (!(ok & above & front) || !(cosv > 0.f)) return 0.f;
  const float3 so = make_float3(P.x + ng.x * SHADOW_BIAS,
                                P.y + ng.y * SHADOW_BIAS,
                                P.z + ng.z * SHADOW_BIAS);
  const float3 soc = sub3(so, center);
  if (any_hit(S.coef_blocks, S.t_total, soc, wi, cross3(soc, wi),
              tl - SHADOW_BIAS))
    return 0.f;
  return cosv / pdf * PI_INV;
}

// One bounce of an active path. Ends the path (act = false) on a miss, a
// roulette kill, an emitter, zero throughput, or after the last bounce.
// ``jac`` follows the Jacobians (NoGrad: nothing).
template <class J>
__device__ __forceinline__ void bounce(const MegaScene& S, const float3 center,
                                       Path& p, J& jac) {
  const uint32_t base = (uint32_t)p.it * SITES_PER_BOUNCE;
  const float3 o = p.o, d = p.d;
  const float3 oc = sub3(o, center);
  const int row = nearest_row(S.coef, S.t_total, oc, d, cross3(oc, d));
  const int it = p.it;
  p.it = it + 1;
  if (row < 0) {  // miss: black background
    p.act = false;
    return;
  }

  // the winner's packed record: normals 0-8, v0 e1 e2 15-23, light 25,
  // albedo 29-31
  const float4* rec = S.tri_rec + (size_t)row * 8;
  const float4 r0 = __ldg(rec + 0), r1 = __ldg(rec + 1), r2 = __ldg(rec + 2),
               r3 = __ldg(rec + 3), r4 = __ldg(rec + 4), r5 = __ldg(rec + 5),
               r6 = __ldg(rec + 6), r7 = __ldg(rec + 7);
  const float3 n0 = make_float3(r0.x, r0.y, r0.z);
  const float3 n1 = make_float3(r0.w, r1.x, r1.y);
  const float3 n2 = make_float3(r1.z, r1.w, r2.x);
  const float3 v0 = make_float3(r3.w, r4.x, r4.y);
  const float3 e1 = make_float3(r4.z, r4.w, r5.x);
  const float3 e2 = make_float3(r5.y, r5.z, r5.w);
  const float lrow = r6.y;
  const float3 alb = make_float3(r7.y, r7.z, r7.w);
  jac.hit(r6.x);

  float t, tu, tv;
  winner_tuv(o, d, v0, e1, e2, t, tu, tv);

  float3 ng = cross3(e1, e2);
  const float ngi = 1.0f / sqrtf(ng.x * ng.x + ng.y * ng.y + ng.z * ng.z);
  ng = make_float3(ng.x * ngi, ng.y * ngi, ng.z * ngi);
  const float w0 = 1.0f - tu - tv;
  float3 ns = make_float3(w0 * n0.x + tu * n1.x + tv * n2.x,
                          w0 * n0.y + tu * n1.y + tv * n2.y,
                          w0 * n0.z + tu * n1.z + tv * n2.z);
  const float nsi =
      1.0f / fmaxf(sqrtf(ns.x * ns.x + ns.y * ns.y + ns.z * ns.z), 1e-20f);
  ns = make_float3(ns.x * nsi, ns.y * nsi, ns.z * nsi);
  const float3 P = make_float3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);

  // Russian roulette from the second bounce on
  if (it > 0) {
    const float u_rr = u1(p.key, base + SITE_RR);
    const float rr_prob = fminf((p.T.x + p.T.y + p.T.z) * THIRD, 1.0f);
    if (u_rr >= rr_prob) {
      p.act = false;
      return;
    }
    const float boost = 1.0f / fmaxf(rr_prob, 1e-12f);
    p.T = jac.roulette(p.T, boost, rr_prob);
  }

  // emitter hit: one-sided radiance, and the path ends
  if (lrow >= 0.f) {
    if (!S.le0 || it == 0) {
      const float wons = -(d.x * ns.x + d.y * ns.y + d.z * ns.z);
      const int li = (int)lrow;
      if (wons > 0.f && li < S.n_lights) {
        const float3 le = ld3(S.lights + li * LIGHT_STRIDE + 13);
        p.L.x += p.T.x * le.x;
        p.L.y += p.T.y * le.y;
        p.L.z += p.T.z * le.z;
        jac.emit(p.T, le, li);
      }
    }
    p.act = false;
    return;
  }

  // next-event estimation over the flat area lights
  if (S.nee) {
    if (S.nee_kind == NEE_ALL) {
      for (int i = 0; i < S.n_lights; ++i) {
        float lu, lv;
        u2(p.key, base + SITE_LIGHT0 + (uint32_t)i, lu, lv);
        const float* row_l = S.lights + i * LIGHT_STRIDE;
        const bool is_tri = __ldg(row_l) == 0.f;
        const float3 lp = light_point(is_tri, ld3(row_l + 1), ld3(row_l + 4),
                                      ld3(row_l + 7), lu, lv);
        const float coef =
            nee_coef(S, center, P, ng, ns, d, lp, ld3(row_l + 10),
                     is_tri ? 2.0f : 1.0f, 1.0f);
        const float3 le = ld3(row_l + 13);
        p.L.x += p.T.x * alb.x * le.x * coef;
        p.L.y += p.T.y * alb.y * le.y * coef;
        p.L.z += p.T.z * alb.z * le.z * coef;
        jac.nee(p.T, alb, le, coef, i);
      }
    } else {
      // one light per vertex: pick at site LIGHT0, sample at LIGHT0 + 1
      const float u_pick = u1(p.key, base + SITE_LIGHT0);
      int lidx;
      if (S.nee_kind == NEE_POWER) {
        // lower_bound over the cdf (n_lights + 1 entries) with the x == 0
        // bump: count of entries below u_pick, at least 1, minus 1
        int x = 0;
        for (int j = 0; j <= S.n_lights; ++j)
          x += __ldg(S.pick_cdf + j) < u_pick ? 1 : 0;
        lidx = min(max(max(x, 1) - 1, 0), S.n_lights - 1);
      } else {
        lidx = min((int)(u_pick * (float)S.n_lights), S.n_lights - 1);
      }
      float lu, lv;
      u2(p.key, base + SITE_LIGHT0 + 1u, lu, lv);
      const float* row_l = S.lights + lidx * LIGHT_STRIDE;
      const bool is_tri = __ldg(row_l) == 0.f;
      const float3 lp = light_point(is_tri, ld3(row_l + 1), ld3(row_l + 4),
                                    ld3(row_l + 7), lu, lv);
      const float coef =
          nee_coef(S, center, P, ng, ns, d, lp, ld3(row_l + 10),
                   is_tri ? 2.0f : 1.0f, __ldg(row_l + 16));
      const float3 le = ld3(row_l + 13);
      p.L.x += p.T.x * alb.x * le.x * coef;
      p.L.y += p.T.y * alb.y * le.y * coef;
      p.L.z += p.T.z * alb.z * le.z * coef;
      jac.nee(p.T, alb, le, coef, lidx);
    }
  }

  // the last bounce's sampled direction feeds nothing
  if (it + 1 >= S.max_depth) {
    p.act = false;
    return;
  }

  // Lambert resampling in the copysign frame of the shading normal
  float ub1, ub2;
  u2(p.key, base + SITE_BSDF, ub1, ub2);
  const float phi = TWO_PI * ub2;
  float lx, ly, lz;
  float3 w = alb;
  float f_bounce = 1.0f;  // w = albedo * f_bounce
  if (S.cosine) {
    const float rad = sqrtf(ub1);
    lx = rad * cosf(phi);
    lz = rad * sinf(phi);
    ly = sqrtf(fmaxf(0.f, 1.0f - ub1));
  } else {
    const float st = sqrtf(fmaxf(0.f, 1.0f - ub1 * ub1));
    lx = st * cosf(phi);
    ly = ub1;
    lz = st * sinf(phi);
    const float cw = 2.0f * fmaxf(ly, 0.f);
    w = make_float3(alb.x * cw, alb.y * cw, alb.z * cw);
    f_bounce = cw;
  }
  const float sg = copysignf(1.0f, ns.z);
  const float a = -1.0f / (sg + ns.z);
  const float b = ns.x * ns.y * a;
  const float3 t0 =
      make_float3(1.0f + sg * ns.x * ns.x * a, sg * b, -sg * ns.x);
  const float3 b0 = make_float3(b, sg + ns.y * ns.y * a, -ns.y);
  const float3 ww = make_float3(lx * t0.x + ly * ns.x + lz * b0.x,
                                lx * t0.y + ly * ns.y + lz * b0.y,
                                lx * t0.z + ly * ns.z + lz * b0.z);
  jac.scatter(p.T, w, f_bounce);
  p.T = make_float3(p.T.x * w.x, p.T.y * w.y, p.T.z * w.z);
  if (!((p.T.x > 0.f) | (p.T.y > 0.f) | (p.T.z > 0.f))) {
    p.act = false;
    return;
  }
  const float side = d.x * ng.x + d.y * ng.y + d.z * ng.z;
  const float isign = side > 0.f ? -1.0f : (side < 0.f ? 1.0f : 0.f);
  const float off = isign * SHADOW_BIAS;
  p.o = make_float3(P.x + off * ng.x, P.y + off * ng.y, P.z + off * ng.z);
  p.d = ww;
}

// Key and camera ray of sample ``s`` of one pixel (path_common.cuh), and a
// fresh path.
__device__ __forceinline__ void start_sample(const MegaCamera& C,
                                             uint32_t pixfold, float px,
                                             float py, uint32_t s, Path& p) {
  camera_sample(C, pixfold, px, py, s, p.key, p.o, p.d);
  p.it = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
}

__global__ void __launch_bounds__(MEGA_BLOCK)
mega_coeffs_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
                   const float* __restrict__ e2,
                   const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ blocks,
                   const float* __restrict__ center, int t_total,
                   float4* __restrict__ coef, float4* __restrict__ coef_blocks) {
  const int j = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (j >= t_total) return;
  const float3 c = make_float3(center[0], center[1], center[2]);
  const TriCoeffs z = zero_coeffs();
  TriCoeffs f = z;
  if (valid[j]) f = tri_coeffs(sub3(load3(v0, j), c), load3(e1, j), load3(e2, j));
  const TriCoeffs g = blocks[j] ? f : z;
  coef[4 * j + 0] = f.f0;
  coef[4 * j + 1] = f.f1;
  coef[4 * j + 2] = f.f2;
  coef[4 * j + 3] = f.f3;
  coef_blocks[4 * j + 0] = g.f0;
  coef_blocks[4 * j + 1] = g.f1;
  coef_blocks[4 * j + 2] = g.f2;
  coef_blocks[4 * j + 3] = g.f3;
}

__global__ void __launch_bounds__(MEGA_BLOCK)
mega_path_kernel(MegaScene S, const float* __restrict__ o,
                 const float* __restrict__ d, const int32_t* __restrict__ keys,
                 int n, float* __restrict__ out) {
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float3 center = ld3(S.center);
  Path p;
  p.key = (uint32_t)keys[i];
  p.it = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
  p.o = load3(o, i);
  p.d = load3(d, i);
  NoGrad ng;
  while (p.act && p.it < S.max_depth) bounce(S, center, p, ng);
  out[3 * i + 0] = p.L.x;
  out[3 * i + 1] = p.L.y;
  out[3 * i + 2] = p.L.z;
}

__global__ void __launch_bounds__(MEGA_BLOCK)
mega_spp_kernel(MegaScene S, MegaCamera C, int s0, int n_spp,
                const int32_t* __restrict__ pixfold,
                const float* __restrict__ px, const float* __restrict__ py,
                int n, float* __restrict__ out_sum, int* __restrict__ out_rej) {
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float3 center = ld3(S.center);
  const uint32_t fold = (uint32_t)pixfold[i];
  const float x = px[i], y = py[i];
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  Path p;
  NoGrad ng;
  for (int s = 0; s < n_spp; ++s) {
    start_sample(C, fold, x, y, (uint32_t)(s0 + s), p);
    while (p.act && p.it < S.max_depth) bounce(S, center, p, ng);
    add_sample(p.L, acc, rej);
  }
  out_sum[3 * i + 0] = acc.x;
  out_sum[3 * i + 1] = acc.y;
  out_sum[3 * i + 2] = acc.z;
  out_rej[i] = rej;
}

__global__ void __launch_bounds__(MEGA_BLOCK)
mega_spp_persistent_kernel(MegaScene S, MegaCamera C, int s0, int n_spp,
                           const int32_t* __restrict__ pixfold,
                           const float* __restrict__ px,
                           const float* __restrict__ py, int n,
                           float* __restrict__ out_sum,
                           int* __restrict__ out_rej) {
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float3 center = ld3(S.center);
  const uint32_t fold = (uint32_t)pixfold[i];
  const float x = px[i], y = py[i];
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  Path p;
  p.act = false;
  p.it = 0;
  NoGrad ng;
  int s = 0;
  // a lane needs one pass per bounce; the bound can only cut a loop that
  // would otherwise not end
  const long long limit = (long long)n_spp * (S.max_depth + 1) + 1;
  for (long long guard = 0; s < n_spp && guard < limit; ++guard) {
    if (!p.act) start_sample(C, fold, x, y, (uint32_t)(s0 + s), p);
    bounce(S, center, p, ng);
    if (!p.act || p.it >= S.max_depth) {
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

// Radiance and Jacobians of one whole path per ray: mega_path_kernel with
// the Grad accumulator. ``out`` holds 3 + 9M + 3L planes of n floats.
__global__ void __launch_bounds__(MEGA_BLOCK)
mega_grad_path_kernel(MegaScene S, const int32_t* __restrict__ obj_mat,
                      int n_obj, int n_mats, const float* __restrict__ o,
                      const float* __restrict__ d,
                      const int32_t* __restrict__ keys, int n,
                      float* __restrict__ out) {
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float3 center = ld3(S.center);
  Grad jac(obj_mat, n_obj, n_mats, S.n_lights, out, n, i);
  Path p;
  p.key = (uint32_t)keys[i];
  p.it = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
  p.o = load3(o, i);
  p.d = load3(d, i);
  while (p.act && p.it < S.max_depth) bounce(S, center, p, jac);
  out[i] = p.L.x;
  out[(size_t)n + i] = p.L.y;
  out[2 * (size_t)n + i] = p.L.z;
}

// What the launchers share: the scene arguments as the C interface takes
// them, the preparation launch, and the argument structs.
struct SceneArgs {
  const float* v0;
  const float* e1;
  const float* e2;
  const uint8_t* valid;
  const uint8_t* blocks;
  int t_total;
  const float* center;
  float* coef;         // scratch (t_total, 16)
  float* coef_blocks;  // scratch (t_total, 16)
  const float* tri_rec;
  const float* lights;
  const float* pick_cdf;
  int n_lights, max_depth, nee, le0, cosine, nee_kind;
};

static MegaScene prepare(const SceneArgs& a, cudaStream_t stream) {
  const int grid = (a.t_total + MEGA_BLOCK - 1) / MEGA_BLOCK;
  mega_coeffs_kernel<<<grid, MEGA_BLOCK, 0, stream>>>(
      a.v0, a.e1, a.e2, a.valid, a.blocks, a.center, a.t_total,
      (float4*)a.coef, (float4*)a.coef_blocks);
  MegaScene S;
  S.coef = (const float4*)a.coef;
  S.coef_blocks = (const float4*)a.coef_blocks;
  S.tri_rec = (const float4*)a.tri_rec;
  S.center = a.center;
  S.lights = a.lights;
  S.pick_cdf = a.pick_cdf;
  S.t_total = a.t_total;
  S.n_lights = a.n_lights;
  S.max_depth = a.max_depth;
  S.nee = a.nee;
  S.le0 = a.le0;
  S.cosine = a.cosine;
  S.nee_kind = a.nee_kind;
  return S;
}

}  // namespace xrt

// The scene arguments of every launcher, in SceneArgs order.
#define XRT_SCENE_PARAMS                                                     \
  const float *v0, const float *e1, const float *e2, const uint8_t *valid,   \
      const uint8_t *blocks, int t_total, const float *center, float *coef,  \
      float *coef_blocks, const float *tri_rec, const float *lights,         \
      const float *pick_cdf, int n_lights, int max_depth, int nee, int le0,  \
      int cosine, int nee_kind
#define XRT_SCENE_ARGS                                                       \
  xrt::SceneArgs {                                                           \
    v0, e1, e2, valid, blocks, t_total, center, coef, coef_blocks, tri_rec,  \
        lights, pick_cdf, n_lights, max_depth, nee, le0, cosine, nee_kind    \
  }

extern "C" {

// Each launcher returns cudaGetLastError() after its launches (0 =
// accepted). ``cam16`` is the host array of path_common.cuh's camera_from.

int mega_path(const float* o, const float* d, const int32_t* keys, int n,
              XRT_SCENE_PARAMS, float* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  const int grid = (n + xrt::MEGA_BLOCK - 1) / xrt::MEGA_BLOCK;
  xrt::mega_path_kernel<<<grid, xrt::MEGA_BLOCK, 0, st>>>(S, o, d, keys, n,
                                                          out);
  return (int)cudaGetLastError();
}

int mega_spp(int s0, int n_spp, const int32_t* pixfold, const float* px,
             const float* py, int n, const float* cam16, unsigned cam_site,
             XRT_SCENE_PARAMS, float* out_sum, int* out_rej, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::MEGA_BLOCK - 1) / xrt::MEGA_BLOCK;
  xrt::mega_spp_kernel<<<grid, xrt::MEGA_BLOCK, 0, st>>>(
      S, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

int mega_spp_persistent(int s0, int n_spp, const int32_t* pixfold,
                        const float* px, const float* py, int n,
                        const float* cam16, unsigned cam_site,
                        XRT_SCENE_PARAMS, float* out_sum, int* out_rej,
                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  const xrt::MegaCamera C = xrt::camera_from(cam16, cam_site);
  const int grid = (n + xrt::MEGA_BLOCK - 1) / xrt::MEGA_BLOCK;
  xrt::mega_spp_persistent_kernel<<<grid, xrt::MEGA_BLOCK, 0, st>>>(
      S, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  return (int)cudaGetLastError();
}

// ``out``: (3 + 9 n_mats + 3 n_lights, n) plane-major; n_mats <= MAX_GRAD_MATS.
int mega_grad_path(const float* o, const float* d, const int32_t* keys, int n,
                   XRT_SCENE_PARAMS, const int32_t* obj_mat, int n_obj,
                   int n_mats, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_mats < 0 || n_mats > xrt::MAX_GRAD_MATS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  const int grid = (n + xrt::MEGA_BLOCK - 1) / xrt::MEGA_BLOCK;
  xrt::mega_grad_path_kernel<<<grid, xrt::MEGA_BLOCK, 0, st>>>(
      S, obj_mat, n_obj, n_mats, o, d, keys, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
