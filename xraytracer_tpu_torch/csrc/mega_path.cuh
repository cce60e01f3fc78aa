// One surface path of the whole-path kernels (megakernel.cu): the table
// walks, the shading of a hit, and the lane of the merged loop (K1c) cut
// into what one pass does before and after its walk. No launch here:
// megakernel.cu's kernels call these functions, and a host program can
// call them too (the CPU rehearsal in tests/test_torch_csrc_mega.py, where
// a "warp" is 32 lanes in a loop and a row or record accessor is a plain
// pointer).
//
// Two ways to walk a pass's rays:
//   bounce             the nearest walk of one path ray over every row
//                      (nearest_row), then the shading, whose light samples
//                      each walk their shadow ray at once over the blocks
//                      copy of the table (any_hit, which stops at the first
//                      blocker). No kernel launches it: it is the reference
//                      the host rehearsals (tests/test_torch_csrc_mega.py,
//                      tests/test_torch_csrc_grad_surface.py) hold the
//                      other walks to.
//   k1c_begin / walk / k1c_end
//                      the merged loop's pass: a lane carries two rays into
//                      the walk, its path ray and the shadow ray of its
//                      previous vertex's last light sample, whose term
//                      T * albedo * Le and weight wait in the lane
//                      (Pending). One walk tests both against each row,
//                      loaded once: test_pair_rows over every row (a table
//                      staged whole) or culled_pair_walk over the chunk table
//                      (sweep.cuh; a warp visits a group, then a chunk,
//                      only when some lane's path ray or shadow ray enters
//                      its box before its best t resp. its t_max). The
//                      shadow ray reads the row's blocks bit and does not
//                      stop at its first blocker. K1a, K1b and K5 run the
//                      same pass with one sample a lane at a time, its ray
//                      given or its sample's camera ray (pass_rays / walk /
//                      path_end; K5, and K1a on a staged table, without
//                      deferring: every shadow ray walked at once by a
//                      walker over the staged rows or the blocks copy).
//
// Bitwise the per-sample loop. The nearest rule is the same in both (strict
// t < best, rows in ascending order, so the first row wins exact ties; a
// chunk the culled walk skips holds no row that could replace the best, as
// in sweep.cuh), and a shadow ray's answer is a boolean, whichever rows it
// was tested against after its first blocker. A light sample adds
// tal * coef to L, tal = (T * albedo) * Le rounded as it was, coef its
// weight or 0 when blocked, so a deferred term is the same fused
// multiply-add as the inline one (add_term). It is added after the next
// walk and before that pass's shading: the next addition to the same L
// (an emitter hit, the next vertex's light samples) comes after it, as it
// did. A path whose last vertex left a shadow ray keeps its L while the
// lane's next sample starts (draws are a pure function of key and site);
// the next pass resolves the term, adds the finished sample and only then
// shades the new one, so each lane adds its samples in ascending order.
// Of several light samples at one vertex ("all"), only the last is
// deferred: the others walk inline before it, in light order.
#pragma once

#include <type_traits>

#include "path_common.cuh"
#include "sweep.cuh"

namespace xrt {

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
  const uint8_t* blocks;      // (T,) 1 = the row blocks shadow rays
  const float4* boxes;        // the chunk table's boxes (sweep.cuh), or
                              // null: a table staged whole
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

// Row and record accessors: __ldg from global memory, or plain loads (a
// block's copy in shared memory; the host).
struct LdgRows {
  const float4* p;
  __device__ __forceinline__ float4 operator[](int j) const {
    return __ldg(p + j);
  }
};
struct PlainRows {
  const float4* p;
  __device__ __forceinline__ float4 operator[](int j) const { return p[j]; }
};
// Whether row k blocks shadow rays: a byte per row, or a bit per row
// (bit k % 32 of word k / 32).
struct ByteBits {
  const uint8_t* b;
  __device__ __forceinline__ bool operator()(int k) const { return b[k] != 0; }
};
struct WordBits {
  const uint32_t* w;
  __device__ __forceinline__ bool operator()(int k) const {
    return (w[k >> 5] >> (k & 31)) & 1u;
  }
};

// ---------------------------------------------------------------------------
// the walks
// ---------------------------------------------------------------------------
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

// pair_test (tri_test.cuh) cut in two, its expressions unchanged, so every
// value and decision is the same: the triangle's plane first (det, t_num),
// then its edges (u, v) only where the plane is hit in range. A warp skips
// the edges of a row no lane needs. The form follows the table's size, as
// K1c's walk does (megakernel.cu, MEGA_STAGE_ROWS): a staged table (the
// Cornell box's 40 rows) runs the whole pair_test, 3-5% faster there than
// plane first, as a ray in a small closed box crosses most planes in
// range; the culled walk of a larger table tests plane first (the 256-row
// rooms' rows staged ran 17-40% slower by the whole test: their light rows
// block nothing, and a ray crosses few of the other planes in range;
// PERF.md, section 6).
struct PairPlane {
  float det, absd, t_num, t_s;
  bool neg;
};

__device__ __forceinline__ PairPlane pair_plane(const float4 f0, const float3 oc,
                                                const float3 d) {
  PairPlane p;
  p.det = -(d.x * f0.x + d.y * f0.y + d.z * f0.z);
  p.t_num = (oc.x * f0.x + oc.y * f0.y + oc.z * f0.z) - f0.w;
  p.neg = p.det < 0.f;
  p.absd = fabsf(p.det);
  p.t_s = p.neg ? -p.t_num : p.t_num;
  return p;
}

// pair_test's ok, less its plane tests |det| >= eps, t_s > eps |det|
__device__ __forceinline__ bool pair_edges(const PairPlane& p, const float4 f1,
                                           const float4 f2, const float4 f3,
                                           const float3 d, const float3 m) {
  const float u_num = (m.x * f1.x + m.y * f1.y + m.z * f1.z) +
                      (d.x * f1.w + d.y * f2.x + d.z * f2.y);
  const float v_num = (d.x * f3.y + d.y * f3.z + d.z * f3.w) -
                      (m.x * f2.z + m.y * f2.w + m.z * f3.x);
  const float u_s = p.neg ? -u_num : u_num;
  const float v_s = p.neg ? -v_num : v_num;
  return (u_s >= 0.f) & (v_s >= 0.f) & (u_s + v_s <= p.absd);
}

// A plane hit whose t_s exceeds fl(fl(best_t |det|) * NEAR_SLACK) lies
// beyond best_t |det| (two roundings of at most 2^-24 each are less than
// the slack), so its quotient rounds to at least best_t and cannot win: its
// edges and its division are skipped without changing the winner.
constexpr float NEAR_SLACK = 1.0f + 0x1p-20f;

// Rows base .. base + count - 1 against a pass's two rays: the path ray
// ``a`` (nearest: strict t < best) where ``want_a``, the shadow ray ``s``
// (blocked when a blocking row's t_s < t_max |det|; best_i >= 0 then) where
// ``want_s``. Each row is loaded once for both; PLANE_FIRST tests a row's
// plane before its edges (above).
template <bool PLANE_FIRST, class R, class B>
__device__ __forceinline__ void test_pair_rows(R rows, B blocks, int base,
                                               int count, SweepRay& a,
                                               SweepRay& s, bool want_a,
                                               bool want_s) {
#pragma unroll 8
  for (int k = base; k < base + count; ++k) {
    const float4 f0 = rows[4 * k];
    if (!PLANE_FIRST) {
      const float4 f1 = rows[4 * k + 1], f2 = rows[4 * k + 2],
                   f3 = rows[4 * k + 3];
      if (want_a) {
        const PairTest r = pair_test(f0, f1, f2, f3, a.oc, a.d, a.m);
        if (r.ok) {
          const float t = r.t_num / r.det;
          if (t < a.best_t) {
            a.best_t = t;
            a.best_i = k;
          }
        }
      }
      if (want_s && !s.done) {
        const PairTest r = pair_test(f0, f1, f2, f3, s.oc, s.d, s.m);
        if (r.ok && r.t_s < s.best_t * r.absd && blocks(k)) {
          s.best_i = k;
          s.done = true;
        }
      }
      continue;
    }
    if (want_a) {
      const PairPlane p = pair_plane(f0, a.oc, a.d);
      if ((p.absd >= K_EPS) & (p.t_s > K_EPS * p.absd) &
          (p.t_s <= a.best_t * p.absd * NEAR_SLACK)) {
        if (pair_edges(p, rows[4 * k + 1], rows[4 * k + 2], rows[4 * k + 3],
                       a.d, a.m)) {
          const float t = p.t_num / p.det;
          if (t < a.best_t) {
            a.best_t = t;
            a.best_i = k;
          }
        }
      }
    }
    if (want_s && !s.done && blocks(k)) {
      const PairPlane p = pair_plane(f0, s.oc, s.d);
      if ((p.absd >= K_EPS) & (p.t_s > K_EPS * p.absd) &
          (p.t_s < s.best_t * p.absd)) {
        if (pair_edges(p, rows[4 * k + 1], rows[4 * k + 2], rows[4 * k + 3],
                       s.d, s.m)) {
          s.best_i = k;
          s.done = true;
        }
      }
    }
  }
}

// The chunk table's walk for a warp's two rays per lane. ``W`` provides
// LANES, path[LANES] and shadow[LANES] (SweepRay) and vote(bool), as
// sweep.cuh's walkers do. A lane wants a box when its path ray enters it
// before its best t or its shadow ray before its t_max (sweep.cuh's
// ``wants``, padded and pruned alike); the warp visits a group, and then a
// chunk of it, only when one of its lanes wants it, and only the rays
// that want a chunk test its rows.
template <class W, class R, class B>
__device__ __forceinline__ void culled_pair_walk(W& w, const float4* boxes,
                                                 R rows, B blocks,
                                                 int t_total) {
  const int n_chunks = (t_total + SWEEP_CHUNK - 1) / SWEEP_CHUNK;
  const int n_groups = (n_chunks + SWEEP_GROUP - 1) / SWEEP_GROUP;
  for (int g = 0; g < n_groups; ++g) {
    const int c0 = g * SWEEP_GROUP, c1 = min(n_chunks, c0 + SWEEP_GROUP);
    const float4* gb = boxes + 2 * (n_chunks + g);
    bool ga[W::LANES], gs[W::LANES];
    bool any = false;
    for (int i = 0; i < W::LANES; ++i) {
      ga[i] = wants(w.path[i], gb);
      gs[i] = wants(w.shadow[i], gb);
      any |= ga[i] | gs[i];
    }
    if (!w.vote(any)) continue;
    for (int c = c0; c < c1; ++c) {
      const bool one = c1 - c0 == 1;  // the group's box is the chunk's
      bool ca[W::LANES], cs[W::LANES];
      bool any_c = false;
      for (int i = 0; i < W::LANES; ++i) {
        ca[i] = ga[i] && (one || wants(w.path[i], boxes + 2 * c));
        cs[i] = gs[i] && (one || wants(w.shadow[i], boxes + 2 * c));
        any_c |= ca[i] | cs[i];
      }
      if (!w.vote(any_c)) continue;
      const int count = min(SWEEP_CHUNK, t_total - c * SWEEP_CHUNK);
      for (int i = 0; i < W::LANES; ++i)
        if (ca[i] | cs[i])
          test_pair_rows<true>(rows, blocks, c * SWEEP_CHUNK, count,
                               w.path[i], w.shadow[i], ca[i], cs[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// the shading of a hit
// ---------------------------------------------------------------------------
// One light sample: its weight cos / pdf / pi if nothing blocks it (0 when
// it contributes nothing) and the shadow ray that decides it, which is
// walked only for a sample that could contribute (``test``; a t_max <= 0
// can never be blocked).
struct LightSample {
  float coef;
  bool test;
  float3 soc, wi;  // shadow ray: origin - centre, direction
  float tm;
};

__device__ __forceinline__ LightSample light_sample(float3 center, float3 P,
                                                    float3 ng, float3 ns,
                                                    float3 d, float3 lp,
                                                    float3 gn, float pdf_scale,
                                                    float prob) {
  LightSample r;
  r.coef = 0.f;
  r.test = false;
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
  if (!(ok & above & front) || !(cosv > 0.f)) return r;
  const float3 so = make_float3(P.x + ng.x * SHADOW_BIAS,
                                P.y + ng.y * SHADOW_BIAS,
                                P.z + ng.z * SHADOW_BIAS);
  r.soc = sub3(so, center);
  r.wi = wi;
  r.tm = tl - SHADOW_BIAS;
  r.test = r.tm > 0.f;
  r.coef = cosv / pdf * PI_INV;
  return r;
}

// A light sample whose shadow ray waits for the next pass's walk (K1c).
struct Pending {
  bool on;
  float3 soc, wi;
  float tm;
  float3 tal;  // (T * albedo) * Le
  float coef;  // the weight if nothing blocks the shadow ray
};

// L += tal * c, each channel one multiply-add, as a light sample has always
// added its term
__device__ __forceinline__ void add_term(float3& L, float3 tal, float c) {
  L.x += tal.x * c;
  L.y += tal.y * c;
  L.z += tal.z * c;
}

// Whether a light sample's shadow ray is blocked, walked at once: over the
// blocks copy of the table through L1 (GlobalShadow), or over a table staged
// in shared memory by the whole pair test and its blocks bits (RowsShadow).
// Both give any_hit's boolean: a zero row of the blocks copy never passes
// the pair test, and a row whose bit is clear is not a blocker.
struct GlobalShadow {
  const MegaScene& S;
  __device__ __forceinline__ bool operator()(float3 soc, float3 wi,
                                             float tm) const {
    return any_hit(S.coef_blocks, S.t_total, soc, wi, cross3(soc, wi), tm);
  }
};
template <class R, class B>
struct RowsShadow {
  R rows;
  B bits;
  int t_total;
  __device__ __forceinline__ bool operator()(float3 soc, float3 wi,
                                             float tm) const {
    SweepRay a, s;
    s.oc = soc;
    s.d = wi;
    s.m = cross3(soc, wi);
    s.best_t = tm;
    s.best_i = -1;
    s.done = false;
    test_pair_rows<false>(rows, bits, 0, t_total, a, s, false, true);
    return s.best_i >= 0;
  }
};

// The term of light sample ``ls`` of light ``li``: added now, its shadow
// ray walked by ``sw``, or (``defer``, NoGrad only) left in ``pend`` for
// the next walk.
template <class J, class SW>
__device__ __forceinline__ void nee_term(const MegaScene& S, Path& p, J& jac,
                                         float3 alb, float3 le,
                                         const LightSample& ls, int li,
                                         bool defer, Pending& pend,
                                         const SW& sw) {
  const float3 tal = make_float3(p.T.x * alb.x * le.x, p.T.y * alb.y * le.y,
                                 p.T.z * alb.z * le.z);
  if (defer && ls.test) {
    pend.on = true;
    pend.soc = ls.soc;
    pend.wi = ls.wi;
    pend.tm = ls.tm;
    pend.tal = tal;
    pend.coef = ls.coef;
    return;
  }
  float coef = ls.coef;
  if (ls.test && sw(ls.soc, ls.wi, ls.tm)) coef = 0.f;
  add_term(p.L, tal, coef);
  jac.nee(p.T, alb, le, coef, li);
}

// The hit on row ``row`` (-1: a miss) of an active path's ray, and what
// follows it: ends the path (act = false) on a miss, a roulette kill, an
// emitter, zero throughput, or after the last bounce. ``rec`` reads the
// record table; ``jac`` follows the Jacobians (NoGrad: nothing). With
// DEFER (NoGrad only: an accumulator's terms would have to wait as well)
// the vertex's last light sample leaves its shadow ray in ``pend``; ``sw``
// walks the shadow rays of the others.
template <class J, bool DEFER, class R, class SW>
__device__ __forceinline__ void shade(const MegaScene& S, const float3 center,
                                      Path& p, int row, R rec, J& jac,
                                      Pending& pend, const SW& sw) {
  const uint32_t base = (uint32_t)p.it * SITES_PER_BOUNCE;
  const float3 o = p.o, d = p.d;
  const int it = p.it;
  p.it = it + 1;
  if (row < 0) {  // miss: black background
    p.act = false;
    return;
  }

  // the winner's packed record: normals 0-8, v0 e1 e2 15-23, light 25,
  // albedo 29-31
  const int r8 = row * 8;
  const float4 r0 = rec[r8 + 0], r1 = rec[r8 + 1], r2 = rec[r8 + 2],
               r3 = rec[r8 + 3], r4 = rec[r8 + 4], r5 = rec[r8 + 5],
               r6 = rec[r8 + 6], r7 = rec[r8 + 7];
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
        const LightSample ls =
            light_sample(center, P, ng, ns, d, lp, ld3(row_l + 10),
                         is_tri ? 2.0f : 1.0f, 1.0f);
        nee_term(S, p, jac, alb, ld3(row_l + 13), ls, i,
                 DEFER && i == S.n_lights - 1, pend, sw);
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
      const LightSample ls =
          light_sample(center, P, ng, ns, d, lp, ld3(row_l + 10),
                       is_tri ? 2.0f : 1.0f, __ldg(row_l + 16));
      nee_term(S, p, jac, alb, ld3(row_l + 13), ls, lidx, DEFER, pend, sw);
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

// One bounce of an active path with its light samples' shadow rays walked
// inline: the reference of the walks below (no kernel launches it).
template <class J>
__device__ __forceinline__ void bounce(const MegaScene& S, const float3 center,
                                       Path& p, J& jac) {
  const float3 oc = sub3(p.o, center);
  const int row = nearest_row(S.coef, S.t_total, oc, p.d, cross3(oc, p.d));
  Pending none;
  shade<J, false>(S, center, p, row, LdgRows{S.tri_rec}, jac, none,
                  GlobalShadow{S});
}

// A fresh path from a given ray and key (K1a, K5); a lane past n starts none.
__device__ __forceinline__ void start_path(Path& p, bool live, uint32_t key,
                                           float3 o, float3 d) {
  p.key = key;
  p.it = 0;
  p.act = live;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
  p.o = o;
  p.d = d;
}

// A pass's two rays (K1a-c, K5): ``a`` the path ray (done: none), ``s``
// the pending shadow ray (done: none). Returns whether there is a ray.
__device__ __forceinline__ bool pass_rays(float3 center, const Path& p,
                                          const Pending& pend, SweepRay& a,
                                          SweepRay& s) {
  a = sweep_ray<NEAREST>(p.o, p.d, center, p.act, 0.f);
  s.oc = pend.soc;
  s.d = pend.wi;
  s.m = cross3(pend.soc, pend.wi);
  s.inv = make_float3(slab_inv(s.d.x), slab_inv(s.d.y), slab_inv(s.d.z));
  s.best_t = pend.tm;
  s.best_i = -1;
  s.done = !pend.on;
  return p.act | pend.on;
}

// The single-path lane (K1a, K1b, K5) after a pass's walk found the path
// ray's row (-1: none) and whether the pending shadow ray is blocked: the
// pending term joins L, then the hit is shaded. With DEFER (K1b; K1a on a
// culled table) the vertex's last light sample waits for the next walk, as
// in K1c; without (K5; K1a on a staged table), its shadow ray is walked at
// once by ``sw`` as the others are. The path is done when
// it is no longer active and nothing is pending; every sum is the per-path
// bounce's (the argument at the top of this file, with one sample a lane).
template <bool DEFER, class J, class R, class SW>
__device__ __forceinline__ void path_end(const MegaScene& S, float3 center,
                                         Path& p, Pending& pend, J& jac,
                                         int row, bool blocked, R rec,
                                         const SW& sw) {
  static_assert(!DEFER || std::is_same<J, NoGrad>::value,
                "only the render kernels defer a light sample");
  if (pend.on) {
    add_term(p.L, pend.tal, blocked ? 0.f : pend.coef);
    pend.on = false;
  }
  if (!p.act) return;
  shade<J, DEFER>(S, center, p, row, rec, jac, pend, sw);
}

// Key and camera ray of sample ``s`` of one pixel (path_common.cuh), and a
// fresh path (K1b, K1c).
__device__ __forceinline__ void start_sample(const MegaCamera& C,
                                             uint32_t pixfold, float px,
                                             float py, uint32_t s, Path& p) {
  camera_sample(C, pixfold, px, py, s, p.key, p.o, p.d);
  p.it = 0;
  p.act = true;
  p.L = make_float3(0.f, 0.f, 0.f);
  p.T = make_float3(1.f, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// the merged loop's lane (K1c)
// ---------------------------------------------------------------------------
struct K1cLane {
  Path p;        // the sample in flight; p.L also the ended one's while fin
  Pending pend;  // the shadow ray of the last vertex shaded
  bool fin;      // the path has ended, its sample waits for pend
  int s_next;    // samples started
  int s_done;    // samples added (or rejected)
  uint32_t fold;
  float px, py;
  float3 acc;
  int rej;
};

__device__ __forceinline__ void k1c_init(K1cLane& l, bool live, uint32_t fold,
                                         float px, float py, int n_spp) {
  l.p.act = false;
  l.p.it = 0;
  l.p.L = make_float3(0.f, 0.f, 0.f);
  l.pend.on = false;
  l.fin = false;
  l.s_next = live ? 0 : n_spp;
  l.s_done = live ? 0 : n_spp;
  l.fold = fold;
  l.px = px;
  l.py = py;
  l.acc = make_float3(0.f, 0.f, 0.f);
  l.rej = 0;
}

// Start of a pass: a lane whose path has ended starts its next sample
// (keeping L while an ended sample waits for its shadow ray). The pass's
// two rays: ``a`` the path ray (done: none), ``s`` the pending shadow ray
// (done: none). Returns whether the lane has a ray to walk.
__device__ __forceinline__ bool k1c_begin(const MegaCamera& C, float3 center,
                                          int s0, int n_spp, K1cLane& l,
                                          SweepRay& a, SweepRay& s) {
  if (!l.p.act && l.s_next < n_spp) {
    camera_sample(C, l.fold, l.px, l.py, (uint32_t)(s0 + l.s_next), l.p.key,
                  l.p.o, l.p.d);
    l.p.it = 0;
    l.p.act = true;
    l.p.T = make_float3(1.f, 1.f, 1.f);
    ++l.s_next;
  }
  return pass_rays(center, l.p, l.pend, a, s);
}

// End of a pass, after the walk found the path ray's row (-1: none) and
// whether the shadow ray is blocked: the pending term joins L, an ended
// sample waiting for it is added, and the path's hit is shaded.
template <class R>
__device__ __forceinline__ void k1c_end(const MegaScene& S, float3 center,
                                        K1cLane& l, int row, bool blocked,
                                        R rec) {
  if (l.pend.on) {
    add_term(l.p.L, l.pend.tal, blocked ? 0.f : l.pend.coef);
    l.pend.on = false;
    if (l.fin) {
      add_sample(l.p.L, l.acc, l.rej);
      l.p.L = make_float3(0.f, 0.f, 0.f);
      l.fin = false;
      ++l.s_done;
    }
  }
  if (!l.p.act) return;
  NoGrad ng;
  shade<NoGrad, true>(S, center, l.p, row, rec, ng, l.pend, GlobalShadow{S});
  if (!l.p.act || l.p.it >= S.max_depth) {
    l.p.act = false;
    if (l.pend.on) {
      l.fin = true;
    } else {
      add_sample(l.p.L, l.acc, l.rej);
      l.p.L = make_float3(0.f, 0.f, 0.f);
      ++l.s_done;
    }
  }
}

}  // namespace xrt
