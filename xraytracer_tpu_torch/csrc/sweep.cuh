// The triangle sweeps' per-warp walk over a chunk table, and the rows and
// boxes the table is built from. No launch here: sweep.cu's kernels call
// these functions, and a host program can call them too (the CPU rehearsal
// in tests/test_torch_csrc_sweep.py, where a "warp" is 32 lanes in a loop).
//
// The chunk table of a triangle table (built once per table and mask by
// sweep.cu's chunk_boxes):
//   coef   (n_chunks * SWEEP_CHUNK, 4) float4: tri_coeffs of every row in
//          the centred coordinates, all-zero for a masked-out row and for
//          the rows that pad the last chunk (an all-zero row is never hit)
//   boxes  (n_chunks + n_groups, BOX_STRIDE) float: one row per chunk of
//          SWEEP_CHUNK rows, then one per group of SWEEP_GROUP chunks;
//          lo3 | hi3 | valid | 0, as xraytracer_tpu's _build_chunk_aabbs:
//          the box of the valid rows' three vertices, padded by
//          1e-4 x its largest extent + 1e-6 (so that rounding in the slab
//          and pair tests cannot cull a hit, where the padding exceeds
//          that rounding: sweep.cu), valid = 1 iff the chunk holds a valid
//          row. A group's box is the union of its chunks' padded boxes.
#pragma once

#include "tri_test.cuh"

namespace xrt {

// rows per chunk (pallas_kernels.py's TRI_CHUNK is 128: chunks of 32 rows
// cull more and stage less, PERF.md) and chunks per group
// (pallas_kernels.py CHUNK_GROUP)
constexpr int SWEEP_CHUNK = 32;
constexpr int SWEEP_GROUP = 16;
constexpr int BOX_STRIDE = 8;
constexpr int BOX_VALID = 6;
// an empty box is [BOX_BIG, -BOX_BIG] (pallas_kernels.py _BIG)
constexpr float BOX_BIG = 3.0e38f;
// a direction component below this in magnitude is taken as this, with its
// sign, before the slab test inverts it (pallas_kernels.py keeps +tiny)
constexpr float SLAB_TINY = 1e-12f;
// a chunk is skipped only when the ray enters its box beyond the lane's best
// t (or t_max) by this factor (pallas_kernels.py: enter < best (1 + 1e-5))
constexpr float PRUNE_SLACK = 1.0f + 1e-5f;

enum Mode { NEAREST = 0, NEAREST_REC = 1, ANYHIT = 2 };

// ---------------------------------------------------------------------------
// the table's rows and boxes
// ---------------------------------------------------------------------------
struct Box {
  float3 lo, hi;
};

__device__ __forceinline__ Box empty_box() {
  return Box{make_float3(BOX_BIG, BOX_BIG, BOX_BIG),
             make_float3(-BOX_BIG, -BOX_BIG, -BOX_BIG)};
}

__device__ __forceinline__ float3 min3(float3 a, float3 b) {
  return make_float3(fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z));
}

__device__ __forceinline__ float3 max3(float3 a, float3 b) {
  return make_float3(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z));
}

__device__ __forceinline__ Box join(Box a, Box b) {
  return Box{min3(a.lo, b.lo), max3(a.hi, b.hi)};
}

// The box of one row's vertices p, p + e1, p + e2 (p = v0 - centre).
__device__ __forceinline__ Box row_box(float3 p, float3 E1, float3 E2) {
  const float3 p1 = make_float3(__fadd_rn(p.x, E1.x), __fadd_rn(p.y, E1.y),
                                __fadd_rn(p.z, E1.z));
  const float3 p2 = make_float3(__fadd_rn(p.x, E2.x), __fadd_rn(p.y, E2.y),
                                __fadd_rn(p.z, E2.z));
  return Box{min3(min3(p, p1), p2), max3(max3(p, p1), p2)};
}

// A chunk's table row from the union of its valid rows' boxes: padded by
// 1e-4 x the largest extent + 1e-6, rounded as the plain version rounds
// (no contraction).
__device__ __forceinline__ void finish_box(Box b, bool valid, float* out) {
  const float ext = fmaxf(fmaxf(fmaxf(__fsub_rn(b.hi.x, b.lo.x), 0.f),
                                fmaxf(__fsub_rn(b.hi.y, b.lo.y), 0.f)),
                          fmaxf(__fsub_rn(b.hi.z, b.lo.z), 0.f));
  const float pad = __fadd_rn(__fmul_rn(1e-4f, ext), 1e-6f);
  out[0] = __fsub_rn(b.lo.x, pad);
  out[1] = __fsub_rn(b.lo.y, pad);
  out[2] = __fsub_rn(b.lo.z, pad);
  out[3] = __fadd_rn(b.hi.x, pad);
  out[4] = __fadd_rn(b.hi.y, pad);
  out[5] = __fadd_rn(b.hi.z, pad);
  out[6] = valid ? 1.f : 0.f;
  out[7] = 0.f;
}

// ---------------------------------------------------------------------------
// one lane
// ---------------------------------------------------------------------------
struct SweepRay {
  float3 oc, d, m;  // oc = o - centre, m = oc x d (pair_test)
  float3 inv;       // 1 / d, guarded (slab test)
  float best_t;     // nearest: the running best t; any-hit: t_max
  int best_i;       // nearest: the winner's row, -1 for none
  bool done;        // no chunk can change this lane: beyond n, blocked, parked
};

__device__ __forceinline__ float slab_inv(float x) {
  return 1.0f / (fabsf(x) < SLAB_TINY ? copysignf(SLAB_TINY, x) : x);
}

// ``t_max`` is read by the any-hit sweep only; a lane with t_max <= 0 is
// parked (t_s > eps |det| > 0 can never be below t_max |det|).
template <int MODE>
__device__ __forceinline__ SweepRay sweep_ray(float3 o, float3 d, float3 center,
                                              bool live, float t_max) {
  SweepRay r;
  r.oc = sub3(o, center);
  r.d = d;
  r.m = cross3(r.oc, d);
  r.inv = make_float3(slab_inv(d.x), slab_inv(d.y), slab_inv(d.z));
  r.best_i = -1;
  if (MODE == ANYHIT) {
    r.best_t = t_max;
    r.done = !live || !(t_max > 0.f);
  } else {
    r.best_t = BIG_T;
    r.done = !live;
  }
  return r;
}

// Could a row inside box ``b`` (a table row, two float4: lo3 hi.x | hi.y
// hi.z valid 0) change this lane? The slab test of pallas_kernels.py's
// _slab_lohi and its candidacy rule.
__device__ __forceinline__ bool wants(const SweepRay& r, const float4* b) {
  const float4 p = b[0], q = b[1];
  if (r.done || !(q.z > 0.f)) return false;
  const float ax = (p.x - r.oc.x) * r.inv.x, bx = (p.w - r.oc.x) * r.inv.x;
  const float ay = (p.y - r.oc.y) * r.inv.y, by = (q.x - r.oc.y) * r.inv.y;
  const float az = (p.z - r.oc.z) * r.inv.z, bz = (q.y - r.oc.z) * r.inv.z;
  const float tmin = fmaxf(fmaxf(fmaxf(-BOX_BIG, fminf(ax, bx)), fminf(ay, by)),
                           fminf(az, bz));
  const float tmax = fminf(fminf(fminf(BOX_BIG, fmaxf(ax, bx)), fmaxf(ay, by)),
                           fmaxf(az, bz));
  return (tmax >= tmin) & (tmax > 0.f) &
         (fmaxf(tmin, 0.f) < r.best_t * PRUNE_SLACK);
}

// The pair tests of one lane against ``count`` rows of a chunk whose first
// row is table row ``base``, in ascending order: strict t < best (first
// row wins exact ties), or the any-hit compare t_s < t_max |det|.
template <int MODE>
__device__ __forceinline__ void test_rows(SweepRay& r, const float4* rows,
                                          int base, int count) {
  for (int k = 0; k < count; ++k) {
    const PairTest p = pair_test(rows[4 * k], rows[4 * k + 1], rows[4 * k + 2],
                                 rows[4 * k + 3], r.oc, r.d, r.m);
    if (MODE == ANYHIT) {
      if (p.ok && p.t_s < r.best_t * p.absd) {
        r.best_i = base + k;
        r.done = true;
        break;
      }
    } else if (p.ok) {
      const float t = p.t_num / p.det;
      if (t < r.best_t) {
        r.best_t = t;
        r.best_i = base + k;
      }
    }
  }
}

// The brute-force walk: every row of the table in ascending order, as
// sweep.cu did before the chunk table (the rehearsal's reference).
template <int MODE>
__device__ __forceinline__ void brute_walk(SweepRay& r, const float4* coef,
                                           int t_total) {
  if (!r.done) test_rows<MODE>(r, coef, 0, t_total);
}

// ---------------------------------------------------------------------------
// the warp's walk
// ---------------------------------------------------------------------------
// ``W`` holds the lanes that walk together: on the card one lane (this
// thread), whose votes go to its warp; in the host rehearsal all 32, whose
// votes are a loop. It provides
//   LANES, ray[LANES]            the lanes' rays
//   bool vote(bool)              some lane of the warp passed true
//   void fetch(c, slot)          start copying chunk c's rows into a slot
//   const float4* rows(c, slot, more)  chunk c's rows, once its copy into
//                                ``slot`` is done (``more``: a later copy
//                                is in flight and need not be)
//   void release()               the rows read may be overwritten
//
// The next chunk at or after ``c`` that some lane of the warp wants, its
// lanes' flags in ``want`` (``want_g``: the flags of c's group, kept between
// calls); n_chunks when none is left. A lane wants a group when its ray
// enters the group's box before its best t (t_max for any-hit), and a chunk
// of it likewise. The box of a table of one group is the table's and is
// not tested (a ray that misses it tests the rows and misses them too); a
// group of one chunk has that chunk's box, which is not tested twice.
template <int MODE, class W>
__device__ __forceinline__ int next_chunk(W& w, const float4* boxes,
                                          int n_chunks, int n_groups, int c,
                                          bool* want_g, bool* want) {
  while (c < n_chunks) {
    const int c0 = c - c % SWEEP_GROUP, c1 = min(n_chunks, c0 + SWEEP_GROUP);
    if (c == c0) {
      bool any = false;
      for (int i = 0; i < W::LANES; ++i) {
        want_g[i] = !w.ray[i].done &&
                    (n_groups == 1 ||
                     wants(w.ray[i], boxes + 2 * (n_chunks + c0 / SWEEP_GROUP)));
        any |= want_g[i];
      }
      if (!w.vote(any)) {
        if (MODE == ANYHIT) {  // leave once every lane is blocked or parked
          bool work = false;
          for (int i = 0; i < W::LANES; ++i) work |= !w.ray[i].done;
          if (!w.vote(work)) return n_chunks;
        }
        c = c1;
        continue;
      }
    }
    bool any_c = false;
    for (int i = 0; i < W::LANES; ++i) {
      want[i] = want_g[i] && (c1 - c0 == 1 || wants(w.ray[i], boxes + 2 * c));
      any_c |= want[i];
    }
    if (c1 - c0 == 1 || w.vote(any_c)) return c;
    ++c;
  }
  return n_chunks;
}

// The chunks some lane of the warp wants, in ascending order; the lanes
// that want a chunk test its rows. The next wanted chunk is found, and its
// copy started into the other slot, before the current one is tested, so
// its vote sees the best t from before that chunk: a larger best t only
// wants more chunks, and testing a chunk that the newer best t would have
// skipped changes nothing. The winner rule is unchanged: a skipped chunk
// holds no row that could replace the lane's best (its hits lie inside the
// padded box, at t >= enter, where the padding exceeds the rounding; see
// sweep.cu), so the result is the brute-force walk's, bit for bit, and
// ascending order keeps the first row among exact ties.
// ``boxes`` holds BOX_STRIDE floats a row.
template <int MODE, class W>
__device__ __forceinline__ void warp_walk(W& w, const float4* boxes,
                                          int t_total) {
  const int n_chunks = (t_total + SWEEP_CHUNK - 1) / SWEEP_CHUNK;
  const int n_groups = (n_chunks + SWEEP_GROUP - 1) / SWEEP_GROUP;
  bool want_g[W::LANES], want[W::LANES], next[W::LANES];
  int c = next_chunk<MODE>(w, boxes, n_chunks, n_groups, 0, want_g, want);
  int slot = 0;
  if (c < n_chunks) w.fetch(c, slot);
  while (c < n_chunks) {
    const int cn =
        next_chunk<MODE>(w, boxes, n_chunks, n_groups, c + 1, want_g, next);
    if (cn < n_chunks) w.fetch(cn, slot ^ 1);
    const float4* rows = w.rows(c, slot, cn < n_chunks);
    const int count = min(SWEEP_CHUNK, t_total - c * SWEEP_CHUNK);
    for (int i = 0; i < W::LANES; ++i)
      if (want[i] && !w.ray[i].done)
        test_rows<MODE>(w.ray[i], rows, c * SWEEP_CHUNK, count);
    w.release();
    for (int i = 0; i < W::LANES; ++i) want[i] = next[i];
    c = cn;
    slot ^= 1;
  }
}

}  // namespace xrt
