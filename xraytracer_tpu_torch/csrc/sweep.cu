// Triangle sweeps of the wavefront path tracer: nearest hit, nearest hit
// with the winner's surface record, and boolean any-hit.
//
// Replaces, in xraytracer_tpu/geometry/pallas_kernels.py:
//   sweep_nearest      <- _sweep_kernel      (via _sweep_kernel_impl)
//   sweep_nearest_rec  <- _sweep_kernel_rec  (via _sweep_kernel_impl)
//   occluded_anyhit    <- _anyhit_kernel
// One templated device function, three extern "C" launchers. The per-pair
// test, the coefficients and the winner epilogue live in tri_test.cuh, which
// the whole-path kernels (megakernel.cu) include as well.
//
// What is computed. Per (ray, triangle) pair the four Moller-Trumbore
// triple products in their EXPANDED BILINEAR form, in coordinates centred
// on the triangle table's centroid c (oc = o - c, p = v0 - c, m = oc x d,
// ng = e1 x e2):
//     det   = -d . ng
//     u_num =  m . e2 + d . (p x e2)
//     v_num = -m . e1 + d . (e1 x p)
//     t_num =  oc . ng - p . ng
// followed by the division-free hit test
//     |det| >= eps, u_s >= 0, v_s >= 0, u_s + v_s <= |det|, t_s > eps |det|
// (x_s = x * sign(det)). This is the form the plain PyTorch version
// (intersect_triangles_mm) and the Pallas kernels evaluate, chosen over the
// factored classic form for two reasons: hit/miss decisions then follow the
// same arithmetic as the plain version up to summation order, and the
// per-pair cost drops to 18 multiply-adds on per-triangle coefficients that
// are computed once per tile while it is staged. The winner's (t, u, v) are
// recomputed once per ray with the factored classic form, as the plain
// version's epilogue does; the any-hit sweep compares t_s < t_max |det|
// without dividing.
//
// Winner rule. A thread keeps a running (t, idx) and replaces it on strict
// t < best while walking triangles in ascending order, i.e. first index
// wins exact ties, like argmin in the plain version. The Pallas kernels
// reduce a packed key (t bits with the low 7 mantissa bits replaced by the
// chunk row) instead; the two rules differ only where two hits lie within
// ~2^-17 relative t of each other (PARITY.md "Nearest-hit tie-break").
//
// Layout. One thread owns one ray; a block of 128 threads takes 128
// consecutive rays and loops over ALL triangle tiles itself. A tile is 128
// triangles; thread j of the block turns triangle j of the tile into 16
// coefficients (64 bytes) in shared memory, so the inner loop reads four
// broadcast float4 per pair and touches global memory only for the tile
// staging. Ragged N and T are masked; there is no padding requirement and
// no triangle-count limit. The record variant ends with a warp-cooperative
// copy of tri_rec[idx] (lane l moves float l of each of the warp's 32
// rows), so every 128-byte record row is one coalesced read and write.
//
// What bounds it on an H100. Small tables (the Cornell box, 40 rows) are
// bound by bytes: 24 B of ray in and 16 B (+128 B of record) out per ray
// dwarf the 40 hit tests. Large tables (a 13k-triangle mesh) are bound by
// float32 operations: N*T pair tests of ~38 flops each on the CUDA cores;
// the tile staging is amortised over 128 rays. This first version is brute
// force: no per-tile AABB cull, no front-to-back order. The any-hit sweep
// skips finished lanes (blocked, or t_max <= 0) and leaves the tile loop
// once a whole block is finished.
//
// nvcc contracts a*b+c into FMAs here; the plain version's matmul sums in
// another order. A ray grazing an edge can therefore hit in one and miss in
// the other, or pick the neighbouring triangle; chip_smoke.py counts these.

#include "tri_test.cuh"

namespace xrt {

constexpr int TILE = 128;   // triangles staged per shared-memory tile
constexpr int BLOCK = 128;  // threads (= rays) per block; == TILE

enum Mode { NEAREST = 0, NEAREST_REC = 1, ANYHIT = 2 };

struct SweepArgs {
  const float* o;        // (n, 3)
  const float* d;        // (n, 3)
  int n;
  const float* v0;       // (t_total, 3)
  const float* e1;
  const float* e2;
  const uint8_t* mask;   // (t_total,) valid / blocks
  int t_total;
  const float* center;   // (3,)
  const float* tri_rec;  // (t_total, 32)   NEAREST_REC
  const float* t_max;    // (n,)            ANYHIT
  float* out_t;          // (n,)
  int* out_idx;          // (n,)
  float* out_u;          // (n,)
  float* out_v;          // (n,)
  float* out_rec;        // (n, 32)         NEAREST_REC
  uint8_t* out_blocked;  // (n,)            ANYHIT
};

template <int MODE>
__global__ void __launch_bounds__(BLOCK) sweep_kernel(SweepArgs a) {
  // tile coefficients, 4 float4 per triangle (tri_test.cuh, TriCoeffs)
  __shared__ float4 feat[TILE * 4];

  const int tid = threadIdx.x;
  const int ray = blockIdx.x * BLOCK + tid;
  const bool live = ray < a.n;
  const float3 center =
      make_float3(a.center[0], a.center[1], a.center[2]);

  float3 o = make_float3(0.f, 0.f, 0.f), d = o;
  if (live) {
    o = load3(a.o, ray);
    d = load3(a.d, ray);
  }
  const float3 oc = sub3(o, center);
  const float3 m = cross3(oc, d);

  float best_t = BIG_T;
  int best_i = -1;
  float tm = 0.f;
  bool blocked = false;
  bool done = !live;
  if (MODE == ANYHIT) {
    if (live) tm = a.t_max[ray];
    // t_s > eps*|det| > 0 can never be below t_max*|det| when t_max <= 0
    done = !(tm > 0.f);
  }

  for (int base = 0; base < a.t_total; base += TILE) {
    // ---- stage one tile ----
    {
      const int j = base + tid;
      TriCoeffs c = zero_coeffs();
      if (j < a.t_total && a.mask[j]) {
        c = tri_coeffs(sub3(load3(a.v0, j), center), load3(a.e1, j),
                       load3(a.e2, j));
      }
      // masked-out rows keep all-zero coefficients: det = 0, never a hit
      feat[tid * 4 + 0] = c.f0;
      feat[tid * 4 + 1] = c.f1;
      feat[tid * 4 + 2] = c.f2;
      feat[tid * 4 + 3] = c.f3;
    }
    __syncthreads();

    // ---- test this thread's ray against the tile ----
    if (!done) {
      const int count = min(TILE, a.t_total - base);
      for (int k = 0; k < count; ++k) {
        const PairTest r =
            pair_test(feat[k * 4 + 0], feat[k * 4 + 1], feat[k * 4 + 2],
                      feat[k * 4 + 3], oc, d, m);
        if (MODE == ANYHIT) {
          if (r.ok && r.t_s < tm * r.absd) {
            blocked = true;
            done = true;
            break;
          }
        } else {
          if (r.ok) {
            const float t = r.t_num / r.det;
            if (t < best_t) {
              best_t = t;
              best_i = base + k;
            }
          }
        }
      }
    }
    // barrier before the tile is overwritten; the any-hit sweep also asks
    // whether any lane of the block still has work
    if (MODE == ANYHIT) {
      if (!__syncthreads_or(!done)) break;
    } else {
      __syncthreads();
    }
  }

  if (MODE == ANYHIT) {
    if (live) a.out_blocked[ray] = blocked ? 1 : 0;
    return;
  }

  // ---- winner epilogue: factored classic form on the original inputs ----
  float t_out = INF_T, u_out = 0.f, v_out = 0.f;
  if (best_i >= 0) {
    winner_tuv(o, d, load3(a.v0, best_i), load3(a.e1, best_i),
               load3(a.e2, best_i), t_out, u_out, v_out);
  }
  if (live) {
    a.out_t[ray] = t_out;
    a.out_idx[ray] = best_i;
    a.out_u[ray] = u_out;
    a.out_v[ray] = v_out;
  }

  if (MODE == NEAREST_REC) {
    // warp-cooperative record copy: lane l moves float l of each row
    const int lane = tid & 31;
    const int warp_ray0 = ray - lane;
    for (int s = 0; s < 32; ++s) {
      const int idx_s = __shfl_sync(0xffffffffu, best_i, s);
      const int ray_s = warp_ray0 + s;
      if (ray_s < a.n) {
        const float val =
            idx_s >= 0 ? a.tri_rec[(size_t)idx_s * 32 + lane] : 0.f;
        a.out_rec[(size_t)ray_s * 32 + lane] = val;
      }
    }
  }
}

template <int MODE>
int launch(const SweepArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  const int grid = (a.n + BLOCK - 1) / BLOCK;
  sweep_kernel<MODE><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace xrt

extern "C" {

// Each launcher returns cudaGetLastError() of its launch (0 = accepted).

int sweep_nearest(const float* o, const float* d, int n, const float* v0,
                  const float* e1, const float* e2, const uint8_t* valid,
                  int t_total, const float* center, float* t, int* idx,
                  float* u, float* v, void* stream) {
  xrt::SweepArgs a{o, d, n, v0, e1, e2, valid, t_total, center, nullptr,
                   nullptr, t, idx, u, v, nullptr, nullptr};
  return xrt::launch<xrt::NEAREST>(a, stream);
}

int sweep_nearest_rec(const float* o, const float* d, int n, const float* v0,
                      const float* e1, const float* e2, const uint8_t* valid,
                      int t_total, const float* center, const float* tri_rec,
                      float* t, int* idx, float* u, float* v, float* rec,
                      void* stream) {
  xrt::SweepArgs a{o, d, n, v0, e1, e2, valid, t_total, center, tri_rec,
                   nullptr, t, idx, u, v, rec, nullptr};
  return xrt::launch<xrt::NEAREST_REC>(a, stream);
}

int occluded_anyhit(const float* o, const float* d, int n, const float* v0,
                    const float* e1, const float* e2, const uint8_t* blocks,
                    int t_total, const float* center, const float* t_max,
                    uint8_t* blocked, void* stream) {
  xrt::SweepArgs a{o, d, n, v0, e1, e2, blocks, t_total, center, nullptr,
                   t_max, nullptr, nullptr, nullptr, nullptr, nullptr,
                   blocked};
  return xrt::launch<xrt::ANYHIT>(a, stream);
}

}  // extern "C"
