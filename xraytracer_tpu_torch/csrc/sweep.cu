// Triangle sweeps of the wavefront path tracer: nearest hit, nearest hit
// with the winner's surface record, and boolean any-hit; and the chunk
// table they walk.
//
// Replaces, in xraytracer_tpu/geometry/pallas_kernels.py:
//   sweep_nearest      <- _sweep_kernel      (via _sweep_kernel_impl)
//   sweep_nearest_rec  <- _sweep_kernel_rec  (via _sweep_kernel_impl)
//   occluded_anyhit    <- _anyhit_kernel
//   chunk_boxes        <- _build_chunk_aabbs and _build_g_chunks (an XLA
//                         pre-pass of every call there; here once per table)
// One templated kernel, three extern "C" launchers; the walk lives in
// sweep.cuh, the per-pair test, the coefficients and the winner epilogue in
// tri_test.cuh, which the whole-path kernels (megakernel.cu) include too.
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
// (intersect_triangles_mm) and the Pallas kernels evaluate: hit/miss
// decisions follow the plain version's arithmetic up to summation order,
// and a pair costs 18 multiply-adds on 16 per-triangle coefficients. The
// winner's (t, u, v) are recomputed once per ray with the factored classic
// form, as the plain version's epilogue does; the any-hit sweep compares
// t_s < t_max |det| without dividing.
//
// Winner rule. A lane keeps a running (t, idx) and replaces it on strict
// t < best while walking rows in ascending order, i.e. first index wins
// exact ties, like argmin in the plain version. The Pallas kernels reduce a
// packed key (t bits with the low 7 mantissa bits replaced by the chunk
// row) instead; the two rules differ only where two hits lie within ~2^-17
// relative t of each other (PARITY.md "Nearest-hit tie-break").
//
// Culling, as the Pallas kernels cull (pallas_kernels.py:163-175, the chunk
// decision :228-252, the group skip :379-397 and :522-530, the inverse
// direction :222). The table is cut into chunks of SWEEP_CHUNK rows and
// groups of SWEEP_GROUP chunks; chunk_boxes writes, once per table and
// mask, every row's 16 coefficients (zero for masked rows) and a padded
// box per chunk and per group (sweep.cuh). A lane wants a box when its ray
// enters it before its best t (t_max for any-hit); a warp visits a group,
// and then a chunk of it, only when one of its 32 lanes wants it
// (__any_sync), and only the lanes that want a chunk test its rows. The
// builder Morton-sorts meshes over 512 triangles and the renderer walks
// pixels in Z-order on such tables, so a warp's rays are a 4x8 pixel patch
// and a chunk is a compact patch of surface. Skipping a box that holds no
// possible winner changes nothing, so every output is the brute-force
// walk's bit for bit, under one condition: the box's padding (1e-4 x its
// largest extent + 1e-6, in absolute units, as the Pallas sweeps pad) must
// exceed the rounding of the slab test and of the pair test, a few float32
// ulps of the centred coordinates of the chunk and of the ray's origin.
// Small triangles far from the table's centroid can break it: at |x| = 100
// an ulp is 7.6e-6, so a chunk less than ~0.03 across is padded by less
// than half an ulp, lo - pad rounds back to lo, and a ray that runs in the
// plane of the box's face can miss a hit that the brute-force walk finds.
// The Pallas sweeps' cull has the same condition (their chunks of 128 rows
// are wider, so their padding is larger). The rehearsal
// (tests/test_torch_csrc_sweep.py) holds a chunk of triangles ~1e-3 in
// size at |x| = 10, inside the condition, bitwise; the tables that
// chip_smoke.py compares (Cornell, the 13k and 51k meshes) meet it.
//
// Layout. One thread owns one ray; a block of 128 threads takes 128
// consecutive rays. Each warp copies the chunks it visits from the cached
// coefficient rows into its own ring of two 2,048-byte slots of shared
// memory with cp.async, the next wanted chunk's copy in flight while the
// current one is tested, and reads them as broadcast float4; no barrier
// across the block. Ragged N and T are masked. The record variant ends
// with a warp-cooperative copy of tri_rec[idx] (lane l moves float l of
// each of the warp's 32 rows), so every 128-byte record row is one
// coalesced read and write.
//
// What bounds it on an H100. Small tables (the Cornell box, 40 rows = two
// chunks of one group) are bound by bytes: 24 B of ray in and 16 B (+128 B
// of record) out per ray dwarf the hit tests. Large tables (a 13k-triangle
// mesh) are bound by float32 operations: the pair tests of the chunks each
// lane wants (~38 flops each; ~1% of the brute-force N*T on the 13k mesh's
// camera rays) and the slab tests of the boxes it reads (~15 each); a lane
// also waits while the other lanes of its warp test chunks it does not
// want. Hopper has no float32 tensor-core path (TF32 flips hits), so the
// lever is fewer tests, not faster ones.
//
// nvcc contracts a*b+c into FMAs here; the plain version's matmul sums in
// another order. A ray grazing an edge can therefore hit in one and miss in
// the other, or pick the neighbouring triangle; chip_smoke.py counts these.

#include "sweep.cuh"

namespace xrt {

constexpr int BLOCK = 128;  // threads (= rays) per block
constexpr int WARPS = BLOCK / 32;

struct SweepArgs {
  const float* o;        // (n, 3)
  const float* d;        // (n, 3)
  int n;
  const float* v0;       // (t_total, 3)   nearest: the winner epilogue
  const float* e1;
  const float* e2;
  int t_total;
  const float* center;   // (3,)
  const float4* boxes;   // chunk table (sweep.cuh)
  const float4* coef;
  const float* tri_rec;  // (t_total, 32)   NEAREST_REC
  const float* t_max;    // (n,)            ANYHIT
  float* out_t;          // (n,)
  int* out_idx;          // (n,)
  float* out_u;          // (n,)
  float* out_v;          // (n,)
  float* out_rec;        // (n, 32)         NEAREST_REC
  uint8_t* out_blocked;  // (n,)            ANYHIT
};

// One lane of a warp that copies the chunks it visits from the cached
// coefficient rows into its own two-slot ring in shared memory with
// cp.async (no registers, no arithmetic), the next chunk's copy in flight
// while the current one is tested.
struct WarpRing {
  static constexpr int LANES = 1;
  SweepRay ray[1];
  float4* tile;  // this warp's 2 slots of SWEEP_CHUNK * 4 float4
  const float4* coef;
  int t_total;

  __device__ __forceinline__ bool vote(bool p) {
    return __any_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ void fetch(int c, int slot) {
    const int n4 = 4 * min(SWEEP_CHUNK, t_total - c * SWEEP_CHUNK);
    const float4* src = coef + (size_t)c * SWEEP_CHUNK * 4;
    float4* dst = tile + slot * SWEEP_CHUNK * 4;
    for (int j = threadIdx.x & 31; j < n4; j += 32) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + j);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src + j)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ const float4* rows(int, int slot, bool more) {
    if (more)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    return tile + slot * SWEEP_CHUNK * 4;
  }
  __device__ __forceinline__ void release() { __syncwarp(); }
};

template <int MODE>
__global__ void __launch_bounds__(BLOCK) sweep_kernel(SweepArgs a) {
  __shared__ float4 tiles[WARPS][2 * SWEEP_CHUNK * 4];

  const int tid = threadIdx.x;
  const int ray = blockIdx.x * BLOCK + tid;
  const bool live = ray < a.n;
  const float3 center =
      make_float3(a.center[0], a.center[1], a.center[2]);

  float3 o = make_float3(0.f, 0.f, 0.f), d = o;
  float tm = 0.f;
  if (live) {
    o = load3(a.o, ray);
    d = load3(a.d, ray);
    if (MODE == ANYHIT) tm = a.t_max[ray];
  }
  WarpRing w;
  w.ray[0] = sweep_ray<MODE>(o, d, center, live, tm);
  w.tile = tiles[tid >> 5];
  w.coef = a.coef;
  w.t_total = a.t_total;
  warp_walk<MODE>(w, a.boxes, a.t_total);
  const int best_i = w.ray[0].best_i;

  if (MODE == ANYHIT) {
    if (live) a.out_blocked[ray] = best_i >= 0 ? 1 : 0;
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

// The chunk table (sweep.cuh). One block of BUILD_BLOCK threads per group,
// a row per thread in passes of BUILD_BLOCK rows: each thread writes its
// row's coefficients and reduces its row's box and validity with the other
// rows of its chunk (shuffles within a warp, then partials in shared
// memory); a thread per chunk finishes the chunk's row, and thread 0 joins
// the group's chunks into the group's row.
constexpr int BUILD_BLOCK = 128;
static_assert(BUILD_BLOCK % SWEEP_CHUNK == 0, "a pass holds whole chunks");

__global__ void __launch_bounds__(BUILD_BLOCK)
    chunk_boxes_kernel(const float* v0, const float* e1, const float* e2,
                       const uint8_t* mask, int t_total, const float* center,
                       float* boxes, float4* coef) {
  constexpr int SEG = SWEEP_CHUNK < 32 ? SWEEP_CHUNK : 32;  // rows a warp reduces
  constexpr int PARTS = SWEEP_CHUNK / SEG;                  // partials per chunk
  __shared__ float part[BUILD_BLOCK / SEG][7];
  __shared__ float done[SWEEP_GROUP][BOX_STRIDE];
  const int tid = threadIdx.x;
  const int n_chunks = (t_total + SWEEP_CHUNK - 1) / SWEEP_CHUNK;
  const int c0 = blockIdx.x * SWEEP_GROUP;
  const int c1 = min(n_chunks, c0 + SWEEP_GROUP);
  const float3 c = make_float3(center[0], center[1], center[2]);
  for (int base = c0 * SWEEP_CHUNK; base < c1 * SWEEP_CHUNK; base += BUILD_BLOCK) {
    const int j = base + tid;
    const bool in_table = j < c1 * SWEEP_CHUNK;
    const bool v = j < t_total && mask[j];
    TriCoeffs f = zero_coeffs();
    Box b = empty_box();
    if (v) {
      const float3 p = sub3(load3(v0, j), c);
      const float3 E1 = load3(e1, j), E2 = load3(e2, j);
      f = tri_coeffs(p, E1, E2);
      b = row_box(p, E1, E2);
    }
    if (in_table) {
      coef[4 * (size_t)j + 0] = f.f0;
      coef[4 * (size_t)j + 1] = f.f1;
      coef[4 * (size_t)j + 2] = f.f2;
      coef[4 * (size_t)j + 3] = f.f3;
    }
    float x[7] = {b.lo.x, b.lo.y, b.lo.z, b.hi.x, b.hi.y, b.hi.z, v ? 1.f : 0.f};
    for (int s = SEG / 2; s > 0; s >>= 1)
      for (int k = 0; k < 7; ++k) {
        const float y = __shfl_xor_sync(0xffffffffu, x[k], s);
        x[k] = k < 3 ? fminf(x[k], y) : fmaxf(x[k], y);
      }
    if (tid % SEG == 0)
      for (int k = 0; k < 7; ++k) part[tid / SEG][k] = x[k];
    __syncthreads();
    const int ch = (base - c0 * SWEEP_CHUNK) / SWEEP_CHUNK + tid;  // within the group
    if (tid < BUILD_BLOCK / SWEEP_CHUNK && c0 + ch < c1) {
      Box cb = empty_box();
      float valid = 0.f;
      for (int q = tid * PARTS; q < (tid + 1) * PARTS; ++q) {
        cb = join(cb, Box{make_float3(part[q][0], part[q][1], part[q][2]),
                          make_float3(part[q][3], part[q][4], part[q][5])});
        valid = fmaxf(valid, part[q][6]);
      }
      finish_box(cb, valid > 0.f, done[ch]);
      for (int k = 0; k < BOX_STRIDE; ++k)
        boxes[(size_t)(c0 + ch) * BOX_STRIDE + k] = done[ch][k];
    }
    __syncthreads();  // part[] is written again by the next pass
  }
  if (tid == 0) {
    Box g = empty_box();
    float valid = 0.f;
    for (int ch = 0; ch < c1 - c0; ++ch) {
      g = join(g, Box{make_float3(done[ch][0], done[ch][1], done[ch][2]),
                      make_float3(done[ch][3], done[ch][4], done[ch][5])});
      valid = fmaxf(valid, done[ch][6]);
    }
    float* out = boxes + (size_t)(n_chunks + blockIdx.x) * BOX_STRIDE;
    out[0] = g.lo.x;
    out[1] = g.lo.y;
    out[2] = g.lo.z;
    out[3] = g.hi.x;
    out[4] = g.hi.y;
    out[5] = g.hi.z;
    out[6] = valid;
    out[7] = 0.f;
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

// boxes: (n_chunks + n_groups, 8) f32, coef: (n_chunks * SWEEP_CHUNK, 16)
// f32 (geometry/kernels.py sizes them by its own SWEEP_CHUNK and
// SWEEP_GROUP, which must equal sweep.cuh's), with n_chunks = ceil(t_total / SWEEP_CHUNK) and n_groups =
// ceil(n_chunks / SWEEP_GROUP).
int chunk_boxes(const float* v0, const float* e1, const float* e2,
                const uint8_t* mask, int t_total, const float* center,
                float* boxes, float* coef, void* stream) {
  if (t_total <= 0) return 0;
  const int n_chunks = (t_total + xrt::SWEEP_CHUNK - 1) / xrt::SWEEP_CHUNK;
  const int n_groups = (n_chunks + xrt::SWEEP_GROUP - 1) / xrt::SWEEP_GROUP;
  xrt::chunk_boxes_kernel<<<n_groups, xrt::BUILD_BLOCK, 0, (cudaStream_t)stream>>>(
      v0, e1, e2, mask, t_total, center, boxes, (float4*)coef);
  return (int)cudaGetLastError();
}

int sweep_nearest(const float* o, const float* d, int n, const float* v0,
                  const float* e1, const float* e2, int t_total,
                  const float* center, const float* boxes, const float* coef,
                  float* t, int* idx, float* u, float* v, void* stream) {
  xrt::SweepArgs a{o, d, n, v0, e1, e2, t_total, center, (const float4*)boxes,
                   (const float4*)coef, nullptr, nullptr, t, idx, u, v,
                   nullptr, nullptr};
  return xrt::launch<xrt::NEAREST>(a, stream);
}

int sweep_nearest_rec(const float* o, const float* d, int n, const float* v0,
                      const float* e1, const float* e2, int t_total,
                      const float* center, const float* boxes,
                      const float* coef, const float* tri_rec, float* t,
                      int* idx, float* u, float* v, float* rec, void* stream) {
  xrt::SweepArgs a{o, d, n, v0, e1, e2, t_total, center, (const float4*)boxes,
                   (const float4*)coef, tri_rec, nullptr, t, idx, u, v, rec,
                   nullptr};
  return xrt::launch<xrt::NEAREST_REC>(a, stream);
}

int occluded_anyhit(const float* o, const float* d, int n, int t_total,
                    const float* center, const float* boxes,
                    const float* coef, const float* t_max, uint8_t* blocked,
                    void* stream) {
  xrt::SweepArgs a{o, d, n, nullptr, nullptr, nullptr, t_total, center,
                   (const float4*)boxes, (const float4*)coef, nullptr, t_max, nullptr,
                   nullptr, nullptr, nullptr, nullptr, blocked};
  return xrt::launch<xrt::ANYHIT>(a, stream);
}

}  // extern "C"
