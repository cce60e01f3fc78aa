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
// One device function for the shading of a hit (mega_path.cuh's `shade`), a
// template over a Jacobian accumulator, four kernels around it, four
// extern "C" launchers. The render kernels instantiate it with `NoGrad`,
// whose hooks are empty, so they compile to the shading alone;
// mega_grad_path instantiates it with `Grad` (mega_grad.cuh).
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
// The render kernels.
//   mega_path            rays and keys in, radiance out: one path per
//                        thread, by the merged loop's pass (below) with one
//                        sample a lane and its ray given.
//   mega_spp             per pixel, a loop over samples s0 .. s0+n_spp-1:
//                        key = pcg(pixfold + s), jittered pinhole ray, the
//                        path by mega_path's lane, rejection of a NaN / Inf
//                        / negative sample, sum. A warp starts sample s+1
//                        only when its slowest lane has finished sample s.
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
// do not block shadow rays. The lane code (walks, shading, the merged
// loop's pass) is in mega_path.cuh.
//
// What bounds K1 on an H100: float32 operations, and the table walks
// spend them. A pixel moves 12 B in and 16 B out per launch whatever the
// sample count, while every ray costs T pair tests of ~38 flops (the
// bound counts only those). Breaking the Cornell main-path launch down
// (PERF.md, section 6): the separate shadow walks cost 40% of its time, and
// their divergence more than their tests (a shadow walk by every lane over
// every row was 8% faster than one by the lanes that need it, stopping at
// the first blocker); row loads through L1 15%; the shading between walks
// 2%. So the merged loop (K1c) walks a coherent pair of rays:
//
//   * One walk per pass. A lane carries its path ray and the shadow ray
//     of its previous vertex's last light sample into one loop over the
//     rows, which tests both against each row, loaded once; the shadow
//     ray reads the row's blocks bit and does not stop at a blocker. Its
//     term waits in the lane and is added after the walk (mega_path.cuh
//     states why every sum stays bitwise the per-sample loop's). A path's
//     last vertex leaves its shadow ray to the pass that walks the lane's
//     next camera ray. With two rays a row the walk's own instructions
//     cost more than its loads: the culled walk tests a row's plane before
//     its edges (mega_path.cuh).
//   * Staging. A table of at most MEGA_STAGE_ROWS rows (the Cornell box's
//     40: 7,688 B) is copied whole, coefficients, records and blocks bits,
//     into each block's dynamic shared memory once; the block turns for
//     the whole launch, so the copy is paid once, and the walk (and the
//     winner's record) read it from there, every row by the whole pair
//     test, without a box test. One barrier follows the copy, before any
//     lane may leave; lanes past n take part in the copy and then leave.
//   * Culling. A larger table is walked over the sweeps' chunk table
//     (sweep.cuh: groups of SWEEP_GROUP chunks of SWEEP_CHUNK rows; its
//     boxes under the valid mask, built once per table by sweep.cu's
//     chunk_boxes), its rows and records through L1: a warp visits a
//     group, then a chunk, only when some lane's path ray enters its box
//     before its best t or its shadow ray before its t_max (__any_sync),
//     as the TPU kernels cull and with the padding condition of sweep.cu.
//     Lanes past n and lanes done with their samples keep voting until
//     their warp is done.
//
// K1a, K1b and K5 take the same walks (`single_path`: a pass per bounce
// and one for the last shadow ray, staged or culled by the same line; K1b
// runs it once per sample, from the sample's camera ray): on the 3,072-row
// table K1a's launch fell from 8.31 to 0.57 ms and K1b's (4 spp) from 30.7
// to 2.1 ms, on Cornell 9% and 16% (PERF.md, section 6). K1a on a culled
// table and K1b on both defer a vertex's last light sample as K1c does, and
// walk it on the next pass (K1b: so that its sums stay K1c's on the card);
// K1a on a staged table walks every shadow ray at once over the staged
// rows. Carrying a sample's last shadow ray into the next sample's
// camera-ray pass (K1c's way across samples) measured no faster for K1b,
// nor did eight blocks per SM. K5 walks every shadow ray
// at once (over the staged rows, or through L1), since a deferred sample
// would carry 9M + 3 sums (measured 19% slower on Cornell). mega_path.cuh's
// `bounce` (the nearest walk, then each light sample's shadow walk over the
// blocks copy, stopping at its first blocker, through L1) is launched by no
// kernel: it is the reference the host rehearsals hold every walk to.
//
// Winner rule: strict t < best while walking rows upwards, first index wins
// exact ties, as in sweep.cu (the Pallas key keeps the lowest row among hits
// within 2^-16 relative t instead); a culled chunk holds no row that could
// replace the best.
//
// mega_grad_path carries, beside the path, its Jacobians w.r.t. the
// material albedos and the light emissions (`Grad`, mega_grad.cuh): the
// gradient of the same estimator that autodiff of the wavefront integrator
// computes, in the forward pass. Its outputs are 3 + 9M + 3L planes of N
// floats (radiance, dL/dalbedo, dL/dLe); each lane owns its column, so
// there are no atomics and the stores of a warp are coalesced. Its
// throughput Jacobian lives in registers, 9 x the bucket of M the launcher
// picks (1, 2, 4 or 8; every loop over materials is unrolled to it), its
// sums in the output planes, read and written in place; it moves
// 28 + 4 (3 + 9M + 3L) bytes per lane, so it is bound by operations for
// Cornell (M = 3, L = 1) and by bytes once the lights are many.
//
// nvcc contracts a*b+c into FMAs; no fast-math flags, so division, sqrtf,
// sinf and cosf are the accurate ones.

#include "mega_grad.cuh"

namespace xrt {

constexpr int MEGA_BLOCK = 128;
// The largest table K1c, K1a and K5 stage whole into each block's shared
// memory (coefficients, records and blocks bits: 192 B a row, 12,296 B at
// 64 rows; Cornell's 40 rows 7,688 B); a larger one is culled over its
// chunk table. Measured at the two sides (PERF.md, section 6): Cornell's
// 40 rows ran the main path's launch 17% slower culled than staged, a
// 128-row sphere mesh 25% faster culled (and the 256-row rooms and 384-row mesh
// about twice as fast culled as with their rows staged). Between 40 and
// 128 rows the crossover was not measured; the line is drawn at two chunks.
// integrators/megakernel.py::MEGA_STAGE_ROWS decides which tables get a
// chunk table, and must equal it.
constexpr int MEGA_STAGE_ROWS = 64;
// The render kernels' blocks per SM (K1a-c): seven at 72 registers (204 B
// of spill stores) ran K1c's main-path launch 4% faster than no minimum (at
// most 96 registers, no spills), six 2% faster, eight 4% slower; K1a and
// K1b at eight (64 registers, more spills) were no faster (PERF.md,
// section 6). A pixel's samples are one lane's sum, so the frame's 3,565
// blocks run in whole waves: seven per SM take four waves of 924.
constexpr int MEGA_MIN_BLOCKS = 7;

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

// How a launch reads its table, by the table's size alone: at most
// MEGA_STAGE_ROWS rows are staged into each block's shared memory and
// walked whole (WALK_STAGED), a larger table is read through L1 by the
// culled walk (WALK_CULLED).
enum K1cWalk { WALK_STAGED = 0, WALK_CULLED = 1 };

// The staged layout: coefficients (4T float4) | records (8T float4) |
// blocks bits (T / 32 words, rounded up).
static inline int stage_bytes(int t_total) {
  return t_total * 192 + 4 * ((t_total + 31) / 32);
}

// One lane of a warp: culled_pair_walk's walker on the card (its votes go
// to the warp).
struct LaneWarp {
  static constexpr int LANES = 1;
  SweepRay path[1], shadow[1];
  __device__ __forceinline__ bool vote(bool p) {
    return __any_sync(0xffffffffu, p);
  }
};

// The block's copy of the table, in stage_bytes' layout; the blocks bits by
// a warp vote per 32 rows.
__device__ __forceinline__ void stage_table(const MegaScene& S, float4* smem) {
  const int T = S.t_total;
  for (int j = threadIdx.x; j < 4 * T; j += MEGA_BLOCK) smem[j] = __ldg(S.coef + j);
  for (int j = threadIdx.x; j < 8 * T; j += MEGA_BLOCK)
    smem[4 * T + j] = __ldg(S.tri_rec + j);
  uint32_t* bits = (uint32_t*)(smem + 12 * T);
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < (T + 31) / 32; w += MEGA_BLOCK / 32) {
    const int k = 32 * w + lane;
    const unsigned b = __ballot_sync(0xffffffffu, k < T && S.blocks[k] != 0);
    if (lane == 0) bits[w] = b;
  }
}

template <int WALK>
__global__ void __launch_bounds__(MEGA_BLOCK, MEGA_MIN_BLOCKS)
mega_spp_persistent_kernel(MegaScene S, MegaCamera C, int s0, int n_spp,
                           const int32_t* __restrict__ pixfold,
                           const float* __restrict__ px,
                           const float* __restrict__ py, int n,
                           float* __restrict__ out_sum,
                           int* __restrict__ out_rej) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  const bool live = i < n;
  const int T = S.t_total;
  constexpr bool STAGED = WALK == WALK_STAGED;
  if (STAGED) {
    stage_table(S, smem);
    __syncthreads();
  }
  // the culled walk's votes need every lane of the warp
  if (STAGED && !live) return;
  const float3 center = ld3(S.center);
  K1cLane l;
  k1c_init(l, live, live ? (uint32_t)pixfold[i] : 0u, live ? px[i] : 0.f,
           live ? py[i] : 0.f, n_spp);
  LaneWarp w;
  SweepRay& a = w.path[0];
  SweepRay& sh = w.shadow[0];
  // a lane needs one pass per bounce and one for its last shadow ray; the
  // bound can only cut a loop that would otherwise not end
  const long long limit = (long long)n_spp * (S.max_depth + 1) + 1;
  for (long long guard = 0; guard < limit; ++guard) {
    const bool has = k1c_begin(C, center, s0, n_spp, l, a, sh);
    if (STAGED) {
      if (!has) break;
      // a small table: the whole pair test per row (mega_path.cuh says
      // why, and at which sizes each form was measured)
      test_pair_rows<false>(PlainRows{smem},
                            WordBits{(const uint32_t*)(smem + 12 * T)}, 0, T,
                            a, sh, !a.done, !sh.done);
      k1c_end(S, center, l, a.best_i, sh.best_i >= 0, PlainRows{smem + 4 * T});
    } else {
      if (!w.vote(has)) break;
      culled_pair_walk(w, S.boxes, LdgRows{S.coef}, ByteBits{S.blocks}, T);
      k1c_end(S, center, l, a.best_i, sh.best_i >= 0, LdgRows{S.tri_rec});
    }
  }
  if (!live) return;
  out_sum[3 * i + 0] = l.acc.x;
  out_sum[3 * i + 1] = l.acc.y;
  out_sum[3 * i + 2] = l.acc.z;
  out_rej[i] = l.rej;
}

// The single-path lane of K1a and K5 over a launch's walk: K1c's pass with
// one sample, its ray given (mega_path.cuh's pass_rays / walk / path_end),
// staged whole or culled over the chunk table as K1c walks. With DEFER each
// pass walks the path ray and the shadow ray the last vertex deferred, and
// a path takes one more pass for its last one; the other shadow rays are
// walked at once, over the staged rows or through L1.
template <int WALK, bool DEFER, class J>
__device__ __forceinline__ void single_path(const MegaScene& S, float3 center,
                                            Path& p, J& jac,
                                            const float4* smem) {
  constexpr bool STAGED = WALK == WALK_STAGED;
  const int T = S.t_total;
  const uint32_t* bits = (const uint32_t*)(smem + 12 * T);
  Pending pend;
  pend.on = false;
  LaneWarp w;
  SweepRay& a = w.path[0];
  SweepRay& sh = w.shadow[0];
  for (int pass = 0; pass <= S.max_depth; ++pass) {
    const bool has = pass_rays(center, p, pend, a, sh);
    if (STAGED) {
      if (!has) break;
      test_pair_rows<false>(PlainRows{smem}, WordBits{bits}, 0, T, a, sh,
                            !a.done, !sh.done);
      path_end<DEFER>(S, center, p, pend, jac, a.best_i, sh.best_i >= 0,
                      PlainRows{smem + 4 * T},
                     RowsShadow<PlainRows, WordBits>{PlainRows{smem},
                                                     WordBits{bits}, T});
    } else {
      if (!w.vote(has)) break;
      culled_pair_walk(w, S.boxes, LdgRows{S.coef}, ByteBits{S.blocks}, T);
      path_end<DEFER>(S, center, p, pend, jac, a.best_i, sh.best_i >= 0,
                      LdgRows{S.tri_rec}, GlobalShadow{S});
    }
  }
}

// K1b: per pixel lane, samples s0 .. s0 + n_spp - 1 one after the other,
// each a whole path by K1a's lane (single_path), its sum joined in sample
// order. On both walks a vertex's last light sample is deferred into the
// next walk, as K1c walks it. Walked at once inside the pass (K1a's split),
// 4 of Cornell's 456,300 pixels at 512 spp parted from K1c's sums, and none
// with both built under -fmad=false: nvcc contracts the two walks'
// arithmetic differently (chip_smoke.py --k1b-probe; PERF.md, section 6).
// On the culled walk a warp's votes end each sample: lanes past n and lanes
// whose sample has ended vote until their warp's slowest lane has finished.
template <int WALK>
__global__ void __launch_bounds__(MEGA_BLOCK, MEGA_MIN_BLOCKS)
mega_spp_kernel(MegaScene S, MegaCamera C, int s0, int n_spp,
                const int32_t* __restrict__ pixfold,
                const float* __restrict__ px, const float* __restrict__ py,
                int n, float* __restrict__ out_sum, int* __restrict__ out_rej) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  const bool live = i < n;
  if (WALK == WALK_STAGED) {
    stage_table(S, smem);
    __syncthreads();
    if (!live) return;
  }
  const float3 center = ld3(S.center);
  const uint32_t fold = live ? (uint32_t)pixfold[i] : 0u;
  const float x = live ? px[i] : 0.f, y = live ? py[i] : 0.f;
  float3 acc = make_float3(0.f, 0.f, 0.f);
  int rej = 0;
  Path p;
  NoGrad ng;
  for (int s = 0; s < n_spp; ++s) {
    start_sample(C, fold, x, y, (uint32_t)(s0 + s), p);
    p.act = live;
    single_path<WALK, true>(S, center, p, ng, smem);
    add_sample(p.L, acc, rej);
  }
  if (!live) return;
  out_sum[3 * i + 0] = acc.x;
  out_sum[3 * i + 1] = acc.y;
  out_sum[3 * i + 2] = acc.z;
  out_rej[i] = rej;
}

// K1a: radiance of one whole path per ray. Lanes past n stage, and (culled)
// vote until their warp is done.
template <int WALK>
__global__ void __launch_bounds__(MEGA_BLOCK, MEGA_MIN_BLOCKS)
mega_path_kernel(MegaScene S, const float* __restrict__ o,
                 const float* __restrict__ d, const int32_t* __restrict__ keys,
                 int n, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  const bool live = i < n;
  if (WALK == WALK_STAGED) {
    stage_table(S, smem);
    __syncthreads();
    if (!live) return;
  }
  const float3 center = ld3(S.center);
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  Path p;
  start_path(p, live, live ? (uint32_t)keys[i] : 0u, live ? load3(o, i) : zero,
             live ? load3(d, i) : zero);
  NoGrad ng;
  // the staged walk walks every shadow ray at once, the culled walk defers
  // the last light sample of a vertex (PERF.md, section 6); staged, a path
  // is therefore not always bitwise K1c's (see K1b above)
  single_path<WALK, WALK == WALK_CULLED>(S, center, p, ng, smem);
  if (!live) return;
  out[3 * i + 0] = p.L.x;
  out[3 * i + 1] = p.L.y;
  out[3 * i + 2] = p.L.z;
}

// K5: radiance and Jacobians of one whole path per ray: K1a's lane with the
// Grad accumulator (mega_grad.cuh) of bucket MB, every light sample's
// shadow ray walked at once (the deferred form measured slower: PERF.md,
// section 6). ``out`` holds 3 + 9M + 3L planes of n floats.
template <int MB, int WALK>
__global__ void __launch_bounds__(MEGA_BLOCK)
mega_grad_path_kernel(MegaScene S, const int32_t* __restrict__ obj_mat,
                      int n_obj, int n_mats, const float* __restrict__ o,
                      const float* __restrict__ d,
                      const int32_t* __restrict__ keys, int n,
                      float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int i = blockIdx.x * MEGA_BLOCK + threadIdx.x;
  const bool live = i < n;
  if (WALK == WALK_STAGED) {
    stage_table(S, smem);
    __syncthreads();
    if (!live) return;
  }
  const float3 center = ld3(S.center);
  const float3 zero = make_float3(0.f, 0.f, 0.f);
  // a lane past n (culled: it votes, and shades nothing) has no planes
  Grad<MB> jac(obj_mat, n_obj, live ? n_mats : 0, live ? S.n_lights : 0, out,
               n, live ? i : 0);
  Path p;
  start_path(p, live, live ? (uint32_t)keys[i] : 0u, live ? load3(o, i) : zero,
             live ? load3(d, i) : zero);
  single_path<WALK, false>(S, center, p, jac, smem);
  if (!live) return;
  out[i] = p.L.x;
  out[(size_t)n + i] = p.L.y;
  out[2 * (size_t)n + i] = p.L.z;
}

// A K5 launch of bucket MB, its walk by the table (as K1c's).
template <int MB>
static void launch_grad(const MegaScene& S, bool culled, const int32_t* obj_mat,
                        int n_obj, int n_mats, const float* o, const float* d,
                        const int32_t* keys, int n, float* out,
                        cudaStream_t st) {
  const int grid = (n + MEGA_BLOCK - 1) / MEGA_BLOCK;
  if (culled)
    mega_grad_path_kernel<MB, WALK_CULLED><<<grid, MEGA_BLOCK, 0, st>>>(
        S, obj_mat, n_obj, n_mats, o, d, keys, n, out);
  else
    mega_grad_path_kernel<MB, WALK_STAGED>
        <<<grid, MEGA_BLOCK, stage_bytes(S.t_total), st>>>(
            S, obj_mat, n_obj, n_mats, o, d, keys, n, out);
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
  const float* boxes;  // the chunk table's boxes (sweep.cuh), or null
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
  S.blocks = a.blocks;
  S.boxes = (const float4*)a.boxes;
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
      int cosine, int nee_kind, const float *boxes
#define XRT_SCENE_ARGS                                                       \
  xrt::SceneArgs {                                                           \
    v0, e1, e2, valid, blocks, t_total, center, coef, coef_blocks, tri_rec,  \
        lights, pick_cdf, n_lights, max_depth, nee, le0, cosine, nee_kind,   \
        boxes                                                                \
  }

extern "C" {

// The launchers' interface: 2 = the scene arguments end with the chunk
// table's boxes.
int mega_abi(void) { return 2; }

// Each launcher returns cudaGetLastError() after its launches (0 =
// accepted). ``cam16`` is the host array of path_common.cuh's camera_from.

int mega_path(const float* o, const float* d, const int32_t* keys, int n,
              XRT_SCENE_PARAMS, float* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  const int grid = (n + xrt::MEGA_BLOCK - 1) / xrt::MEGA_BLOCK;
  if (boxes != nullptr)
    xrt::mega_path_kernel<xrt::WALK_CULLED>
        <<<grid, xrt::MEGA_BLOCK, 0, st>>>(S, o, d, keys, n, out);
  else if (t_total <= xrt::MEGA_STAGE_ROWS)
    xrt::mega_path_kernel<xrt::WALK_STAGED>
        <<<grid, xrt::MEGA_BLOCK, xrt::stage_bytes(t_total), st>>>(S, o, d,
                                                                   keys, n, out);
  else  // the caller passes the chunk table's boxes for every larger table
    return (int)cudaErrorInvalidValue;
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
  if (boxes != nullptr)
    xrt::mega_spp_kernel<xrt::WALK_CULLED><<<grid, xrt::MEGA_BLOCK, 0, st>>>(
        S, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  else if (t_total <= xrt::MEGA_STAGE_ROWS)
    xrt::mega_spp_kernel<xrt::WALK_STAGED>
        <<<grid, xrt::MEGA_BLOCK, xrt::stage_bytes(t_total), st>>>(
            S, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  else  // the caller passes the chunk table's boxes for every larger table
    return (int)cudaErrorInvalidValue;
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
  if (boxes != nullptr)
    xrt::mega_spp_persistent_kernel<xrt::WALK_CULLED>
        <<<grid, xrt::MEGA_BLOCK, 0, st>>>(S, C, s0, n_spp, pixfold, px, py, n,
                                           out_sum, out_rej);
  else if (t_total <= xrt::MEGA_STAGE_ROWS)
    xrt::mega_spp_persistent_kernel<xrt::WALK_STAGED>
        <<<grid, xrt::MEGA_BLOCK, xrt::stage_bytes(t_total), st>>>(
            S, C, s0, n_spp, pixfold, px, py, n, out_sum, out_rej);
  else  // the caller passes the chunk table's boxes for every larger table
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// ``out``: (3 + 9 n_mats + 3 n_lights, n) plane-major; n_mats <= MAX_GRAD_MATS.
int mega_grad_path(const float* o, const float* d, const int32_t* keys, int n,
                   XRT_SCENE_PARAMS, const int32_t* obj_mat, int n_obj,
                   int n_mats, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_mats < 0 || n_mats > xrt::MAX_GRAD_MATS) return (int)cudaErrorInvalidValue;
  const bool culled = boxes != nullptr;
  // the caller passes the chunk table's boxes for every larger table
  if (!culled && t_total > xrt::MEGA_STAGE_ROWS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const xrt::MegaScene S = xrt::prepare(XRT_SCENE_ARGS, st);
  switch (xrt::grad_bucket(n_mats)) {
    case 1:
      xrt::launch_grad<1>(S, culled, obj_mat, n_obj, n_mats, o, d, keys, n, out,
                          st);
      break;
    case 2:
      xrt::launch_grad<2>(S, culled, obj_mat, n_obj, n_mats, o, d, keys, n, out,
                          st);
      break;
    case 4:
      xrt::launch_grad<4>(S, culled, obj_mat, n_obj, n_mats, o, d, keys, n, out,
                          st);
      break;
    default:
      xrt::launch_grad<xrt::MAX_GRAD_MATS>(S, culled, obj_mat, n_obj, n_mats, o,
                                           d, keys, n, out, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
