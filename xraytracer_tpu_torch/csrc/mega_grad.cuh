// The Jacobian accumulator of the analytic-gradient kernel (K5,
// megakernel.cu's mega_grad_path): the hooks that mega_path.cuh's `shade`
// calls where a path's Jacobians w.r.t. the material albedos and the light
// emissions change. No launch here: the kernel and a host program (the CPU
// rehearsal in tests/test_torch_csrc_grad_surface.py) both run it.
//
// Per lane, the recursion of the JAX package's _trace_body(grads=...):
//   GT[c][cc][m] = dT_c / dalbedo_{m,cc}   (registers, MB wide: the bucket
//                                           of the scene's M materials the
//                                           launcher picks, 1, 2, 4 or 8;
//                                           every loop over m is unrolled to
//                                           MB and predicated on n_mats)
//   dL[c][cc][m] = dL_c / dalbedo_{m,cc}   (plane 3 + (3c + cc) M + m)
//   dE[c][l]     = dL_c / dLe_{l,c}        (plane 3 + 9M + c L + l)
// Channels couple through the roulette's boost 1 / mean(T); Le enters no
// throughput, so dE has no cross-channel terms. dL and dE are summed in
// the lane's own column of the output, which the constructor zeroes: a
// shared-memory frame [plane][thread] and registers were both measured and
// were no faster (PERF.md, section 6). The bucket was: a 3x3x8 GT
// held 167 registers whatever M, a bucket of 4 (Cornell) 127.
//
// Every product and sum is rounded as written (XM / XA, and XF = one fused
// multiply-add): nvcc chose between fusing and not fusing by the shape of
// the code around it (a GT bucket of 1 against the parent's 8 parted 577
// lanes by an ulp), and these are the forms the parent's build took,
// measured bitwise on the card against it (PERF.md, section 6): the
// roulette's GT boost + T dboost fuses its first product, the light
// sample's and the scattering's same-channel term is a separate addition,
// each sum a fused multiply-add.
#pragma once

#include "mega_path.cuh"

namespace xrt {

#define XF(a, b, c) __fmaf_rn((a), (b), (c))

constexpr int MAX_GRAD_MATS = 8;  // integrators/megakernel.py::MAX_GRAD_MATS

// The register width of GT for a scene of n_mats materials.
__host__ __device__ inline int grad_bucket(int n_mats) {
  return n_mats <= 1 ? 1 : n_mats <= 2 ? 2 : n_mats <= 4 ? 4 : MAX_GRAD_MATS;
}

template <int MB>
struct Grad {
  const int32_t* __restrict__ obj_mat;  // object -> material row, -1 none
  int n_obj, n_mats, n_lights;
  float* __restrict__ out;  // (3 + 9M + 3L, n) plane-major
  int n, i;
  int mat;  // material of the current hit, -1 none
  float GT[3][3][MB];

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
        for (int m = 0; m < MB; ++m) GT[c][cc][m] = 0.f;
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
      for (int m = 0; m < MB; ++m) {
        if (m >= n_mats) break;
        const float db = XM(live, XA(XA(GT[0][cc][m], GT[1][cc][m]), GT[2][cc][m]));
#pragma unroll
        for (int c = 0; c < 3; ++c)
          GT[c][cc][m] = XF(GT[c][cc][m], boost, XM(tc[c], db));
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
        for (int m = 0; m < MB; ++m) {
          if (m >= n_mats) break;
          dl(c, cc, m) = XF(GT[c][cc][m], lc[c], dl(c, cc, m));
        }
      de(c, li) = XA(de(c, li), tc[c]);
    }
  }

  // L += T * albedo * Le * coef for a light sample of light li; the hit's
  // own albedo adds the same-channel term T * Le * coef
  __device__ __forceinline__ void nee(float3 t, float3 alb, float3 le,
                                      float coef, int li) {
    if (coef == 0.f) return;
    const float tc[3] = {t.x, t.y, t.z}, ac[3] = {alb.x, alb.y, alb.z};
    const float lc[3] = {XM(le.x, coef), XM(le.y, coef), XM(le.z, coef)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if (m >= n_mats) break;
          float dd = XM(GT[c][cc][m], ac[c]);
          if (cc == c && m == mat) dd = XA(dd, tc[c]);
          dl(c, cc, m) = XF(dd, lc[c], dl(c, cc, m));
        }
      de(c, li) = XF(XM(tc[c], ac[c]), coef, de(c, li));
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
        for (int m = 0; m < MB; ++m) {
          if (m >= n_mats) break;
          const float g = XM(GT[c][cc][m], wc[c]);
          GT[c][cc][m] = (cc == c && m == mat) ? XA(g, XM(tc[c], f)) : g;
        }
  }
};

}  // namespace xrt
