// The ray/triangle arithmetic shared by every kernel that decides a hit:
// the sweeps (sweep.cu) and the whole-path kernels (megakernel.cu) include
// this header, so a given (ray, triangle) pair resolves identically in all
// of them.
//
//   tri_coeffs    16 per-triangle coefficients of the expanded bilinear
//                 Moller-Trumbore form, in coordinates centred on the
//                 table's centroid (an all-zero row can never be hit)
//   pair_test     the four triple products and the division-free hit test
//   winner_tuv    exact (t, u, v) of the winning triangle by the factored
//                 classic form on the original inputs
#pragma once

#include "common.cuh"

namespace xrt {

// Coefficients of one triangle, 4 float4:
//   f0 = (ng.x, ng.y, ng.z, p.ng)           ng = e1 x e2, p = v0 - centre
//   f1 = (e2.x, e2.y, e2.z, pe2.x)          pe2 = p x e2
//   f2 = (pe2.y, pe2.z, e1.x, e1.y)
//   f3 = (e1.z, e1p.x, e1p.y, e1p.z)        e1p = e1 x p
struct TriCoeffs {
  float4 f0, f1, f2, f3;
};

__device__ __forceinline__ TriCoeffs zero_coeffs() {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  return TriCoeffs{z, z, z, z};
}

__device__ __forceinline__ TriCoeffs tri_coeffs(float3 p, float3 E1,
                                                float3 E2) {
  const float3 ng = cross3(E1, E2);
  const float3 pe2 = cross3(p, E2);
  const float3 e1p = cross3(E1, p);
  TriCoeffs c;
  c.f0 = make_float4(ng.x, ng.y, ng.z, dot3(p, ng));
  c.f1 = make_float4(E2.x, E2.y, E2.z, pe2.x);
  c.f2 = make_float4(pe2.y, pe2.z, E1.x, E1.y);
  c.f3 = make_float4(E1.z, e1p.x, e1p.y, e1p.z);
  return c;
}

// Result of one pair test. A hit's distance is t_num / det; the any-hit
// compare is t_s < t_max * absd, without dividing.
struct PairTest {
  bool ok;
  float det, absd, t_num, t_s;
};

// oc = o - centre, m = oc x d.
__device__ __forceinline__ PairTest pair_test(const float4 f0, const float4 f1,
                                              const float4 f2, const float4 f3,
                                              const float3 oc, const float3 d,
                                              const float3 m) {
  PairTest r;
  r.det = -(d.x * f0.x + d.y * f0.y + d.z * f0.z);
  const float u_num = (m.x * f1.x + m.y * f1.y + m.z * f1.z) +
                      (d.x * f1.w + d.y * f2.x + d.z * f2.y);
  const float v_num = (d.x * f3.y + d.y * f3.z + d.z * f3.w) -
                      (m.x * f2.z + m.y * f2.w + m.z * f3.x);
  r.t_num = (oc.x * f0.x + oc.y * f0.y + oc.z * f0.z) - f0.w;
  const bool neg = r.det < 0.f;
  r.absd = fabsf(r.det);
  const float u_s = neg ? -u_num : u_num;
  const float v_s = neg ? -v_num : v_num;
  r.t_s = neg ? -r.t_num : r.t_num;
  r.ok = (r.absd >= K_EPS) & (u_s >= 0.f) & (v_s >= 0.f) &
         (u_s + v_s <= r.absd) & (r.t_s > K_EPS * r.absd);
  return r;
}

// Factored classic Moller-Trumbore against one triangle; a zero determinant
// is guarded, not tested.
__device__ __forceinline__ void winner_tuv(const float3 o, const float3 d,
                                           const float3 w_v0,
                                           const float3 w_e1,
                                           const float3 w_e2, float& t,
                                           float& u, float& v) {
  const float3 pvec = cross3(d, w_e2);
  const float det = dot3(w_e1, pvec);
  const float inv_det = 1.0f / (det == 0.f ? 1.0f : det);
  const float3 tvec = sub3(o, w_v0);
  u = dot3(tvec, pvec) * inv_det;
  const float3 qvec = cross3(tvec, w_e1);
  v = dot3(d, qvec) * inv_det;
  t = dot3(w_e2, qvec) * inv_det;
}

}  // namespace xrt
