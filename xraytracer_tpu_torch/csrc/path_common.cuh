// What every kernel that carries paths shares: the counter-based random
// numbers, the pinhole camera ray of a pixel's sample, and the rejection of a
// finished sample. The whole-path kernels (megakernel.cu, vol_megakernel.cu)
// and the tracking kernels (media.cuh) include this header, so a draw at a
// given (key, site) and the camera ray of a given (pixel, sample) are the
// same numbers in all of them.
#pragma once

#include "common.cuh"

namespace xrt {

constexpr uint32_t GOLDEN = 0x9E3779B9u;  // Weyl increment between sites
constexpr uint32_t SITES_PER_BOUNCE = 1u << 16;
constexpr float INV24 = 1.0f / 16777216.0f;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float THIRD = (float)(1.0 / 3.0);
constexpr float RAY_EPS_F = 1e-3f;  // constants.py::RAY_EPS
constexpr float TINY = 1e-38f;      // floor under 1 - u before a logarithm
constexpr float INV_4PI = (float)(1.0 / (4.0 * 3.14159265359));  // warps.py

__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  const uint32_t word = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float tof(uint32_t u) {
  return (float)(u >> 8) * INV24;
}

__device__ __forceinline__ float u1(uint32_t key, uint32_t site) {
  return tof(pcg(key + site * GOLDEN));
}

__device__ __forceinline__ void u2(uint32_t key, uint32_t site, float& a,
                                   float& b) {
  const uint32_t x1 = pcg(key + site * GOLDEN);
  const uint32_t x2 = pcg(x1);
  a = tof(x1);
  b = tof(x2);
}

// A product, a sum resp. a difference that the compiler must not contract
// into a fused multiply-add: for values on the way to a discrete decision
// that a plain PyTorch version takes from separately rounded tensor
// operations.
#define XM(a, b) __fmul_rn((a), (b))
#define XA(a, b) __fadd_rn((a), (b))
#define XS(a, b) __fsub_rn((a), (b))

__device__ __forceinline__ float safe1(float x) { return x == 0.f ? 1.0f : x; }

// sampling/distribution.py::sample_channel: pmf proportional to the weights
// (uniform on a zero sum), lower_bound with the x == 0 bump. Sums in the
// plain version's order: s = (w0 + w1) + w2, c2 = pmf0 + pmf1.
__device__ __forceinline__ int pick_channel(float w0, float w1, float w2,
                                            float u, float pmf[3]) {
  const float s = XA(XA(w0, w1), w2);
  const bool pos = s > 0.f;
  const float sg = s == 0.f ? 1.0f : s;
  pmf[0] = pos ? w0 / sg : THIRD;
  pmf[1] = pos ? w1 / sg : THIRD;
  pmf[2] = pos ? w2 / sg : THIRD;
  const float c1 = pmf[0], c2 = XA(pmf[0], pmf[1]);
  const int x = (0.f < u ? 1 : 0) + (c1 < u ? 1 : 0) + (c2 < u ? 1 : 0);
  return max(x, 1) - 1;
}

__device__ __forceinline__ float3 ld3(const float* __restrict__ p) {
  return make_float3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}

struct MegaCamera {
  float m[9];  // camera-to-world rotation, row-vector convention, row-major
  float o[3];
  float scale, scale_over_aspect, inv_w, inv_h;
  uint32_t cam_site;  // (camera site * GOLDEN) mod 2^32
};

// ``cam16`` is a HOST array: rotation (9, row-major), origin (3), scale,
// scale / aspect, 1 / width, 1 / height.
static inline MegaCamera camera_from(const float* cam16, unsigned cam_site) {
  MegaCamera C;
  for (int k = 0; k < 9; ++k) C.m[k] = cam16[k];
  for (int k = 0; k < 3; ++k) C.o[k] = cam16[9 + k];
  C.scale = cam16[12];
  C.scale_over_aspect = cam16[13];
  C.inv_w = cam16[14];
  C.inv_h = cam16[15];
  C.cam_site = cam_site;
  return C;
}

// Path key and jittered pinhole ray of sample ``s`` of one pixel.
__device__ __forceinline__ void camera_sample(const MegaCamera& C,
                                              uint32_t pixfold, float px,
                                              float py, uint32_t s,
                                              uint32_t& key, float3& o,
                                              float3& d) {
  key = pcg(pixfold + s);
  const uint32_t x1 = pcg(key + C.cam_site);
  const uint32_t x2 = pcg(x1);
  const float uvx = (px + tof(x1)) * C.inv_w;
  const float uvy = (py + tof(x2)) * C.inv_h;
  const float nx = (2.0f * uvx - 1.0f) * C.scale;
  const float ny = (1.0f - 2.0f * uvy) * C.scale_over_aspect;
  const float dxw = nx * C.m[0] + ny * C.m[3] - C.m[6];
  const float dyw = nx * C.m[1] + ny * C.m[4] - C.m[7];
  const float dzw = nx * C.m[2] + ny * C.m[5] - C.m[8];
  const float inv = 1.0f / sqrtf(dxw * dxw + dyw * dyw + dzw * dzw);
  o = make_float3(C.o[0], C.o[1], C.o[2]);
  d = make_float3(dxw * inv, dyw * inv, dzw * inv);
}

// A finished sample joins the sum unless a channel is NaN, Inf or negative.
__device__ __forceinline__ void add_sample(const float3& L, float3& acc,
                                           int& rej) {
  const bool ok = (L.x >= 0.f) & (L.x < INFINITY) & (L.y >= 0.f) &
                  (L.y < INFINITY) & (L.z >= 0.f) & (L.z < INFINITY);
  if (ok) {
    acc.x += L.x;
    acc.y += L.y;
    acc.z += L.z;
  } else {
    rej += 1;
  }
}

// Point on a flat light for the uniforms (lu, lv): the sqrt warp on a
// triangle (a = v0, b = v0 + e1, c = v0 + e2), the bilinear point on a quad.
__device__ __forceinline__ float3 light_point(bool is_tri, float3 v0,
                                              float3 e1, float3 e2, float lu,
                                              float lv) {
  if (is_tri) {
    const float su = sqrtf(lu);
    const float vs = lv * su;
    return make_float3(
        (v0.x + e2.x) + (1.0f - su) * (-e2.x) + vs * (e1.x - e2.x),
        (v0.y + e2.y) + (1.0f - su) * (-e2.y) + vs * (e1.y - e2.y),
        (v0.z + e2.z) + (1.0f - su) * (-e2.z) + vs * (e1.z - e2.z));
  }
  return make_float3(v0.x + e1.x * lu + e2.x * lv, v0.y + e1.y * lu + e2.y * lv,
                     v0.z + e1.z * lu + e2.z * lv);
}

// The volume kernels' shared geometry and phase function: every product,
// sum and difference rounded on its own, in the order of the plain
// PyTorch version named beside each, so that the decisions a path takes
// after them (the next hit, the next tracking step) follow it bit for bit.
// ((a.x * b.x + a.y * b.y) + a.z * b.z), each step rounded: PyTorch's sum
// of a 3-vector product
__device__ __forceinline__ float dot3x(float3 a, float3 b) {
  return XA(XA(XM(a.x, b.x), XM(a.y, b.y)), XM(a.z, b.z));
}

__device__ __forceinline__ float3 f3(const float v[3]) {
  return make_float3(v[0], v[1], v[2]);
}

// geometry/intersect.py::intersect_boxes for one box
__device__ __forceinline__ void slab(float o, float d, float lo, float hi,
                                     float& t_near, float& t_far) {
  const float d_safe = fabsf(d) < 1e-12f ? 1e-12f : d;
  const float iv = 1.0f / d_safe;
  const float ta = XM(XS(lo, o), iv), tb = XM(XS(hi, o), iv);
  t_near = fminf(ta, tb);
  t_far = fmaxf(ta, tb);
}

// math/vec.py::orthonormal_basis (the branchless Duff et al. frame)
__device__ __forceinline__ void onb(float3 n, float3& t, float3& b) {
  const float sg = copysignf(1.0f, n.z);
  const float a = -1.0f / XA(sg, n.z);
  const float c = XM(XM(n.x, n.y), a);
  t = make_float3(XA(1.0f, XM(XM(XM(sg, n.x), n.x), a)), XM(sg, c),
                  XM(-sg, n.x));
  b = make_float3(c, XA(sg, XM(XM(n.y, n.y), a)), -n.y);
}

// (v0 * t + v1 * m) + v2 * b, per component: math/vec.py::local_to_world
__device__ __forceinline__ float3 to_world(float v0, float v1, float v2,
                                          float3 t, float3 m, float3 b) {
  return make_float3(XA(XA(XM(v0, t.x), XM(v1, m.x)), XM(v2, b.x)),
                     XA(XA(XM(v0, t.y), XM(v1, m.y)), XM(v2, b.y)),
                     XA(XA(XM(v0, t.z), XM(v1, m.z)), XM(v2, b.z)));
}

// sampling/warps.py::hg_sample_direction about wo (local +Y is wo)
__device__ __forceinline__ float3 hg_direction(float g, float3 wo, float u1_,
                                               float u2_) {
  float cos_t;
  if (fabsf(g) < 1e-3f) {
    cos_t = XS(XM(2.0f, u1_), 1.0f);
  } else {
    const float sqr = XS(1.0f, XM(g, g)) / XA(XS(1.0f, g), XM(XM(2.0f, g), u1_));
    cos_t = XS(XA(1.0f, XM(g, g)), XM(sqr, sqr)) / XM(2.0f, g);
  }
  const float sin_t = sqrtf(fmaxf(XS(1.0f, XM(cos_t, cos_t)), 0.f));
  const float phi = XM(TWO_PI, u2_);
  float3 t, b;
  onb(wo, t, b);
  return to_world(XM(cosf(phi), sin_t), cos_t, XM(sinf(phi), sin_t), t, wo, b);
}

// sampling/warps.py::hg_phase
__device__ __forceinline__ float hg_phase(float g, float cos_t) {
  const float denom = XS(XA(1.0f, XM(g, g)), XM(XM(2.0f, g), cos_t));
  return XM(INV_4PI, XS(1.0f, XM(g, g))) / XM(denom, sqrtf(denom));
}

}  // namespace xrt
