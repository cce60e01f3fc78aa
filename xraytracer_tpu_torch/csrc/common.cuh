// Shared helpers for the sweep kernels: small float3 math and the constants
// the Python side also uses (xraytracer_tpu_torch/constants.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xrt {

// Intersection epsilon (reference: kEpsilon = FLT_EPSILON).
constexpr float K_EPS = 1.1920928955078125e-07f;
// "Infinite" distance sentinel (reference: kInfinity = FLT_MAX).
constexpr float INF_T = 3.4028234663852886e+38f;
// Running-minimum start value of the nearest-hit sweep; the plain version
// uses the same number, so a hit at or beyond it loses in both.
constexpr float BIG_T = 3.4e38f;

__device__ __forceinline__ float3 load3(const float* __restrict__ p, int i) {
  return make_float3(p[3 * i + 0], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float3 sub3(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

__device__ __forceinline__ float dot3(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float3 cross3(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
                     a.x * b.y - a.y * b.x);
}

}  // namespace xrt
