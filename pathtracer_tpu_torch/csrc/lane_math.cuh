// What the one-thread-a-lane kernels share (shade.cu: M1, M2; lights.cu: L1,
// L2): ops/math.py's vector helpers, written out in the order of the plain
// PyTorch versions, the input columns, and the RNG draw of a lane.
//
// Rounding conventions (every kernel here is built with -fmad=false and
// without fast math): each Python float constant rounded to float32, as
// PyTorch rounds a scalar for a float32 kernel; `1.0 / x` a division and
// `c / x` a reciprocal times c (torch.Tensor.__rdiv__); `x / c` a
// multiplication by c's reciprocal (a tensor divided by a Python scalar);
// torch.clamp(x, min=lo) a NaN-propagating max; ops/math.py dot as
// x*x + y*y + z*z left to right.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"
#include "traverse_common.cuh"

namespace {

// A Python float as PyTorch hands it to a float32 kernel: rounded to nearest.
#define F32(x) static_cast<float>(x)
// utils/config.py PI, TWO_PI, INV_PI: double arithmetic, then float32
#define PI_D 3.1415926535897932384626422832795028841971
constexpr float kPi = F32(PI_D);
constexpr float kTwoPi = F32(2.0 * PI_D);
constexpr float kInvPi = F32(1.0 / PI_D);

// torch.clamp(x, min=lo): max(x, lo), a NaN kept.
__device__ __forceinline__ float clamp_min(float x, float lo) { return nan_max(x, lo); }

__device__ __forceinline__ float3 f3(float x, float y, float z) { return make_float3(x, y, z); }
__device__ __forceinline__ float3 neg(float3 a) { return f3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float3 add(float3 a, float3 b) {
  return f3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ float3 sub(float3 a, float3 b) {
  return f3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ float3 scale(float3 a, float s) { return f3(a.x * s, a.y * s, a.z * s); }

// ops/math.py dot, cross, normalize (eps 0)
__device__ __forceinline__ float dot(float3 a, float3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return f3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float3 normalize(float3 v) {
  const float n2 = dot(v, v);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(clamp_min(n2, F32(1e-38))) : 0.0f;
  return scale(v, inv);
}

// ops/math.py onb_pixar: (tangent, bitangent) of n.
__device__ __forceinline__ void onb_pixar(float3 n, float3& t, float3& b) {
  const float sz = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = 1.0f / (sz + n.z);
  const float sx = sz * n.x;
  const float bb = n.x * n.y * a;
  t = f3(sx * n.x * a - 1.0f, sz * bb, sx);
  b = f3(bb, n.y * n.y * a - sz, n.y);
}

// An (N,) or (N, 3) input column: lane i's first element at p[i * s].
template <typename T>
struct Col {
  const T* p;
  int s;
  __device__ __forceinline__ T at(int i) const { return p[(size_t)i * s]; }
  __device__ __forceinline__ float3 at3(int i) const {
    const T* q = p + (size_t)i * s;
    return f3(q[0], q[1], q[2]);
  }
};

// A counter field of the RNG: per lane (s 1), one word in device memory (s
// 0), or, with no pointer, an immediate.
struct Counter {
  const int* p;
  int s;
  uint32_t imm;
  __device__ __forceinline__ uint32_t at(int i) const {
    return p ? (uint32_t)p[(size_t)i * s] : imm;
  }
};

// A lane's draw: pixel_uniforms(key, it, dp, stage, lane + pixel0, ncols).
struct Draw {
  Col<int> lane;
  uint32_t pixel0, k0, k1;
  Counter it, dp;
  __device__ __forceinline__ uint32_t pixel(int i) const { return (uint32_t)lane.at(i) + pixel0; }
  __device__ __forceinline__ uint32_t word(int i, uint32_t stage) const {
    return counter_word(it.at(i), dp.at(i), stage);
  }
  // ncols 3
  __device__ __forceinline__ float3 at3(int i, uint32_t stage) const {
    return uniforms3(k0, k1, pixel(i), word(i, stage));
  }
  // ncols 4 (its first three columns are ncols 3's)
  __device__ __forceinline__ float4 at4(int i, uint32_t stage) const {
    return uniforms4(k0, k1, pixel(i), word(i, stage));
  }
};

inline Draw make_draw(const int* lane, int lane_s, uint32_t pixel0, uint32_t k0, uint32_t k1,
                      const int* it, int it_s, uint32_t it_imm, const int* dp, int dp_s,
                      uint32_t dp_imm) {
  return Draw{Col<int>{lane, lane_s}, pixel0, k0, k1, Counter{it, it_s, it_imm},
              Counter{dp, dp_s, dp_imm}};
}

}  // namespace
