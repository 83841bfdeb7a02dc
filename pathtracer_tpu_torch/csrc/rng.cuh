// The port's counter-based RNG on the card: threefry-2x32 (20 rounds) keyed
// on (pixel, iteration, depth, stage), the bits of utils/rng.py
// pixel_uniforms word for word.  utils/rng.py carries each 32-bit word in an
// int64 and masks it back to 32 bits after every add and shift; here the
// words are uint32, whose arithmetic wraps the same way.

#pragma once

#include <stdint.h>

namespace {

// utils/rng.py STAGE_CAMERA, STAGE_SCATTER, STAGE_LIGHT
constexpr uint32_t kStageCamera = 0;
constexpr uint32_t kStageScatter = 1;
constexpr uint32_t kStageLight = 2;

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// utils/rng.py _threefry2x32: the pair (x0, x1) under key (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[d % 2][j]);
      x1 = x0 ^ x1;
    }
    x0 += ks[(d + 1) % 3];
    x1 += ks[(d + 2) % 3] + (uint32_t)(d + 1);
  }
  return make_uint2(x0, x1);
}

// The counter word of a draw: block in bits 0-1, stage in 2-3, depth in
// 4-11, iteration in 12-31 (a depth above 255 spills into the iteration's
// bits, as in utils/rng.py; its Python caller refuses one).
__device__ __forceinline__ uint32_t counter_word(uint32_t iteration, uint32_t depth,
                                                 uint32_t stage) {
  return (iteration << 12) | (depth << 4) | (stage << 2);
}

// uint32 -> U[0,1): the top 23 bits as a mantissa, exact in float32.
__device__ __forceinline__ float u01(uint32_t x) {
  return static_cast<float>(x >> 9) * (1.0f / 8388608.0f);
}

// pixel_uniforms(key, iteration, depth, stage, pixel, 3) of one lane: block
// 0 gives columns 0 and 1, block 1 column 2.
__device__ __forceinline__ float3 uniforms3(uint32_t k0, uint32_t k1, uint32_t pixel,
                                            uint32_t word) {
  const uint2 a = threefry2x32(k0, k1, pixel, word | 0u);
  const uint2 b = threefry2x32(k0, k1, pixel, word | 1u);
  return make_float3(u01(a.x), u01(a.y), u01(b.x));
}

// pixel_uniforms(key, iteration, depth, stage, pixel, 4) of one lane: block
// 1's second word gives column 3.
__device__ __forceinline__ float4 uniforms4(uint32_t k0, uint32_t k1, uint32_t pixel,
                                            uint32_t word) {
  const uint2 a = threefry2x32(k0, k1, pixel, word | 0u);
  const uint2 b = threefry2x32(k0, k1, pixel, word | 1u);
  return make_float4(u01(a.x), u01(a.y), u01(b.x), u01(b.y));
}

}  // namespace
