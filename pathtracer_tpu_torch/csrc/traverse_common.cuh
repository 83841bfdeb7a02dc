// Device helpers shared by the traversal kernels (wbvh_traverse.cu: K1/K2,
// stream_traverse.cu: K3/K4/K5) and the probes.  Every operation is written
// out in the order of the plain PyTorch versions (ops/traverse_cuda.py _slab
// and _moller_trumbore); with -fmad=false and no fast math, kernel and plain
// version round alike.

#pragma once

#include <cuda_runtime.h>

namespace {

// NaN-propagating min/max, as jnp.minimum/maximum and torch.minimum/maximum:
// one opcode each (PTX min.NaN.f32 / max.NaN.f32, sm_80 and later; SASS
// FMNMX.NAN), no branch.  fminf/fmaxf DROP NaN and would accept the empty
// (NaN) child slots.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// One ray: origin, direction and the reciprocal direction (IEEE division, so
// a zero component gives +-inf).
struct Ray {
  float ox, oy, oz, dx, dy, dz, idx, idy, idz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray r;
  r.ox = o[3 * i], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
  r.dx = d[3 * i], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
  r.idx = 1.0f / r.dx, r.idy = 1.0f / r.dy, r.idz = 1.0f / r.dz;
  return r;
}

// Which of the 8 child orders of a node the ray takes (one bit per positive
// direction component).
__device__ __forceinline__ int octant(const Ray& r) {
  return (r.dx > 0.0f ? 1 : 0) | (r.dy > 0.0f ? 2 : 0) | (r.dz > 0.0f ? 4 : 0);
}

// Slab test of one child box [bmin, bmax] given by value; returns hit and
// writes t_enter.  As in the Pallas kernel's _aabb_packet
// (pathtracer_tpu/ops/traverse_pallas.py:45): a zero direction component with
// the origin exactly on a bound gives 0 * inf = NaN and rejects the box
// (ROADMAP Queue 3 records this choice).  A NaN anywhere makes te or tx NaN,
// and both comparisons are then false.
__device__ __forceinline__ bool slab(float bx0, float by0, float bz0,
                                     float bx1, float by1, float bz1,
                                     float ox, float oy, float oz,
                                     float idx, float idy, float idz,
                                     float* t_enter) {
  float lo_x = (bx0 - ox) * idx, hi_x = (bx1 - ox) * idx;
  float lo_y = (by0 - oy) * idy, hi_y = (by1 - oy) * idy;
  float lo_z = (bz0 - oz) * idz, hi_z = (bz1 - oz) * idz;
  float te = nan_max(nan_max(nan_min(lo_x, hi_x), nan_min(lo_y, hi_y)), nan_min(lo_z, hi_z));
  float tx = nan_min(nan_min(nan_max(lo_x, hi_x), nan_max(lo_y, hi_y)), nan_max(lo_z, hi_z));
  *t_enter = te;
  return (te <= tx) && (tx > 0.0f);
}

// The same test on a box stored as 6 consecutive floats.
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     float ox, float oy, float oz,
                                     float idx, float idy, float idz,
                                     float* t_enter) {
  return slab(b[0], b[1], b[2], b[3], b[4], b[5], ox, oy, oz, idx, idy, idz, t_enter);
}

// Möller-Trumbore on one edge-form triangle [v0, e1, e2] given by value;
// operation order as _moller_trumbore (traverse_pallas.py:80).  Returns hit;
// writes t, u, v.
__device__ __forceinline__ bool moller_trumbore(float v0x, float v0y, float v0z,
                                                float e1x, float e1y, float e1z,
                                                float e2x, float e2y, float e2z,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float* t, float* u, float* v) {
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  float uu = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
  float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t = tt;
  *u = uu;
  *v = vv;
  return (det != 0.0f) && (tt >= 0.0f) && (uu >= 0.0f) && (vv >= 0.0f) &&
         (1.0f - uu - vv >= 0.0f);
}

// The same test on a row stored as 9 consecutive floats.
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ r,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float* t, float* u, float* v) {
  return moller_trumbore(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8],
                         ox, oy, oz, dx, dy, dz, t, u, v);
}

}  // namespace
