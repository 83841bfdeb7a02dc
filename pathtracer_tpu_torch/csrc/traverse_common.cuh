// Device helpers shared by the traversal kernels (wbvh_traverse.cu: K1/K2,
// stream_traverse.cu: K3/K4).  Every operation is written out in the order
// of the plain PyTorch versions (ops/traverse_cuda.py _slab and
// _moller_trumbore); with -fmad=false and no fast math, kernel and plain
// version round alike.

#pragma once

#include <cuda_runtime.h>

namespace {

// NaN-propagating min/max, as jnp.minimum/maximum and torch.minimum/maximum.
// fminf/fmaxf DROP NaN and would accept the empty (NaN) child slots.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

// Slab test of one child box; returns hit and writes t_enter.  As in the
// Pallas kernel's _aabb_packet (pathtracer_tpu/ops/traverse_pallas.py:45): a
// zero direction component with the origin exactly on a bound gives
// 0 * inf = NaN and rejects the box (ROADMAP Queue 3 records this choice).
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     float ox, float oy, float oz,
                                     float idx, float idy, float idz,
                                     float* t_enter) {
  float lo_x = (b[0] - ox) * idx, hi_x = (b[3] - ox) * idx;
  float lo_y = (b[1] - oy) * idy, hi_y = (b[4] - oy) * idy;
  float lo_z = (b[2] - oz) * idz, hi_z = (b[5] - oz) * idz;
  float te = nan_max(nan_max(nan_min(lo_x, hi_x), nan_min(lo_y, hi_y)), nan_min(lo_z, hi_z));
  float tx = nan_min(nan_min(nan_max(lo_x, hi_x), nan_max(lo_y, hi_y)), nan_max(lo_z, hi_z));
  *t_enter = te;
  return (te <= tx) && (tx > 0.0f);
}

// Möller-Trumbore on one edge-form row; operation order as _moller_trumbore
// (traverse_pallas.py:80).  Returns hit; writes t, u, v.
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ r,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float* t, float* u, float* v) {
  float e1x = r[3], e1y = r[4], e1z = r[5];
  float e2x = r[6], e2y = r[7], e2z = r[8];
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  float tx = ox - r[0], ty = oy - r[1], tz = oz - r[2];
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

}  // namespace
