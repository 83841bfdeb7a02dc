// Wide (8-ary) BVH traversal kernels for Hopper (sm_90a): closest hit (K1)
// and shadow any-hit (K2).  One thread per ray, tables read straight from
// global memory (a resident mesh of ~10k triangles is well under 1 MB of
// tables, so they stay in L2).  Both are walks of walk_core.cuh over the
// tables below: K1 its closest-hit walk, K2 its any-hit walk.
//
// Tables (scene/flatscene.py build_wide_tables, identical to the JAX
// package's):
//   wf  (M*48,) f32  node m child c AABB at [m*48 + c*6 : +6] = bmin, bmax;
//                    NaN marks an empty slot.  A node's 8 boxes are 192
//                    consecutive bytes: 12 loads of 16 bytes
//   wi  (M*24,) i32  node m [link x8 | start x8 | end x8]; link >= 0 is an
//                    internal wide node, else [start, end) is a leaf cut
//   wp  (M*8,)  i32  per-octant near->far child order, 3 bits per rank (K1)
//   tri (T*12,) f32  EDGE-form rows [v0, e1 = v1 - v0, e2 = v2 - v0, pad]:
//                    48 bytes, 3 loads of 16 bytes
// Both need wf, wi and tri 16-byte aligned (the wrappers check).
//
// Built with -fmad=false and without fast math, so every operation rounds
// like the plain PyTorch versions in ops/traverse_cuda.py.  K1 walks their
// per-ray order and agrees bit for bit; K2's result does not depend on the
// order (walk_core.cuh says why) and agrees on every lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_core.cuh"

namespace {

// The resident tables as walk_core.cuh walks them: an entry is a node id,
// a child is a node (link >= 0) or a leaf cut of `tri`.
struct WideTables {
  const float* wf;
  const int* wi;
  const int* wp;  // K1 alone reads it; K2 passes none
  const float4* tri;
  static constexpr int kRoot = 0;
  struct Node {
    const float4* boxes;
    const int4* links;
    const int* perm;
  };
  __device__ __forceinline__ Node node(int e) const {
    return {reinterpret_cast<const float4*>(wf + (size_t)e * 48),
            reinterpret_cast<const int4*>(wi + (size_t)e * 24), wp + (size_t)e * 8};
  }
  struct Level {};
  __device__ __forceinline__ Level level(int) const { return {}; }
  __device__ __forceinline__ int inner(Level, int link) const { return link; }
  __device__ __forceinline__ bool child(int, const Node& nd, int slot, int link, int& push,
                                        int& lo, int& hi) const {
    if (link >= 0) {
      push = link;
      return true;
    }
    const int* ni = reinterpret_cast<const int*>(nd.links);
    lo = __ldg(ni + 8 + slot);
    hi = __ldg(ni + 16 + slot);
    return false;
  }
  __device__ __forceinline__ int tri_id(int row) const { return row; }
};

// K1: closest hit.  Replaces closest_hit_wbvh_pallas /
// _make_wide_closest_kernel (pathtracer_tpu/ops/traverse_pallas.py:418,139).
// Each pop tests the node's 8 children, then visits the passing ones in the
// ray's own octant order, far to near: a leaf child runs Möller-Trumbore over
// its cut at once, an internal child is pushed, so the nearest child is
// walked first.  A hit replaces the current one only if strictly closer
// (tt < best_t).  Lanes with t_init < 0 (the -FLT_MAX dead sentinel) never
// enter.  What bounds it on this card, and what the design does about it:
// walk_core.cuh.
__global__ void __launch_bounds__(WALK_THREADS)
closest_hit_wbvh_kernel(const float* __restrict__ wf, const int* __restrict__ wi,
                        const int* __restrict__ wp, const float* __restrict__ tri,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ t_init,
                        float* __restrict__ t_out, int* __restrict__ tri_out,
                        float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  const WideTables tb = {wf, wi, wp, reinterpret_cast<const float4*>(tri)};
  closest_hit_rays(tb, o, d, t_init, t_out, tri_out, u_out, v_out, n);
}

// K2: shadow any-hit.  Replaces occlusion_wbvh_pallas /
// _make_wide_occlusion_kernel (pathtracer_tpu/ops/traverse_pallas.py:1529,297).
// Blocked iff some triangle in a box the ray reaches within min_t has
// t < min_t - 1e-5 and |t - min_t| > 1e-4.  occluded0 lanes stay blocked;
// lanes with min_t < 0 (the -FLT_MAX sentinel) never block.  The any-hit walk
// of walk_core.cuh over the tables above, without the child order: what
// bounds it on this card, and why its order may differ from the plain
// version's, is said there.
__global__ void __launch_bounds__(WALK_THREADS)
occlusion_wbvh_kernel(const float* __restrict__ wf, const int* __restrict__ wi,
                      const float* __restrict__ tri,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ min_t,
                      const uint8_t* __restrict__ occluded0,
                      uint8_t* __restrict__ occ_out, int n) {
  const WideTables tb = {wf, wi, nullptr, reinterpret_cast<const float4*>(tri)};
  any_hit_rays(tb, o, d, min_t, occluded0, occ_out, n);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().

extern "C" int pt_closest_hit_wbvh(const float* wf, const int* wi, const int* wp,
                                   const float* tri, const float* o, const float* d,
                                   const float* t_init, float* t_out, int* tri_out,
                                   float* u_out, float* v_out, int n, void* stream) {
  if (n > 0)
    closest_hit_wbvh_kernel<<<walk_grid(n), WALK_THREADS, 0, (cudaStream_t)stream>>>(
        wf, wi, wp, tri, o, d, t_init, t_out, tri_out, u_out, v_out, n);
  return (int)cudaGetLastError();
}

extern "C" int pt_occlusion_wbvh(const float* wf, const int* wi, const float* tri,
                                 const float* o, const float* d, const float* min_t,
                                 const uint8_t* occluded0, uint8_t* occ_out, int n,
                                 void* stream) {
  if (n > 0)
    occlusion_wbvh_kernel<<<walk_grid(n), WALK_THREADS, 0, (cudaStream_t)stream>>>(
        wf, wi, tri, o, d, min_t, occluded0, occ_out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
