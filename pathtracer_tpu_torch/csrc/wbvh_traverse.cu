// Wide (8-ary) BVH traversal kernels for Hopper (sm_90a): closest hit (K1)
// and shadow any-hit (K2).  One thread per ray, tables read straight from
// global memory (a resident mesh of ~10k triangles is well under 1 MB of
// tables, so they stay in L2).  K1 is the walk of walk_core.cuh over the
// tables below; K2 keeps a child-after-child walk with a stack in local
// memory.
//
// Tables (scene/flatscene.py build_wide_tables, identical to the JAX
// package's):
//   wf  (M*48,) f32  node m child c AABB at [m*48 + c*6 : +6] = bmin, bmax;
//                    NaN marks an empty slot.  A node's 8 boxes are 192
//                    consecutive bytes: 12 loads of 16 bytes
//   wi  (M*24,) i32  node m [link x8 | start x8 | end x8]; link >= 0 is an
//                    internal wide node, else [start, end) is a leaf cut
//   wp  (M*8,)  i32  per-octant near->far child order, 3 bits per rank
//   tri (T*12,) f32  EDGE-form rows [v0, e1 = v1 - v0, e2 = v2 - v0, pad]:
//                    48 bytes, 3 loads of 16 bytes
// K1 needs wf, wi and tri 16-byte aligned (the wrapper checks).
//
// Built with -fmad=false and without fast math, so every operation rounds
// like the plain PyTorch versions in ops/traverse_cuda.py, which walk the
// same per-ray order; kernel and plain version then agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_core.cuh"

#define STACK 64     // K2's traversal stack; the wrapper checks 7*wide_depth+1 <= STACK
#define THREADS 128  // K2's rays per block

namespace {

// The resident tables as walk_core.cuh walks them: an entry is a node id,
// a child is a node (link >= 0) or a leaf cut of `tri`.
struct WideTables {
  const float* wf;
  const int* wi;
  const int* wp;
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
// t < min_t - 1e-5 and |t - min_t| > 1e-4.  The box test caps at min_t (not
// at a running best), so the visited set does not depend on order: children
// go in slot order and the ray stops at its first blocker.  occluded0 lanes
// stay blocked; lanes with min_t < 0 (the -FLT_MAX sentinel) never block.
// What bounds it on this card: latency, as K1 before its redesign: every pop
// is a chain of dependent 4-byte loads, child after child (boxes, then links
// and triangle rows), and the rays of a warp walk different nodes.  Its box
// test is branch-free through traverse_common.cuh; the rest of K1's redesign
// (walk_core.cuh) is still to be carried over.
__global__ void __launch_bounds__(THREADS)
occlusion_wbvh_kernel(const float* __restrict__ wf, const int* __restrict__ wi,
                      const float* __restrict__ tri,
                      const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ min_t,
                      const uint8_t* __restrict__ occluded0,
                      uint8_t* __restrict__ occ_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = occluded0[i] != 0;
  const float mt = min_t[i];
  if (!occ && mt >= 0.0f) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float idx = 1.0f / dx, idy = 1.0f / dy, idz = 1.0f / dz;
    const float t_far = mt - 1e-5f;
    int stack[STACK];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0 && !occ) {
      const int node = stack[--sp];
      const float* nf = wf + node * 48;
      const int* ni = wi + node * 24;
      for (int slot = 0; slot < 8 && !occ; ++slot) {
        float t_enter;
        if (!slab(nf + slot * 6, ox, oy, oz, idx, idy, idz, &t_enter) || !(t_enter <= mt))
          continue;
        const int link = ni[slot];
        if (link >= 0) {
          stack[sp++] = link;
          continue;
        }
        const int end = ni[16 + slot];
        for (int k = ni[8 + slot]; k < end; ++k) {
          float tt, tu, tv;
          if (moller_trumbore(tri + 12 * k, ox, oy, oz, dx, dy, dz, &tt, &tu, &tv) &&
              t_far > tt && fabsf(tt - mt) > 1e-4f) {
            occ = true;
            break;
          }
        }
      }
    }
  }
  occ_out[i] = occ ? 1 : 0;
}

inline dim3 grid_for(int n) { return dim3((unsigned)((n + THREADS - 1) / THREADS)); }

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
    occlusion_wbvh_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        wf, wi, tri, o, d, min_t, occluded0, occ_out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
