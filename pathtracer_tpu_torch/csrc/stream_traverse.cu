// Two-level (streaming) wide-BVH traversal kernels for Hopper (sm_90a):
// closest hit (K3), shadow any-hit (K4) and block-major closest hit (K5),
// for meshes past the resident budget.  One thread per ray, as K1/K2
// (wbvh_traverse.cu).
//
// Tables (scene/flatscene.py build_stream_tables, identical to the JAX
// package's; accel/bvh.py partition_stream splits the wide tree):
//   topf (T*48,)        f32  top node child AABBs, as K1's wf
//   topl (T*8,)         i32  child link: >= 0 top node, -1 empty, -(2+s) block s
//   topp (T*8,)         i32  per-octant near->far child order, as K1's wp (K3)
//   subf (n_sub*S*48,)  f32  block s node m child AABBs at [(s*S + m)*48 ...]
//   subi (n_sub*S*24,)  i32  block node [local link x8 | start x8 | end x8];
//                            [start, end) indexes the block's triangles
//   subp (n_sub*S*8,)   i32  block node child order (K3, K5)
//   subt (n_sub*Tmax*9,) f32 block triangle rows [v0, e1, e2] (stride 9; the
//                            plain versions' rows, no kernel reads it)
//   base (n_sub,)       i32  global id of block s's first triangle
// and, derived from them once per scene (scene/flatscene.py
// stream_walk_tables, stream_cull_tables):
//   subt12 (n_sub*Tmax*12,) f32  subt's rows padded to [v0, e1, e2, 0 0 0]: 48
//                            bytes, 3 loads of 16 bytes (a stride-9 row is
//                            never 16-byte aligned); K3-K5
//   blocks (n_sub*4,)   i32  block s: [base[s], s*Tmax, lo, hi]; a block that
//                            wraps one leaf cut has its rows [lo, hi) of
//                            subt12, any other block lo = hi = -1; K3-K5
//   roots8 (n_sub*8,)   f32  K5: block s's root box (the top slot that links
//                            it) [bmin, bmax, 0, 0]
//   groups (n_grp*8,)   f32  K5: the union of G consecutive root boxes, as
//                            roots8
//
// The TPU kernels stream each block into on-chip memory through a DMA ring.
// Here the tables simply stay in device memory (22 MB for 160k triangles,
// inside the 50 MB L2), and a ray walks them in place: no ring, no packet
// queue, no block sort.
//
// K3 and K4 are the walks of walk_core.cuh (K1's closest-hit walk, K2's
// any-hit walk) over the two levels as one tree.  The top tree is the wide
// tree's upper part and each block is a relabelled subtree, so a depth-first
// walk that enters a block when it pops the block's entry, and walks the
// block to its end before it pops another top entry, visits the same boxes
// and triangles in the same order as K1 on the wide tables.
//
// A leaf cut that hangs off a top node is stored as a one-node block (slot 0
// the leaf, slot 1 empty).  K1 tests such a cut as soon as its box passes,
// and so do K3/K4 (chosen so that K3 returns K1's result lane for lane,
// exact-t ties included).
//
// Built with -fmad=false and without fast math, as K1/K2.  The plain PyTorch
// versions in ops/traverse_stream_cuda.py walk K3's and K5's per-ray order
// (K5's without the group cull, which changes no result); K4's result does
// not depend on the order (walk_core.cuh says why).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_core.cuh"

namespace {

// The stream tables as walk_core.cuh walks them, as one tree.  An entry is
// ~t for top node t (so negative) or the flat row s*S + m of block s's node m
// (which indexes subf/subi/subp as they lie), so one stack serves both
// levels and nothing is kept per block.  A top child is a top node, a block
// (entered at its root, row s*S) or a wrapped leaf cut (tested at once); a
// block child is a node of the same block or a leaf cut of its triangles.
struct StreamTables {
  const float* topf;
  const int* topl;
  const int* topp;  // K3 reads topp and subp, K5 subp alone (no top entry); K4 neither
  const float* subf;
  const int* subi;
  const int* subp;
  const float4* tri;    // subt12
  const int4* blocks;
  int S, Tmax;
  static constexpr int kRoot = ~0;
  struct Node {
    const float4* boxes;
    const int4* links;
    const int* perm;
  };
  __device__ __forceinline__ Node node(int e) const {
    const bool top = e < 0;
    const size_t row = top ? ~e : e;
    return {reinterpret_cast<const float4*>((top ? topf : subf) + row * 48),
            reinterpret_cast<const int4*>(top ? topl + row * 8 : subi + row * 24),
            (top ? topp : subp) + row * 8};
  }
  // A top node's inner children are top nodes; a block node's are nodes of
  // its block, whose root is row0.
  struct Level {
    bool top;
    int row0;
  };
  __device__ __forceinline__ Level level(int e) const {
    return {e < 0, (int)((unsigned)e / (unsigned)S) * S};
  }
  __device__ __forceinline__ int inner(Level lv, int link) const {
    return lv.top ? ~link : lv.row0 + link;
  }
  __device__ __forceinline__ bool child(int e, const Node& nd, int slot, int link, int& push,
                                        int& lo, int& hi) const {
    if (e < 0) {
      if (link >= 0) {
        push = ~link;
        return true;
      }
      lo = hi = 0;
      if (link == -1) return false;  // empty (its NaN box never passes)
      const int s = -(link + 2);
      const int4 b = __ldg(blocks + s);
      push = s * S;
      lo = b.z;
      hi = b.w;
      return b.z < 0;
    }
    const int s = (unsigned)e / (unsigned)S;
    if (link >= 0) {
      push = s * S + link;
      return true;
    }
    const int* ni = reinterpret_cast<const int*>(nd.links);
    lo = s * Tmax + __ldg(ni + 8 + slot);
    hi = s * Tmax + __ldg(ni + 16 + slot);
    return false;
  }
  // row s*Tmax + k of subt12 is triangle base[s] + k
  __device__ __forceinline__ int tri_id(int row) const {
    const int4 b = __ldg(blocks + (unsigned)row / (unsigned)Tmax);
    return b.x + (row - b.y);
  }
};

// K3: closest hit.  Replaces closest_hit_stream_pallas /
// _make_stream_closest_kernel / _sub_walk_closest
// (pathtracer_tpu/ops/traverse_pallas.py:871,633,549).  Starts from
// t = t_init, tri = -1, u = v = 0; lanes with t_init < 0 never enter.  The
// best triangle is kept as its row of subt12 and turned into its global id
// (base[s] + the row within block s) once, at the end.
// What bounds it on this card, and what the design does about it:
// walk_core.cuh.  Beyond K1's walk a pop pays the choice of the level's
// pointers, a block link its 16-byte row of `blocks`, and the tables are
// sparser (blocks padded to S nodes and Tmax triangles).
__global__ void __launch_bounds__(WALK_THREADS)
closest_hit_stream_kernel(const float* __restrict__ topf, const int* __restrict__ topl,
                          const int* __restrict__ topp, const float* __restrict__ subf,
                          const int* __restrict__ subi, const int* __restrict__ subp,
                          const float* __restrict__ subt12, const int* __restrict__ blocks,
                          const float* __restrict__ o, const float* __restrict__ d,
                          const float* __restrict__ t_init,
                          float* __restrict__ t_out, int* __restrict__ tri_out,
                          float* __restrict__ u_out, float* __restrict__ v_out,
                          int n, int S, int Tmax) {
  const StreamTables tb = {topf, topl, topp, subf, subi, subp,
                           reinterpret_cast<const float4*>(subt12),
                           reinterpret_cast<const int4*>(blocks), S, Tmax};
  closest_hit_rays(tb, o, d, t_init, t_out, tri_out, u_out, v_out, n);
}

// K4: shadow any-hit.  Replaces occlusion_stream_pallas /
// _make_stream_occlusion_kernel (pathtracer_tpu/ops/traverse_pallas.py:1448,
// 1221).  K2's semantics: boxes are tested against min_t, a lane stops at its
// first blocker (t < min_t - 1e-5 and |t - min_t| > 1e-4); occluded0 lanes
// stay blocked and lanes with min_t < 0 (the -FLT_MAX sentinel) never block.
// The any-hit walk of walk_core.cuh over the one tagged stack, without the
// child orders; a block link costs its 16-byte row of `blocks`, and a
// wrapped leaf cut is tested off its top node, before anything is pushed.
// What bounds it on this card: walk_core.cuh; beyond K2's walk it pays what
// K3 pays beyond K1's.
__global__ void __launch_bounds__(WALK_THREADS)
occlusion_stream_kernel(const float* __restrict__ topf, const int* __restrict__ topl,
                        const float* __restrict__ subf, const int* __restrict__ subi,
                        const float* __restrict__ subt12, const int* __restrict__ blocks,
                        const float* __restrict__ o, const float* __restrict__ d,
                        const float* __restrict__ min_t,
                        const uint8_t* __restrict__ occluded0,
                        uint8_t* __restrict__ occ_out, int n, int S, int Tmax) {
  const StreamTables tb = {topf, topl, nullptr, subf, subi, nullptr,
                           reinterpret_cast<const float4*>(subt12),
                           reinterpret_cast<const int4*>(blocks), S, Tmax};
  any_hit_rays(tb, o, d, min_t, occluded0, occ_out, n);
}

// K5: block-major closest hit.  Replaces closest_hit_blockmajor_pallas /
// _make_blockmajor_closest_kernel (pathtracer_tpu/ops/traverse_pallas.py:1120,
// 993).  K3's result with the loops swapped: an outer loop over the blocks
// in index order; a ray enters block s only if it passes the block's root
// box under its current best t, and then walks it to its end with K3's
// closest-hit walk (walk_core.cuh closest_walk from entry s*S: the same
// visits in the same order as K3 inside a block, so the plain version's
// block steps); a wrapped one-node block has its rows of subt12 tested at
// once.  The closest t equals K3's (the minimum does not depend on the
// visit order); on an exact-t tie the block of lower index wins, where K3's
// depth-first order may pick another.  Starts from t = t_init, tri = -1,
// u = v = 0; lanes with t_init < 0 never enter a block.
// The top tree's boxes are not tested.  In their place the blocks come in
// groups of G consecutive ones (one depth-first split, so near in space),
// and a ray that misses a group's union box under its best t skips the
// group's root tests (scene/flatscene.py stream_cull_tables says why that
// never skips a block the root test would pass).  Group and root boxes are
// rows of 8 floats, 2 loads of 16 bytes, which every lane of a warp reads at
// the same step: one broadcast.
// What bounds it on this card: what bounds K3's walk (walk_core.cuh), plus
// a root test per group and per block of a passing group, and the order:
// the lanes of a warp that enter different blocks walk them in turns (a CTA's
// lanes enter 21 blocks of 71, 36 of 470, on a bounce's continuation rays;
// about 1 on camera rays).  Measured and dropped (PERF.md): one loop that
// pops or tests a root each lap, so that such lanes pop together (as fast on
// continuation rays, 20% slower on camera rays).  Shared memory for a block's
// nodes was reckoned and not built: the staged bytes would be 2.4-12.8x the
// sectors the walks fetch (tools/blockmajor_reckoning.py).  The TPU kernel's
// chunk of resident rays, DMA ring and per-packet root filter are not
// carried over: the tables stay in device memory.
__device__ __forceinline__ bool box_row(const float4* __restrict__ row, const Ray& r, float cap) {
  const float4 lo = __ldg(row), hi = __ldg(row + 1);
  float t_enter;
  return slab(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r.ox, r.oy, r.oz, r.idx, r.idy, r.idz,
              &t_enter) &&
         t_enter <= cap;
}

__global__ void __launch_bounds__(WALK_THREADS)
closest_hit_blockmajor_kernel(const float* __restrict__ groups, const float* __restrict__ roots8,
                              const float* __restrict__ subf, const int* __restrict__ subi,
                              const int* __restrict__ subp, const float* __restrict__ subt12,
                              const int* __restrict__ blocks, const float* __restrict__ o,
                              const float* __restrict__ d, const float* __restrict__ t_init,
                              float* __restrict__ t_out, int* __restrict__ tri_out,
                              float* __restrict__ u_out, float* __restrict__ v_out, int n,
                              int n_sub, int G, int S, int Tmax) {
  const StreamTables tb = {nullptr, nullptr, nullptr, subf, subi, subp,
                           reinterpret_cast<const float4*>(subt12),
                           reinterpret_cast<const int4*>(blocks), S, Tmax};
  const float4* group_rows = reinterpret_cast<const float4*>(groups);
  const float4* root_rows = reinterpret_cast<const float4*>(roots8);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  WalkHit best = {t_init[i], 0.0f, 0.0f, -1};
  if (best.t >= 0.0f) {
    const Ray r = load_ray(o, d, i);
    const int oct = octant(r);
    int stack[WALK_STACK];
    for (int g = 0, s0 = 0; s0 < n_sub; ++g, s0 += G) {
      if (!box_row(group_rows + 2 * g, r, best.t)) continue;
      const int s1 = min(s0 + G, n_sub);
      for (int s = s0; s < s1; ++s) {
        if (!box_row(root_rows + 2 * s, r, best.t)) continue;
        const int4 b = __ldg(tb.blocks + s);
        if (b.z >= 0)
          closest_leaf(tb, r, b.z, b.w, best);
        else
          closest_walk(tb, r, oct, s * S, best, stack);
      }
    }
  }
  t_out[i] = best.t;
  tri_out[i] = best.row < 0 ? -1 : tb.tri_id(best.row);
  u_out[i] = best.u;
  v_out[i] = best.v;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().

extern "C" int pt_closest_hit_stream(const float* topf, const int* topl, const int* topp,
                                     const float* subf, const int* subi, const int* subp,
                                     const float* subt12, const int* blocks, const float* o,
                                     const float* d, const float* t_init, float* t_out,
                                     int* tri_out, float* u_out, float* v_out, int n, int S,
                                     int Tmax, void* stream) {
  if (n > 0)
    closest_hit_stream_kernel<<<walk_grid(n), WALK_THREADS, 0, (cudaStream_t)stream>>>(
        topf, topl, topp, subf, subi, subp, subt12, blocks, o, d, t_init, t_out, tri_out,
        u_out, v_out, n, S, Tmax);
  return (int)cudaGetLastError();
}

extern "C" int pt_closest_hit_blockmajor(const float* groups, const float* roots8,
                                         const float* subf, const int* subi, const int* subp,
                                         const float* subt12, const int* blocks, const float* o,
                                         const float* d, const float* t_init, float* t_out,
                                         int* tri_out, float* u_out, float* v_out, int n,
                                         int n_sub, int G, int S, int Tmax, void* stream) {
  if (n > 0)
    closest_hit_blockmajor_kernel<<<walk_grid(n), WALK_THREADS, 0, (cudaStream_t)stream>>>(
        groups, roots8, subf, subi, subp, subt12, blocks, o, d, t_init, t_out, tri_out, u_out,
        v_out, n, n_sub, G, S, Tmax);
  return (int)cudaGetLastError();
}

extern "C" int pt_occlusion_stream(const float* topf, const int* topl, const float* subf,
                                   const int* subi, const float* subt12, const int* blocks,
                                   const float* o, const float* d, const float* min_t,
                                   const uint8_t* occluded0, uint8_t* occ_out, int n, int S,
                                   int Tmax, void* stream) {
  if (n > 0)
    occlusion_stream_kernel<<<walk_grid(n), WALK_THREADS, 0, (cudaStream_t)stream>>>(
        topf, topl, subf, subi, subt12, blocks, o, d, min_t, occluded0, occ_out, n, S, Tmax);
  return (int)cudaGetLastError();
}
