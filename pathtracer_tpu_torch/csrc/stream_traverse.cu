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
//   subt (n_sub*Tmax*9,) f32 block triangle rows [v0, e1, e2] (stride 9; K5)
//   base (n_sub,)       i32  global id of block s's first triangle
//   rootf (n_sub*6,)    f32  K5 only: block s's root box, the top slot that
//                            links it (scene/flatscene.py stream_roots)
// and, derived from them once per scene for K3 and K4 (scene/flatscene.py
// stream_walk_tables):
//   subt12 (n_sub*Tmax*12,) f32  subt's rows padded to [v0, e1, e2, 0 0 0]: 48
//                            bytes, 3 loads of 16 bytes (a stride-9 row is
//                            never 16-byte aligned)
//   blocks (n_sub*4,)   i32  block s: [base[s], s*Tmax, lo, hi]; a block that
//                            wraps one leaf cut has its rows [lo, hi) of
//                            subt12, any other block lo = hi = -1
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
// versions in ops/traverse_stream_cuda.py walk K3's and K5's per-ray order;
// K4's result does not depend on the order (walk_core.cuh says why).

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk_core.cuh"

#define SUB_STACK 64  // K5: the wrapper checks 7*sub_depth+1 <= SUB_STACK
#define THREADS 128   // K5: rays per block

namespace {

struct Closest {
  float t, u, v;
  int tri;
};

__device__ __forceinline__ bool child_box(const float* __restrict__ nf, int slot,
                                          const Ray& r, float cap) {
  float t_enter;
  return slab(nf + slot * 6, r.ox, r.oy, r.oz, r.idx, r.idy, r.idz, &t_enter) &&
         t_enter <= cap;
}

// K5: block s's node rows (boxes, ints) and triangle rows.
struct Block {
  const float* f;
  const int* i;
  const float* t;
};

__device__ __forceinline__ Block block(const float* __restrict__ subf,
                                       const int* __restrict__ subi,
                                       const float* __restrict__ subt, int s, int S, int Tmax) {
  return {subf + (size_t)s * S * 48, subi + (size_t)s * S * 24, subt + (size_t)s * Tmax * 9};
}

// A block that wraps one leaf cut: its root has nothing in slot 1 (a real
// wide node has at least two children).
__device__ __forceinline__ bool wrapped_leaf(const int* __restrict__ root) {
  return root[1] < 0 && root[16 + 1] <= root[8 + 1];
}

// Closest hit over block triangles [start, end), ids rebased by gbase; in cut
// order, a hit wins only if strictly closer.
__device__ __forceinline__ void leaf_closest(const float* __restrict__ rows, int start,
                                             int end, int gbase, const Ray& r,
                                             Closest& best) {
  for (int k = start; k < end; ++k) {
    float tt, tu, tv;
    if (moller_trumbore(rows + 9 * k, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, &tt, &tu, &tv) &&
        tt < best.t) {
      best.t = tt;
      best.tri = gbase + k;
      best.u = tu;
      best.v = tv;
    }
  }
}

// One node of K5's block walk (the per-ray order of K3's walk, child after
// child):
// children far -> near in the ray's octant order (the nearest is pushed
// last), child nodes onto the block stack, leaf cuts tested at once.
__device__ __forceinline__ void block_node_closest(const Block& b, const int* __restrict__ bp,
                                                   int node, int oct, int gbase, const Ray& r,
                                                   Closest& best, int* bstack, int& bsp) {
  const int perm = bp[node * 8 + oct];
  const float* nf = b.f + node * 48;
  const int* ni = b.i + node * 24;
  for (int rank = 7; rank >= 0; --rank) {
    const int slot = (perm >> (3 * rank)) & 7;
    if (!child_box(nf, slot, r, best.t)) continue;
    const int link = ni[slot];
    if (link >= 0)
      bstack[bsp++] = link;
    else
      leaf_closest(b.t, ni[8 + slot], ni[16 + slot], gbase, r, best);
  }
}

// The stream tables as walk_core.cuh walks them, as one tree.  An entry is
// ~t for top node t (so negative) or the flat row s*S + m of block s's node m
// (which indexes subf/subi/subp as they lie), so one stack serves both
// levels and nothing is kept per block.  A top child is a top node, a block
// (entered at its root, row s*S) or a wrapped leaf cut (tested at once); a
// block child is a node of the same block or a leaf cut of its triangles.
struct StreamTables {
  const float* topf;
  const int* topl;
  const int* topp;  // K3 alone reads topp and subp; K4 passes none
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
// box under its current best t, and then walks it to its end as K3 does (a
// wrapped one-node block has its triangles tested at once).  The top tree's
// inner boxes are never tested, so every live ray pays n_sub root tests.
// The closest t equals K3's (the minimum does not depend on the visit
// order); on an exact-t tie the block of lower index wins, where K3's
// depth-first order may pick another.  Starts from t = t_init, tri = -1,
// u = v = 0; lanes with t_init < 0 never enter a block.
// What bounds it on this card: latency (dependent 4-byte loads, child after
// child, from L2 or device memory; warps that diverge over the blocks' nodes).  The TPU
// kernel's chunk of resident rays, DMA ring and per-packet root filter are
// not carried over: the tables stay in device memory, and the block-outer
// order is what gives the threads of a CTA the same block at about the same
// time.  A whole block (311,296 bytes at 512 nodes / 4,096 triangles) does
// not fit the 232,448 bytes of shared memory a CTA may use; only its node
// part (163,840 bytes) would, which is the design question for making K5
// fast.
__global__ void __launch_bounds__(THREADS)
closest_hit_blockmajor_kernel(const float* __restrict__ rootf, const float* __restrict__ subf,
                              const int* __restrict__ subi, const int* __restrict__ subp,
                              const float* __restrict__ subt, const int* __restrict__ base,
                              const float* __restrict__ o, const float* __restrict__ d,
                              const float* __restrict__ t_init,
                              float* __restrict__ t_out, int* __restrict__ tri_out,
                              float* __restrict__ u_out, float* __restrict__ v_out,
                              int n, int n_sub, int S, int Tmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(o, d, i);
  Closest best = {t_init[i], 0.0f, 0.0f, -1};
  if (best.t >= 0.0f) {
    const int oct = (r.dx > 0.0f ? 1 : 0) | (r.dy > 0.0f ? 2 : 0) | (r.dz > 0.0f ? 4 : 0);
    int bstack[SUB_STACK];
    for (int s = 0; s < n_sub; ++s) {
      if (!child_box(rootf, s, r, best.t)) continue;
      const Block b = block(subf, subi, subt, s, S, Tmax);
      const int gbase = base[s];
      if (wrapped_leaf(b.i)) {
        leaf_closest(b.t, b.i[8], b.i[16], gbase, r, best);
        continue;
      }
      const int* bp = subp + (size_t)s * S * 8;
      int bsp = 0;
      bstack[bsp++] = 0;
      while (bsp > 0) {
        const int node = bstack[--bsp];
        block_node_closest(b, bp, node, oct, gbase, r, best, bstack, bsp);
      }
    }
  }
  t_out[i] = best.t;
  tri_out[i] = best.tri;
  u_out[i] = best.u;
  v_out[i] = best.v;
}

inline dim3 grid_for(int n) { return dim3((unsigned)((n + THREADS - 1) / THREADS)); }

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

extern "C" int pt_closest_hit_blockmajor(const float* rootf, const float* subf,
                                         const int* subi, const int* subp, const float* subt,
                                         const int* base, const float* o, const float* d,
                                         const float* t_init, float* t_out, int* tri_out,
                                         float* u_out, float* v_out, int n, int n_sub, int S,
                                         int Tmax, void* stream) {
  if (n > 0)
    closest_hit_blockmajor_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        rootf, subf, subi, subp, subt, base, o, d, t_init, t_out, tri_out, u_out, v_out, n,
        n_sub, S, Tmax);
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
