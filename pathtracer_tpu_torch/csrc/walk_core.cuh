// The two walks shared by the traversal kernels: the closest-hit walk of K1
// (wbvh_traverse.cu, the resident wide BVH), K3 (stream_traverse.cu, the
// two-level stream tables) and, one block at a time, K5 (the same tables,
// blocks outer), and the shadow any-hit walk of K2 and K4 over the first two
// table types.  One thread per ray, one stack of node entries, and
// a table type that says where an entry's rows lie and what a child link
// means.
//
// What bounds a walk on this card: neither bytes nor operations (it runs at
// about 3% of its roofline bound).  The rays of a warp sit on different nodes,
// so every load is a transaction of its own per lane (scattered 32-byte
// sectors from L2), a pop cannot start before the one before it ended, and a
// branch that only some lanes take is run for all of them.  The design keeps
// branches out of the box tests and spends loads and round trips sparingly:
//
//   - a node is fetched in 16-byte loads through the read-only path, all
//     started before anything depends on them: 12 for its 8 child boxes (48
//     consecutive floats), 2 for its 8 links (fetch_node), and for the
//     closest-hit walk 1 word for the ray's child order.  One round trip to
//     L2 per pop, where a child-after-child loop takes eight;
//   - the 8 slab tests run unrolled and branch-free (traverse_common.cuh) into
//     a pass mask and 8 entry distances, before any branch;
//   - leaf ranges are read only for passing leaf children, and a triangle row
//     (12 floats, 48 bytes) in 3 loads of 16 bytes;
//   - the stack is 64 entries of local memory, every push and pop through it.
//
// The closest-hit walk visits only passing children, far to near in the
// ray's octant order.  A child is taken only if its entry distance is within
// the best t at the moment of the visit, so the decisions and the order are
// those of the plain versions (ops/traverse_cuda.py closest_hit_wbvh_plain,
// ops/traverse_stream_cuda.py closest_hit_stream_plain) and the results
// equal theirs bit for bit.  The pass mask is filtered with the best t at
// the pop first: the best t only shrinks, so a child beyond it then is
// beyond it at its visit too.
//
// The any-hit walk is freer.  Its box test caps at min_t, which is constant
// for a ray, so the set of boxes a ray reaches does not depend on the order
// of the visits, and the result is an OR over the triangles of that set.
// Hence the pass mask of a pop is final: no entry distance is looked at
// again, none is kept, and the child-order word is never loaded.  Any order
// that covers the passing children, left at any blocker, gives the bool of
// the plain versions (occlusion_wbvh_plain, occlusion_stream_plain: slot
// order, child after child) on every lane, although the two visit in
// different orders.  The walk uses that: within a pop the passing leaf cuts
// are tested first and the walk is left at the first blocker, before the
// passing inner children are pushed, so a ray that is going to be blocked
// stops before it grows its stack.  What bounds it is what bounds the
// closest-hit walk; a blocked ray's early exit leaves its lane idle until
// the warp's longest walk ends.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) and dropped, each within the
// spread or slower (PERF.md has the numbers).  Closest hit: the entry pushed
// last kept in a register, the stack in shared memory, the next triangle row
// fetched while this one is tested, 32/64/256 threads a CTA, a register cap
// for more resident CTAs, and threads that pull ray after ray from a shared
// counter.  Any hit: the passing children in slot order as they come (leaf
// cut or node), near first in the ray's octant order (needs the child-order
// word; up to 1.6x slower), the pushes in a loop over the mask, 64 threads a
// CTA, and threads that pull ray after ray from a counter of the grid (10-20%
// faster on shadow rays of which most lanes are dead, 4-18% slower where all
// lanes walk, 0-7% over an iteration's launches, for one more launch a call)
// or of their CTA's chunk of rays (1.3-4x slower).

#pragma once

#include <stdint.h>

#include "traverse_common.cuh"

#ifndef WALK_THREADS
#define WALK_THREADS 128  // rays per CTA (measured: 32, 64 and 256 within the spread of 128)
#endif
#define WALK_STACK 64     // entries; the wrappers check the walk's depth against it

namespace {

// The best hit so far; `row` indexes the triangle table the walk reads
// (Tables::tri_id turns it into the triangle's id at the end).
struct WalkHit {
  float t, u, v;
  int row;
};

template <class T>
__device__ __forceinline__ T pick8(const T (&a)[8], int s) {
  const T p0 = (s & 1) ? a[1] : a[0];
  const T p1 = (s & 1) ? a[3] : a[2];
  const T p2 = (s & 1) ? a[5] : a[4];
  const T p3 = (s & 1) ? a[7] : a[6];
  const T q0 = (s & 2) ? p1 : p0;
  const T q1 = (s & 2) ? p3 : p2;
  return (s & 4) ? q1 : q0;
}

// How a walk reads its node rows: 16 bytes at a time through the read-only
// data path.  The probe P2 (probes.cu) pops through fetch_node with a Fetch
// of its own, for nodes staged in shared memory or already in registers.
struct LdgFetch {
  template <class T>
  __device__ __forceinline__ static T ld(const T* __restrict__ p) {
    return __ldg(p);
  }
};

// The 8 slab tests of a node whose child boxes are the 48 floats at `nf`
// (16-byte aligned): bit c of the result says that child c's box is hit and
// entered within `cap`; te[c] is its entry distance.
template <class Fetch = LdgFetch>
__device__ __forceinline__ unsigned slab8(const float4* __restrict__ nf, const Ray& r,
                                          float cap, float (&te)[8]) {
  float b[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 q = Fetch::ld(nf + j);
    b[4 * j] = q.x, b[4 * j + 1] = q.y, b[4 * j + 2] = q.z, b[4 * j + 3] = q.w;
  }
  unsigned pass = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool hit = slab(b[6 * c], b[6 * c + 1], b[6 * c + 2], b[6 * c + 3], b[6 * c + 4],
                          b[6 * c + 5], r.ox, r.oy, r.oz, r.idx, r.idy, r.idz, &te[c]);
    pass |= (hit && te[c] <= cap) ? (1u << c) : 0u;
  }
  return pass;
}

// What a walk asks of its Tables:
//   kRoot                         the first entry
//   node(e) -> Node               where entry e's rows lie: boxes (12 float4),
//                                 links (2 int4), perm (8 words, one per octant;
//                                 the closest-hit walk alone reads it)
//   child(e, nd, slot, link, push, lo, hi) -> bool
//                                 true: the child is a node, `push` its entry;
//                                 false: it is a leaf cut, rows [lo, hi) of tri
//   level(e) -> Level             what entry e's inner children share
//   inner(level, link) -> int     the entry of a child whose link is >= 0
//   tri                           triangle rows, 3 float4 each: v0, e1, e2, pad
//   tri_id(row) -> int            the id of the triangle in row `row`

// The fetch of one pop, shared by both walks: the node's 8 links and 8 child
// boxes in 14 loads of 16 bytes, then the 8 slab tests against `cap`.
template <class Fetch = LdgFetch, class Node>
__device__ __forceinline__ unsigned fetch_node(const Node& nd, const Ray& r, float cap,
                                               float (&te)[8], int (&link)[8]) {
  const int4 la = Fetch::ld(nd.links), lb = Fetch::ld(nd.links + 1);
  const unsigned pass = slab8<Fetch>(nd.boxes, r, cap, te);
  link[0] = la.x, link[1] = la.y, link[2] = la.z, link[3] = la.w;
  link[4] = lb.x, link[5] = lb.y, link[6] = lb.z, link[7] = lb.w;
  return pass;
}

__device__ __forceinline__ void load_tri_row(const float4* __restrict__ tri, int k, float4& a,
                                             float4& b, float4& c) {
  const float4* row = tri + 3 * (size_t)k;
  a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
}

// Triangle rows [lo, hi) of a leaf cut against the best hit, in cut order: a
// hit wins only if strictly closer.
template <class Tables>
__device__ __forceinline__ void closest_leaf(const Tables& tb, const Ray& r, int lo, int hi,
                                             WalkHit& best) {
  for (int k = lo; k < hi; ++k) {
    float4 a, b, c;
    load_tri_row(tb.tri, k, a, b, c);
    float tt, tu, tv;
    if (moller_trumbore(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r.ox, r.oy, r.oz, r.dx,
                        r.dy, r.dz, &tt, &tu, &tv) &&
        tt < best.t) {
      best.t = tt;
      best.row = k;
      best.u = tu;
      best.v = tv;
    }
  }
}

// One pop of the closest-hit walk: tests the 8 children of entry `e`, runs
// the passing leaf cuts and pushes the passing nodes, far to near.
template <class Tables>
__device__ __forceinline__ void visit_node(const Tables& tb, const Ray& r, int oct, int e,
                                           WalkHit& best, int* stack, int& sp) {
  const typename Tables::Node nd = tb.node(e);
  const int perm = __ldg(nd.perm + oct);
  float te[8];
  int link[8];
  const unsigned pass = fetch_node(nd, r, best.t, te, link);
  // the passing children by rank in the ray's order (rank 0 the nearest)
  unsigned todo = 0;
#pragma unroll
  for (int rank = 0; rank < 8; ++rank)
    todo |= ((pass >> ((perm >> (3 * rank)) & 7)) & 1u) << rank;
  while (todo) {
    const int rank = 31 - __clz(todo);  // far -> near: the nearest is pushed last
    todo ^= 1u << rank;
    const int slot = (perm >> (3 * rank)) & 7;
    if (!(pick8(te, slot) <= best.t)) continue;
    int push, lo, hi;
    if (tb.child(e, nd, slot, pick8(link, slot), push, lo, hi)) {
      stack[sp++] = push;
      continue;
    }
    closest_leaf(tb, r, lo, hi, best);
  }
}

// The closest-hit walk from entry `e` until the stack is empty again.
template <class Tables>
__device__ __forceinline__ void closest_walk(const Tables& tb, const Ray& r, int oct, int e,
                                             WalkHit& best, int* stack) {
  int sp = 0;
  while (true) {
    visit_node(tb, r, oct, e, best, stack, sp);
    if (sp == 0) break;
    e = stack[--sp];
  }
}

// The body of a closest-hit kernel over `tb`, one thread per ray: from
// t = t_init (lanes with t_init < 0 never enter), tri = -1, u = v = 0.
template <class Tables>
__device__ __forceinline__ void closest_hit_rays(
    const Tables& tb, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_init, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  WalkHit best = {t_init[i], 0.0f, 0.0f, -1};
  if (best.t >= 0.0f) {
    const Ray r = load_ray(o, d, i);
    const int oct = octant(r);
    int stack[WALK_STACK];
    closest_walk(tb, r, oct, Tables::kRoot, best, stack);
  }
  t_out[i] = best.t;
  tri_out[i] = best.row < 0 ? -1 : tb.tri_id(best.row);
  u_out[i] = best.u;
  v_out[i] = best.v;
}

// One pop of the any-hit walk; true as soon as a triangle blocks the ray.
// The blocking window is the plain versions', written out: a hit at tt blocks
// iff tt < min_t - 1e-5 and |tt - min_t| > 1e-4.  Children whose link is not
// negative are inner nodes; the others (leaf cuts, and in the stream tables'
// top level the links to blocks) go first, in slot order: a leaf cut is
// tested at once, a block's root is pushed.  The inner nodes are pushed after
// them, by 8 predicated stores.
template <class Tables>
__device__ __forceinline__ bool any_hit_node(const Tables& tb, const Ray& r, float mt,
                                             float t_far, int e, int* stack, int& sp) {
  const typename Tables::Node nd = tb.node(e);
  float te[8];
  int link[8];
  const unsigned pass = fetch_node(nd, r, mt, te, link);
  unsigned inner = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) inner |= (link[c] >= 0 ? 1u : 0u) << c;
  unsigned todo = pass & ~inner;
  while (todo) {
    const int slot = __ffs(todo) - 1;
    todo &= todo - 1;
    int push, lo, hi;
    if (tb.child(e, nd, slot, pick8(link, slot), push, lo, hi)) {
      stack[sp++] = push;
      continue;
    }
    for (int k = lo; k < hi; ++k) {
      float4 a, b, c;
      load_tri_row(tb.tri, k, a, b, c);
      float tt, tu, tv;
      if (moller_trumbore(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r.ox, r.oy, r.oz,
                          r.dx, r.dy, r.dz, &tt, &tu, &tv) &&
          t_far > tt && fabsf(tt - mt) > 1e-4f)
        return true;
    }
  }
  const unsigned nodes = pass & inner;
  const typename Tables::Level lv = tb.level(e);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if ((nodes >> c) & 1u) stack[sp++] = tb.inner(lv, link[c]);
  }
  return false;
}

// The body of a shadow any-hit kernel over `tb`, one thread per ray:
// occluded0 lanes stay blocked, lanes with min_t < 0 (the -FLT_MAX sentinel)
// never enter, a ray leaves the walk at its first blocker.
template <class Tables>
__device__ __forceinline__ void any_hit_rays(
    const Tables& tb, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ min_t, const uint8_t* __restrict__ occluded0,
    uint8_t* __restrict__ occ_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool occ = occluded0[i] != 0;
  const float mt = min_t[i];
  if (!occ && mt >= 0.0f) {
    const Ray r = load_ray(o, d, i);
    const float t_far = mt - 1e-5f;
    int stack[WALK_STACK];
    int sp = 0;
    int e = Tables::kRoot;
    while (true) {
      if (any_hit_node(tb, r, mt, t_far, e, stack, sp)) {
        occ = true;
        break;
      }
      if (sp == 0) break;
      e = stack[--sp];
    }
  }
  occ_out[i] = occ ? 1 : 0;
}

inline dim3 walk_grid(int n) { return dim3((unsigned)((n + WALK_THREADS - 1) / WALK_THREADS)); }

}  // namespace
