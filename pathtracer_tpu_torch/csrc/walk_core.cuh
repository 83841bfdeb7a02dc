// The closest-hit walk shared by K1 (wbvh_traverse.cu, the resident wide
// BVH) and K3 (stream_traverse.cu, the two-level stream tables): one thread
// per ray, one stack of node entries, and a table type that says where an
// entry's rows lie and what a child link means.
//
// What bounds the walk on this card: neither bytes nor operations (it runs at
// about 3% of its roofline bound).  The rays of a warp sit on different nodes,
// so every load is a transaction of its own per lane (scattered 32-byte
// sectors from L2), a pop cannot start before the one before it ended, and a
// branch that only some lanes take is run for all of them.  The design keeps
// branches out of the box tests and spends loads and round trips sparingly:
//
//   - a node is fetched in 16-byte loads through the read-only path, all
//     started before anything depends on them: 12 for its 8 child boxes (48
//     consecutive floats), 2 for its 8 links, 1 word for the ray's child
//     order.  One round trip to L2 per pop, where a child-after-child loop
//     takes eight;
//   - the 8 slab tests run unrolled and branch-free (traverse_common.cuh) into
//     a pass mask and 8 entry distances, before any branch;
//   - only passing children are visited, far to near in the ray's octant
//     order.  A child is taken only if its entry distance is within the best
//     t at the moment of the visit, so the decisions and the order are those
//     of the plain versions (ops/traverse_cuda.py closest_hit_wbvh_plain,
//     ops/traverse_stream_cuda.py closest_hit_stream_plain) and the results
//     equal theirs bit for bit.  The pass mask is filtered with the best t at
//     the pop first: the best t only shrinks, so a child beyond it then is
//     beyond it at its visit too;
//   - leaf ranges are read only for passing leaf children, and a triangle row
//     (12 floats, 48 bytes) in 3 loads of 16 bytes;
//   - the stack is 64 entries of local memory, every push and pop through it.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) and dropped, each within the
// spread or slower (PERF.md has the numbers): the entry pushed last kept in a
// register, the stack in shared memory, the next triangle row fetched while
// this one is tested, 32/64/256 threads a CTA, a register cap for more
// resident CTAs, and threads that pull ray after ray from a shared counter.

#pragma once

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

// The 8 slab tests of a node whose child boxes are the 48 floats at `nf`
// (16-byte aligned): bit c of the result says that child c's box is hit and
// entered within `cap`; te[c] is its entry distance.
__device__ __forceinline__ unsigned slab8(const float4* __restrict__ nf, const Ray& r,
                                          float cap, float (&te)[8]) {
  float b[48];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float4 q = __ldg(nf + j);
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

// One pop: tests the 8 children of entry `e`, runs the passing leaf cuts and
// pushes the passing nodes, far to near.  Tables gives:
//   kRoot                         the first entry
//   node(e) -> Node               where entry e's rows lie: boxes (12 float4),
//                                 links (2 int4), perm (8 words, one per octant)
//   child(e, nd, slot, link, push, lo, hi) -> bool
//                                 true: the child is a node, `push` its entry;
//                                 false: it is a leaf cut, rows [lo, hi) of tri
//   tri                           triangle rows, 3 float4 each: v0, e1, e2, pad
//   tri_id(row) -> int            the id of the triangle in row `row`
template <class Tables>
__device__ __forceinline__ void visit_node(const Tables& tb, const Ray& r, int oct, int e,
                                           WalkHit& best, int* stack, int& sp) {
  const typename Tables::Node nd = tb.node(e);
  const int perm = __ldg(nd.perm + oct);
  const int4 la = __ldg(nd.links), lb = __ldg(nd.links + 1);
  float te[8];
  const unsigned pass = slab8(nd.boxes, r, best.t, te);
  const int link[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
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
    for (int k = lo; k < hi; ++k) {
      const float4* row = tb.tri + 3 * (size_t)k;
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
      float tt, tu, tv;
      if (moller_trumbore(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r.ox, r.oy, r.oz,
                          r.dx, r.dy, r.dz, &tt, &tu, &tv) &&
          tt < best.t) {
        best.t = tt;
        best.row = k;
        best.u = tu;
        best.v = tv;
      }
    }
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
    int sp = 0;
    int e = Tables::kRoot;
    while (true) {
      visit_node(tb, r, oct, e, best, stack, sp);
      if (sp == 0) break;
      e = stack[--sp];
    }
  }
  t_out[i] = best.t;
  tri_out[i] = best.row < 0 ? -1 : tb.tri_id(best.row);
  u_out[i] = best.u;
  v_out[i] = best.v;
}

inline dim3 walk_grid(int n) { return dim3((unsigned)((n + WALK_THREADS - 1) / WALK_THREADS)); }

}  // namespace
