// Timing probes for Hopper (sm_90a), counterparts of the JAX package's two
// TPU probes.  They compute nothing the renderer uses; each answers a
// question about where traversal time goes, and its wrapper and plain
// PyTorch version live in ops/probes.py.  Built with -fmad=false, as the
// traversal kernels, so the plain versions agree bit for bit.
//
// P1 replaces tools/rowprim_probe.py kernel/run: the primitives a
// per-row-stack walk needs, per lap: 8 rows of a (M, 128) table read at
// dynamic indices (lap * 8 + r * 37) % M, lane broadcasts of a row's columns
// c and 64 + c, a per-row any of (ray > lo && ray < hi) packed into bits,
// those bits read back as scalars, and a sum of the 8 rows; 2,000 laps in
// order on one CTA, so the tile lies on one SM as the TPU probe's lies on
// one core.
//
// P2 replaces tools/kernel_microbench.py make_kernel/run: one wide-node pop
// split into its costs, one kernel per variant, F pops in order per lane on
// 2,048 lanes (16 CTAs of 128, the TPU probe's 16x128 tile: one CTA an SM,
// one warp a scheduler).  The TPU's cross-lane jnp.any is a warp vote
// (__any_sync, over the 32 lanes of a warp); push_packed's one reduce of the
// packed slot bits is one warp OR (__reduce_or_sync; the TPU probe's max was
// a stand-in for it); the SMEM stack is a per-thread local array, as the
// walks keep theirs.  Every pop feeds the accumulator that is written out;
// unlike the TPU probe, "aabb" adds each box's result to it.
//
// What bounds them on one SM (chip_smoke.py probe_bound, PERF.md section 6):
// per lap, the largest of the function's operations on the SM over its 128
// FP32/INT lanes a clock, the bytes the lap brings to the SM over 128 bytes
// a clock, and the accumulator's dependent chain at 4 clocks an operation.
//   P1: 8 x 1,024 x 4 (2 comparisons, the and, the any) + 1,023 adds of the
//       row sum + 8 of the bits + 2 of the accumulator = 33,801 operations,
//       264 clocks; 8 rows of 512 bytes = 32 clocks; 2 adds = 8 clocks.
//   P2, 128 lanes on the SM, one clock an operation a lane: the box
//       variants 8 slab tests of 25 operations with their votes, links and
//       pushes (aabb 232 clocks, aabb_any 219, push_branchless 227,
//       push_packed 236), any1 28, loads 65, loads4 257, leaf_mt 496; a
//       node is 224 bytes (2 clocks); the loops' one dependent add (4).
// Operations bind all but P2's loops.  Their comparisons, min/max and logic
// issue at half the 128 lanes (a 16-lane pipe per scheduler), so about half
// of the bound is what a design can reach.  The design before this one
// reached 13% (P1) and 18-45% (P2's node variants): each lap waited on an L2
// round trip and three CTA barriers (P1), or on its own node's loads and box
// tests (P2), with nothing to hide the wait.  What the design does:
//
//   - P1: a warp per row (4 lanes a thread) and a ninth warp that sums.
//     The rows are copied by TMA (1-D bulk copies: each row warp's lane 0
//     copies its own row, 512 bytes a lap) into 2 stages of P1_GROUP laps,
//     a group ahead; mbarriers hand over every stage and every slot of row
//     results, one wait a group, and each wait traps after P1_WAIT_CYCLES
//     rather than hang.  No CTA barrier is left in the loop.  A thread reads
//     its 4 values and the row's 16 columns as 5 loads of 16 bytes; the
//     group's laps are one branch-free block the compiler interleaves; the
//     membership test takes differences on the FMA pipe and min/max where
//     comparisons would crowd the ALU pipe (any_inside).  The row sum is
//     (x0 + x1) + (x2 + x3) per thread, a shuffle tree over the warp, then a
//     tree over the 8 rows; rowprim_plain repeats that order.
//   - P2: each node is read as the walks read it, through walk_core.cuh's
//     fetch_node: 12 + 2 loads of 16 bytes, the eight slab tests unrolled and
//     branch-free (against no cap; a miss's entry distance becomes NaN, so
//     the cap comparison alone decides).  A node is loaded two pops ahead and
//     tested one pop ahead, so only the cap comparisons, the votes and the sp
//     and accumulator arithmetic wait on the accumulator.  The node variants
//     stage the tables in shared memory, 224 bytes a node copied in 16-byte
//     loads (5-20% faster a pop than reading them through the read-only
//     path, as the walks do); leaf_mt reads its triangle rows as the walks do
//     (load_tri_row) from L1, which the tables no longer crowd; the loop
//     variants are as before.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "walk_core.cuh"

#define FULL 0xffffffffu
#define P1_THREADS 288  // a warp per row of the (8, 128) tile, 4 lanes a thread, and one that sums
#define P1_SUM_WARP 8
#define P1_GROUP 4      // laps a stage holds and a slot of results (1: 1.2-1.5x slower; 2: within 10%)
#define P1_STAGES 2     // stages of P1_GROUP laps' rows in shared memory (32 KB)
#define P1_SLOTS 2      // slots of P1_GROUP laps' row results
#define P1_ROW_BYTES 512
#define P1_WAIT_CYCLES (1ll << 31)  // about a second: no copy takes that long
#define P2_THREADS 128  // lanes per CTA; 16 CTAs make the 16x128 tile

namespace {

// ---------------------------------------------------------------------------
// mbarrier and 1-D bulk copy (PTX, sm_90)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed; traps
// after P1_WAIT_CYCLES, so a wrong parity ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > P1_WAIT_CYCLES) __trap();
  }
}

// ---------------------------------------------------------------------------
// P1

__device__ __forceinline__ int wrap(int n, int M) {
  while (n >= M) n -= M;
  return n;
}

// lo < r < hi for one of the 4 values of r: 8 subtractions on the FMA pipe,
// 7 min/max and 1 comparison where 8 comparisons and 3 ors would crowd the
// slower ALU pipe (1.3x faster a lap).  Exact for all floats (no flush to zero): x - y > 0 iff x > y
// (a difference of 0 means x == y; an infinite one keeps its sign; NaN, from
// a NaN or from inf - inf, is no greater than 0 as x > y is false); the
// NaN-propagating min is false when either test is, and the max, which
// drops NaN, is true when one value is inside.
__device__ __forceinline__ bool any_inside(const float4& r, float lo, float hi) {
  const float a = nan_min(r.x - lo, hi - r.x), b = nan_min(r.y - lo, hi - r.y);
  const float c = nan_min(r.z - lo, hi - r.z), d = nan_min(r.w - lo, hi - r.w);
  return fmaxf(fmaxf(a, b), fmaxf(c, d)) > 0.0f;
}

// Warp r < 8 takes row r of every lap, P1_GROUP laps at a time: it waits
// for the group's stage, reads its rows, refills them with the group
// P1_STAGES ahead, votes and sums each lap, and leaves the group's row words
// and sums in a slot; warp 8 adds each lap's slot entries to the
// accumulator in lap order.  mbarriers order every hand-over, one wait a
// group: full[s] (8 arrivals, with their bytes) for a stage's rows, ready[k]
// (8 arrivals) and freed[k] (1) for a slot; no CTA barrier is left in the
// loop.  A group's laps are independent until the accumulator, so the
// compiler interleaves their loads, votes and shuffle trees.
__global__ void __launch_bounds__(P1_THREADS)
p1_rowprim_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
                  float* __restrict__ out, int M, int laps) {
  __shared__ __align__(128) float stage[P1_STAGES][P1_GROUP][8 * 128];
  __shared__ __align__(8) uint64_t full[P1_STAGES];
  __shared__ __align__(8) uint64_t ready[P1_SLOTS];
  __shared__ __align__(8) uint64_t freed[P1_SLOTS];
  __shared__ __align__(16) float row_sum[P1_SLOTS][P1_GROUP][8];
  __shared__ __align__(16) int row_bits[P1_SLOTS][P1_GROUP][8];
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int groups = (laps + P1_GROUP - 1) / P1_GROUP;
  if (t == 0) {
    for (int s = 0; s < P1_STAGES; ++s) mbar_init(&full[s], 8);
    for (int k = 0; k < P1_SLOTS; ++k) mbar_init(&ready[k], 8), mbar_init(&freed[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == P1_SUM_WARP) {
    // each lap's sum over the 8 rows (a tree: offsets 4, 2, 1) and its row
    // words read back as scalars
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) {
      const int k = g % P1_SLOTS, n = min(P1_GROUP, laps - g * P1_GROUP);
      mbar_wait(&ready[k], (g / P1_SLOTS) & 1);
      float w[P1_GROUP];
      int sb[P1_GROUP];
#pragma unroll
      for (int j = 0; j < P1_GROUP; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(&row_sum[k][j][0]);
        const float4 b = *reinterpret_cast<const float4*>(&row_sum[k][j][4]);
        const int4 p = *reinterpret_cast<const int4*>(&row_bits[k][j][0]);
        const int4 q = *reinterpret_cast<const int4*>(&row_bits[k][j][4]);
        w[j] = ((a.x + b.x) + (a.z + b.z)) + ((a.y + b.y) + (a.w + b.w));
        sb[j] = ((p.x + p.y) + (p.z + p.w)) + ((q.x + q.y) + (q.z + q.w));
      }
      __syncwarp();
      if (wl == 0) mbar_arrive(&freed[k]);
#pragma unroll
      for (int j = 0; j < P1_GROUP; ++j)
        if (j < n) acc = acc + w[j] + (float)sb[j];
    }
    if (wl == 0) out[0] = acc;
    return;
  }
  const int row = warp, step = 8 % M;
  // lanes 4 wl .. 4 wl + 3 of this warp's row
  const float4 ray = reinterpret_cast<const float4*>(rays)[t];
  // this warp's row of lap 0, (lap * 8 + row * 37) % M, then of each next
  // lap, in the order the copies are issued
  int next = row * 37 % M;
  // lane 0: the laps of group g into stage s, completing on full[s]
  auto issue = [&](int g, int s) {
    const int n = min(P1_GROUP, laps - g * P1_GROUP);
    mbar_expect_tx(&full[s], n * P1_ROW_BYTES);
    for (int j = 0; j < n; ++j) {
      bulk_copy(stage[s][j] + row * 128, tab + (size_t)next * 128, P1_ROW_BYTES, &full[s]);
      next = wrap(next + step, M);
    }
  };
  if (wl == 0)
    for (int g = 0; g < P1_STAGES && g < groups; ++g) issue(g, g);
  for (int g = 0; g < groups; ++g) {
    const int s = g % P1_STAGES;
    mbar_wait(&full[s], (g / P1_STAGES) & 1);
    __syncwarp();  // converged again after the wait: the votes need no divergence path
    // all P1_GROUP laps of the stage, in one branch-free block: a last group
    // of n < P1_GROUP laps also tests its stage's older rows, whose results
    // the summing warp leaves out
    float4 x[P1_GROUP], la[P1_GROUP], lb[P1_GROUP], ha[P1_GROUP], hb[P1_GROUP];
#pragma unroll
    for (int j = 0; j < P1_GROUP; ++j) {
      const float4* tile = reinterpret_cast<const float4*>(stage[s][j] + row * 128);
      x[j] = tile[wl], la[j] = tile[0], lb[j] = tile[1], ha[j] = tile[16], hb[j] = tile[17];
    }
    __syncwarp();  // the warp has read its rows of stage s: refill them
    if (wl == 0 && g + P1_STAGES < groups) issue(g + P1_STAGES, s);
    float v[P1_GROUP];
    unsigned bits[P1_GROUP];
#pragma unroll
    for (int j = 0; j < P1_GROUP; ++j) {
      const float lo[8] = {la[j].x, la[j].y, la[j].z, la[j].w, lb[j].x, lb[j].y, lb[j].z, lb[j].w};
      const float hi[8] = {ha[j].x, ha[j].y, ha[j].z, ha[j].w, hb[j].x, hb[j].y, hb[j].z, hb[j].w};
      // the row's any for each column: this thread's 4 lanes, then a vote
      bits[j] = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        bits[j] |= (__any_sync(FULL, any_inside(ray, lo[c], hi[c])) ? 1u : 0u) << c;
      v[j] = (x[j].x + x[j].y) + (x[j].z + x[j].w);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[j] += __shfl_down_sync(FULL, v[j], off);
    }
    if (wl == 0) {
      const int k = g % P1_SLOTS;
      mbar_wait(&freed[k], ((g / P1_SLOTS) & 1) ^ 1);  // the summing warp is done with group g - P1_SLOTS
#pragma unroll
      for (int j = 0; j < P1_GROUP; ++j) {
        row_sum[k][j][row] = v[j];
        row_bits[k][j][row] = (int)bits[j];
      }
      mbar_arrive(&ready[k]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// P2

enum P2Variant {
  LOOP_EMPTY, WHILE_EMPTY, LOOP_AND, LOOP_ONLY, LOADS, LOADS4, AABB, ANY1, AABB_ANY,
  PUSH_BRANCHLESS, PUSH_PACKED, LEAF_MT,
};

// The variants that read nodes, and stage the tables in shared memory
__host__ __device__ constexpr bool reads_nodes(int v) { return v >= LOADS && v <= PUSH_PACKED; }

// fetch_node's load for a node in shared memory or already in registers
struct PlainFetch {
  template <class T>
  __device__ __forceinline__ static T ld(const T* p) {
    return *p;
  }
};

// Node n of the staged tables, as walk_core.cuh's fetch_node takes it: its 8
// child boxes at wf[12 n] and its 8 links at wi[2 n] (int4 each).
struct P2Node {
  const float4* boxes;
  const int4* links;
};

struct P2Tables {
  const float4* wf;
  const int4* wi;
  __device__ __forceinline__ P2Node node(int n) const { return {wf + 12 * n, wi + 2 * n}; }
};

// A node's rows as fetch_node's 16-byte loads bring them (any1: child 0's
// box alone, the first 2 loads).
struct P2Raw {
  float4 box[12];
  int4 link[2];
};

template <int V>
__device__ __forceinline__ P2Raw p2_load(const P2Tables& tb, int n) {
  P2Raw raw;
  const P2Node nd = tb.node(n);
#pragma unroll
  for (int j = 0; j < (V == ANY1 ? 2 : 12); ++j) raw.box[j] = nd.boxes[j];
  if constexpr (V != ANY1) raw.link[0] = nd.links[0], raw.link[1] = nd.links[1];
  return raw;
}

// What a pop tests ahead of the accumulator: the entry distance of each
// child, NaN where the box misses (so that the cap comparison alone
// decides), and the links.
struct P2Pop {
  float te[8];
  int link[8];
};

template <int V>
__device__ __forceinline__ P2Pop p2_test(const P2Raw& raw, const Ray& r) {
  P2Pop p;
  unsigned hit;
  if constexpr (V == ANY1) {
    const float4 a = raw.box[0], b = raw.box[1];
    hit = slab(a.x, a.y, a.z, a.w, b.x, b.y, r.ox, r.oy, r.oz, r.idx, r.idy, r.idz, &p.te[0]) ? 1u
                                                                                               : 0u;
  } else {
    hit = fetch_node<PlainFetch>(P2Node{raw.box, raw.link}, r, INFINITY, p.te, p.link);
  }
#pragma unroll
  for (int c = 0; c < (V == ANY1 ? 1 : 8); ++c) p.te[c] = ((hit >> c) & 1u) ? p.te[c] : NAN;
  return p;
}

// The accumulator-dependent part of a pop: the cap comparison, the votes
// and the sp and accumulator arithmetic.  As make_kernel's body
// (tools/kernel_microbench.py:77-213), bit for bit: a box passes iff it is
// hit and entered within the accumulator.
template <int V>
__device__ __forceinline__ float p2_chain(float acc, const P2Pop& p, volatile int* stack) {
  if constexpr (V == ANY1) {
    return acc + (__any_sync(FULL, p.te[0] <= acc) ? 1.0f : 0.0f);
  } else if constexpr (V == AABB) {
    // each child against the accumulator as the child before left it; both
    // values of (link + active) * 1e-30 are ready before the comparison
    float acc2 = acc;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float f0 = (float)p.link[c] * (float)1e-30;
      const float f1 = (float)(p.link[c] + 1) * (float)1e-30;
      acc2 = acc2 + (p.te[c] <= acc2 ? f1 : f0);
    }
    return acc2;
  } else if constexpr (V == AABB_ANY) {
    int n_any = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) n_any += __any_sync(FULL, p.te[c] <= acc) ? 1 : 0;
    return acc + (float)n_any * (float)1e-30;
  } else {
    // PUSH_BRANCHLESS: one vote per child, after the 8 tests; PUSH_PACKED:
    // the 8 cap comparisons packed into bits, one OR of them
    unsigned any_bits = 0;
    if constexpr (V == PUSH_PACKED) {
#pragma unroll
      for (int c = 0; c < 8; ++c) any_bits |= (p.te[c] <= acc ? 1u : 0u) << c;
      any_bits = __reduce_or_sync(FULL, any_bits);
    }
    int sp = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const bool any_c =
          V == PUSH_PACKED ? ((any_bits >> c) & 1u) != 0u : __any_sync(FULL, p.te[c] <= acc);
      stack[sp] = p.link[c];  // unconditional store (sp <= c: the probe's min(sp, 63) is sp)
      sp += (any_c && p.link[c] >= 0) ? 1 : 0;
    }
    return acc + (float)sp * (float)1e-30;
  }
}

// s plus the 48 box floats and 8 links of a node, added in the order of
// make_kernel's loads: child by child, its 6 floats, then its link.
__device__ __forceinline__ float p2_node_sum(const P2Raw& raw, float s) {
  const float4* q = raw.box;
  const float b[48] = {q[0].x,  q[0].y,  q[0].z,  q[0].w,  q[1].x,  q[1].y,  q[1].z,  q[1].w,
                       q[2].x,  q[2].y,  q[2].z,  q[2].w,  q[3].x,  q[3].y,  q[3].z,  q[3].w,
                       q[4].x,  q[4].y,  q[4].z,  q[4].w,  q[5].x,  q[5].y,  q[5].z,  q[5].w,
                       q[6].x,  q[6].y,  q[6].z,  q[6].w,  q[7].x,  q[7].y,  q[7].z,  q[7].w,
                       q[8].x,  q[8].y,  q[8].z,  q[8].w,  q[9].x,  q[9].y,  q[9].z,  q[9].w,
                       q[10].x, q[10].y, q[10].z, q[10].w, q[11].x, q[11].y, q[11].z, q[11].w};
  const int link[8] = {raw.link[0].x, raw.link[0].y, raw.link[0].z, raw.link[0].w,
                       raw.link[1].x, raw.link[1].y, raw.link[1].z, raw.link[1].w};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s += b[6 * c + k];
    s += (float)link[c];
  }
  return s;
}

template <int V>
__device__ __forceinline__ void p2_run(const float* __restrict__ pool,
                                       const float* __restrict__ wf_g,
                                       const int* __restrict__ wi_g,
                                       const float* __restrict__ tr, float* __restrict__ out,
                                       int lanes, int M, int NT, int F, int leaf_k, float acc0) {
  P2Tables tb = {};
  if constexpr (reads_nodes(V)) {
    // each node's boxes and links, 224 bytes, copied in 16-byte loads (a
    // node's links are the first 2 of its 6 int4 in device memory)
    extern __shared__ float4 p2_smem[];
    float4* wf = p2_smem;
    int4* wi = reinterpret_cast<int4*>(p2_smem + M * 12);
    const float4* wf4 = reinterpret_cast<const float4*>(wf_g);
    const int4* wi4 = reinterpret_cast<const int4*>(wi_g);
    for (int k = threadIdx.x; k < M * 12; k += blockDim.x) wf[k] = __ldg(wf4 + k);
    for (int k = threadIdx.x; k < M * 2; k += blockDim.x) wi[k] = __ldg(wi4 + 6 * (k >> 1) + (k & 1));
    __syncthreads();
    tb = {wf, wi};
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  Ray r;
  r.ox = pool[lane], r.oy = pool[lanes + lane], r.oz = pool[2 * lanes + lane];
  r.dx = r.dy = r.dz = 0.0f;  // the probe's boxes are tested with o and 1 / max(o, 0.1)
  r.idx = 1.0f / fmaxf(r.ox, 0.1f), r.idy = 1.0f / fmaxf(r.oy, 0.1f);
  r.idz = 1.0f / fmaxf(r.oz, 0.1f);
  float out_r = 0.0f;
  volatile int stack[64];
  float acc = acc0;
  if constexpr (V == WHILE_EMPTY) {
    int k = 0;
    acc = 0.0f;
    while (k < F) {
      k += 1;
      acc += 1.0f;
    }
  } else if constexpr (V == LOOP_EMPTY || V == LOOP_AND || V == LOOP_ONLY) {
    for (int i = 0; i < F; ++i) {
      if constexpr (V == LOOP_EMPTY) acc = acc + 1.0f;
      if constexpr (V == LOOP_AND) acc = acc + (float)(i & 255);
      if constexpr (V == LOOP_ONLY) acc = acc + (float)(i % M);
    }
  } else if constexpr (V == LOADS || V == LOADS4) {
    // pop i sums node i % M (loads) or nodes (4 i + j) % M (loads4): the
    // nodes 0, 1, 2, ... in turn, each loaded a node ahead of its sum
    P2Raw cur = p2_load<V>(tb, 0);
    int n = 0;
    for (int i = 0; i < F; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < (V == LOADS4 ? 4 : 1); ++j) {
        n = wrap(n + 1, M);
        const P2Raw nxt = p2_load<V>(tb, n);
        s = p2_node_sum(cur, s);
        cur = nxt;
      }
      acc = acc + s;
    }
  } else if constexpr (V == LEAF_MT) {
    const float4* tri = reinterpret_cast<const float4*>(tr);
    for (int i = 0; i < F; ++i) {
      const int node = i % M;
      for (int k = 0; k < leaf_k; ++k) {
        float4 a, b, c;
        load_tri_row(tri, min(node * 8 + k, NT - 1), a, b, c);
        // vertex rows [v0, v1, v2 | 3 unused]; the ray is (o, o), as the probe's
        const float row[9] = {a.x, a.y, a.z, a.w - a.x, b.x - a.y, b.y - a.z,
                              b.z - a.x, b.w - a.y, c.x - a.z};
        float tt, tu, tv;
        const bool th = moller_trumbore(row, r.ox, r.oy, r.oz, r.ox, r.oy, r.oz, &tt, &tu, &tv);
        if (th && tt < acc) out_r = tt;
      }
    }
  } else {
    // the box variants: pop i's node is i % M, loaded two pops ahead and
    // tested one pop ahead of the accumulator
    P2Pop cur = p2_test<V>(p2_load<V>(tb, 0), r);
    int n = wrap(1, M);
    P2Raw ahead = p2_load<V>(tb, n);
#pragma unroll 2
    for (int i = 0; i < F; ++i) {
      n = wrap(n + 1, M);
      const P2Raw far = p2_load<V>(tb, n);
      const P2Pop nxt = p2_test<V>(ahead, r);
      acc = p2_chain<V>(acc, cur, stack);
      cur = nxt;
      ahead = far;
    }
  }
  // never true (the wrapper passes leaf_k >= 0); a read the compiler cannot
  // rule out, so that the push variants' stack stores stay
  if constexpr (V == PUSH_BRANCHLESS || V == PUSH_PACKED)
    if (leaf_k < 0) out_r = (float)stack[-leaf_k & 63];
  out[lane] = out_r + acc;
}

#define P2_KERNEL(name, V)                                                                 \
  __global__ void __launch_bounds__(P2_THREADS) p2_##name##_kernel(                       \
      const float* pool, const float* wf, const int* wi, const float* tr, float* out,     \
      int lanes, int M, int NT, int F, int leaf_k, float acc0) {                          \
    p2_run<V>(pool, wf, wi, tr, out, lanes, M, NT, F, leaf_k, acc0);                      \
  }

P2_KERNEL(loop_empty, LOOP_EMPTY)
P2_KERNEL(while_empty, WHILE_EMPTY)
P2_KERNEL(loop_and, LOOP_AND)
P2_KERNEL(loop_only, LOOP_ONLY)
P2_KERNEL(loads, LOADS)
P2_KERNEL(loads4, LOADS4)
P2_KERNEL(aabb, AABB)
P2_KERNEL(any1, ANY1)
P2_KERNEL(aabb_any, AABB_ANY)
P2_KERNEL(push_branchless, PUSH_BRANCHLESS)
P2_KERNEL(push_packed, PUSH_PACKED)
P2_KERNEL(leaf_mt, LEAF_MT)

typedef void (*P2Fn)(const float*, const float*, const int*, const float*, float*, int, int,
                     int, int, int, float);

// in the order of P2Variant and of ops/probes.py P2_VARIANTS
const P2Fn P2_KERNELS[] = {
    p2_loop_empty_kernel, p2_while_empty_kernel, p2_loop_and_kernel, p2_loop_only_kernel,
    p2_loads_kernel, p2_loads4_kernel, p2_aabb_kernel, p2_any1_kernel, p2_aabb_any_kernel,
    p2_push_branchless_kernel, p2_push_packed_kernel, p2_leaf_mt_kernel,
};

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().

// tab (M, 128) and rays (8, 128), both 16-byte aligned.
extern "C" int pt_probe_rowprim(const float* tab, const float* rays, float* out, int M,
                                int laps, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  p1_rowprim_kernel<<<1, P1_THREADS, 0, (cudaStream_t)stream>>>(tab, rays, out, M, laps);
  return (int)cudaGetLastError();
}

// `lanes` threads (a multiple of 128), tables of M nodes and NT triangle rows,
// wf, wi and tr 16-byte aligned.
extern "C" int pt_probe_pop(int variant, const float* pool, const float* wf, const int* wi,
                            const float* tr, float* out, int lanes, int M, int NT, int F,
                            int leaf_k, float acc0, void* stream) {
  if (variant < 0 || variant >= (int)(sizeof(P2_KERNELS) / sizeof(P2_KERNELS[0])) ||
      lanes % P2_THREADS != 0 || M < 1 || leaf_k < 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)P2_KERNELS[variant];
  const int smem = reads_nodes(variant) ? M * (48 + 8) * 4 : 0;
  cudaError_t err = cudaSuccess;
  if (smem)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&pool, &wf, &wi, &tr, &out, &lanes, &M, &NT, &F, &leaf_k, &acc0};
  err = cudaLaunchKernel(fn, dim3(lanes / P2_THREADS), dim3(P2_THREADS), args, smem,
                         (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
