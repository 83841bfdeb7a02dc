// Timing probes for Hopper (sm_90a), counterparts of the JAX package's two
// TPU probes.  They compute nothing the renderer uses; each answers a
// question about where traversal time goes, and its wrapper and plain
// PyTorch version live in ops/probes.py.
//
// P1 (tools/rowprim_probe.py kernel/run): the primitives a per-row-stack
// walk needs, per lap: 8 rows read at dynamic indices, lane broadcasts of a
// row's values, a per-row any packed into bits, those bits read back as
// scalars, and a sum of the 8 rows.  One CTA of 1,024 threads: row r of the
// (8, 128) tile is threads 128r .. 128r+127, four warps.  The 512 KB table
// stays in device memory (past shared memory, unlike the TPU's VMEM); the
// broadcasts go through shared memory; the per-row any is one __any_sync
// per warp, combined over the row's four warps in shared memory (the
// "bounce buffer"), whose eight words thread 0 reads back; the sum is a CTA
// reduction (a shuffle tree per warp, then one over the 32 warp sums, in an
// order the plain version repeats).
//
// P2 (tools/kernel_microbench.py make_kernel/run): one wide-node pop split
// into its costs, one kernel per variant.  2,048 threads (16 CTAs of 128)
// stand for the TPU's 16x128 tile, one lane each.  The node tables are
// copied into dynamic shared memory, as the TPU kernel copies them into
// SMEM; the triangle rows stay in device memory.  The TPU's cross-lane
// jnp.any becomes a warp vote (__any_sync, over the 32 lanes of a warp
// rather than the whole tile); push_packed's one reduce of the packed slot
// bits becomes one warp OR (__reduce_or_sync: a ballot carries one bit per
// lane, not eight, and the TPU probe's max was a stand-in for this OR); the
// SMEM stack becomes a per-thread local array, as K1-K4 keep theirs, made
// volatile so its stores, never read, are not deleted.  Every pop feeds the
// accumulator that is written out, so no loop is dropped: unlike the TPU
// probe, "aabb" adds each box's result to it.
//
// What bounds them on this card: latency of the dependent chain a lap is
// (shared-memory or device-memory loads, then compares, then a vote), not
// bytes or operations; the probes exist to measure that chain.  Built with
// -fmad=false, as the traversal kernels, so the plain versions agree bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

#define FULL 0xffffffffu
#define P1_THREADS 1024  // 8 rows x 128 lanes
#define P2_THREADS 128   // lanes per CTA; 16 CTAs make the 16x128 tile

namespace {

// ---------------------------------------------------------------------------
// P1

__global__ void __launch_bounds__(P1_THREADS)
p1_rowprim_kernel(const float* __restrict__ tab, const float* __restrict__ rays,
                  float* __restrict__ out, int M, int laps) {
  __shared__ float tab8[P1_THREADS];
  __shared__ unsigned warp_bits[P1_THREADS / 32];
  __shared__ float warp_sum[P1_THREADS / 32];
  __shared__ unsigned bounce[8];
  const int t = threadIdx.x, row = t >> 7, lane = t & 127, warp = t >> 5, wl = t & 31;
  const float ray = rays[t];
  float acc = 0.0f;
  for (int i = 0; i < laps; ++i) {
    // 8 rows at dynamic indices, one element per thread
    const float x = tab[(size_t)((i * 8 + row * 37) % M) * 128 + lane];
    tab8[t] = x;
    __syncthreads();
    // broadcasts of the row's columns c and 64+c; a vote per warp
    unsigned bits = 0;
    for (int c = 0; c < 8; ++c) {
      const float lo = tab8[row * 128 + c], hi = tab8[row * 128 + 64 + c];
      bits |= (__any_sync(FULL, ray > lo && ray < hi) ? 1u : 0u) << c;
    }
    if (wl == 0) warp_bits[warp] = bits;
    float v = x;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    if (wl == 0) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      // the row's four warps combined into one packed word per row
      if (wl < 8)
        bounce[wl] = warp_bits[4 * wl] | warp_bits[4 * wl + 1] | warp_bits[4 * wl + 2] |
                     warp_bits[4 * wl + 3];
      float w = warp_sum[wl];
      for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(FULL, w, off);
      __syncwarp();
      if (wl == 0) {
        int s = 0;
        for (int r = 0; r < 8; ++r) s += (int)bounce[r];  // scalar read-back
        acc = acc + w + (float)s;
      }
    }
    __syncthreads();  // the next lap overwrites tab8 and the warp words
  }
  if (t == 0) out[0] = acc;
}

// ---------------------------------------------------------------------------
// P2

enum P2Variant {
  LOOP_EMPTY, WHILE_EMPTY, LOOP_AND, LOOP_ONLY, LOADS, LOADS4, AABB, ANY1, AABB_ANY,
  PUSH_BRANCHLESS, PUSH_PACKED, LEAF_MT,
};

struct P2Lane {
  float ox, oy, oz, idx, idy, idz;
};

__device__ __forceinline__ bool p2_box(const float* __restrict__ nf, const P2Lane& l,
                                       float cap) {
  float t_enter;
  return slab(nf, l.ox, l.oy, l.oz, l.idx, l.idy, l.idz, &t_enter) && t_enter <= cap;
}

// One lap of variant V at loop index i; returns the new accumulator.  As
// make_kernel's body (tools/kernel_microbench.py:77-213).
template <int V>
__device__ __forceinline__ float p2_lap(int i, float acc, const float* __restrict__ wf,
                                        const int* __restrict__ wi,
                                        const float* __restrict__ tr, int M, int NT,
                                        int leaf_k, const P2Lane& l, float& out_r,
                                        volatile int* stack) {
  if (V == LOOP_EMPTY) return acc + 1.0f;
  if (V == LOOP_AND) return acc + (float)(i & 255);
  const int node = i % M;
  const int bf = node * 48, bi = node * 24;
  if (V == LOOP_ONLY) return acc + (float)node;
  if (V == LOADS || V == LOADS4) {
    float s = 0.0f;
    for (int j = 0; j < (V == LOADS4 ? 4 : 1); ++j) {
      const int nd = V == LOADS4 ? (i * 4 + j) % M : node;
      for (int c = 0; c < 8; ++c) {
        for (int k = 0; k < 6; ++k) s += wf[nd * 48 + c * 6 + k];
        s += (float)wi[nd * 24 + c];
      }
    }
    return acc + s;
  }
  if (V == ANY1) return acc + (__any_sync(FULL, p2_box(wf + bf, l, acc)) ? 1.0f : 0.0f);
  if (V == AABB || V == AABB_ANY) {
    float acc2 = acc;
    int n_any = 0;
    for (int c = 0; c < 8; ++c) {
      const bool active = p2_box(wf + bf + c * 6, l, acc2);
      if (V == AABB)
        acc2 = acc2 + (float)(wi[bi + c] + (active ? 1 : 0)) * (float)1e-30;
      else
        n_any += __any_sync(FULL, active) ? 1 : 0;
    }
    return V == AABB ? acc2 : acc2 + (float)n_any * (float)1e-30;
  }
  if (V == PUSH_BRANCHLESS || V == PUSH_PACKED) {
    int sp = 0;
    unsigned any_bits = 0;
    if (V == PUSH_PACKED) {
      unsigned bits = 0;
      for (int c = 0; c < 8; ++c) bits |= (p2_box(wf + bf + c * 6, l, acc) ? 1u : 0u) << c;
      any_bits = __reduce_or_sync(FULL, bits);
    }
    for (int c = 0; c < 8; ++c) {
      const int link = wi[bi + c];
      const bool any_c = V == PUSH_PACKED ? ((any_bits >> c) & 1u) != 0u
                                          : __any_sync(FULL, p2_box(wf + bf + c * 6, l, acc));
      stack[min(sp, 63)] = link;  // unconditional store
      sp += (any_c && link >= 0) ? 1 : 0;
    }
    return acc + (float)sp * (float)1e-30;
  }
  if (V == LEAF_MT) {
    for (int k = 0; k < leaf_k; ++k) {
      const float* v = tr + (size_t)min(node * 8 + k, NT - 1) * 12;
      // vertex rows [v0, v1, v2 | 3 unused]; the ray is (o, o), as the probe's
      const float row[9] = {v[0], v[1], v[2], v[3] - v[0], v[4] - v[1], v[5] - v[2],
                            v[6] - v[0], v[7] - v[1], v[8] - v[2]};
      float tt, tu, tv;
      const bool th = moller_trumbore(row, l.ox, l.oy, l.oz, l.ox, l.oy, l.oz, &tt, &tu, &tv);
      if (th && tt < acc) out_r = tt;
    }
    return acc;
  }
  return acc;
}

template <int V>
__device__ __forceinline__ void p2_run(const float* __restrict__ pool,
                                       const float* __restrict__ wf_g,
                                       const int* __restrict__ wi_g,
                                       const float* __restrict__ tr, float* __restrict__ out,
                                       int lanes, int M, int NT, int F, int leaf_k, float acc0) {
  extern __shared__ float p2_smem[];
  float* wf = p2_smem;
  int* wi = (int*)(p2_smem + M * 48);
  for (int k = threadIdx.x; k < M * 48; k += blockDim.x) wf[k] = wf_g[k];
  for (int k = threadIdx.x; k < M * 24; k += blockDim.x) wi[k] = wi_g[k];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  P2Lane l;
  l.ox = pool[lane], l.oy = pool[lanes + lane], l.oz = pool[2 * lanes + lane];
  l.idx = 1.0f / fmaxf(l.ox, 0.1f), l.idy = 1.0f / fmaxf(l.oy, 0.1f);
  l.idz = 1.0f / fmaxf(l.oz, 0.1f);
  float out_r = 0.0f;
  volatile int stack[64];
  float r;
  if (V == WHILE_EMPTY) {
    int k = 0;
    r = 0.0f;
    while (k < F) {
      k += 1;
      r += 1.0f;
    }
  } else {
    r = acc0;
    for (int i = 0; i < F; ++i) r = p2_lap<V>(i, r, wf, wi, tr, M, NT, leaf_k, l, out_r, stack);
  }
  out[lane] = out_r + r;
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

extern "C" int pt_probe_rowprim(const float* tab, const float* rays, float* out, int M,
                                int laps, void* stream) {
  p1_rowprim_kernel<<<1, P1_THREADS, 0, (cudaStream_t)stream>>>(tab, rays, out, M, laps);
  return (int)cudaGetLastError();
}

// `lanes` threads (a multiple of 128), tables of M nodes and NT triangle rows.
extern "C" int pt_probe_pop(int variant, const float* pool, const float* wf, const int* wi,
                            const float* tr, float* out, int lanes, int M, int NT, int F,
                            int leaf_k, float acc0, void* stream) {
  if (variant < 0 || variant >= (int)(sizeof(P2_KERNELS) / sizeof(P2_KERNELS[0])) ||
      lanes % P2_THREADS != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)P2_KERNELS[variant];
  const int smem = M * (48 + 24) * 4;  // the node tables, in dynamic shared memory
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&pool, &wf, &wi, &tr, &out, &lanes, &M, &NT, &F, &leaf_k, &acc0};
  err = cudaLaunchKernel(fn, dim3(lanes / P2_THREADS), dim3(P2_THREADS), args, smem,
                         (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
