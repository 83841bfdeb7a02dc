// Device stamps for the program's spans (utils/profiling.py).  Replaces no
// TPU kernel: the JAX package times its iteration from the host alone.
//
// A stamp is one thread that writes the card's %globaltimer (ns) into a
// row-major int64 table at (row, col), row = base + *lap when `lap` is given
// (the iteration's own lap counter on the card, integrator/graphs.py
// StaticIteration.depth), so that every lap of one captured graph lands in
// its own row; a row past the table's last is written to the last (a spill
// row the reader drops).  Captured into a CUDA graph it is one kernel node
// between the step's other nodes, so it runs after the node before it ends
// and before the node after it starts.  Bound by the graph's per-node launch
// floor, a few microseconds, not by its one load and one store.
//
// The timer probe reads %globaltimer n times back to back in one thread:
// the smallest step between two readings is the timer's resolution.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (int64_t)t;
}

__global__ void stamp_kernel(int64_t* __restrict__ table, const int* __restrict__ lap,
                             int base, int col, int ncols, int nrows) {
  const int64_t t = global_ns();
  int row = base + (lap ? *lap : 0);
  row = row < 0 ? 0 : (row >= nrows ? nrows - 1 : row);
  table[(int64_t)row * ncols + col] = t;
}

__global__ void timer_probe_kernel(int64_t* __restrict__ out, int n) {
  for (int i = 0; i < n; ++i) out[i] = global_ns();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError().

extern "C" int pt_stamp(int64_t* table, const int* lap, int base, int col, int ncols, int nrows,
                        void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(table, lap, base, col, ncols, nrows);
  return (int)cudaGetLastError();
}

extern "C" int pt_timer_probe(int64_t* out, int n, void* stream) {
  if (n > 0) timer_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
