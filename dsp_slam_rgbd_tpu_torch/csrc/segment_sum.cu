// Fixed-order scatter-add: out[t] += the rows of src aimed at t, in source order.
//
// Replaces no TPU kernel.  The JAX package's scatter-adds (XLA's, on the TPU
// and the CPU) return the same bits on every run; `index_add_` on the card
// adds with atomics, in an order that changes from run to run, and a
// converged Levenberg-Marquardt loop turns those last-bit differences into
// different accept decisions and a different map.  This kernel sums in one
// order, the CPU's: `ops/scatter.py::plan` sorts the indices once (stable,
// so each target's rows stay in source order) and cuts the sorted list into
// one segment per target; a thread owns one (target, trailing element) pair,
// starts from out's value and adds its segment's rows one after the other
// with `__fadd_rn` / `__dadd_rn` (never contracted into an FMA).  The result
// equals `out.index_add_(0, idx, src)` over the plan's rows on the CPU, bit
// for bit.
//
// Bound: bytes (each output element read and written once, each source
// element and each index read once).  The design trades the atomics'
// parallelism inside a target for a serial chain of dependent adds.  The
// chain's loads do not depend on the sum: a thread issues a batch of kBatch
// index loads, then kBatch source loads, then adds them in order, so a
// long segment costs a memory latency every kBatch rows, not every row.
// Rows whose contributions are known zeros (a bucket's padding, a dump
// row) are left out of the plan, so no caller makes a segment that long.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kBatch = 16;

template <typename T>
__global__ void segment_sum_kernel(T* __restrict__ out, const T* __restrict__ src,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ offsets,
                                   int64_t total, int64_t elems) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t target = i / elems;
    const int64_t e = i - target * elems;
    const int64_t k1 = offsets[target + 1];
    int64_t k = offsets[target];
    T acc = out[i];
    for (; k + kBatch <= k1; k += kBatch) {
      int64_t row[kBatch];
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) row[j] = perm[k + j];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) v[j] = src[row[j] * elems + e];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) acc = add_rn(acc, v[j]);   // in source order
    }
    for (; k < k1; ++k) acc = add_rn(acc, src[perm[k] * elems + e]);
    out[i] = acc;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;   // a grid-stride loop past 32 blocks an SM

template <typename T>
int launch(void* out, const void* src, const void* perm, const void* offsets,
           int64_t n_targets, int64_t elems, void* stream) {
  const int64_t total = n_targets * elems;
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)out, (const T*)src, (const int64_t*)perm, (const int64_t*)offsets, total, elems);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n_targets, elems) and src (rows, elems), contiguous, of one type;
// perm (rows,) the stable sort of the rows' targets; offsets (n_targets + 1,)
// each target's first position in perm.  Returns the launch's CUDA error.
extern "C" int segment_sum_f32(void* out, const void* src, const void* perm,
                               const void* offsets, int64_t n_targets, int64_t elems,
                               void* stream) {
  return launch<float>(out, src, perm, offsets, n_targets, elems, stream);
}

extern "C" int segment_sum_f64(void* out, const void* src, const void* perm,
                               const void* offsets, int64_t n_targets, int64_t elems,
                               void* stream) {
  return launch<double>(out, src, perm, offsets, n_targets, elems, stream);
}
