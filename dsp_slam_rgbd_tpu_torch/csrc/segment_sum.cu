// Fixed-order scatter-add: out[t] += the rows of src aimed at t, in source order,
// for a short table of scatters in one launch; and the plan's segment offsets.
//
// Replaces no TPU kernel.  The JAX package's scatter-adds (XLA's, on the TPU
// and the CPU) return the same bits on every run; `index_add_` on the card
// adds with atomics, in an order that changes from run to run, and a
// converged Levenberg-Marquardt loop turns those last-bit differences into
// different accept decisions and a different map.  This kernel sums in one
// order, the CPU's: `ops/scatter.py::plan` sorts the indices once (stable,
// so each target's rows stay in source order) and cuts the sorted list into
// one segment per target (`segment_offsets` below).  Every add is one
// rounding, `__fadd_rn` / `__dadd_rn` (never contracted into an FMA), from
// out's value or from +0.0, so the result equals the same `index_add_` calls
// on the CPU, bit for bit: 0.0 + (-0.0) = +0.0 there too.
//
// A launch takes up to kMaxDesc scatters (descriptors).  Descriptors onto one
// output form a group: the same thread folds all of the first descriptor's
// segment, then all of the second's, in table order, which is what the same
// `index_add_` calls in sequence give.  Groups (outputs) run side by side,
// each over its own range of blocks.  One launch in place of one a scatter
// saves the host's launch cost, which sets a scatter's time at the main
// path's shapes (a few µs on the device against ~20 µs on the host).
//
// Bound: bytes (each output element with a kept row read and written once,
// or written once where it starts from +0.0; each kept source element, perm
// entry and offset read once).  The sum is a serial chain per (target,
// element); the layout keeps that chain from waiting on memory one row at a
// time.  A thread owns one (target, trailing element), consecutive threads
// the consecutive elements of a target, so the lanes reading one row read it
// coalesced (a 6x6 row is one 144-byte read) and every lane has work (lane
// groups padded to a power of two left 14 of 32 lanes idle on 6x3 rows: 8.24
// against 2.56 µs on an H100).  The lanes of a target read its offsets and
// perm entries at one address (one transaction a warp); each thread issues
// kBatch rows' perm loads, then their source loads, then folds them.  The
// kernel comes in two register budgets, one for tables of short segments and
// one for long (launch_table says why and how the host picks).
//
// A hot target (2^20 rows onto one) is one chain on one SM under the CPU's
// order, where `index_add_`'s atomics spread its rows over many SMs, so it
// stays slower than `index_add_` (27 against 1.8 ms on an H100).  Staging
// long segments through a cp.async ring in shared memory, with producer and
// consumer warps, took it to 6.3 ms; but no segment of the SLAM loop passes
// ~200 rows, where the ring was slower, and its kernel, with 40 KB of shared
// memory a block, slowed the short scatters beside it, so it was taken out.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDesc = 16;   // scatters a launch takes
constexpr int kThreads = 256;  // 8 warps a block
constexpr int kBatch = 16;     // rows whose loads a thread issues together
constexpr int kDeepRows = 4;   // source rows a target, on average, that take the deep kernel

struct Desc {
  const void* src;
  const int64_t* perm;
  const int64_t* offsets;
};

struct Group {
  void* out;
  int64_t n_targets;
  int64_t block0;        // the group's first block
  int elems;             // trailing elements of a row
  int first, count;      // its descriptors, in table order
  int zero;              // start from +0.0 (else from out's value)
};

struct Table {
  Desc d[kMaxDesc];
  Group g[kMaxDesc];
  int n_groups;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// This thread folds element e of target t straight from global memory, kBatch
// rows at a time: their perm entries, then their source values, then the adds
// in order.
template <typename T>
__device__ void fold(const Table& tab, const Group& g, int64_t t, int64_t e) {
  const int64_t E = g.elems;
  T* out = static_cast<T*>(g.out) + t * E + e;
  if (!g.zero) {   // a target without rows keeps its value: no read, no write
    bool any = false;
    for (int q = g.first; q < g.first + g.count && !any; ++q)
      any = tab.d[q].offsets[t + 1] > tab.d[q].offsets[t];
    if (!any) return;
  }
  T acc = g.zero ? T(0) : *out;
  for (int q = g.first; q < g.first + g.count; ++q) {
    const Desc& d = tab.d[q];
    const T* src = static_cast<const T*>(d.src);
    const int64_t k1 = d.offsets[t + 1];
    int64_t k = d.offsets[t];
    for (; k + kBatch <= k1; k += kBatch) {
      int64_t row[kBatch];
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) row[i] = d.perm[k + i];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) v[i] = src[row[i] * E + e];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) acc = add_rn(acc, v[i]);   // in source order
    }
    for (; k < k1; ++k) acc = add_rn(acc, src[d.perm[k] * E + e]);
  }
  *out = acc;
}

// kMinBlocks 8: 32 registers, every thread of an SM resident; kMinBlocks 4: 64
// registers, room for a batch's 16 loads in flight (see launch_table).
template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    segment_sum_kernel(const __grid_constant__ Table tab) {
  int gi = 0;
  while (gi + 1 < tab.n_groups && (int64_t)blockIdx.x >= tab.g[gi + 1].block0) ++gi;
  const Group& g = tab.g[gi];
  const int64_t i = ((int64_t)blockIdx.x - g.block0) * kThreads + threadIdx.x;
  if (i < g.n_targets * g.elems) {   // (target, element), row-major
    const int64_t t = i / g.elems;
    fold<T>(tab, g, t, i - t * g.elems);
  }
}

// offsets[t] = the first position of the sorted keys holding a key >= t, for
// t = 0..n; keys past n - 1 (rows left out of the plan) sort last.  A thread a
// target, by binary search: every thread does log2(rows) loads, and
// neighbouring targets read the same lines.  (A thread a position writing the
// targets between its predecessor's key and its own left one thread the whole
// gap after a sparse plan's last key: the pose graph's plan, 163 rows onto
// 16,384 targets, took 84 µs on the device against 38 µs before.)
template <typename K>
__global__ void segment_offsets_kernel(const K* __restrict__ keys, int64_t rows, int64_t n,
                                       int64_t* __restrict__ offsets) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > n) return;
  int64_t lo = 0, hi = rows;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)keys[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  offsets[t] = lo;
}

// raw: kFields int64 a scatter, in table order: out, src, perm, offsets
// (pointers), targets, trailing elements, start from +0.0 (1) or from out
// (0), rows of src.
constexpr int kFields = 8;

template <typename T>
int launch_table(const int64_t* raw, int n_desc, void* stream) {
  if (n_desc < 1 || n_desc > kMaxDesc) return (int)cudaErrorInvalidValue;
  Table tab{};
  int group_of[kMaxDesc], n_groups = 0;
  bool deep = false;   // some scatter has kDeepRows source rows a target or more
  for (int i = 0; i < n_desc; ++i) {
    const int64_t* r = raw + kFields * i;
    int gi = 0;
    while (gi < n_groups && (int64_t)(uintptr_t)tab.g[gi].out != r[0]) ++gi;
    if (gi == n_groups) {
      Group& g = tab.g[n_groups++];
      g.out = (void*)(uintptr_t)r[0];
      g.n_targets = r[4];
      g.elems = (int)r[5];
      g.zero = (int)r[6];
      g.count = 0;
    } else if (r[6] || tab.g[gi].n_targets != r[4] || tab.g[gi].elems != r[5]) {
      return (int)cudaErrorInvalidValue;   // only an output's first scatter starts it at +0.0
    }
    group_of[i] = gi;
    deep = deep || r[7] >= kDeepRows * r[4];
    tab.g[gi].count++;
  }
  // each group's descriptors side by side, in table order
  int next = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    tab.g[gi].first = next;
    next += tab.g[gi].count;
    tab.g[gi].count = 0;
  }
  for (int i = 0; i < n_desc; ++i) {
    const int64_t* r = raw + kFields * i;
    Group& g = tab.g[group_of[i]];
    Desc& d = tab.d[g.first + g.count++];
    d.src = (const void*)(uintptr_t)r[1];
    d.perm = (const int64_t*)(uintptr_t)r[2];
    d.offsets = (const int64_t*)(uintptr_t)r[3];
  }
  int64_t blocks = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    Group& g = tab.g[gi];
    g.block0 = blocks;
    if (g.n_targets > 0 && g.elems > 0)   // else nothing to write
      blocks += (g.n_targets * g.elems + kThreads - 1) / kThreads;
  }
  if (blocks == 0) return 0;
  tab.n_groups = n_groups;
  // Held to 32 registers, ptxas issues a batch's loads a few at a time: a
  // chain of 200 rows (the PCG's Hcc) took 18 µs on an H100, 2^20 rows onto
  // one target 50 ms.  With 64 (half the threads of an SM resident) they take
  // 10.5 µs and 27 ms, but scatters of a row or so a target (BA's Hcp, the
  // pose graph) run slower: there occupancy, not the batch, hides the loads.
  // So the host picks by the mean rows a target, which it knows without
  // reading the offsets.
  if (deep)
    segment_sum_kernel<T, 4><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(tab);
  else
    segment_sum_kernel<T, 8><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_offsets(const void* keys, int64_t rows, int64_t n, void* offsets, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + 1 + threads - 1) / threads;
  segment_offsets_kernel<K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const K*)keys, rows, n, (int64_t*)offsets);
  return (int)cudaGetLastError();
}

}  // namespace

// The table's scatters (see launch_table), all of one type: out (n_targets,
// elems) and src (rows, elems) contiguous, perm (rows,) the stable sort of the
// rows' targets, offsets (n_targets + 1,) each target's first position in perm.
// No src may be another scatter's out.  Returns the launch's CUDA error.
extern "C" int segment_sum_table_f32(const int64_t* table, int n, void* stream) {
  return launch_table<float>(table, n, stream);
}

extern "C" int segment_sum_table_f64(const int64_t* table, int n, void* stream) {
  return launch_table<double>(table, n, stream);
}

// offsets (n + 1,) int64 of sorted int32 / int64 keys (rows,); see the kernel.
extern "C" int segment_offsets_i32(const void* keys, int64_t rows, int64_t n, void* offsets,
                                   void* stream) {
  return launch_offsets<int32_t>(keys, rows, n, offsets, stream);
}

extern "C" int segment_offsets_i64(const void* keys, int64_t rows, int64_t n, void* offsets,
                                   void* stream) {
  return launch_offsets<int64_t>(keys, rows, n, offsets, stream);
}
