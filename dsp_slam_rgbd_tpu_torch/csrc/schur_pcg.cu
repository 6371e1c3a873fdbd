// The global BA's conjugate-gradient loop on the reduced (pose + object)
// system, matrix-free: three kernels a CG step, all launched from one host
// call a solve.
//
// Replaces no TPU kernel.  The JAX package runs this loop as einsums and
// segment sums (`mapping/ba.py::_pcg_gn_step`), and the port ran it as torch
// ops: ~40 launches a CG step, where each edge einsum became a cuBLAS batched
// gemv over one 6x3 matrix a batch entry.  On the KITTI-00-scale corridor
// (262,144 edge slots, 196,709 kept) those gemvs took ~0.6 ms a step on an
// H100 and the launches paced the loop.  Here a step is:
//
//   point_side  u_p = sum over p's kept edges of Ccp_n^T x[kf_n], v_p = Hpp^-1_p u_p
//   pose_side   y_b = Hcc_b x_b - sum over b's kept edges of Ccp_n v[pt_n]
//                     + sum of ko_m x[oobj_m] (m onto b as its keyframe)
//                     + sum of ko_m^T x[okf_m] (m onto b as its object)
//                     + damp_b * x_b, zero where b is not free; Ap = y,
//               and its block's share of p.Ap
//   update      alpha = rz / max(p.Ap, 1e-20); x += alpha p; r -= alpha Ap;
//               z = Minv r; rz' = r.z; beta = rz' / max(rz, 1e-20); p = z + beta p
//
// with x the direction p masked by `free` (the matvec's input).  One more
// launch of `update` before the loop sets x = 0, r = b, z = Minv b, rz and
// p = z.  So a solve of S steps is 1 + 3 S launches (`schur_pcg_solve`).
//
// `schur_pcg_launch` launches one kernel in one mode (`Op`), for a host that
// runs the loop itself: a solve whose edges are sharded over ranks sums each
// side's partial edge sums over the ranks between launches, so a step is
// point_side's masked u, the sum, v = Hpp^-1 u, pose_side's edge and object
// sums, the sum, and `update`, which adds Hcc x and the damping, masks, and
// forms p.Ap before the same CG update: 1 + 4 S launches.  The same entry
// runs the GN step's two other edge products: the reduced right-hand side's
// correction sum Ccp_n (Hpp^-1 bp)[pt_n] and the back-substitution's sum
// Ccp_n^T dx[kf_n].  Every mode sums in the order of the fused step, so a
// one-rank sharded solve gives the unsharded solve's bits.
//
// Fixed order, no atomics: every run sums the same values in the same order,
// so the card's SLAM loop repeats bit for bit.  A point sums its edges in
// point-plan order (one thread, from +0.0).  A pose block's edges are split
// over a warp's lanes (lane l takes the block's edges l, l + 32, ... in plan
// order), and the lanes' sums meet in a fixed butterfly; its object edges
// follow, in plan order, as the torch version's scatters order them.  The
// dot products are two-level: a block's share (pose side) or a thread's
// (update), then one fixed tree in the single block of `update`.
//
// Bound: bytes.  A step reads each kept edge's 6x3 block twice (72 B, once a
// side) and its index once a side; the plan's offsets, Hpp^-1, Hcc, Minv and
// the (B, 6) vectors are ~1.5 MB more.  At the corridor's size that is ~36 MB,
// ~11 us at 3.35 TB/s.  The wrapper (`ops/cuda/schur_pcg.py`) stores the
// blocks twice, once in each plan's order, so that both sides stream them:
// consecutive threads (points) or lanes (edges of a pose block) read
// consecutive rows.  The update runs in one block: its (B, 6) vectors are a
// few hundred KB, and one block can finish both reductions without another
// launch.  On an H100 (700 W) at the corridor's size a CG step takes ~27 us
// of device time, 2.4x the bound: point side ~9 us (a thread a point, ~7
// edges each, the index-then-gather chains in flight four edges at a time),
// pose side ~6.5 us, update ~8.5 us (latency: one block, two reductions).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPointThreads = 128;   // points a block (a thread each)
constexpr int kPoseWarps = 4;        // pose blocks a block (a warp each)
constexpr int kUpdateThreads = 1024; // the one block of `update`
constexpr unsigned kFull = 0xffffffffu;

// the kernels' modes
enum PointMode { kPointMatvec = 0, kPointSums = 1, kPointMaskedSums = 2, kPointApplyHpp = 3 };
enum PoseMode { kPoseMatvec = 0, kPoseSums = 1, kPoseEdgeSums = 2 };
enum UpdateMode { kUpdateStep = 0, kUpdateInit = 1, kUpdateStepFromSums = 2 };

struct Operands {
  int64_t B, P;
  // point side: the kept edges in point-plan order
  const float* ccp_pt;     // (N, 6, 3)
  const int32_t* kf_pt;    // (N,) each row's pose block
  const int64_t* pt_off;   // (P + 1,)
  const float* hpp_inv;    // (P, 3, 3)
  // pose side: the kept edges in pose-plan order
  const float* ccp_kf;     // (N, 6, 3)
  const int32_t* pt_kf;    // (N,) each row's point
  const int64_t* kf_off;   // (B + 1,)
  const float* hcc;        // (B, 6, 6)
  const float* damp;       // (B, 6)
  const uint8_t* free_;    // (B,) bool
  // object edges (M,): coupling blocks, their two plans and targets
  const float* ko;         // (M, 6, 6)
  const int64_t* okf_perm;
  const int64_t* okf_off;  // (B + 1,)
  const int64_t* okf_idx;  // (M,) keyframe block of each edge
  const int64_t* oobj_perm;
  const int64_t* oobj_off; // (B + 1,)
  const int64_t* oobj_idx; // (M,) object block of each edge
  // the preconditioner and the right-hand side
  const float* minv;       // (B, 6, 6)
  const float* b;          // (B, 6), zero on blocks that are not free
  // CG state and scratch
  float* x;                // (B, 6) the solution
  float* r;                // (B, 6)
  float* z;                // (B, 6)
  float* p;                // (B, 6)
  float* ap;               // (B, 6)
  float* v;                // (P, 3)
  float* dot;              // (B,) each pose block's share of p.Ap
  float* rz;               // (1,)
};

// torch.clamp_min: NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float a, float lo) {
  return isnan(a) ? a : fmaxf(a, lo);
}

// the matvec's input: the direction where the block is free, +0.0 elsewhere
// (with `mask`; else p as it is)
__device__ __forceinline__ void masked_p(const Operands& o, int64_t blk, float xs[6],
                                         bool mask = true) {
  const bool f = !mask || o.free_[blk] != 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) xs[i] = f ? o.p[blk * 6 + i] : 0.f;
}

// a 6x3 block, row-major; rows are 72 B apart, so 8-byte loads
__device__ __forceinline__ void load_6x3(const float* src, float c[18]) {
  const float2* c2 = reinterpret_cast<const float2*>(src);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float2 t = c2[q];
    c[2 * q] = t.x;
    c[2 * q + 1] = t.y;
  }
}

// the same butterfly in every lane: each lane ends with the same bits
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// the sum of one value a thread over the block, in a fixed tree; every
// thread gets the same bits
__device__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();   // red is free from its last use
  if (lane == 0) red[w] = s;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// Ccp_n^T x for one edge: e_j = sum_i C[i][j] x_i, i in order
__device__ __forceinline__ void edge_u(const Operands& o, int64_t k, float e[3], bool mask) {
  float xs[6], c[18];
  masked_p(o, o.kf_pt[k], xs, mask);
  load_6x3(o.ccp_pt + k * 18, c);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float a = c[j] * xs[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) a = fmaf(c[3 * i + j], xs[i], a);
    e[j] = a;
  }
}

// v_pt = Hpp^-1_pt u, row by row in a fixed order
__device__ __forceinline__ void apply_hpp(const Operands& o, int64_t pt, const float u[3]) {
  const float* h = o.hpp_inv + pt * 9;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    o.v[pt * 3 + j] = fmaf(h[3 * j + 2], u[2], fmaf(h[3 * j + 1], u[1], h[3 * j] * u[0]));
}

// kPointMatvec: v = Hpp^-1 u of the masked direction.  kPointSums: u of p
// (unmasked) into v, the back-substitution's product.  kPointMaskedSums: u
// of the masked direction into v.  kPointApplyHpp: v = Hpp^-1 v, in place.
__global__ void __launch_bounds__(kPointThreads) point_side(const __grid_constant__ Operands o,
                                                            int mode) {
  const int64_t pt = (int64_t)blockIdx.x * kPointThreads + threadIdx.x;
  if (pt >= o.P) return;
  float u[3] = {0.f, 0.f, 0.f};
  if (mode == kPointApplyHpp) {
#pragma unroll
    for (int j = 0; j < 3; ++j) u[j] = o.v[pt * 3 + j];
    apply_hpp(o, pt, u);
    return;
  }
  const bool mask = mode != kPointSums;
  const int64_t k1 = o.pt_off[pt + 1];
  int64_t k = o.pt_off[pt];
  for (; k + 4 <= k1; k += 4) {   // four edges' loads in flight, added in order
    float e[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q) edge_u(o, k + q, e[q], mask);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 3; ++j) u[j] = __fadd_rn(u[j], e[q][j]);
  }
  for (; k < k1; ++k) {
    float e[3];
    edge_u(o, k, e, mask);
#pragma unroll
    for (int j = 0; j < 3; ++j) u[j] = __fadd_rn(u[j], e[j]);
  }
  if (mode == kPointMatvec) {
    apply_hpp(o, pt, u);
    return;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) o.v[pt * 3 + j] = u[j];
}

// Ccp_n v[pt_n] for one edge: e_i = sum_j C[i][j] v_j, j in order
__device__ __forceinline__ void edge_y(const Operands& o, int64_t k, float e[6]) {
  float c[18];
  const int64_t pt = o.pt_kf[k];
  const float v0 = o.v[pt * 3], v1 = o.v[pt * 3 + 1], v2 = o.v[pt * 3 + 2];
  load_6x3(o.ccp_kf + k * 18, c);
#pragma unroll
  for (int i = 0; i < 6; ++i) e[i] = fmaf(c[3 * i + 2], v2, fmaf(c[3 * i + 1], v1, c[3 * i] * v0));
}

// kPoseMatvec: the matvec's pose side.  kPoseSums: the edges' sum of Ccp v
// into ap, the reduced right-hand side's correction.  kPoseEdgeSums: minus
// that sum, then the object terms, into ap (the matvec's pose side without
// Hcc x, the damping and the mask, which `update` adds after the ranks' sum).
__global__ void __launch_bounds__(kPoseWarps * 32) pose_side(const __grid_constant__ Operands o,
                                                             int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t blk = (int64_t)blockIdx.x * kPoseWarps + (threadIdx.x >> 5);
  if (blk >= o.B) return;   // the whole warp
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int64_t k1 = o.kf_off[blk + 1];
  int64_t k = o.kf_off[blk] + lane;
  for (; k + 96 < k1; k += 128) {   // this lane's next four edges, added in order
    float e[4][6];
#pragma unroll
    for (int q = 0; q < 4; ++q) edge_y(o, k + 32 * q, e[q]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 6; ++i) s[i] = __fadd_rn(s[i], e[q][i]);
  }
  for (; k < k1; k += 32) {
    float e[6];
    edge_y(o, k, e);
#pragma unroll
    for (int i = 0; i < 6; ++i) s[i] = __fadd_rn(s[i], e[i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) s[i] = warp_sum(s[i]);
  if (lane != 0) return;
  if (mode == kPoseSums) {
#pragma unroll
    for (int i = 0; i < 6; ++i) o.ap[blk * 6 + i] = s[i];
    return;
  }

  float acc[6], xo[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[i] = -s[i];
  // object edges with this block as their keyframe: ko x[object]
  for (int64_t q = o.okf_off[blk]; q < o.okf_off[blk + 1]; ++q) {
    const int64_t m = o.okf_perm[q];
    const float* K = o.ko + m * 36;
    masked_p(o, o.oobj_idx[m], xo);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = K[i * 6] * xo[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) a = fmaf(K[i * 6 + j], xo[j], a);
      acc[i] = __fadd_rn(acc[i], a);
    }
  }
  // object edges with this block as their object: ko^T x[keyframe]
  for (int64_t q = o.oobj_off[blk]; q < o.oobj_off[blk + 1]; ++q) {
    const int64_t m = o.oobj_perm[q];
    const float* K = o.ko + m * 36;
    masked_p(o, o.okf_idx[m], xo);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = K[i] * xo[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) a = fmaf(K[j * 6 + i], xo[j], a);
      acc[i] = __fadd_rn(acc[i], a);
    }
  }
  if (mode == kPoseEdgeSums) {
#pragma unroll
    for (int i = 0; i < 6; ++i) o.ap[blk * 6 + i] = acc[i];
    return;
  }
  float xb[6];
  masked_p(o, blk, xb);
  const bool f = o.free_[blk] != 0;
  const float* H = o.hcc + blk * 36;
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float hx = H[i * 6] * xb[0];
#pragma unroll
    for (int j = 1; j < 6; ++j) hx = fmaf(H[i * 6 + j], xb[j], hx);
    const float y = f ? __fadd_rn(__fadd_rn(hx, acc[i]), __fmul_rn(o.damp[blk * 6 + i], xb[i]))
                      : 0.f;
    o.ap[blk * 6 + i] = y;
    d = fmaf(o.p[blk * 6 + i], y, d);
  }
  o.dot[blk] = d;
}

// kUpdateInit: x = 0, r = b, z = Minv r, rz = r.z, p = z.  kUpdateStep: one
// CG update from the pose side's Ap and shares of p.Ap.  kUpdateStepFromSums:
// the same from the edge and object sums in ap (kPoseEdgeSums, summed over
// the ranks): first Ap = Hcc x + ap + damp x, zero where the block is not
// free, and its blocks' shares of p.Ap, in the pose side's order.  An
// element (block, row) a thread, so that consecutive threads read
// consecutive addresses: one block reading a 6x6 Minv a thread took ~21 us a
// step on an H100 (the single SM's L1 turns each 32-lane load at a 144-byte
// stride into 32 line lookups).
__global__ void __launch_bounds__(kUpdateThreads) update(const __grid_constant__ Operands o,
                                                         int mode) {
  __shared__ float red[kUpdateThreads / 32];
  const int t = threadIdx.x;
  const int E = (int)o.B * 6;
  const bool init = mode == kUpdateInit;
  const float rz = init ? 0.f : o.rz[0];   // read by all before any thread writes it
  if (mode == kUpdateStepFromSums) {
    for (int e = t; e < E; e += kUpdateThreads) {
      const int64_t blk = e / 6;
      const float* pb = o.p + blk * 6;
      const float2* H = reinterpret_cast<const float2*>(o.hcc + (int64_t)e * 6);
      float2 h = H[0];
      float hx = fmaf(h.y, pb[1], h.x * pb[0]);
#pragma unroll
      for (int j = 1; j < 3; ++j) {
        h = H[j];
        hx = fmaf(h.y, pb[2 * j + 1], fmaf(h.x, pb[2 * j], hx));
      }
      o.ap[e] = o.free_[blk] != 0
                    ? __fadd_rn(__fadd_rn(hx, o.ap[e]), __fmul_rn(o.damp[e], o.p[e])) : 0.f;
    }
    __syncthreads();   // every Ap before a block's share of p.Ap reads it
  }
  float alpha = 0.f;
  if (!init) {
    float s = 0.f;
    for (int b = t; b < (int)o.B; b += kUpdateThreads) {
      float d = o.dot[b];
      if (mode == kUpdateStepFromSums) {
        d = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) d = fmaf(o.p[b * 6 + i], o.ap[b * 6 + i], d);
      }
      s = __fadd_rn(s, d);
    }
    alpha = rz / clamp_min(block_sum(s, red), 1e-20f);
  }
  for (int e = t; e < E; e += kUpdateThreads) {
    if (init) {
      o.x[e] = 0.f;
      o.r[e] = o.b[e];
    } else {
      o.x[e] = fmaf(alpha, o.p[e], o.x[e]);
      o.r[e] = fmaf(-alpha, o.ap[e], o.r[e]);
    }
  }
  __syncthreads();   // every r before a row of Minv r reads its block's
  float q = 0.f;
  for (int e = t; e < E; e += kUpdateThreads) {
    const float2* M = reinterpret_cast<const float2*>(o.minv + (int64_t)e * 6);
    const float2* rb = reinterpret_cast<const float2*>(o.r + (e / 6) * 6);
    float2 m = M[0], rr = rb[0];
    float zi = fmaf(m.y, rr.y, m.x * rr.x);
#pragma unroll
    for (int j = 1; j < 3; ++j) {
      m = M[j];
      rr = rb[j];
      zi = fmaf(m.y, rr.y, fmaf(m.x, rr.x, zi));
    }
    o.z[e] = zi;
    q = fmaf(o.r[e], zi, q);
  }
  const float rz_new = block_sum(q, red);
  const float beta = init ? 0.f : rz_new / clamp_min(rz, 1e-20f);
  for (int e = t; e < E; e += kUpdateThreads)   // z as this thread wrote it
    o.p[e] = init ? o.z[e] : fmaf(beta, o.p[e], o.z[e]);
  if (t == 0) o.rz[0] = rz_new;
}

// raw: the fields of Operands in order, each as one int64 (sizes, then
// pointers).
constexpr int kFields = 29;

Operands read_operands(const int64_t* raw) {
  Operands o;
  o.B = raw[0];
  o.P = raw[1];
  const void* ptr[kFields - 2];
  for (int i = 0; i < kFields - 2; ++i) ptr[i] = (const void*)(uintptr_t)raw[2 + i];
  int f = 0;
  o.ccp_pt = (const float*)ptr[f++];
  o.kf_pt = (const int32_t*)ptr[f++];
  o.pt_off = (const int64_t*)ptr[f++];
  o.hpp_inv = (const float*)ptr[f++];
  o.ccp_kf = (const float*)ptr[f++];
  o.pt_kf = (const int32_t*)ptr[f++];
  o.kf_off = (const int64_t*)ptr[f++];
  o.hcc = (const float*)ptr[f++];
  o.damp = (const float*)ptr[f++];
  o.free_ = (const uint8_t*)ptr[f++];
  o.ko = (const float*)ptr[f++];
  o.okf_perm = (const int64_t*)ptr[f++];
  o.okf_off = (const int64_t*)ptr[f++];
  o.okf_idx = (const int64_t*)ptr[f++];
  o.oobj_perm = (const int64_t*)ptr[f++];
  o.oobj_off = (const int64_t*)ptr[f++];
  o.oobj_idx = (const int64_t*)ptr[f++];
  o.minv = (const float*)ptr[f++];
  o.b = (const float*)ptr[f++];
  o.x = (float*)ptr[f++];
  o.r = (float*)ptr[f++];
  o.z = (float*)ptr[f++];
  o.p = (float*)ptr[f++];
  o.ap = (float*)ptr[f++];
  o.v = (float*)ptr[f++];
  o.dot = (float*)ptr[f++];
  o.rz = (float*)ptr[f++];
  return o;
}

// at least one block each: an empty side launches and returns, so that the
// launch count follows the call alone
unsigned point_blocks(const Operands& o) {
  return (unsigned)(o.P > 0 ? (o.P + kPointThreads - 1) / kPointThreads : 1);
}

unsigned pose_blocks(const Operands& o) {
  return (unsigned)(o.B > 0 ? (o.B + kPoseWarps - 1) / kPoseWarps : 1);
}

}  // namespace

// raw (kFields,) int64: B, P, then the pointers of Operands in its order (0
// for those a call does not read).  Every tensor is contiguous and on one
// card; the caller allocated all of it.  Each entry returns the first failed
// launch's CUDA error, else 0.

// `steps` CG steps of the reduced system (see the top of this file) on
// `stream`: 1 + 3 * steps launches.
extern "C" int schur_pcg_solve(const int64_t* raw, int n_fields, int steps, void* stream) {
  if (n_fields != kFields || steps < 0) return (int)cudaErrorInvalidValue;
  const Operands o = read_operands(raw);
  cudaStream_t s = (cudaStream_t)stream;
  update<<<1, kUpdateThreads, 0, s>>>(o, kUpdateInit);
  cudaError_t err = cudaGetLastError();
  for (int i = 0; i < steps && err == cudaSuccess; ++i) {
    point_side<<<point_blocks(o), kPointThreads, 0, s>>>(o, kPointMatvec);
    pose_side<<<pose_blocks(o), kPoseWarps * 32, 0, s>>>(o, kPoseMatvec);
    update<<<1, kUpdateThreads, 0, s>>>(o, kUpdateStep);
    err = cudaGetLastError();
  }
  return (int)err;
}

// `schur_pcg_launch`'s `op`: one kernel in one mode, one launch
enum Op {
  kOpPointSums = 0,     // v[p] = sum over p's kept edges of Ccp_n^T p[kf_n]
  kOpPoseSums = 1,      // ap[b] = sum over b's kept edges of Ccp_n v[pt_n]
  kOpPointU = 2,        // v = the masked direction's point sums u
  kOpPointV = 3,        // v = Hpp^-1 v
  kOpPoseEdges = 4,     // ap = the pose side's edge and object sums
  kOpUpdateInit = 5,    // the CG state from b
  kOpUpdateFromSums = 6 // one CG step's update from ap's sums
};

extern "C" int schur_pcg_launch(const int64_t* raw, int n_fields, int op, void* stream) {
  if (n_fields != kFields || op < kOpPointSums || op > kOpUpdateFromSums)
    return (int)cudaErrorInvalidValue;
  const Operands o = read_operands(raw);
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kOpPointSums:
    case kOpPointU:
    case kOpPointV:
      point_side<<<point_blocks(o), kPointThreads, 0, s>>>(
          o, op == kOpPointSums ? kPointSums : op == kOpPointU ? kPointMaskedSums : kPointApplyHpp);
      break;
    case kOpPoseSums:
    case kOpPoseEdges:
      pose_side<<<pose_blocks(o), kPoseWarps * 32, 0, s>>>(
          o, op == kOpPoseSums ? kPoseSums : kPoseEdgeSums);
      break;
    default:
      update<<<1, kUpdateThreads, 0, s>>>(
          o, op == kOpUpdateInit ? kUpdateInit : kUpdateStepFromSums);
  }
  return (int)cudaGetLastError();
}
