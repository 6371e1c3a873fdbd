// The object fit's normal equations and their solve: two kernels a GN
// iteration of `recon/optimizer.py::_gn_iteration`, for every object of a
// batch at once.
//
// Replaces no TPU kernel.  The JAX package forms these systems with einsums
// and solves them with `jnp.linalg.solve` (dsp_slam_rgbd_tpu/recon/
// optimizer.py:241), and the port ran the same as torch ops: a `cat` and
// two `where` of J per term, two batched gemms, the sums and counts, the
// damping as slices, then `torch.linalg.solve_ex`, whose batched LU goes to
// MAGMA on the card (pointer arrays built on the host at every call, ~200
// launches at 263 unknowns).  Here:
//
//   sums   one launch for both terms.  For each object and term, the packed
//          lower triangle of J_ext^T J_ext over the live rows, J_ext = [J | r]
//          (n + 1 columns: the last row of the triangle is J^T r and its
//          corner sum r^2 over the live rows), then sum r^2 over the masked
//          rows and the live count.  Rows whose mask is false are skipped:
//          they add exactly zero in the op route too.
//   solve  one block an object: H and b from the sums, exactly as the op
//          route forms them (per term k / max(count, 1); k3 on the code
//          diagonal and -k3 code in b; k4 drot drot^T + I on the pose block,
//          scale_damping at (6, 6), +k4 drot res_rot in b), the loss, then a
//          Cholesky factorisation of H as a packed lower triangle in shared
//          memory and the two triangular solves.  H is symmetric positive
//          definite: H >= min(1, k3) I.  info is 0 where every pivot was
//          finite and positive, else the first failing column + 1.
//
// Bound: operations.  At 263 unknowns and 128 objects (~51,000 live rows a
// batch) the sums are ~3.6 GFLOP and the factorisations 128 x 6.2 MFLOP:
// ~65 us at the 67 TFLOP/s f32 rate; the bytes, the live rows of [J | r]
// once, take ~17 us at 3.35 TB/s.  On an H100 (700 W) the pair takes
// ~0.52 ms there (sums ~0.25, solve ~0.26) and ~0.11 ms at 71 unknowns,
// against ~4.7 and ~2.0 ms op by op.
//   The sums tile the triangle in 64 x 64 blocks, 4 x 4 outputs a thread,
// and stage the tile's columns of 32 live rows at a time in shared memory,
// each thread one column (loaded from its own source, with the next
// chunk's loads in flight while a chunk is summed); a tile on the diagonal
// stages its columns once.  When the batch is too small to fill the card
// each object's live rows are split in `chunks` of equal live counts over
// more blocks.  They run at about a quarter of the FMA rate: the loads
// and barriers of each chunk, and the blocks of the last tile row, which
// hold few outputs.
//   The solve is latency-bound: one block an object holds the whole
// augmented triangle [H b; b^T 0] (160 KB at 263 unknowns), so the forward
// solve is its last row.  Right-looking in panels of 16 columns, three
// block barriers a panel: warp 0 factors the diagonal block (a row a lane,
// columns shared by shuffles), every row below it solves for its panel
// values on its own thread, and the trailing triangle takes the panel's
// rank-16 update, four rows a warp.  The back substitution runs on the
// rows of L divided by their pivots (so its chain holds no division), 32
// rows at a time, a warp solving their triangle and the block updating
// the rows above.  The diagonal blocks' chain of square roots, divisions
// and shuffles (~0.8k cycles a column) takes about 40% of the solve.
//
// Fixed order, no atomics, IEEE division and square root: every output
// element of the sums is one FMA chain over its chunk's live rows in row
// order (so where the padding lies does not change it), the chunks add up
// in chunk order, the masked rows' squares in a fixed tree; the solve's
// order is fixed.  Two runs on the same inputs give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // a sums block's tile of the triangle
constexpr int kTargetBlocks = 264;  // sums blocks that fill an H100's 132 SMs twice
constexpr int kMaxChunks = 16;      // the most parts an object's live rows are split into
constexpr int kSumsThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowChunk = 32;       // live rows staged at a time
constexpr int kSegment = 4096;      // mask slots compacted at a time
constexpr int kSolveThreads = 512;    // a row of the augmented matrix a thread in a panel
constexpr int kSolveWarps = kSolveThreads / 32;
constexpr int kMaxSmem = 232448;    // an H100 block's shared memory
constexpr unsigned kFull = 0xffffffffu;

constexpr int kPanel = 16;          // the solve's panel of columns

// the solve's shared memory: the panel, its diagonal block scaled, the
// augmented matrix's packed triangle, the pivots, y then x, four scalars
__host__ __device__ constexpr int64_t solve_smem_bytes(int64_t n) {
  return 4 * ((n + 1) * kPanel + kPanel * kPanel + (n + 1) * (n + 2) / 2 + 2 * n + 4);
}

// the widest system the solve holds (321 unknowns)
constexpr int max_width() {
  int n = 1;
  while (solve_smem_bytes(n + 1) <= kMaxSmem) ++n;
  return n;
}
constexpr int kMaxWidth = max_width();

// floats a (object, chunk, term) of the sums: the (n + 1)-triangle, the
// masked rows' squares, the live count; a multiple of 4
__host__ __device__ constexpr int64_t sums_stride(int64_t n) {
  return ((n + 1) * (n + 2) / 2 + 2 + 3) / 4 * 4;
}

struct Term {
  const float* jac_pose;   // (B, R, 7), unit stride on the last axis
  const float* jac_code;   // (B, R, L)
  const uint8_t* mask;     // (B, R) bool
  const float* rr;         // (B, R)
  int64_t rows;            // R
  int64_t pose_b, pose_r, code_b, code_r, mask_b, rr_b;   // strides (elements)
};

struct Operands {
  int64_t B, L, chunks, stride;   // n = 7 + L unknowns; stride: sums_stride(n)
  Term term[2];                    // 0: the SDF term (k2), 1: the render term (k1)
  const float* code;               // (B, L)
  int64_t code_b;
  const float* drot;               // (B, 7) contiguous
  const float* res_rot;            // (B,)
  float* sums;                     // (B, chunks, 2, stride)
  float* dx;                       // (B, n)
  int32_t* info;                   // (B,)
  float* loss;                     // (B,)
  float k1, k2, k3, k4, scale_damping;
};

// column c of J_ext = [jac_pose | jac_code | r] of object b: row r's value
// is col[r * step] (null past column n: zero)
struct Column {
  const float* col;
  int64_t step;
};

__device__ __forceinline__ Column jext_column(const Term& t, int64_t b, int c, int n) {
  if (c < 7) return {t.jac_pose + b * t.pose_b + c, t.pose_r};
  if (c < n) return {t.jac_code + b * t.code_b + (c - 7), t.code_r};
  if (c == n) return {t.rr + b * t.rr_b, 1};
  return {nullptr, 0};
}

// IEEE a / b for b > 0.  A zero a gives a, as the division does, without
// the division's slow path, which zero numerators take
__device__ __forceinline__ float div_pos(float a, float b) {
  return a == 0.f ? a : __fdiv_rn(a, b);
}

// the same butterfly in every lane: each lane ends with the same bits
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  return s;
}

// one value a thread summed over the block in a fixed tree; every thread
// gets the same bits
__device__ float block_sum(float s, float* red) {
  s = warp_sum(s);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = s;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f);
}

// a thread's loads of a staged chunk: its column, rows threadIdx / kTile + 4 q
constexpr int kLoads = kRowChunk * kTile / kSumsThreads;

// the values of chunk c0's rows (zero past cnt) in this thread's columns
__device__ __forceinline__ void stage_loads(const Column& ca, const Column& cb, bool on_diag,
                                            const uint16_t* idx, int64_t s0, int c0, int cnt,
                                            float ra[kLoads], float rb[kLoads]) {
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    const int rr = c0 + threadIdx.x / kTile + q * (kSumsThreads / kTile);
    float a = 0.f, v = 0.f;
    if (rr < cnt) {
      const int64_t r = s0 + idx[rr];
      if (ca.col) a = ca.col[r * ca.step];
      if (!on_diag && cb.col) v = cb.col[r * cb.step];
    }
    ra[q] = a;
    rb[q] = v;
  }
}

// blockIdx: x the object, y the term, z a tile of the (n + 1)-triangle and
// a chunk of the live rows (z = tile + tiles * (tiles + 1) / 2 * chunk)
__global__ void __launch_bounds__(kSumsThreads, 3) sums_kernel(const __grid_constant__ Operands o,
                                                            int tiles) {
  __shared__ __align__(16) float As[kRowChunk][kTile];
  __shared__ __align__(16) float Bs[kRowChunk][kTile];
  __shared__ uint16_t idx[kSegment];
  __shared__ int warp_live[kSumsThreads / 32];
  __shared__ float red[kSumsThreads / 32];

  const int n = 7 + (int)o.L, m = n + 1;
  const int tri_tiles = tiles * (tiles + 1) / 2;
  const int tile = (int)(blockIdx.z % tri_tiles);
  const int64_t chunk = blockIdx.z / tri_tiles;
  const int64_t b = blockIdx.x;
  const Term& t = blockIdx.y == 0 ? o.term[0] : o.term[1];
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  const int tj = tile - ti * (ti + 1) / 2;
  const int row0 = ti * kTile, col0 = tj * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i0 = row0 + ty * 4, j0 = col0 + tx * 4;
  // some output of this thread's 4 x 4 lies on or below the diagonal
  const bool active = i0 < m && j0 < m && j0 <= i0 + 3;
  // a tile on the diagonal stages its columns once
  const bool on_diag = ti == tj;
  // the tile holding [n][n] also sums the masked rows' squares (chunk 0)
  // and counts this chunk's live rows
  const bool corner = ti == tiles - 1 && tj == tiles - 1;

  // this thread's column of the tile's rows (A) and of its columns (B)
  const Column ca = jext_column(t, b, row0 + (threadIdx.x & (kTile - 1)), n);
  const Column cb = jext_column(t, b, col0 + (threadIdx.x & (kTile - 1)), n);

  // this chunk's live rows: ranks [lo, hi) of the object's live rows
  int64_t lo = 0, hi = INT64_MAX;
  if (o.chunks > 1) {
    int64_t live = 0;
    for (int64_t s0 = 0; s0 < t.rows; s0 += kSumsThreads) {
      const int64_t r = s0 + threadIdx.x;
      live += __syncthreads_count(r < t.rows && t.mask[b * t.mask_b + r] != 0);
    }
    lo = live * chunk / o.chunks;
    hi = live * (chunk + 1) / o.chunks;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  float masked_sq = 0.f;
  int64_t rank = 0, taken = 0;   // live rows before the round; rows of this chunk
  for (int64_t s0 = 0; s0 < t.rows; s0 += kSegment) {
    // compact the segment's live rows of this chunk into idx, in row order
    int cnt = 0;
    const int64_t slots = t.rows - s0 < kSegment ? t.rows - s0 : kSegment;
    for (int q = 0; q < (int)((slots + kSumsThreads - 1) / kSumsThreads); ++q) {
      const int64_t r = s0 + q * kSumsThreads + threadIdx.x;
      const bool in = r < t.rows;
      const bool live = in && t.mask[b * t.mask_b + r] != 0;
      if (corner && chunk == 0 && in && !live) {
        const float v = t.rr[b * t.rr_b + r];
        masked_sq = fmaf(v, v, masked_sq);
      }
      const unsigned bal = __ballot_sync(kFull, live);
      if (lane == 0) warp_live[w] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int k = 0; k < kSumsThreads / 32; ++k) {
        const int c = warp_live[k];
        before += k < w ? c : 0;
        total += c;
      }
      const int64_t first = rank > lo ? rank : lo;
      const int64_t my = rank + before + __popc(bal & ((1u << lane) - 1));
      if (live && my >= lo && my < hi) idx[cnt + (int)(my - first)] = (uint16_t)(r - s0);
      const int64_t last = rank + total < hi ? rank + total : hi;
      cnt += last > first ? (int)(last - first) : 0;
      rank += total;
      __syncthreads();   // idx written, warp_live free
    }
    taken += cnt;
    // the tile's columns of kRowChunk rows at a time; the next chunk's loads
    // in flight while this one is summed
    float ra[kLoads], rb[kLoads];
    stage_loads(ca, cb, on_diag, idx, s0, 0, cnt, ra, rb);
    for (int c0 = 0; c0 < cnt; c0 += kRowChunk) {
      const int here = cnt - c0 < kRowChunk ? cnt - c0 : kRowChunk;
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int rr = threadIdx.x / kTile + q * (kSumsThreads / kTile);
        As[rr][threadIdx.x & (kTile - 1)] = ra[q];
        if (!on_diag) Bs[rr][threadIdx.x & (kTile - 1)] = rb[q];
      }
      const float(*Bt)[kTile] = on_diag ? As : Bs;
      __syncthreads();
      if (c0 + kRowChunk < cnt) stage_loads(ca, cb, on_diag, idx, s0, c0 + kRowChunk, cnt, ra, rb);
      if (active) {
        for (int r = 0; r < here; ++r) {
          const float4 a4 = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
          const float4 b4 = *reinterpret_cast<const float4*>(&Bt[r][tx * 4]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
        }
      }
      __syncthreads();   // As, Bs free
    }
  }

  float* out = o.sums + ((b * o.chunks + chunk) * 2 + blockIdx.y) * o.stride;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t j = j0 + c;
      if (i < m && j <= i) out[i * (i + 1) / 2 + j] = acc[a][c];
    }
  }
  if (corner) {
    const float sq = block_sum(masked_sq, red);
    if (threadIdx.x == 0) {
      const int64_t tm = (int64_t)m * (m + 1) / 2;
      out[tm] = sq;
      out[tm + 1] = (float)taken;
    }
  }
}

// one block an object: H, b and the loss from the sums, then Cholesky of
// the augmented matrix [H b; b^T 0] (its last row becomes y = L^-1 b) in
// panels of kPanel columns, and the back substitution L^T x = y
__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const __grid_constant__ Operands o) {
  extern __shared__ __align__(16) float smem[];
  const int n = 7 + (int)o.L, m = n + 1;
  const int64_t b = blockIdx.x;
  const int T = n * (n + 1) / 2, Tm = m * (m + 1) / 2;
  float* pan = smem;                     // (m, kPanel) the panel's L values, row-major
  float* dn = pan + m * kPanel;          // (kPanel, kPanel) the diagonal block's L_ck / L_cc
  float* tri = dn + kPanel * kPanel;     // (Tm,) packed lower triangle of the augmented matrix
  float* diag = tri + Tm;                // (n,) the pivots
  float* xv = diag + n;                  // (n,) y, then x
  float* scal = xv + n;                  // (4,) max(count_s, 1), max(count_r, 1), rsq_s, rsq_r
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const float* base = o.sums + b * o.chunks * 2 * o.stride;

  if (t < 2) {   // per term, chunks in order
    float cnt = 0.f, sq = 0.f, msq = 0.f;
    for (int64_t c = 0; c < o.chunks; ++c) {
      const float* p = base + (c * 2 + t) * o.stride;
      sq = __fadd_rn(sq, p[Tm - 1]);
      msq = __fadd_rn(msq, p[Tm]);
      cnt = __fadd_rn(cnt, p[Tm + 1]);
    }
    scal[t] = fmaxf(cnt, 1.f);
    scal[2 + t] = __fadd_rn(sq, msq);
  }
  __syncthreads();
  const float ns = scal[0], nr = scal[1];
  const float* drot = o.drot + b * 7;
  // the normalized sums over the whole triangle: H = k2 S_s / n_s + k1 S_r / n_r
  // above row n, b = -k2 (J^T r)_s / n_s - k1 (J^T r)_r / n_r in it (b sits
  // in the last row of the sums' triangle); chunks in order
#pragma unroll 4
  for (int e = t; e < Tm - 1; e += kSolveThreads) {
    float s_s = base[e], s_r = base[o.stride + e];
    for (int64_t c = 1; c < o.chunks; ++c) {
      s_s = __fadd_rn(s_s, base[(c * 2) * o.stride + e]);
      s_r = __fadd_rn(s_r, base[(c * 2 + 1) * o.stride + e]);
    }
    const float hs = div_pos(__fmul_rn(o.k2, s_s), ns), hr = div_pos(__fmul_rn(o.k1, s_r), nr);
    tri[e] = e < T ? __fadd_rn(hs, hr) : __fsub_rn(__fsub_rn(0.f, hs), hr);
  }
  if (t == 0) {
    tri[Tm - 1] = 0.f;
    const float sdf_loss = div_pos(scal[2], ns), ren_loss = div_pos(scal[3], nr);
    o.loss[b] = __fadd_rn(__fmul_rn(o.k1, ren_loss), __fmul_rn(o.k2, sdf_loss));
  }
  __syncthreads();
  // then the damping, in the op route's order: k3 on the code diagonal,
  // k4 drot drot^T + I on the pose block, scale_damping at (6, 6); -k3 code
  // and +k4 drot res_rot in b
  for (int i = t; i < n; i += kSolveThreads) {
    float* row = tri + i * (i + 1) / 2;
    if (i >= 7) {
      row[i] = __fadd_rn(row[i], o.k3);
      tri[T + i] = __fsub_rn(tri[T + i], __fmul_rn(o.k3, o.code[b * o.code_b + (i - 7)]));
    } else {
      const float ki = __fmul_rn(o.k4, drot[i]);
      for (int j = 0; j <= i; ++j) row[j] = __fadd_rn(row[j], __fmul_rn(ki, drot[j]));
      row[i] = __fadd_rn(row[i], 1.f);
      if (i == 6) row[6] = __fadd_rn(row[6], o.scale_damping);
      tri[T + i] = __fadd_rn(tri[T + i], __fmul_rn(ki, o.res_rot[b]));
    }
  }
  __syncthreads();

  // Cholesky, right-looking in panels of kPanel columns, three barriers a
  // panel: warp 0 factors the panel's diagonal block (a row a lane, the
  // columns' values passed by shuffles); every row below it then solves
  // for its panel values on its own thread (each value first divided by
  // its pivot, then a chain of FMAs with the block's L_ck / L_cc); the
  // trailing triangle takes the panel's rank-kPanel update, four rows a
  // warp, the columns over the lanes.
  int info = 0;   // thread 0's
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int pw = n - j0 < kPanel ? n - j0 : kPanel;
    if (w == 0) {
      const int i = j0 + lane;
      const bool in = lane < pw;
      const int ri = i * (i + 1) / 2;
      float d[kPanel];
#pragma unroll
      for (int c = 0; c < kPanel; ++c) d[c] = in && c < pw && c <= lane ? tri[ri + j0 + c] : 0.f;
      // a runtime loop over the columns (small code: warp 0 runs it alone)
#pragma unroll 1
      for (int c = 0; c < pw; ++c) {
        float dcv = 0.f;   // this lane's entry of column c
#pragma unroll
        for (int k = 0; k < kPanel; ++k) dcv = k == c ? d[k] : dcv;
        const float dc = __shfl_sync(kFull, dcv, c);
        const float piv = __fsqrt_rn(dc);
        if (lane == 0 && info == 0 && !(dc > 0.f && dc < INFINITY)) info = j0 + c + 1;
        const float q = __fdiv_rn(lane > c ? dcv : 1.f, piv);   // no zero numerator
        dcv = lane == c ? piv : lane > c ? q : dcv;
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const float lkc = __shfl_sync(kFull, dcv, k);
          if (k > c && k < pw && lane >= k) d[k] = fmaf(-dcv, lkc, d[k]);
          if (k == c) d[k] = dcv;
        }
      }
      if (in) {
        float own = 0.f;
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          if (c == lane) own = d[c];
          if (c < lane) tri[ri + j0 + c] = d[c];
        }
        diag[i] = own;
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          const float q = __fdiv_rn(c < lane ? d[c] : 1.f, own);
          dn[lane * kPanel + c] = c < lane ? q : 0.f;
        }
      }
    }
    __syncthreads();
    const int r0 = j0 + pw;
    {
      const int i = r0 + t;
      if (i <= n) {
        const int ri = i * (i + 1) / 2;
        float l[kPanel];
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          const float q = div_pos(tri[ri + j0 + (c < pw ? c : 0)], diag[j0 + (c < pw ? c : 0)]);
          l[c] = c < pw ? q : 0.f;
        }
#pragma unroll
        for (int c = 1; c < kPanel; ++c)
#pragma unroll
          for (int k = 0; k < c; ++k) l[c] = fmaf(-l[k], dn[c * kPanel + k], l[c]);
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          if (c < pw) tri[ri + j0 + c] = l[c];
          pan[i * kPanel + c] = l[c];
        }
      }
    }
    __syncthreads();
    for (int g = r0 + 4 * w; g <= n; g += 4 * kSolveWarps) {
      float p[4][kPanel];
      int row[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        row[r] = (g + r) * (g + r + 1) / 2;
#pragma unroll
        for (int c4 = 0; c4 < kPanel / 4; ++c4) {
          const float4 v = g + r <= n ? reinterpret_cast<const float4*>(pan + (g + r) * kPanel)[c4]
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          p[r][4 * c4] = v.x;
          p[r][4 * c4 + 1] = v.y;
          p[r][4 * c4 + 2] = v.z;
          p[r][4 * c4 + 3] = v.w;
        }
      }
      const int kmax = g + 3 < n ? g + 3 : n;
      for (int k = r0 + lane; k <= kmax; k += 32) {
        float q[kPanel], e[4];
#pragma unroll
        for (int c4 = 0; c4 < kPanel / 4; ++c4) {
          const float4 v = reinterpret_cast<const float4*>(pan + k * kPanel)[c4];
          q[4 * c4] = v.x;
          q[4 * c4 + 1] = v.y;
          q[4 * c4 + 2] = v.z;
          q[4 * c4 + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) e[r] = g + r <= n && k <= g + r ? tri[row[r] + k] : 0.f;
#pragma unroll
        for (int c = 0; c < kPanel; ++c)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (c < pw) e[r] = fmaf(-p[r][c], q[c], e[r]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (g + r <= n && k <= g + r) tri[row[r] + k] = e[r];
      }
    }
    __syncthreads();
  }

  // L^T x = y (y: the augmented row) as D^-1 L^T (D x) = D^-1 y: first
  // every row of L divided by its pivot, in parallel; then u = D x, 32 rows
  // at a time from the bottom, warp 0 solving the block's triangle (lane l
  // holding column i0 + l of the block's rows) and every thread taking the
  // block's rows out of the rows above it, with no division in the chain;
  // then x = u / D
  for (int i = w; i < n; i += kSolveWarps) {
    float* row = tri + i * (i + 1) / 2;
    const float piv = diag[i];
    for (int k = lane; k < i; k += 32) row[k] = div_pos(row[k], piv);
  }
  for (int k = t; k < n; k += kSolveThreads) xv[k] = tri[T + k];
  __syncthreads();
  for (int i1 = n; i1 > 0;) {
    const int i0 = i1 > 32 ? i1 - 32 : 0, h = i1 - i0;
    if (w == 0) {
      float v = lane < h ? xv[i0 + lane] : 0.f;
#pragma unroll 4
      for (int s = h - 1; s >= 0; --s) {
        const float lc = lane < s ? tri[(i0 + s) * (i0 + s + 1) / 2 + i0 + lane] : 0.f;
        const float us = __shfl_sync(kFull, v, s);
        if (lane < s) v = fmaf(-lc, us, v);
      }
      if (lane < h) xv[i0 + lane] = v;
    }
    __syncthreads();
    for (int k = t; k < i0; k += kSolveThreads) {
      float s = xv[k];
      for (int ii = i1 - 1; ii >= i0; --ii) s = fmaf(-tri[ii * (ii + 1) / 2 + k], xv[ii], s);
      xv[k] = s;
    }
    __syncthreads();
    i1 = i0;
  }
  for (int k = t; k < n; k += kSolveThreads) xv[k] = div_pos(xv[k], diag[k]);
  for (int k = t; k < n; k += kSolveThreads) o.dx[b * n + k] = xv[k];
  if (t == 0) o.info[b] = info;
}

// raw: B, L, chunks, stride; per term jac_pose, pose_b, pose_r, jac_code,
// code_b, code_r, mask, mask_b, rr, rr_b, rows; then code, code_b, drot,
// res_rot, sums, dx, info, loss (pointers as int64)
constexpr int kTermFields = 11;
constexpr int kFields = 4 + 2 * kTermFields + 8;

Operands read_operands(const int64_t* raw, const float* k) {
  Operands o;
  int f = 0;
  o.B = raw[f++];
  o.L = raw[f++];
  o.chunks = raw[f++];
  o.stride = raw[f++];
  for (int t = 0; t < 2; ++t) {
    Term& m = o.term[t];
    m.jac_pose = (const float*)(uintptr_t)raw[f++];
    m.pose_b = raw[f++];
    m.pose_r = raw[f++];
    m.jac_code = (const float*)(uintptr_t)raw[f++];
    m.code_b = raw[f++];
    m.code_r = raw[f++];
    m.mask = (const uint8_t*)(uintptr_t)raw[f++];
    m.mask_b = raw[f++];
    m.rr = (const float*)(uintptr_t)raw[f++];
    m.rr_b = raw[f++];
    m.rows = raw[f++];
  }
  o.code = (const float*)(uintptr_t)raw[f++];
  o.code_b = raw[f++];
  o.drot = (const float*)(uintptr_t)raw[f++];
  o.res_rot = (const float*)(uintptr_t)raw[f++];
  o.sums = (float*)(uintptr_t)raw[f++];
  o.dx = (float*)(uintptr_t)raw[f++];
  o.info = (int32_t*)(uintptr_t)raw[f++];
  o.loss = (float*)(uintptr_t)raw[f++];
  o.k1 = k[0];
  o.k2 = k[1];
  o.k3 = k[2];
  o.k4 = k[3];
  o.scale_damping = k[4];
  return o;
}

int tiles_of(int64_t n) { return (int)((n + 1 + kTile - 1) / kTile); }

}  // namespace

// op 0: the sums (one launch), op 1: the solve (one launch), on `stream`.
// raw (kFields,) int64 as above, k (5,): k1, k2, k3, k4, scale_damping.
// Every tensor is f32 (the mask bool) on one card with unit stride on its
// last axis; the caller allocated sums (B, chunks, 2, stride), dx (B, n),
// info (B,) int32 and loss (B,).  B = 0 launches nothing.  Returns the
// launch's CUDA error, else 0.
extern "C" int normal_solve_launch(const int64_t* raw, int n_fields, const float* k, int n_k,
                                   int op, void* stream) {
  if (n_fields != kFields || n_k != 5 || (op != 0 && op != 1)) return (int)cudaErrorInvalidValue;
  const Operands o = read_operands(raw, k);
  const int64_t n = 7 + o.L;
  if (o.L < 0 || n > kMaxWidth || o.B < 0 || o.chunks < 1 || o.stride != sums_stride(n))
    return (int)cudaErrorInvalidValue;
  if (o.term[0].rows < 0 || o.term[1].rows < 0) return (int)cudaErrorInvalidValue;
  if (o.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) {
    const int tiles = tiles_of(n);
    const int64_t z = (int64_t)tiles * (tiles + 1) / 2 * o.chunks;
    if (z > 65535) return (int)cudaErrorInvalidValue;
    sums_kernel<<<dim3((unsigned)o.B, 2, (unsigned)z), kSumsThreads, 0, s>>>(o, tiles);
  } else {
    const int bytes = (int)solve_smem_bytes(n);
    static int set_bytes[64] = {0};   // the attribute set so far, by device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64 && set_bytes[dev] < bytes) {
      err = cudaFuncSetAttribute(solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      set_bytes[dev] = kMaxSmem;
    }
    solve_kernel<<<(unsigned)o.B, kSolveThreads, bytes, s>>>(o);
  }
  return (int)cudaGetLastError();
}

// The sizes the wrapper allocates and launches with, at n unknowns and B
// objects: out[0] the sums' floats a (object, chunk, term), out[1] the place
// of the live count among them, out[2] the parts each object's live rows
// are split into (enough sums blocks, B objects x 2 terms x the triangle's
// tiles, to fill the card twice; 1 at 128 objects, 6 at 8 objects of 71
// unknowns), out[3] the widest system the solve holds.  Returns 0, or
// cudaErrorInvalidValue for n < 1 or B < 0.
extern "C" int normal_solve_sizes(int64_t n, int64_t B, int64_t* out) {
  if (n < 1 || B < 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  const int64_t blocks = B * 2 * tiles * (tiles + 1) / 2;
  const int64_t want = (kTargetBlocks + (blocks > 1 ? blocks : 1) - 1) / (blocks > 1 ? blocks : 1);
  out[0] = sums_stride(n);
  out[1] = (n + 1) * (n + 2) / 2 + 1;
  out[2] = want < 1 ? 1 : want > kMaxChunks ? kMaxChunks : want;
  out[3] = kMaxWidth;
  return 0;
}
