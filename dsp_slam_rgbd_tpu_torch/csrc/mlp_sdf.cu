// Fused DeepSDF decoder kernels for Hopper (sm_90a) in f32, the parity
// mode: the 9-layer cars_64 MLP forward, and forward + input Jacobian, over
// rows of [code 64 | xyz 3].  The bf16 (production) mode runs on the tensor
// cores in mlp_sdf_value_tc.cu and mlp_sdf_jacobian_tc.cu; this file also
// holds the C interface that routes a launch to either.
//
// Replaces, for f32 operands, the two Pallas TPU kernels of
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:
//   mlp_sdf_jacobian  <- _make_kernel        (value + d sdf / d[code, xyz])
//   mlp_sdf_value     <- _make_value_kernel  (value only)
//
// What bounds it on this card: operations.  One row costs 3.67 MFLOP
// forward (7.34 MFLOP with the Jacobian) against 12 input bytes, and the
// 8.4 MB f32 weight stack is read from device memory once and from L2
// after that, far above the card's ~295 FLOP/byte ridge.  Tensor cores
// have no full-f32 product, so the f32 FMA pipes' rate (67 TFLOP/s on an
// H100 SXM) is the ceiling.
//
// What the design does about it:
//   * The TPU kept the whole weight stack resident in VMEM.  A block here
//     has at most 227 KB of shared memory, so the weights stay L2-resident
//     and are streamed through shared memory in chunks of KC rows, with
//     the next chunk prefetched into registers while the current one is
//     multiplied.
//   * A block owns BM = 32 rows.  Their activations (and in the backward
//     sweep, the running gradient) live in shared memory for the whole
//     sweep, stored k-major so one thread reads its rows as two float4;
//     each thread accumulates an 8 x 8 output tile in registers, and
//     writes it back over the same buffer after a barrier, so no
//     ping-pong buffer is needed.
//   * The backward sweep needs only the ReLU masks from the forward: they
//     are kept as bits (one warp ballot per 32 outputs), 16 KB per block.
//   * g W^T reads rows of W that are contiguous in the reduced "out"
//     index: the stager reads those row segments and writes them
//     transposed into shared memory.
//   * Products are f32 FMA with f32 accumulation, bias and ReLU, as the
//     Pallas kernel's `_forward` and `dot_t` at HIGHEST precision.
//   * Layer 8 has one real output column, so its forward is a per-row
//     dot product and its backward a rank-1 product, not a padded
//     512 x 512 GEMM.
//   * Codes are read per row as code[row / rows_per_code]: one launch
//     covers a batch of objects (rows_per_code = points per object), a
//     shared code (rows_per_code = n) or per-row codes (rows_per_code = 1),
//     without materialising packed input rows.  The last tile is masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 512;        // hidden width
constexpr int CODE = 64;      // latent size
constexpr int IN_DIM = 67;    // code + xyz
constexpr int SPLIT = 445;    // layer-3 real output width (D - IN_DIM)
constexpr int K0 = 80;        // layer-0 depth: IN_DIM padded to a multiple of KC
constexpr int BM = 32;        // rows per block
constexpr int NT = 256;       // threads per block
constexpr int KC = 8;         // weight rows staged per chunk
constexpr int WS_LD = D + 4;  // staged-chunk row stride (floats), keeps float4 alignment
constexpr int N_MASK_WORDS = BM * D / 32;  // ReLU-mask words per layer

// Thread tiling of a (BM x NOUT) product: each thread owns TM rows and
// 8 columns, 4 at cg*4 and 4 at NOUT/2 + cg*4.
template <int NOUT>
struct Tile {
  static constexpr int CG = NOUT / 8;
  static constexpr int RG = NT / CG;
  static constexpr int TM = BM / RG;
  static_assert(CG * RG == NT && TM * RG == BM, "bad tiling");
};

__device__ __forceinline__ int tile_col(int cg, int j, int nout) {
  return j < 4 ? cg * 4 + j : nout / 2 + cg * 4 + (j - 4);
}

// acc[m][j] = sum_k A[k][row0 + m] * B[k][col(j)] over k < K, where A is
// the block's k-major shared operand (leading dimension BM) and B is
//   TRANS = false:  B[k][n] = W[k * D + n]    (forward, x W)
//   TRANS = true:   B[k][n] = W[n * D + k]    (backward, g W^T)
// streamed through Ws in chunks of KC rows.  Starts and ends with a
// barrier-free Ws; the caller syncs before overwriting A.
template <int NOUT, bool TRANS>
__device__ __forceinline__ void gemm(const float* __restrict__ A, int K,
                                     const float* __restrict__ W, float* Ws,
                                     float (&acc)[Tile<NOUT>::TM][8]) {
  using T = Tile<NOUT>;
  constexpr int VN = 4;                            // floats per 16-byte vector
  constexpr int NVEC = KC * NOUT / VN;             // vectors per chunk
  constexpr int PER = (NVEC + NT - 1) / NT;        // per thread
  constexpr int VPR = KC / VN > 0 ? KC / VN : 1;   // TRANS: vectors per W row segment
  static_assert(!TRANS || KC % VN == 0, "chunk must hold whole vectors");
  const int t = threadIdx.x;
  const int cg = t % T::CG;
  const int row0 = (t / T::CG) * T::TM;

#pragma unroll
  for (int m = 0; m < T::TM; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  uint4 pre[PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int v = t + p * NT;
      if (v < NVEC) {
        const float* src;
        if constexpr (TRANS) {
          src = W + (v / VPR) * D + k0 + (v % VPR) * VN;
        } else {
          const int e = v * VN;
          src = W + (k0 + e / NOUT) * D + e % NOUT;
        }
        pre[p] = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int v = t + p * NT;
      if (v < NVEC) {
        const float f[VN] = {__uint_as_float(pre[p].x), __uint_as_float(pre[p].y),
                             __uint_as_float(pre[p].z), __uint_as_float(pre[p].w)};
        if constexpr (TRANS) {
          const int n = v / VPR, kk = (v % VPR) * VN;
#pragma unroll
          for (int q = 0; q < VN; ++q) Ws[(kk + q) * WS_LD + n] = f[q];
        } else {
          const int e = v * VN;
          float* dst = Ws + (e / NOUT) * WS_LD + e % NOUT;
#pragma unroll
          for (int q = 0; q < VN; ++q) dst[q] = f[q];
        }
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // Ws free; the caller's writes to A visible
    stage();
    __syncthreads();
    if (k0 + KC < K) fetch(k0 + KC);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[T::TM];
      const float* ap = A + (k0 + kk) * BM + row0;
      if constexpr (T::TM % 4 == 0) {
#pragma unroll
        for (int m = 0; m < T::TM; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ap + m);
          a[m] = v.x; a[m + 1] = v.y; a[m + 2] = v.z; a[m + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < T::TM; ++m) a[m] = ap[m];
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Ws + kk * WS_LD + cg * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Ws + kk * WS_LD + NOUT / 2 + cg * 4);
#pragma unroll
      for (int m = 0; m < T::TM; ++m) {
        acc[m][0] = fmaf(a[m], b0.x, acc[m][0]);
        acc[m][1] = fmaf(a[m], b0.y, acc[m][1]);
        acc[m][2] = fmaf(a[m], b0.z, acc[m][2]);
        acc[m][3] = fmaf(a[m], b0.w, acc[m][3]);
        acc[m][4] = fmaf(a[m], b1.x, acc[m][4]);
        acc[m][5] = fmaf(a[m], b1.y, acc[m][5]);
        acc[m][6] = fmaf(a[m], b1.z, acc[m][6]);
        acc[m][7] = fmaf(a[m], b1.w, acc[m][7]);
      }
    }
  }
}

// Shared-memory layout (floats / words):
//   act   [D][BM]        activations, later the running gradient (k-major)
//   xin   [K0][BM]       raw input rows (k-major); in the backward sweep,
//                        the layer-4 re-injection gradient
//   ws    [KC][WS_LD]    staged weight chunk
//   sdf   [BM]
//   masks [8][BM*D/32]   ReLU masks as ballot words (Jacobian kernel only)
constexpr size_t SMEM_VALUE =
    sizeof(float) * (size_t(D) * BM + K0 * BM + KC * WS_LD + BM);
constexpr size_t SMEM_JAC = SMEM_VALUE + sizeof(uint32_t) * 8 * N_MASK_WORDS;

// Mask word of (row, j) for the thread tiling of Tile<D>: the 32 lanes of a
// warp share their rows and hold 32 consecutive column groups.
__device__ __forceinline__ int mask_word(int row, int j, int cg) {
  return ((row * 8 + j) * 2 + cg / 32);
}

template <bool JAC>
__global__ void __launch_bounds__(NT, 2)
    mlp_sdf_kernel(const float* __restrict__ code, int rows_per_code,
                   const float* __restrict__ xyz, int n,
                   const float* __restrict__ w0, const float* __restrict__ W,
                   const float* __restrict__ bias, float* __restrict__ sdf_out,
                   float* __restrict__ grad_out) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* xin = act + D * BM;
  float* ws = xin + K0 * BM;
  float* sdf_s = ws + KC * WS_LD;
  uint32_t* masks = reinterpret_cast<uint32_t*>(sdf_s + BM);

  using T = Tile<D>;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int cg = t % T::CG;
  const int row0 = (t / T::CG) * T::TM;
  const int base = blockIdx.x * BM;

  // ---- input rows [code | xyz | 0], k-major
  for (int e = t; e < K0 * BM; e += NT) {
    const int k = e / BM, r = e % BM, g = base + r;
    float v = 0.f;
    if (g < n) {
      if (k < CODE) v = code[(g / rows_per_code) * CODE + k];
      else if (k < IN_DIM) v = xyz[g * 3 + (k - CODE)];
    }
    xin[e] = v;
  }

  // ---- forward: layers 0..7 with ReLU, re-injection into layer 4's input
  float acc[T::TM][8];
  for (int layer = 0; layer < 8; ++layer) {
    if (layer == 0) {
      gemm<D, false>(xin, K0, w0, ws, acc);
    } else {
      gemm<D, false>(act, D, W + size_t(layer - 1) * D * D, ws, acc);
    }
    __syncthreads();  // every read of act is done
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = row0 + m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(cg, j, D);
        const float p = acc[m][j] + bias[layer * D + c];
        float h = p > 0.f ? p : 0.f;
        if (layer == 3 && c >= SPLIT) h = xin[(c - SPLIT) * BM + r];  // latent re-injection
        act[c * BM + r] = h;
        if constexpr (JAC) {
          const uint32_t word = __ballot_sync(0xffffffffu, p > 0.f);
          if (lane == 0) masks[layer * N_MASK_WORDS + mask_word(r, j, cg)] = word;
        }
      }
    }
    __syncthreads();
  }

  // ---- layer 8: one real output column -> per-row dot product, tanh
  const float* w8 = W + size_t(7) * D * D;  // w8[k * D + 0]
  float w8c[D / 32];
#pragma unroll
  for (int q = 0; q < D / 32; ++q) w8c[q] = w8[(lane + 32 * q) * D];
  for (int r = warp; r < BM; r += NT / 32) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < D / 32; ++q) s = fmaf(act[(lane + 32 * q) * BM + r], w8c[q], s);
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float v = tanhf(s + bias[8 * D]);
      sdf_s[r] = v;
      if (base + r < n) sdf_out[base + r] = v;
    }
  }
  if constexpr (!JAC) return;
  __syncthreads();

  // ---- backward, step 8: g = (1 - sdf^2) e_0, gin = g W8^T (rank 1)
#pragma unroll
  for (int m = 0; m < T::TM; ++m) {
    const int r = row0 + m;
    const float s = sdf_s[r];
    const float g = 1.f - s * s;
    const uint32_t* mk = masks + 7 * N_MASK_WORDS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(cg, j, D);
      const bool on = (mk[mask_word(r, j, cg)] >> lane) & 1u;
      act[c * BM + r] = on ? g * w8[c * D] : 0.f;
    }
  }

  // ---- steps 7..1: gin = g W_i^T, masked by layer i-1's ReLU
  for (int layer = 7; layer >= 1; --layer) {
    gemm<D, true>(act, D, W + size_t(layer - 1) * D * D, ws, acc);
    __syncthreads();
    const uint32_t* mk = masks + (layer - 1) * N_MASK_WORDS;
#pragma unroll
    for (int m = 0; m < T::TM; ++m) {
      const int r = row0 + m;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(cg, j, D);
        float g = acc[m][j];
        if (layer == 4 && c >= SPLIT) {
          // columns >= SPLIT of layer 4's input are the raw input
          xin[(c - SPLIT) * BM + r] = g;
          g = 0.f;
        }
        const bool on = (mk[mask_word(r, j, cg)] >> lane) & 1u;
        act[c * BM + r] = on ? g : 0.f;
      }
    }
  }

  // ---- layer 0: d/d input = g W0^T + re-injection gradient
  using T0 = Tile<128>;
  float acc0[T0::TM][8];
  gemm<128, true>(act, D, w0, ws, acc0);
  const int cg0 = t % T0::CG;
  const int r00 = (t / T0::CG) * T0::TM;
#pragma unroll
  for (int m = 0; m < T0::TM; ++m) {
    const int r = r00 + m;
    if (base + r >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(cg0, j, 128);
      if (c < IN_DIM)
        grad_out[size_t(base + r) * IN_DIM + c] = acc0[m][j] + xin[c * BM + r];
    }
  }
}

template <bool JAC>
int launch(const void* code, int rows_per_code, const void* xyz, int n,
           const void* w0, const void* W, const void* b, void* sdf, void* grad,
           void* stream) {
  auto kern = mlp_sdf_kernel<JAC>;
  const size_t smem = JAC ? SMEM_JAC : SMEM_VALUE;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (n + BM - 1) / BM;
  kern<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(code), rows_per_code,
      static_cast<const float*>(xyz), n, static_cast<const float*>(w0),
      static_cast<const float*>(W), static_cast<const float*>(b),
      static_cast<float*>(sdf), static_cast<float*>(grad));
  return int(cudaGetLastError());
}

}  // namespace

// The bf16 kernels, on the tensor cores (mlp_sdf_value_tc.cu,
// mlp_sdf_jacobian_tc.cu).
int mlp_sdf_value_tc(const void* code, int rows_per_code, const void* xyz, int n,
                     const void* tiles, const void* W, const void* b, void* sdf, void* stream);
int mlp_sdf_jacobian_tc(const void* code, int rows_per_code, const void* xyz, int n,
                        const void* fwd, const void* bwd, const void* W, const void* b,
                        void* sdf, void* grad, void* relu, void* stream);

// C interface, bound with ctypes.  code (C, 64) f32, row g uses code
// row g / rows_per_code; xyz (n, 3) f32; w0 (128, 512), W (8, 512, 512)
// in f32 (bf16 = 0) or bf16 (bf16 = 1); b (9, 512) f32.  Outputs
// sdf (n,) f32 and, for the Jacobian, grad (n, 67) f32.  Returns the
// launch's cudaError_t.  n > 0.  In bf16 the kernels read their weights
// from the host-packed streams, pack_value_tiles(w0, W) (tiles, fwd) and
// pack_backward_tiles(w0, W) (bwd), and only layer 8's column from W, and
// the Jacobian can report the ReLU masks it took into relu ((n, 8, 512)
// uint8, or null); in f32 the streams and relu are unused.
extern "C" int mlp_sdf_value(const void* code, int rows_per_code, const void* xyz,
                             int n, const void* w0, const void* W, const void* b,
                             int bf16, const void* tiles, void* sdf, void* stream) {
  return bf16 ? mlp_sdf_value_tc(code, rows_per_code, xyz, n, tiles, W, b, sdf, stream)
              : launch<false>(code, rows_per_code, xyz, n, w0, W, b, sdf, nullptr, stream);
}

extern "C" const char* mlp_sdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int mlp_sdf_jacobian(const void* code, int rows_per_code, const void* xyz,
                                int n, const void* w0, const void* W, const void* b,
                                int bf16, const void* fwd, const void* bwd, void* sdf,
                                void* grad, void* relu, void* stream) {
  return bf16 ? mlp_sdf_jacobian_tc(code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                    relu, stream)
              : launch<true>(code, rows_per_code, xyz, n, w0, W, b, sdf, grad, stream);
}
