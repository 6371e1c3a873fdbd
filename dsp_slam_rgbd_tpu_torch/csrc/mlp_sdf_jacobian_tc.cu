// Tensor-core value + input Jacobian of the fused DeepSDF decoder, bf16,
// for Hopper (sm_90a): the 9-layer cars_64 MLP forward over rows of
// [code 64 | xyz 3], then d sdf / d[code, xyz] by one reverse sweep.
//
// Replaces, for bf16 operands, the Pallas TPU kernel
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py::_make_kernel.  The f32 parity
// mode stays on the FMA kernel of mlp_sdf.cu: tensor cores have no full-f32
// product.
//
// What bounds it on this card: operations.  One row costs 7.34 MFLOP of
// real work (forward and backward) against 12 input and 272 output bytes;
// the weights (two 3.8 MB bf16 streams) stay L2-resident.  The products run
// on the tensor cores (wgmma), whose bf16 rate (989 TFLOP/s dense) is the
// ceiling.  At the main path's sizes (32 and 128 blocks, under one wave)
// what holds it back is the serial chain of 122 weight stages each block
// streams: one block's time, whatever the row count.
//
// Design (bring-up stage 3 of 3):
//   * A block owns BM = 64 rows, one wgmma M, and has three warpgroups:
//     two consumers and one producer.  setmaxnreg moves registers from the
//     producer (40 a thread) to the consumers (232).
//   * Forward: the value kernel's (mlp_sdf_value_tc.cu), on the same
//     ring, set-up and K loop (mlp_sdf_tc.cuh).  Consumer j
//     computes outputs 256j..256j+255 of every layer with wgmma m64n256k16
//     into a 64 x 256 f32 accumulator; bf16 activations stay in 128-byte-
//     swizzled shared memory and are updated in place behind a named
//     barrier; the epilogue adds the bias, applies ReLU, rounds to bf16
//     (RNE), re-injects the input before layer 4, and keeps each layer's
//     ReLU mask as bits in the order of the thread's accumulator fragment
//     (4 words a thread); layer 8 is a per-row dot product and tanh.
//   * Backward: g = (1 - sdf^2) W8[:, 0] under layer 7's mask, written
//     elementwise (a rank-1 product); then g W[i-1]^T for i = 7..1, the
//     same in-place wgmma sweep over g.  Output column c of step i is
//     column c of layer i-1's output, held in the same fragment position in
//     the forward, so each thread reads back only its own mask words.  The
//     epilogue applies layer i-1's mask and rounds g to bf16 (RNE); at step
//     4 columns 445..511 (all in consumer 1's half) go to the output, f32
//     and unmasked (the re-injection gradient), and to 0 in g.  The last
//     product g w0^T has 128 outputs: consumer j takes 64j..64j+63 with
//     m64n64k16 and adds columns < 67 to the re-injection gradient.
//   * Weights are host-packed streams of stages in the exact shared-memory
//     order the B descriptor reads, 64 K values an output row, 128-byte
//     swizzled: the forward's (`pack_value_tiles`) and the backward's
//     (`pack_backward_tiles`: W[6]^T..W[0]^T, then w0^T in 16 KB stages),
//     122 stages in all.  One producer thread streams them through a ring
//     of NSLOT slots, one bulk asynchronous copy (cp.async.bulk) per stage,
//     completed on the slot's "full" mbarrier; each consumer warp arrives on
//     the slot's "empty" mbarrier once its wgmma reads are done.  The ring
//     runs across layer boundaries and from the forward into the backward.
//   * Codes are read per row as code[row / rows_per_code]; the last tile
//     is masked.  On request the kernel writes out the masks it took, so a
//     check can hold its reverse sweep to the plain one without ReLU ties.
//
// Shared memory (231,712 of the 232,448 B a block may have): 16 KB input
// rows, 64 KB activations (later g), two 64 KB ring slots, 16 KB for the
// ReLU masks of layers 0..3 (those of layers 4..7 go to the input buffer,
// free once layer 3's epilogue has re-injected it), 1 KB layer-8 column
// (bf16), 256 B sdf, four mbarriers, 1 KB alignment slack.
#include "mlp_sdf_tc.cuh"

namespace {

constexpr int STAGE = 3;                     // bring-up stage of this kernel
constexpr int W0T_STAGE_BYTES = KC * K0 * 2;   // 16 KB: one K chunk of w0^T
constexpr int BWD_W_STAGES = 7 * (D / KC);     // 56 stages of W[6]^T..W[0]^T
constexpr int N_STAGES = FWD_STAGES + BWD_W_STAGES + D / KC;  // 122, the last 8 of w0^T
constexpr int MASK_LAYER_WORDS = 4 * NCONS;    // one layer's ReLU mask: 4 KB
constexpr size_t SMEM = 1024 /* alignment slack */ + XIN_BYTES + ACT_BYTES + RING_BYTES +
                        4 * MASK_LAYER_WORDS * 4 + D * 2 + BM * 4 + BAR_BYTES;
static_assert(SMEM <= 232448, "shared memory of one block");

// Stage s of the weight stream: its source and its bytes.
__device__ __forceinline__ const uint8_t* stage_src(int s, const uint8_t* fwd, const uint8_t* bwd,
                                                    uint32_t* bytes) {
  *bytes = STAGE_BYTES;
  if (s < FWD_STAGES) return fwd + size_t(s) * STAGE_BYTES;
  if (s < FWD_STAGES + BWD_W_STAGES) return bwd + size_t(s - FWD_STAGES) * STAGE_BYTES;
  *bytes = W0T_STAGE_BYTES;
  return bwd + size_t(BWD_W_STAGES) * STAGE_BYTES +
         size_t(s - FWD_STAGES - BWD_W_STAGES) * W0T_STAGE_BYTES;
}

// Backward step 8, elementwise: g[r][c] = bf16((1 - sdf_r^2) w8[c]) where
// layer 7's mask is set, else 0 (1 - sdf^2 rounded to bf16 first, so the
// product is exact in f32), for the fragment positions of columns c0..c0+255.
__device__ __forceinline__ void start_backward(uint8_t* out, int c0, int t, const uint32_t* mk,
                                               const float* sdf_s, const __nv_bfloat16* w8s) {
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int sw = r0 & 7;
  uint8_t* row = out + (c0 >> 6) * ATOM_BYTES + r0 * 128 + (lane & 3) * 4;
  const __nv_bfloat16* wc = w8s + c0 + 2 * (lane & 3);
  float gs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = sdf_s[r0 + 8 * h];
    // no FMA contraction: 1 - sdf^2 rounds as the plain version's does
    gs[h] = __bfloat162float(__float2bfloat16_rn(__fsub_rn(1.f, __fmul_rn(s, s))));
  }
  uint32_t words[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) words[q] = mk[q * NCONS];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float w0 = __bfloat162float(wc[8 * j]), w1 = __bfloat162float(wc[8 * j + 1]);
    uint8_t* p = row + (j >> 3) * ATOM_BYTES + (((j & 7) ^ sw) << 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i0 = 4 * j + 2 * h;
      const float v0 = (words[j >> 3] >> (i0 & 31)) & 1u ? gs[h] * w0 : 0.f;
      const float v1 = (words[j >> 3] >> ((i0 + 1) & 31)) & 1u ? gs[h] * w1 : 0.f;
      *reinterpret_cast<uint32_t*>(p + h * 8 * 128) = pack_bf16x2(v0, v1);
    }
  }
}

// Backward steps 7..1: the fragment of g W[i-1]^T for columns c0..c0+255,
// masked by layer i-1's ReLU (mask words as the forward epilogue wrote
// them), rounded to bf16, into the swizzled buffer out.  At step 4
// (STEP4), columns >= SPLIT are the raw input's: their f32 values go to
// grad[row][c - SPLIT] and 0 goes to out.
template <bool STEP4>
__device__ __forceinline__ void backward_epilogue(const float (&d)[128], uint8_t* out, int c0,
                                                  int t, const uint32_t* mk,
                                                  float* __restrict__ grad, int n, int base) {
  asm volatile("" : "+r"(t), "+l"(out), "+l"(mk));
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int sw = r0 & 7;
  uint8_t* row = out + (c0 >> 6) * ATOM_BYTES + r0 * 128 + (lane & 3) * 4;
  uint32_t words[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) words[q] = mk[q * NCONS];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    uint8_t* p = row + (j >> 3) * ATOM_BYTES + (((j & 7) ^ sw) << 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i0 = 4 * j + 2 * h;
      float v0 = (words[j >> 3] >> (i0 & 31)) & 1u ? d[i0] : 0.f;
      float v1 = (words[j >> 3] >> ((i0 + 1) & 31)) & 1u ? d[i0 + 1] : 0.f;
      const int c = c0 + 8 * j + 2 * (lane & 3);
      if (STEP4 && c + 1 >= SPLIT) {  // re-injection gradient
        const int g = base + r0 + 8 * h;
        if (c >= SPLIT) {
          if (g < n) grad[size_t(g) * IN_DIM + (c - SPLIT)] = d[i0];
          v0 = 0.f;
        }
        if (g < n) grad[size_t(g) * IN_DIM + (c + 1 - SPLIT)] = d[i0 + 1];
        v1 = 0.f;
      }
      *reinterpret_cast<uint32_t*>(p + h * 8 * 128) = pack_bf16x2(v0, v1);
    }
  }
}

// The last product g w0^T, fragment of output columns c0..c0+63: columns
// < IN_DIM of the block's rows < n are added to the re-injection gradient
// already in grad.
__device__ __forceinline__ void output_epilogue(const float (&d)[32], int c0, int t,
                                                float* __restrict__ grad, int n, int base) {
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * (lane & 3) + e, g = base + r0 + 8 * h;
        if (c < IN_DIM && g < n) grad[size_t(g) * IN_DIM + c] += d[4 * j + 2 * h + e];
      }
}

// Check output: every ReLU mask bit of the block's rows < n as one byte,
// relu[row][layer][column] (1 where the pre-activation was > 0), read back
// from the fragment-ordered words of consumer thread t (tw in its
// warpgroup j).
__device__ void dump_masks(const uint32_t* mask_lo, const uint32_t* mask_hi,
                           uint8_t* __restrict__ relu, int n, int base, int t) {
  const int j = t / 128, tw = t % 128, lane = tw & 31;
  const int r0 = 16 * (tw >> 5) + (lane >> 2);
  for (int layer = 0; layer < 8; ++layer)
    for (int q = 0; q < 4; ++q) {
      const uint32_t w =
          (layer < 4 ? mask_lo : mask_hi)[(layer % 4) * MASK_LAYER_WORDS + q * NCONS + t];
      for (int b = 0; b < 32; ++b) {
        const int i = 32 * q + b, g = base + r0 + 8 * ((i >> 1) & 1);
        const int c = j * NH + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (g < n) relu[(size_t(g) * 8 + layer) * D + c] = (w >> b) & 1u;
      }
    }
}

__global__ void __launch_bounds__(NT, 1)
    mlp_sdf_jacobian_tc_kernel(const float* __restrict__ code, int rows_per_code,
                               const float* __restrict__ xyz, int n,
                               const uint8_t* __restrict__ fwd, const uint8_t* __restrict__ bwd,
                               const __nv_bfloat16* __restrict__ W,
                               const float* __restrict__ bias, float* __restrict__ sdf,
                               float* __restrict__ grad, uint8_t* __restrict__ relu) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xin = smem_base(smem_raw);  // input rows (layer 0's A), then masks 4..7
  uint8_t* act = xin + XIN_BYTES;      // activations, then g, updated in place
  uint8_t* ring = act + ACT_BYTES;     // NSLOT weight stages
  uint32_t* mask_lo = reinterpret_cast<uint32_t*>(ring + RING_BYTES);  // masks 0..3
  uint32_t* mask_hi = reinterpret_cast<uint32_t*>(xin);
  __nv_bfloat16* w8s = reinterpret_cast<__nv_bfloat16*>(mask_lo + 4 * MASK_LAYER_WORDS);
  float* sdf_s = reinterpret_cast<float*>(w8s + D);
  const uint32_t full = smem_u32(sdf_s + BM);  // the ring's mbarriers
  const int t = threadIdx.x;
  const int base = blockIdx.x * BM;
  ring_init(full, t);

  // warpgroup index, uniform across each warp, so that ptxas can apply
  // setmaxnreg to each role's code
  const int role = __shfl_sync(0xffffffffu, t / 128, 0);
  if (role == NCONS / 128) {
    produce(N_STAGES, [=](int s, uint32_t* bytes) { return stage_src(s, fwd, bwd, bytes); },
            ring, full, t);
    return;
  }

  // ---- two consumer warpgroups: warpgroup j computes outputs
  // 256j..256j+255 of every product for all 64 rows
  consumer_start(xin, w8s, code, rows_per_code, xyz, n, base, W, t);
  const int j = t / 128, tw = t % 128;

  // this thread's mask words of a layer (word q at [q * NCONS])
  auto mask_of = [&](int layer) {
    return (layer < 4 ? mask_lo : mask_hi) + (layer % 4) * MASK_LAYER_WORDS + t;
  };
  int s = 0;  // next stage of the ring

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;

  // ---- forward
  for (int layer = 0; layer < 8; ++layer) {
    product(d, layer == 0 ? xin : act, layer == 0 ? K0 / KC : D / KC, ring, full,
            j * HALF_BYTES, t, s);
    if (layer == 3)
      epilogue<true, true>(d, act, xin, bias + layer * D, j * NH, tw, mask_of(layer));
    else
      epilogue<false, true>(d, act, xin, bias + layer * D, j * NH, tw, mask_of(layer));
    fence_proxy_async();
    named_sync<NCONS>();
  }
  head(act, w8s, bias[8 * D], sdf, n, base, t, sdf_s);
  named_sync<NCONS>();

  // ---- backward, step 8: the rank-1 start under layer 7's mask
  start_backward(act, j * NH, tw, mask_of(7), sdf_s, w8s);
  fence_proxy_async();
  named_sync<NCONS>();

  // ---- steps 7..1: g W[i-1]^T under layer i-1's mask
  for (int i = 7; i >= 1; --i) {
    product(d, act, D / KC, ring, full, j * HALF_BYTES, t, s);
    if (i == 4)
      backward_epilogue<true>(d, act, j * NH, tw, mask_of(i - 1), grad, n, base);
    else
      backward_epilogue<false>(d, act, j * NH, tw, mask_of(i - 1), grad, n, base);
    fence_proxy_async();
    named_sync<NCONS>();
  }

  // ---- g w0^T (128 outputs, 64 a warpgroup) plus the re-injection term
  float d2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d2[i] = 0.f;
  product(d2, act, D / KC, ring, full, j * (W0T_STAGE_BYTES / 2), t, s);
  output_epilogue(d2, 64 * j, tw, grad, n, base);
  if (relu != nullptr) dump_masks(mask_lo, mask_hi, relu, n, base, t);
}

}  // namespace

// Launch on `stream`: code (C, 64) f32, row g uses code row g / rows_per_code;
// xyz (n, 3) f32; fwd = pack_value_tiles(w0, W), bwd = pack_backward_tiles(w0,
// W) (bf16); W (8, 512, 512) bf16 for layer 8's column; b (9, 512) f32;
// sdf (n,) f32, grad (n, 67) f32; relu, if not null, (n, 8, 512) uint8 gets
// the ReLU masks the kernel took.  Returns the launch's cudaError_t.  n > 0.
int mlp_sdf_jacobian_tc(const void* code, int rows_per_code, const void* xyz, int n,
                        const void* fwd, const void* bwd, const void* W, const void* b,
                        void* sdf, void* grad, void* relu, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_sdf_jacobian_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  mlp_sdf_jacobian_tc_kernel<<<(n + BM - 1) / BM, NT, SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(code), rows_per_code, static_cast<const float*>(xyz), n,
      static_cast<const uint8_t*>(fwd), static_cast<const uint8_t*>(bwd),
      static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(b),
      static_cast<float*>(sdf), static_cast<float*>(grad), static_cast<uint8_t*>(relu));
  return int(cudaGetLastError());
}

// Shared memory per block, threads per block, rows per block, bring-up
// stage, registers per thread and local (spill) bytes of the kernel.
extern "C" int mlp_sdf_jacobian_tc_config(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_sdf_jacobian_tc_kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = int(SMEM);
  out[1] = NT;
  out[2] = BM;
  out[3] = STAGE;
  out[4] = attr.numRegs;
  out[5] = int(attr.localSizeBytes);
  return 0;
}
