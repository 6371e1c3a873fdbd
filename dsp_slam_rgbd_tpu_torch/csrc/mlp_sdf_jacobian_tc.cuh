// Tensor-core value + input Jacobian of the fused DeepSDF decoder, bf16,
// for Hopper (sm_90a): the 9-layer MLP forward over rows of [code | xyz],
// then d sdf / d[code, xyz] by one reverse sweep, for each compiled layout
// (`Layout<64>` in mlp_sdf_jacobian_tc.cu, `Layout<256>` in
// mlp_sdf256_jacobian_tc.cu).
//
// Replaces, for bf16 operands, the Pallas TPU kernel
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py::_make_kernel.  The f32 parity
// mode stays on the FMA kernel of mlp_sdf.cu: tensor cores have no full-f32
// product.
//
// What bounds it on this card: operations.  One row costs 7.34 MFLOP of
// real work (forward and backward) against 12 input and 272 output bytes
// at latent 64, 1,040 at 256;
// the weights (two 3.8 MB bf16 streams) stay L2-resident.  The products run
// on the tensor cores (wgmma), whose bf16 rate (989 TFLOP/s dense) is the
// ceiling.  At the main path's sizes (32 and 128 blocks, under one wave)
// what holds it back is the serial chain of weight stages each block
// streams (122 at 64): one block's time, whatever the row count.
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
//     4 columns SPLIT..511 go to the output, f32 and unmasked (the
//     re-injection gradient, code columns included where they are folded),
//     and to 0 in g.  The last product g w0^T has IN_PAD outputs (128 at
//     64, 320 at 256): consumer j takes half of them with m64n64k16 or
//     m64n160k16 and adds columns < IN_DIM to the re-injection gradient.
//   * Weights are host-packed streams of stages in the exact shared-memory
//     order the B descriptor reads, 64 K values an output row, 128-byte
//     swizzled: the forward's (`pack_value_tiles`) and the backward's
//     (`pack_backward_tiles`: W[6]^T..W[0]^T, then w0^T in stages of 16 KB
//     at 64, 40 KB at 256), 122 stages in all at 64 and 118 at 256 (whose
//     forward leaves out layer 4's 3 code-only chunks).  One producer
//     thread streams them through a ring of NSLOT slots, one bulk
//     asynchronous copy (cp.async.bulk) per stage,
//     completed on the slot's "full" mbarrier; each consumer warp arrives on
//     the slot's "empty" mbarrier once its wgmma reads are done.  The ring
//     runs across layer boundaries and from the forward into the backward.
//   * Codes are read per row as code[row / rows_per_code]; the last tile
//     is masked.  On request the kernel writes out the masks it took, so a
//     check can hold its reverse sweep to the plain one without ReLU ties.
//
// Shared memory (231,712 of the 232,448 B a block may have, at either
// layout): 16 KB input rows at 64, none at 256 (the row tile of xyz sits
// in the activations' first atom), 64 KB activations (later g), two 64 KB
// ring slots, 16 KB for the ReLU masks of layers 0..3, 16 KB for those of
// layers 4..7 (at 64 the input buffer, free once layer 3's epilogue has
// re-injected it), 1 KB layer-8 column (bf16), 256 B sdf, four mbarriers,
// 1 KB alignment slack.
#pragma once

#include "mlp_sdf_tc.cuh"

namespace {

constexpr int JACOBIAN_STAGE = 3;              // bring-up stage of this kernel
constexpr int BWD_W_STAGES = 7 * (D / KC);     // 56 stages of W[6]^T..W[0]^T
constexpr int MASK_LAYER_WORDS = 4 * NCONS;    // one layer's ReLU mask: 4 KB
constexpr int MASK_BYTES = 4 * MASK_LAYER_WORDS * 4;  // four layers' masks: 16 KB

template <class L>
struct Jac {
  static constexpr int W0T_STAGE_BYTES = KC * L::W0T_N * 2;   // one K chunk of w0^T
  static constexpr int N_STAGES = L::FWD_STAGES + BWD_W_STAGES + D / KC;  // the last 8 w0^T
  // masks of layers 4..7 in the row tile's buffer where it has one
  static constexpr int MASK_HI_BYTES = L::XIN_BYTES >= MASK_BYTES ? 0 : MASK_BYTES;
  static constexpr size_t SMEM = 1024 /* alignment slack */ + L::XIN_BYTES + ACT_BYTES +
                                 RING_BYTES + MASK_BYTES + MASK_HI_BYTES + D * 2 + BM * 4 +
                                 BAR_BYTES;
  static_assert(SMEM <= 232448, "shared memory of one block");
  static_assert(W0T_STAGE_BYTES <= STAGE_BYTES, "a w0^T stage fits a ring slot");
};

// Stage s of the weight stream: its source and its bytes.
template <class L>
__device__ __forceinline__ const uint8_t* stage_src(int s, const uint8_t* fwd, const uint8_t* bwd,
                                                    uint32_t* bytes) {
  *bytes = STAGE_BYTES;
  if (s < L::FWD_STAGES) return fwd + size_t(s) * STAGE_BYTES;
  if (s < L::FWD_STAGES + BWD_W_STAGES) return bwd + size_t(s - L::FWD_STAGES) * STAGE_BYTES;
  *bytes = Jac<L>::W0T_STAGE_BYTES;
  return bwd + size_t(BWD_W_STAGES) * STAGE_BYTES +
         size_t(s - L::FWD_STAGES - BWD_W_STAGES) * Jac<L>::W0T_STAGE_BYTES;
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
template <class L, bool STEP4>
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
      if (STEP4 && c + 1 >= L::SPLIT) {  // re-injection gradient
        const int g = base + r0 + 8 * h;
        if (c >= L::SPLIT) {
          if (g < n) grad[size_t(g) * L::IN_DIM + (c - L::SPLIT)] = d[i0];
          v0 = 0.f;
        }
        if (g < n) grad[size_t(g) * L::IN_DIM + (c + 1 - L::SPLIT)] = d[i0 + 1];
        v1 = 0.f;
      }
      *reinterpret_cast<uint32_t*>(p + h * 8 * 128) = pack_bf16x2(v0, v1);
    }
  }
}

// The last product g w0^T, fragment of output columns c0..c0+W0T_N/2-1:
// columns < IN_DIM of the block's rows < n are added to the re-injection
// gradient already in grad.
template <class L>
__device__ __forceinline__ void output_epilogue(const float (&d)[L::W0T_N / 4], int c0, int t,
                                                float* __restrict__ grad, int n, int base) {
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < L::W0T_N / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * (lane & 3) + e, g = base + r0 + 8 * h;
        if (c < L::IN_DIM && g < n) grad[size_t(g) * L::IN_DIM + c] += d[4 * j + 2 * h + e];
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

template <class L>
__device__ __forceinline__ void jacobian_body(const float* __restrict__ code, int rows_per_code,
                                              const float* __restrict__ xyz, int n,
                                              const uint8_t* __restrict__ fwd,
                                              const uint8_t* __restrict__ bwd,
                                              const __nv_bfloat16* __restrict__ W,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ fold, int codes,
                                              float* __restrict__ sdf, float* __restrict__ grad,
                                              uint8_t* __restrict__ relu) {
  using J = Jac<L>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* act = smem_base(smem_raw) + L::XIN_BYTES;  // activations, then g, in place
  uint8_t* xin = act - L::XIN_BYTES;   // row tile (layer 0's A); with FOLD act's first atom
  uint8_t* ring = act + ACT_BYTES;     // NSLOT weight stages
  uint32_t* mask_lo = reinterpret_cast<uint32_t*>(ring + RING_BYTES);  // masks 0..3
  // masks 4..7: in the row tile's buffer once layer 3 has re-injected it,
  // or after masks 0..3
  uint32_t* mask_hi = J::MASK_HI_BYTES ? mask_lo + 4 * MASK_LAYER_WORDS
                                       : reinterpret_cast<uint32_t*>(xin);
  __nv_bfloat16* w8s = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<uint8_t*>(mask_lo) + MASK_BYTES + J::MASK_HI_BYTES);
  float* sdf_s = reinterpret_cast<float*>(w8s + D);
  const uint32_t full = smem_u32(sdf_s + BM);  // the ring's mbarriers
  const int t = threadIdx.x;
  const int base = blockIdx.x * BM;
  ring_init(full, t);

  // warpgroup index, uniform across each warp, so that ptxas can apply
  // setmaxnreg to each role's code
  const int role = __shfl_sync(0xffffffffu, t / 128, 0);
  if (role == NCONS / 128) {
    produce(J::N_STAGES,
            [=](int s, uint32_t* bytes) { return stage_src<L>(s, fwd, bwd, bytes); }, ring,
            full, t);
    return;
  }

  // ---- two consumer warpgroups: warpgroup j computes outputs
  // 256j..256j+255 of every product for all 64 rows
  consumer_start<L>(xin, w8s, code, rows_per_code, xyz, n, base, W, t);
  const Rows in{xyz, n, rows_per_code, base, fold, codes};
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
    forward_product<L>(layer, d, xin, act, ring, full, j * HALF_BYTES, t, s);
    forward_epilogue<L, true>(layer, d, act, xin, bias, j * NH, tw, mask_of(layer), in);
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
      backward_epilogue<L, true>(d, act, j * NH, tw, mask_of(i - 1), grad, n, base);
    else
      backward_epilogue<L, false>(d, act, j * NH, tw, mask_of(i - 1), grad, n, base);
    fence_proxy_async();
    named_sync<NCONS>();
  }

  // ---- g w0^T (W0T_N outputs, half a warpgroup) plus the re-injection term
  float d2[L::W0T_N / 4];
#pragma unroll
  for (int i = 0; i < L::W0T_N / 4; ++i) d2[i] = 0.f;
  product(d2, act, D / KC, ring, full, j * (J::W0T_STAGE_BYTES / 2), t, s);
  output_epilogue<L>(d2, (L::W0T_N / 2) * j, tw, grad, n, base);
  if (relu != nullptr) dump_masks(mask_lo, mask_hi, relu, n, base, t);
}

// Shared memory per block, threads per block, rows per block, bring-up
// stage, registers per thread and local (spill) bytes of `kernel`.
template <class L, typename K>
int jacobian_config(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = int(Jac<L>::SMEM);
  out[1] = NT;
  out[2] = BM;
  out[3] = JACOBIAN_STAGE;
  out[4] = attr.numRegs;
  out[5] = int(attr.localSizeBytes);
  return 0;
}

}  // namespace
