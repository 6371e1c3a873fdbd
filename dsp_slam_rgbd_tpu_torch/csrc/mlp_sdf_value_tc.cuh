// Tensor-core value pass of the fused DeepSDF decoder, bf16, for Hopper
// (sm_90a): the 9-layer MLP forward over rows of [code | xyz], for each
// compiled layout (`Layout<64>` in mlp_sdf_value_tc.cu, `Layout<256>` in
// mlp_sdf256_value_tc.cu).
//
// Replaces, for bf16 operands, the Pallas TPU kernel
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py::_make_value_kernel.  The f32
// parity mode stays on the FMA kernel of mlp_sdf.cu: tensor cores have no
// full-f32 product.
//
// What bounds it on this card: operations.  One row costs 3.67 MFLOP of
// real work at latent 64 (3.80 as computed here, layer 0 padded to K =
// 128); at 256 3.15 a row (layer 0 over xyz, padded to K = 64 here, and
// layer 4 without the code's columns) and 0.52 a code (the folded
// products), against 12 input bytes; the weights (3.8 MB in bf16) are the only large operand and
// stay L2-resident.  The products run on the tensor cores (wgmma), whose
// bf16 rate (989 TFLOP/s dense) is the ceiling.  What holds this design
// back is the weight stream: every block receives the whole stack through
// a two-slot ring, so each stage waits for its copy (on an H100 80GB HBM3
// at 700 W: 0.82 ms at 102,400 rows, 7.4 TB/s from L2, against a 0.38 ms
// bound).
//
// Design (bring-up stage 3 of 3):
//   * A block owns BM = 64 rows, one wgmma M, and has three warpgroups:
//     two consumers and one producer.  setmaxnreg moves registers from the
//     producer (40 a thread) to the consumers (232).
//   * Consumer warpgroup j computes outputs 256j..256j+255 of every layer
//     for all 64 rows with wgmma m64n256k16: a 64 x 256 f32 accumulator,
//     128 registers a thread.
//   * The activations stay in shared memory as bf16 for the whole sweep,
//     K-major in the 128-byte swizzled layout that a wgmma A descriptor
//     reads (8 atoms of 64 columns), and are updated in place: both
//     consumers finish their K loop (wgmma.wait_group 0), meet at a named
//     barrier, and only then write their columns back.
//   * The weights are packed on the host (`pack_value_tiles`) into the
//     exact shared-memory order the B descriptor reads: a sequence of
//     stages, each one 64-deep K chunk of a layer for all 512 outputs,
//     K-major and 128-byte swizzled, consumer j reading half j.  One
//     producer thread streams the stages through a ring of NSLOT slots,
//     one bulk asynchronous copy (cp.async.bulk, no tensor map) per stage,
//     completed on the slot's "full" mbarrier; each consumer warp arrives
//     on the slot's "empty" mbarrier once its wgmma reads are done.  The
//     ring runs across layer boundaries, so the next layer's first
//     weights arrive during this layer's epilogue.
//   * The epilogue adds the bias, applies ReLU, rounds to bf16 (RNE) and
//     writes the accumulator fragment into the swizzled layout; before
//     layer 4, columns SPLIT..511 (445 at 64, 253 at 256) take the bf16
//     input row (latent re-injection).  Layer 8 has one real output
//     column (kept in shared memory as bf16): a per-row dot product in
//     f32, then tanh.
//   * At 256 (FOLD, mlp_sdf_tc.cuh) the row tile is xyz alone, in the
//     activations' first atom; layers 0 and 4 add their code's folded
//     product as a per-row bias, the re-injected code columns are 0, and
//     layer 4's K chunks of code columns alone are left out.
//   * The ring, both roles' set-up and the K loop are the Jacobian
//     kernel's too (mlp_sdf_tc.cuh).
//   * Codes are read per row as code[row / rows_per_code]; the last tile
//     is masked.
#pragma once

#include "mlp_sdf_tc.cuh"

namespace {

constexpr int VALUE_STAGE = 3;               // bring-up stage of this kernel

template <class L>
constexpr size_t value_smem() {
  return 1024 /* alignment slack */ + L::XIN_BYTES + ACT_BYTES + RING_BYTES + D * 2 + BAR_BYTES;
}

template <class L>
__device__ __forceinline__ void value_body(const float* __restrict__ code, int rows_per_code,
                                           const float* __restrict__ xyz, int n,
                                           const uint8_t* __restrict__ tiles,
                                           const __nv_bfloat16* __restrict__ W,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ fold, int codes,
                                           float* __restrict__ sdf) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* act = smem_base(smem_raw) + L::XIN_BYTES;  // activations, updated in place
  uint8_t* xin = act - L::XIN_BYTES;   // row tile (layer 0's A); with FOLD act's first atom
  uint8_t* ring = act + ACT_BYTES;     // NSLOT weight stages
  __nv_bfloat16* w8s = reinterpret_cast<__nv_bfloat16*>(ring + RING_BYTES);  // layer 8
  const uint32_t full = smem_u32(w8s + D);  // the ring's mbarriers
  const int t = threadIdx.x;
  const int base = blockIdx.x * BM;
  ring_init(full, t);

  // warpgroup index, uniform across each warp, so that ptxas can apply
  // setmaxnreg to each role's code
  const int role = __shfl_sync(0xffffffffu, t / 128, 0);
  if (role == NCONS / 128) {
    produce(L::FWD_STAGES, [=](int s, uint32_t* bytes) {
      *bytes = STAGE_BYTES;
      return tiles + size_t(s) * STAGE_BYTES;
    }, ring, full, t);
    return;
  }

  // ---- two consumer warpgroups: warpgroup j computes outputs
  // 256j..256j+255 of every layer for all 64 rows
  consumer_start<L>(xin, w8s, code, rows_per_code, xyz, n, base, W, t);
  const Rows in{xyz, n, rows_per_code, base, fold, codes};
  const int j = t / 128, tw = t % 128;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  int s = 0;  // next stage of the ring
  for (int layer = 0; layer < 8; ++layer) {
    forward_product<L>(layer, d, xin, act, ring, full, j * HALF_BYTES, t, s);
    forward_epilogue<L, false>(layer, d, act, xin, bias, j * NH, tw, nullptr, in);
    fence_proxy_async();
    named_sync<NCONS>();
  }
  head(act, w8s, bias[8 * D], sdf, n, base, t);
}

// Shared memory per block, threads per block, rows per block, bring-up
// stage, registers per thread and local (spill) bytes of `kernel`.
template <class L, typename K>
int value_config(K kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = int(value_smem<L>());
  out[1] = NT;
  out[2] = BM;
  out[3] = VALUE_STAGE;
  out[4] = attr.numRegs;
  out[5] = int(attr.localSizeBytes);
  return 0;
}

}  // namespace
