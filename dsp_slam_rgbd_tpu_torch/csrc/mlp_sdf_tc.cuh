// Shared pieces of the tensor-core DeepSDF kernels for Hopper (sm_90a):
// the value pass (mlp_sdf_value_tc.cuh) and the value + input Jacobian
// (mlp_sdf_jacobian_tc.cuh).  Both run the 9-layer DeepSDF MLP (8 x 512,
// latent re-injected at layer 4) over 64-row blocks whose bf16 activations
// stay in 128-byte-swizzled shared memory, read by wgmma descriptors, and
// both stream host-packed weight stages (64-deep K chunks of a layer for
// all its outputs, K-major, swizzled) with bulk asynchronous copies through
// an mbarrier ring.  A block has two consumer warpgroups, which multiply,
// and one producer warpgroup, whose first thread feeds the ring; the ring,
// both roles' set-up and the K loop of a product live here, so the two
// kernels differ only in what they compute.
//
// Two decoder layouts are compiled, each in translation units of its own
// (`Layout<LATENT>`): the cars/chairs_64 layout (latent 64, DSP-SLAM's
// cars) and DeepSDF's published ShapeNet layout (latent 256).  At 64 a row
// tile holds the whole input row [code 64 | xyz 3 | 0] (16 KB).  At 256 it
// would hold 40 KB, past what the Jacobian kernel's shared memory has left,
// so the code's products are folded: the rows of one code share it, so
// layer 0's and layer 4's products over the code columns are per code
// (`fold_body`, a small kernel before each launch), and the epilogues of
// those layers add the per-code result as a bias.  The row tile then holds
// only xyz, in the activation buffer itself.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 512;                       // hidden width
constexpr int BM = 64;                       // rows per block (wgmma M)
constexpr int KC = 64;                       // K per weight stage (one swizzle atom)
constexpr int NH = 256;                      // outputs per consumer (wgmma N)
constexpr int ATOM_BYTES = BM * 128;         // 64 rows x 64 bf16
constexpr int ACT_BYTES = (D / KC) * ATOM_BYTES;   // 64 KB
constexpr int STAGE_BYTES = KC * D * 2;      // 64 KB: one K chunk, all outputs
constexpr int HALF_BYTES = STAGE_BYTES / 2;  // one consumer's 256 outputs
constexpr int NCONS = 256;                   // consumer threads: two warpgroups
constexpr int NT = NCONS + 128;              // and one producer warpgroup
constexpr int NSLOT = 2;                     // weight ring slots of one stage each
constexpr int RING_BYTES = NSLOT * STAGE_BYTES;
constexpr int BAR_BYTES = 2 * NSLOT * 8;     // the ring's mbarriers
constexpr int CONSUMER_REGS = 232;           // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int PRODUCER_REGS = 40;            //   <= 65,536 registers of the SM

// The decoder layout of a kernel: the latent size, the input row
// [code | xyz], layer 3's real output width (the rest of layer 4's input
// is the raw row) and what a block's row tile holds.
template <int LATENT>
struct Layout {
  static constexpr int CODE = LATENT;                   // latent size
  static constexpr int IN_DIM = CODE + 3;               // code + xyz
  static constexpr int SPLIT = D - IN_DIM;              // layer-3 real output width
  static constexpr int IN_PAD = (IN_DIM + KC - 1) / KC * KC;  // 128 or 320
  // fold the code's products per code where the whole row would not fit
  static constexpr bool FOLD = IN_PAD > 2 * KC;
  static constexpr int TILE_CODE = FOLD ? 0 : CODE;     // code columns of a row tile
  static constexpr int K0 = FOLD ? KC : IN_PAD;         // layer-0 depth of a row tile
  static constexpr int XIN_BYTES = FOLD ? 0 : (K0 / KC) * ATOM_BYTES;  // 16 KB or none
  // With FOLD, layer 4's input holds 0 in the code's columns: its K chunks
  // SKIP_AT..SKIP_AT+SKIP-1 hold nothing else, so neither the stream nor
  // the product has them (chunks 4..6 of 8 at 256)
  static constexpr int SKIP_AT = FOLD ? (SPLIT + KC - 1) / KC : 0;
  static constexpr int SKIP = FOLD ? (SPLIT + CODE) / KC - SKIP_AT : 0;
  static constexpr int FWD_STAGES = K0 / KC + 7 * (D / KC) - SKIP;  // 58 or 54: w0, W[0..6]
  static constexpr int W0T_N = IN_PAD;                  // outputs of the last g w0^T
  static_assert(W0T_N / 2 <= 256 && (W0T_N / 2) % 8 == 0, "a wgmma N per consumer");
};

// What a launch knows of its rows: xyz (n, 3), row g's code index
// g / rows_per_code, and with FOLD the per-code results of the folded
// products, fold[(layer 0 or 4, code, output)].
struct Rows {
  const float* __restrict__ xyz;
  int n, rows_per_code, base;
  const float* __restrict__ fold;
  int codes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row m, column k) in a K-major operand of BM rows
// in the 128-byte swizzle: 64-column atoms of 8 KB, 128 bytes a row, the
// 16-byte chunk index XORed with the row's index within its 8-row group.
__device__ __forceinline__ uint32_t sw_off(int m, int k) {
  return (k >> 6) * ATOM_BYTES + m * 128 + ((((k >> 3) & 7) ^ (m & 7)) << 4) + ((k & 7) << 1);
}

// wgmma shared-memory descriptor: 128-byte swizzle, 8-row groups 1024 bytes
// apart (SBO), LBO unused by the swizzled K-major layout (set to 16 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Writes through the generic proxy made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) (+)= A (64 x 16, bf16) B (16 x 256, bf16), both K-major
// in shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16) B (16 x 64, bf16), both K-major
// in shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 160, f32) (+)= A (64 x 16, bf16) B (16 x 160, bf16), both K-major
// in shared memory.  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float bf16_at(const uint8_t* buf, int m, int k) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(buf + sw_off(m, k)));
}

// Row tile of the block, rounded to bf16, into xin (consumer thread t):
// [code | xyz | 0] of K0 columns, or with FOLD [xyz | 0] of 64.
template <class L>
__device__ void load_input(uint8_t* xin, const float* __restrict__ code, int rows_per_code,
                           const float* __restrict__ xyz, int n, int base, int t) {
  constexpr int K0 = L::K0, TC = L::TILE_CODE;
  for (int e = t; e < BM * (K0 / 8); e += NCONS) {
    const int m = e / (K0 / 8), k0 = (e % (K0 / 8)) * 8, g = base + m;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int k = k0 + q;
      v[q] = 0.f;
      if (g < n) {
        if (k < TC) v[q] = code[(g / rows_per_code) * L::CODE + k];
        else if (k < TC + 3) v[q] = xyz[g * 3 + (k - TC)];
      }
    }
    *reinterpret_cast<uint4*>(xin + sw_off(m, k0)) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  }
}

// Input column k of block row m as layer 4 takes it back in, bf16: from the
// row tile, or with FOLD 0 for the code (its product is in the fold) and
// xyz read again.
template <class L>
__device__ __forceinline__ float reinjected(const uint8_t* xin, const Rows& in, int m, int k) {
  if constexpr (L::FOLD) {
    const int g = in.base + m;
    if (k < L::CODE || g >= in.n) return 0.f;
    return __bfloat162float(__float2bfloat16_rn(in.xyz[g * 3 + (k - L::CODE)]));
  } else {
    return bf16_at(xin, m, k);
  }
}

// Accumulator fragment of one warpgroup (t = thread in it) for output
// columns c0..c0+255 (c0 % 64 == 0) -> bias, ReLU, bf16, into the swizzled
// buffer out.  Fragment of m64nNk16: d[4j + 2h + e] is row r0 + 8h with
// r0 = 16 warp + lane / 4, column c0 + 8j + 2 (lane % 4) + e, so both rows
// share one swizzle and column block j sits in atom j / 8, chunk j % 8.
// With MASKS, the ReLU mask (pre-activation > 0) of fragment element i goes
// to bit i % 32 of word mk[(i / 32) * NCONS].  With ROW_BIAS, bias is a
// (codes, 512) table of which each row takes its code's row (the folded
// layers 0 and 4).
template <class L, bool REINJECT, bool MASKS = false, bool ROW_BIAS = false>
__device__ __forceinline__ void epilogue(const float (&d)[128], uint8_t* out, const uint8_t* xin,
                                         const float* __restrict__ bias, int c0, int t,
                                         uint32_t* mk = nullptr, const Rows* in = nullptr) {
  // Addresses are recomputed per call: hoisted out of the layer loop, they
  // would stay live beside the 128 accumulators and spill.
  asm volatile("" : "+r"(t), "+l"(out), "+l"(xin), "+l"(bias));
  if (MASKS) asm volatile("" : "+l"(mk));
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int sw = r0 & 7;
  uint8_t* row = out + (c0 >> 6) * ATOM_BYTES + r0 * 128 + (lane & 3) * 4;
  const float* bc[2] = {bias + c0 + 2 * (lane & 3), nullptr};
  if constexpr (ROW_BIAS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = min(in->base + r0 + 8 * h, in->n - 1);
      bc[h] = bias + size_t(g / in->rows_per_code) * D + c0 + 2 * (lane & 3);
    }
  }
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float2 bb[2];
    bb[0] = __ldg(reinterpret_cast<const float2*>(bc[0] + 8 * j));
    if constexpr (ROW_BIAS) bb[1] = __ldg(reinterpret_cast<const float2*>(bc[1] + 8 * j));
    uint8_t* p = row + (j >> 3) * ATOM_BYTES + (((j & 7) ^ sw) << 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 b2 = bb[ROW_BIAS ? h : 0];
      const float p0 = d[4 * j + 2 * h] + b2.x;
      const float p1 = d[4 * j + 2 * h + 1] + b2.y;
      if (MASKS)
        words[j >> 3] |= (uint32_t(p0 > 0.f) << ((4 * j + 2 * h) & 31)) |
                         (uint32_t(p1 > 0.f) << ((4 * j + 2 * h + 1) & 31));
      float v0 = fmaxf(p0, 0.f);
      float v1 = fmaxf(p1, 0.f);
      const int c = c0 + 8 * j + 2 * (lane & 3);
      if (REINJECT && c + 1 >= L::SPLIT) {  // latent re-injection
        if constexpr (L::FOLD) {
          if (c >= L::SPLIT) v0 = reinjected<L>(xin, *in, r0 + 8 * h, c - L::SPLIT);
          v1 = reinjected<L>(xin, *in, r0 + 8 * h, c + 1 - L::SPLIT);
        } else {
          if (c >= L::SPLIT) v0 = bf16_at(xin, r0 + 8 * h, c - L::SPLIT);
          v1 = bf16_at(xin, r0 + 8 * h, c + 1 - L::SPLIT);
        }
      }
      *reinterpret_cast<uint32_t*>(p + h * 8 * 128) = pack_bf16x2(v0, v1);
    }
  }
  if (MASKS) {
#pragma unroll
    for (int q = 0; q < 4; ++q) mk[q * NCONS] = words[q];
  }
}

// Layer `layer`'s epilogue of the forward sweep: re-injection after layer
// 3, and with FOLD the per-code bias of layers 0 and 4.
template <class L, bool MASKS>
__device__ __forceinline__ void forward_epilogue(int layer, const float (&d)[128], uint8_t* act,
                                                 const uint8_t* xin,
                                                 const float* __restrict__ bias, int c0, int t,
                                                 uint32_t* mk, const Rows& in) {
  if (layer == 3) {
    epilogue<L, true, MASKS>(d, act, xin, bias + layer * D, c0, t, mk, &in);
  } else if (L::FOLD && (layer == 0 || layer == 4)) {
    epilogue<L, false, MASKS, L::FOLD>(
        d, act, xin, in.fold + size_t(layer == 4) * in.codes * D, c0, t, mk, &in);
  } else {
    epilogue<L, false, MASKS>(d, act, xin, bias + layer * D, c0, t, mk, &in);
  }
}

// Layer 8: sdf = tanh(act . w8 + b8) per row, 4 consumer threads a row;
// with sdf_s, every row's value also goes to shared memory.
__device__ void head(const uint8_t* act, const __nv_bfloat16* w8s, float b8,
                     float* __restrict__ sdf, int n, int base, int t, float* sdf_s = nullptr) {
  for (int e = t; e < BM * 4; e += NCONS) {
    const int m = e >> 2, part = e & 3;
    float s = 0.f;
#pragma unroll 4
    for (int q = 0; q < 16; ++q) {
      const int k = part * 128 + q * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(act + sw_off(m, k));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s = fmaf(__uint_as_float(w[i] << 16), __bfloat162float(w8s[k + 2 * i]), s);
        s = fmaf(__uint_as_float(w[i] & 0xffff0000u), __bfloat162float(w8s[k + 2 * i + 1]), s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) {
      const float v = tanhf(s + b8);
      if (sdf_s != nullptr) sdf_s[m] = v;
      if (base + m < n) sdf[base + m] = v;
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrive and expect `bytes` of asynchronous copies to complete on bar.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the completion of bar's phase of the given parity.  With
// WATCHDOG (the producer's waits), a lost arrival traps after 2^26 polls,
// each of which may suspend the thread for a while, instead of hanging the
// card; the consumers' waits go without it, which costs them registers.
template <bool WATCHDOG>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (WATCHDOG && polls == (1u << 26)) __trap();
  }
}
// One bulk copy global -> shared, completed on bar as transaction bytes.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Barrier of the first N threads only (id 1; 0 is __syncthreads).
template <int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// Start of the dynamic shared memory, aligned to the swizzle's 1024 bytes.
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Thread 0 sets up the ring's mbarriers: NSLOT "full" ones at `full` (the
// producer's arrival plus the stage's copy bytes), then NSLOT "empty" ones
// (one arrival per consumer warp).  The whole block meets after.
__device__ __forceinline__ void ring_init(uint32_t full, int t) {
  if (t == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(full + 8 * (NSLOT + i), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warpgroup: gives up its registers; its first thread streams
// stages 0..n_stages-1 through the ring, one bulk copy each, once the
// slot's previous stage has been read (with the watchdog).  src(s, &bytes)
// gives stage s's source and size (at most STAGE_BYTES).
template <typename Src>
__device__ __forceinline__ void produce(int n_stages, Src src, uint8_t* ring, uint32_t full,
                                        int t) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
  if (t != NCONS) return;
  const uint32_t empty = full + 8 * NSLOT;
  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % NSLOT;
    uint32_t bytes;
    const uint8_t* p = src(s, &bytes);
    mbar_wait<true>(empty + 8 * slot, ((s / NSLOT) & 1) ^ 1);
    mbar_expect_tx(full + 8 * slot, bytes);
    bulk_copy(smem_u32(ring + slot * STAGE_BYTES), p, bytes, full + 8 * slot);
  }
}

// The consumer warpgroups' start (thread t < NCONS): take the producer's
// registers, load the block's row tile into xin and layer 8's column
// (column 0 of W[7]) into w8s, visible to wgmma and to every consumer.
template <class L>
__device__ __forceinline__ void consumer_start(uint8_t* xin, __nv_bfloat16* w8s,
                                               const float* __restrict__ code, int rows_per_code,
                                               const float* __restrict__ xyz, int n, int base,
                                               const __nv_bfloat16* __restrict__ W, int t) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  load_input<L>(xin, code, rows_per_code, xyz, n, base, t);
  const __nv_bfloat16* w8 = W + size_t(7) * D * D;
  for (int k = t; k < D; k += NCONS) w8s[k] = w8[size_t(k) * D];
  fence_proxy_async();
  named_sync<NCONS>();
}

// d = A B for consumer thread t: A is nk K chunks of 64 from a (BM rows;
// with SKIP, chunks SKIP_AT..SKIP_AT+SKIP-1 of a are passed over), B the
// ring's next nk stages from byte b_off of each (this warpgroup's NACC / 2
// outputs); s counts the stages taken.  wgmma m64n256k16 for 128
// accumulators, m64n160k16 for 80, m64n64k16 for 32.  Ends once both warpgroups' reads of a
// are done, so that a may be written.
template <int NACC, int SKIP_AT = 0, int SKIP = 0>
__device__ __forceinline__ void product(float (&d)[NACC], const uint8_t* a, int nk,
                                        const uint8_t* ring, uint32_t full, int b_off, int t,
                                        int& s) {
  static_assert(NACC == 128 || NACC == 80 || NACC == 32,
                "an m64n256k16, m64n160k16 or m64n64k16 accumulator");
  const uint32_t empty = full + 8 * NSLOT;
  for (int kc = 0; kc < nk; ++kc, ++s) {
    const int slot = s % NSLOT;
    const uint8_t* b = ring + slot * STAGE_BYTES + b_off;
    mbar_wait<false>(full + 8 * slot, (s / NSLOT) & 1);
    wgmma_fence();
    fence_acc(d);
#pragma unroll
    for (int q = 0; q < KC / 16; ++q) {
      const int ka = SKIP == 0 || kc < SKIP_AT ? kc : kc + SKIP;
      const uint64_t da = desc_sw128(smem_u32(a + ka * ATOM_BYTES + q * 32));
      const uint64_t db = desc_sw128(smem_u32(b + q * 32));
      if constexpr (NACC == 128)
        wgmma_m64n256k16(d, da, db, kc > 0 || q > 0);
      else if constexpr (NACC == 80)
        wgmma_m64n160k16(d, da, db, kc > 0 || q > 0);
      else
        wgmma_m64n64k16(d, da, db, kc > 0 || q > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
    if ((t & 31) == 0) mbar_arrive(empty + 8 * slot);
  }
  named_sync<NCONS>();
}

// The folded products of code c (FOLD layouts), one block of 512 threads a
// (code, layer), thread o one output: fold[0][c][o] = b[0][o] + bf16(z_c) .
// w0[:CODE, o] and fold[1][c][o] = b[4][o] + bf16(z_c) . W[3][SPLIT:SPLIT +
// CODE, o], the products exact in f32 and summed in k order.  Launched as
// a grid of (codes, 2) before the kernel that reads them.
template <class L>
__device__ __forceinline__ void fold_body(const float* __restrict__ code, int codes,
                                          const __nv_bfloat16* __restrict__ w0,
                                          const __nv_bfloat16* __restrict__ W,
                                          const float* __restrict__ bias,
                                          float* __restrict__ fold) {
  __shared__ float z[L::CODE];
  const int c = blockIdx.x, which = blockIdx.y, o = threadIdx.x;
  for (int k = o; k < L::CODE; k += blockDim.x)
    z[k] = __bfloat162float(__float2bfloat16_rn(code[size_t(c) * L::CODE + k]));
  __syncthreads();
  const __nv_bfloat16* w = which == 0 ? w0 : W + (size_t(3) * D + L::SPLIT) * D;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < L::CODE; ++k) s = fmaf(z[k], __bfloat162float(w[size_t(k) * D + o]), s);
  fold[(size_t(which) * codes + c) * D + o] = s + bias[(which == 0 ? 0 : 4) * D + o];
}

// Layer `layer`'s product of the forward sweep: layer 0 over the row tile,
// the others over the activations, layer 4 without the folded code's chunks.
template <class L>
__device__ __forceinline__ void forward_product(int layer, float (&d)[128], const uint8_t* xin,
                                                const uint8_t* act, const uint8_t* ring,
                                                uint32_t full, int b_off, int t, int& s) {
  if (L::SKIP > 0 && layer == 4)
    product<128, L::SKIP_AT, L::SKIP>(d, act, D / KC - L::SKIP, ring, full, b_off, t, s);
  else
    product(d, layer == 0 ? xin : act, layer == 0 ? L::K0 / KC : D / KC, ring, full, b_off, t,
            s);
}

constexpr int FOLD_THREADS = D;

}  // namespace
