// Fused DeepSDF decoder kernels for Hopper (sm_90a) in f32, the mode the
// system runs (`ReconConfig()`): the 9-layer MLP forward, and forward +
// input Jacobian, over rows of [code | xyz], for each compiled layout
// (`Layout<64>` in mlp_sdf_f32.cu, `Layout<256>` in mlp_sdf256_f32.cu;
// mlp_sdf_tc.cuh).  Products are f32 FMA with f32 accumulation: no TF32 and
// no tensor cores.  The input row sits in the activations, whose 512 rows
// hold it at either latent size, so nothing is folded here.
//
// Replaces, for f32 operands, the two Pallas TPU kernels of
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py:
//   jacobian (JAC = true)  <- _make_kernel        (value + d sdf / d[code, xyz])
//   value    (JAC = false) <- _make_value_kernel  (value only)
//
// What bounds it on this card: operations.  One row costs 3.67 MFLOP
// forward (7.34 MFLOP with the Jacobian) at either latent size against 12
// input bytes, and the
// 7.5 MB f32 weight stream of each sweep stays L2-resident, far above the
// card's ridge; tensor cores have no full-f32 product, so the ceiling is
// the FMA pipes' 67 TFLOP/s (H100 SXM).  The first design (32-row blocks,
// weights staged through registers) was held by the shared-memory pipe
// instead: about 1.1 wavefronts per FMA issue cycle counting the 4-way
// conflicted staging stores and the 32-way conflicted epilogue stores, two
// block barriers per 8-row weight chunk, and at refinement's 2,048 rows 64
// blocks on 132 SMs.  This one issues FMAs at about 60% of the peak rate
// in its K loop, as f32 cuBLAS does on these shapes (PERF.md).
//
// Design:
//   * A tiling is (BM rows of a tile, a cluster of C CTAs): CTA `rank`
//     computes columns [rank 512/C, (rank+1) 512/C) of every layer for the
//     tile's rows.  Every CTA keeps the whole tile's activations (k-major,
//     row stride BM + 4) and, after each layer, writes its slice into its
//     own copy and, through distributed shared memory, into its peers'.
//     Two mbarrier rounds per layer order this among the consumers alone:
//     "free" (every CTA has finished reading the activations) before the
//     writes, "ready" (every slice has arrived) after them.  The launcher
//     takes, of 32 x 1, 64 x 2 and 32 x 2, the one with the least time in
//     whole waves of resident clusters at each one's measured speed
//     (`pick_tiling`): 64 x 2 or 32 x 1 at large row counts, 32 x 2 (128
//     SMs) at refinement's 2,048 rows and below.
//   * Weights arrive by bulk asynchronous copy (cp.async.bulk) into a ring
//     of 8 or 16 KB slots, issued by one producer thread (a ninth warp) and
//     tracked by full/empty mbarriers, running across layer boundaries and
//     from the forward into the backward sweep.  The consumers read a slot
//     with generic loads and the refill writes it through the async proxy,
//     so each consumer thread issues fence.proxy.async after its reads of
//     a slot and before its warp arrives on "empty".  Without that fence
//     the kernel did not repeat bit for bit: ptxas schedules the arrive
//     ahead of the last loads of the slot (their FMAs after it), and when
//     other kernels' blocks on the SM back up its memory pipe, the refill
//     can land before those loads are served, so one warp multiplies part
//     of the next slot's weights (its TM rows of one layer, or of the last
//     product, come out wrong, finite): `tools/kernel_repeat.py stress`
//     caught it in 1 of 5 Jacobian calls beside memory-bound kernels.  The
//     host packs each sweep's weights once per decoder
//     (`pack_value_tiles_f32`, `pack_backward_tiles_f32`) as the exact
//     shared-memory image the consumers read: 128-column blocks,
//     block-major over the whole stream, so a CTA's slice of a slot is 4/C
//     contiguous copies of KS rows each; within a block, position 4 l + j
//     holds column l + 32 j.
//     The backward stream holds W[6]^T..W[0]^T and w0^T, already transposed.
//   * Eight consumer warps: warp w computes TM = BM (4/C) / 8 rows by one
//     128-column block, each lane 4 columns (l, l+32, l+64, l+96) for its
//     TM rows.  Per k a warp reads its rows' activations as TM/4 broadcast
//     float4 (one wavefront each) and its weights as one conflict-free
//     float4 (four): at TM = 16, 8 wavefronts per 64 FMA instructions, 0.5
//     per issue cycle of the SM.  Lanes are one column apart, so the
//     epilogue's float4 stores down a column (row stride BM + 4) hit
//     distinct banks.  The bias is 4 registers a layer.  The ninth warp
//     caps a thread at 168 registers (3 warps on one SM sub-partition).
//   * The Jacobian keeps each layer's ReLU masks as bits in the thread that
//     computed them (TM / 8 words a layer); the backward products give each
//     thread the same rows and columns, so the masks stay local to the CTA.
//     Layer 8 (one real output column) is a per-row dot product that every
//     CTA of the cluster computes in full, so every CTA has each row's
//     g = 1 - sdf^2.  Layer 3's re-injected columns and step 4's
//     re-injection gradient belong to the last slice: that gradient goes to
//     the output rows in global memory, and the last product (g w0^T, 128
//     outputs), split by rows over the cluster, adds to it.  What orders the
//     store before the add: the consumers' named barrier at each later
//     exchange within a CTA, and with C = 2 the exchanges' cluster-scope
//     fence and mbarriers across the CTAs.  At latent 256 the last product
//     has 259 outputs: three 128-column blocks of w0^T, one after another.
//   * Codes are read per row as code[row / rows_per_code]: one launch covers
//     a batch of objects, a shared code or per-row codes.  The last tile is
//     masked.  Every wait traps after about 2^33 cycles instead of hanging.
//
// Shared memory of one CTA (232,448 B at most; each tiling's figures are
// reported by mlp_sdf_f32_config): the activations, 512 (BM + 4) floats
// (139,264 B at BM = 64, 73,728 B at 32); layer 8's column, the head's
// partial sums and sdf, 2.8-3.3 KB; in the Jacobian the masks, BM 512 / C
// bits a layer (16 KB at 32 x 1 and 64 x 2, 8 KB at 32 x 2); the rest, up
// to 8 slots, is ring: 64 x 2 has 5 (value) or 4 (Jacobian) 16 KB slots,
// the 32-row tilings 8.
// One CTA an SM, 288 threads.
#pragma once

#include "mlp_sdf_tc.cuh"

// The tiling every later f32 launch takes, of either layout (0..2), or -1
// to pick by row count (`mlp_sdf_f32_force_tiling`).
extern int mlp_sdf_f32_forced_tiling;


namespace {
namespace fk {

constexpr int NCONS = 256;              // consumer threads: 8 warps
constexpr int NT = NCONS + 32;          // and one producer warp
constexpr int BLK = 128;                // columns of a weight block
constexpr int BWD_ROWS = 7 * D;         // backward stream rows: W[6]^T..W[0]^T, then w0^T
constexpr int SMEM_MAX = 232448;
constexpr int ALIGN = 128;

// The f32 kernels' view of a layout: layer 0's depth (the input row
// padded to a multiple of every KS: 80 at 64, 272 at 256), the forward
// stream's rows [w0[:K0F]; W[0]; ...; W[6]] and the 128-column blocks of
// w0^T (the last product's outputs).
template <class L>
struct FL {
  static constexpr int K0F = (L::IN_DIM + 15) / 16 * 16;
  static constexpr int FWD_ROWS = K0F + 7 * D;
  static constexpr int NB0 = (L::IN_DIM + BLK - 1) / BLK;
};

// A tiling: tiles of BM rows, clusters of C CTAs.
template <class L, bool JAC, int C, int ROWS>
struct Cfg {
  static constexpr int BM = ROWS;                 // rows of a tile
  static constexpr int LD = BM + 4;               // activation row stride: float4 aligned, conflict-free
  static constexpr int NC = D / C;                // output columns per CTA
  static constexpr int NB = NC / BLK;             // weight blocks per CTA
  static constexpr int TM = BM * NB / 8;          // rows per warp (8 warps, NB across columns)
  static constexpr int TMF = BM / C / 8;          // rows per warp of the last product (g w0^T)
  static constexpr int MW = (TM * 4 + 31) / 32;   // mask words per thread and layer
  static constexpr int ACT_F = D * LD;
  static constexpr int MASK_U = JAC ? 8 * MW * NCONS : 0;
  static constexpr int FIXED = 4 * (ACT_F + MASK_U + D + NCONS + BM);
  static constexpr int AVAIL = SMEM_MAX - ALIGN - FIXED - 8 * 18;
  // 16 KB slots where 4 of them fit and hold at most 16 K rows, else 8 KB
  static constexpr bool BIG = AVAIL / 16384 >= 4 && 4096 / NC <= 16;
  static constexpr int SLOT_BYTES = BIG ? 16384 : 8192;
  static constexpr int SLOT_FLOATS = SLOT_BYTES / 4;
  static constexpr int KS = SLOT_FLOATS / NC;     // K rows per slot
  static constexpr int NSLOT = AVAIL / SLOT_BYTES < 8 ? AVAIL / SLOT_BYTES : 8;
  static constexpr int SMEM = ALIGN + NSLOT * SLOT_BYTES + FIXED + 8 * (2 * NSLOT + 2);
  static_assert(NSLOT >= 4 && SMEM <= SMEM_MAX, "shared memory of one block");
  static_assert(FL<L>::K0F % KS == 0 && D % KS == 0 && TM % 4 == 0 && TMF * 8 * C == BM &&
                NCONS >= BM, "tiling");
};

struct Args {
  const float* code;
  int rows_per_code;
  const float* xyz;
  int n;
  const float* fwd;   // pack_value_tiles_f32
  const float* bwd;   // pack_backward_tiles_f32 (Jacobian)
  const float* W;     // (8, 512, 512): layer 8's column
  const float* bias;  // (9, 512)
  float* sdf;
  float* grad;        // (n, IN_DIM) (Jacobian)
};

// ---- synchronisation pieces beyond mlp_sdf_tc.cuh's

template <bool CLUSTER>
__device__ __forceinline__ uint32_t try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  if (CLUSTER)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok;
}

// Waits for the completion of bar's phase of the given parity (with
// CLUSTER, acquiring what the cluster released to it); traps after about
// 2^33 cycles (seconds) instead of hanging the card.
template <bool CLUSTER = false>
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  if (try_wait<CLUSTER>(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_wait<CLUSTER>(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Arrive on an mbarrier of any CTA of the cluster, releasing at cluster scope.
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Every thread of every CTA of the cluster meets.
template <int C>
__device__ __forceinline__ void sync_all() {
  if constexpr (C > 1)
    asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                     "memory");
  else
    __syncthreads();
}

// v into floats off..off+3 of buf in every CTA of the cluster.
template <int C>
__device__ __forceinline__ void put4(float* buf, int off, float4 v) {
  if constexpr (C == 1) {
    *reinterpret_cast<float4*>(buf + off) = v;
  } else {
    const uint32_t a = smem_u32(buf + off);
#pragma unroll
    for (int q = 0; q < C; ++q) st_cluster(mapa(a, q), v);
  }
}

// The consumers' exchange of a layer's output.  begin: every CTA of the
// cluster has finished reading its activations (and the consumers of this
// one have met); end: every CTA's slice has been written into every copy.
// xbar: the "free" mbarrier, then the "ready" one (C arrivals each).
template <int C>
__device__ __forceinline__ void exchange_begin(uint32_t xbar, uint32_t ph, int t) {
  named_sync<NCONS>();
  if constexpr (C > 1) {
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < C; ++q) arrive_cluster(mapa(xbar, q));
    }
    wait_phase<true>(xbar, ph);
  }
}
template <int C>
__device__ __forceinline__ void exchange_end(uint32_t xbar, uint32_t& ph, int t) {
  if constexpr (C > 1) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  named_sync<NCONS>();
  if constexpr (C > 1) {
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < C; ++q) arrive_cluster(mapa(xbar + 8, q));
    }
    wait_phase<true>(xbar + 8, ph);
    ph ^= 1;
  }
}

// ---- the weight ring

struct Ring {
  uint32_t full, empty;
  int slot;
  uint32_t phase;
  template <int NSLOT>
  __device__ __forceinline__ void advance() {
    if (++slot == NSLOT) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// The producer thread: every slot of the sweep(s) in order, once the slot's
// previous contents have been read.  Forward slots, then (JAC) backward
// slots of W[6]^T..W[0]^T, each this CTA's NB blocks of KS rows; then (JAC)
// the w0^T slots, KS rows of one whole 128-column block each, block after
// block.
template <class L, typename K, bool JAC>
__device__ __forceinline__ void produce(const Args& a, float* ring, Ring rg, int rank) {
  constexpr int FWD_ROWS = FL<L>::FWD_ROWS;
  constexpr int FWD_SLOTS = FWD_ROWS / K::KS;
  constexpr int BWD_SLOTS = JAC ? BWD_ROWS / K::KS : 0;
  constexpr int ALL = FWD_SLOTS + BWD_SLOTS + (JAC ? FL<L>::NB0 * (D / K::KS) : 0);
  constexpr uint32_t COPY = K::KS * BLK * 4;   // KS rows of one block
  for (int s = 0; s < ALL; ++s) {
    const uint32_t full = rg.full + 8 * rg.slot;
    wait_phase(rg.empty + 8 * rg.slot, rg.phase ^ 1);
    const uint32_t dst = smem_u32(ring + rg.slot * K::SLOT_FLOATS);
    if (s < FWD_SLOTS + BWD_SLOTS) {
      const bool fw = s < FWD_SLOTS;
      const float* src = fw ? a.fwd : a.bwd;
      const int rows = fw ? FWD_ROWS : BWD_ROWS;
      const int k0 = (fw ? s : s - FWD_SLOTS) * K::KS;
      mbar_expect_tx(full, K::NB * COPY);
#pragma unroll
      for (int bi = 0; bi < K::NB; ++bi)
        bulk_copy(dst + bi * COPY, src + (size_t(rank * K::NB + bi) * rows + k0) * BLK, COPY,
                  full);
    } else {
      const int k0 = (s - FWD_SLOTS - BWD_SLOTS) * K::KS;   // over the blocks, D rows each
      mbar_expect_tx(full, COPY);
      bulk_copy(dst, a.bwd + (size_t(4) * BWD_ROWS + k0) * BLK, COPY, full);
    }
    rg.advance<K::NSLOT>();
  }
}

// acc[m][j] = sum_k A[k][m] B[k][j] over nslots slots of KS rows: A k-major
// at a (row stride LD, this warp's first row), B the ring's next slots from
// float b of each (this warp's block, this lane's 4 columns).  Each warp
// releases a slot once its reads are done: every lane's proxy fence orders
// its generic reads of the slot before the producer's refill through the
// async proxy, which the arrive alone does not (see the note at the top).
template <int TM, int KS, int NSLOT, int LD, int SLOT_FLOATS>
__device__ __forceinline__ void product(float (&acc)[TM][4], const float* a, int nslots,
                                        const float* b, Ring& rg, int lane) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  for (int i = 0; i < nslots; ++i) {
    wait_phase(rg.full + 8 * rg.slot, rg.phase);
    const float* bs = b + rg.slot * SLOT_FLOATS;
    const float* as = a + i * KS * LD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * BLK);
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int m = 0; m < TM; m += 4) {
          const float4 av = *reinterpret_cast<const float4*>(as + kk * LD + m);
          const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[m + q][j] = fmaf(am[q], bj[j], acc[m + q][j]);
        }
      } else {   // the last product's few rows
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float am = as[kk * LD + m];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(am, bj[j], acc[m][j]);
        }
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(rg.empty + 8 * rg.slot);
    rg.advance<NSLOT>();
  }
}

// Input element k of row g: [code | xyz | 0], 0 past the last row.
template <class L>
__device__ __forceinline__ float input_at(const Args& a, int g, int k) {
  if (g >= a.n) return 0.f;
  if (k < L::CODE) return a.code[(g / a.rows_per_code) * L::CODE + k];
  if (k < L::IN_DIM) return a.xyz[g * 3 + (k - L::CODE)];
  return 0.f;
}

template <class L, bool JAC, int C, int ROWS>
__device__ __forceinline__ void f32_body(const Args& a) {
  using K = Cfg<L, JAC, C, ROWS>;
  constexpr int K0F = FL<L>::K0F, SPLIT = L::SPLIT, IN_DIM = L::IN_DIM;
  constexpr int BM = K::BM, LD = K::LD, TM = K::TM, KS = K::KS, NSLOT = K::NSLOT;
  constexpr int SLOT_FLOATS = K::SLOT_FLOATS, PARTS = NCONS / BM;
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((ALIGN - (smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1)));
  float* act = ring + NSLOT * SLOT_FLOATS;    // activations, later g: [512][LD]
  uint32_t* masks = reinterpret_cast<uint32_t*>(act + K::ACT_F);  // [8][MW][NCONS] (JAC)
  float* w8s = reinterpret_cast<float*>(masks + K::MASK_U);     // layer 8's column
  float* red = w8s + D;                       // the head's partial sums [PARTS][BM]
  float* sdf_s = red + NCONS;
  const uint32_t full = smem_u32(sdf_s + BM);
  const uint32_t empty = full + 8 * NSLOT;
  const uint32_t xbar = empty + 8 * NSLOT;    // exchange: "free", then "ready"
  const int t = threadIdx.x;
  const int rank = C > 1 ? int(cluster_rank()) : 0;
  const int base = (blockIdx.x / C) * BM;

  if (t == 0) {
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, NCONS / 32);
    }
    mbar_init(xbar, C);
    mbar_init(xbar + 8, C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  sync_all<C>();
  Ring rg{full, empty, 0, 0};
  if (t >= NCONS) {
    if (t == NCONS) produce<L, K, JAC>(a, ring, rg, rank);
    return;
  }

  // ---- consumers
  const int lane = t & 31, warp = t >> 5;
  const int wc = warp % K::NB, row0 = (warp / K::NB) * TM;
  const int col0 = rank * K::NC + wc * BLK + lane;  // column j of the thread: col0 + 32 j
  const float* bw = ring + wc * KS * BLK + 4 * lane;
  uint32_t xph = 0;
  for (int e = t; e < K0F * BM; e += NCONS) act[(e / BM) * LD + e % BM] = input_at<L>(a, base + e % BM, e / BM);
  for (int k = t; k < D; k += NCONS) w8s[k] = a.W[size_t(7) * D * D + size_t(k) * D];
  named_sync<NCONS>();

  // ---- forward: layers 0..7, bias and ReLU, re-injection into layer 4's input
  float acc[TM][4];
  for (int layer = 0; layer < 8; ++layer) {
    product<TM, KS, NSLOT, LD, SLOT_FLOATS>(acc, act + row0, (layer == 0 ? K0F : D) / KS, bw, rg, lane);
    exchange_begin<C>(xbar, xph, t);
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bj[j] = __ldg(a.bias + layer * D + col0 + 32 * j);
    uint32_t words[K::MW];
#pragma unroll
    for (int w = 0; w < K::MW; ++w) words[w] = 0u;
#pragma unroll
    for (int m = 0; m < TM; m += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 32 * j;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float p = acc[m + q][j] + bj[j];
          if (JAC) words[((m + q) * 4 + j) / 32] |= uint32_t(p > 0.f) << (((m + q) * 4 + j) % 32);
          v[q] = p > 0.f ? p : 0.f;
          if (layer == 3 && col >= SPLIT) v[q] = input_at<L>(a, base + row0 + m + q, col - SPLIT);
        }
        put4<C>(act, col * LD + row0 + m, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
    if (JAC) {
#pragma unroll
      for (int w = 0; w < K::MW; ++w) masks[(layer * K::MW + w) * NCONS + t] = words[w];
    }
    exchange_end<C>(xbar, xph, t);
  }

  // ---- layer 8: one real output column, a per-row dot product (every CTA), tanh
  {
    const int r = t % BM, part = t / BM;
    if (part < PARTS) {
      float s = 0.f;
#pragma unroll 8
      for (int k = part; k < D; k += PARTS) s = fmaf(act[k * LD + r], w8s[k], s);
      red[part * BM + r] = s;
    }
    named_sync<NCONS>();
    if (t < BM) {
      float sum = red[t];
#pragma unroll
      for (int q = 1; q < PARTS; ++q) sum += red[q * BM + t];
      const float v = tanhf(sum + a.bias[8 * D]);
      sdf_s[t] = v;
      if (rank == 0 && base + t < a.n) a.sdf[base + t] = v;
    }
  }
  if constexpr (JAC) {
    // ---- backward, step 8: g = (1 - sdf^2) w8 under layer 7's mask (rank 1)
    exchange_begin<C>(xbar, xph, t);
#pragma unroll
    for (int m = 0; m < TM; m += 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 32 * j;
        const float w8 = w8s[col];
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int bit = (m + q) * 4 + j;
          const float s = sdf_s[row0 + m + q];
          const bool on = (masks[(7 * K::MW + bit / 32) * NCONS + t] >> (bit % 32)) & 1u;
          v[q] = on ? (1.f - __fmul_rn(s, s)) * w8 : 0.f;
        }
        put4<C>(act, col * LD + row0 + m, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
    exchange_end<C>(xbar, xph, t);

    // ---- steps 7..1: g = g W[i-1]^T under layer i-1's mask
    for (int layer = 7; layer >= 1; --layer) {
      product<TM, KS, NSLOT, LD, SLOT_FLOATS>(acc, act + row0, D / KS, bw, rg, lane);
      exchange_begin<C>(xbar, xph, t);
      uint32_t words[K::MW];
#pragma unroll
      for (int w = 0; w < K::MW; ++w) words[w] = masks[((layer - 1) * K::MW + w) * NCONS + t];
#pragma unroll
      for (int m = 0; m < TM; m += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = col0 + 32 * j;
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int bit = (m + q) * 4 + j;
            v[q] = (words[bit / 32] >> (bit % 32)) & 1u ? acc[m + q][j] : 0.f;
          }
          if (layer == 4 && col >= SPLIT) {
            // columns >= SPLIT of layer 4's input are the raw input: their
            // gradient goes to the output, unmasked, for the last product
            // to add to (after the exchanges, which order it cluster-wide)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int g = base + row0 + m + q;
              if (g < a.n) a.grad[size_t(g) * IN_DIM + col - SPLIT] = acc[m + q][j];
              v[q] = 0.f;
            }
          }
          put4<C>(act, col * LD + row0 + m, make_float4(v[0], v[1], v[2], v[3]));
        }
      }
      exchange_end<C>(xbar, xph, t);
    }

    // ---- the input gradient: g w0^T + the re-injection gradient (written
    // at step 4), this CTA's BM / C rows of the tile, one 128-column block
    // of w0^T after another
    constexpr int TMF = K::TMF;
    const int rf = rank * (BM / C) + warp * TMF;
    float accf[TMF][4];
#pragma unroll
    for (int cb = 0; cb < FL<L>::NB0; ++cb) {
      product<TMF, KS, NSLOT, LD, SLOT_FLOATS>(accf, act + rf, D / KS, ring + 4 * lane, rg, lane);
#pragma unroll
      for (int m = 0; m < TMF; ++m) {
        const int g = base + rf + m;
        if (g >= a.n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cb * BLK + lane + 32 * j;
          if (cb * BLK + 32 * j < IN_DIM && c < IN_DIM)
            a.grad[size_t(g) * IN_DIM + c] += accf[m][j];
        }
      }
    }
  }
}

// ---- host side

// The kernel of a layout, tiling and sweep: each layout's translation unit
// defines its __global__ kernels (so that each carries its own name in a
// trace) and specializes this.
template <class L, bool JAC, int C, int ROWS>
struct Kernel;

// The tilings the launcher chooses from: (rows of a tile, CTAs of a
// cluster), and the relative speed of a CTA of each, value kernel then
// Jacobian (measured by chip_smoke.py's phase 10 on an H100 SXM: the
// 8-row warp tiles of (32, 2) run slower than the 16-row ones of (32, 1)
// and (64, 2)).  Clusters of 4 lost everywhere (only 30 are resident, and
// their warp tiles are 8 rows too).
constexpr int N_TILINGS = 3;
constexpr int TILE_ROWS[N_TILINGS] = {32, 64, 32};
constexpr int TILE_C[N_TILINGS] = {1, 2, 2};
constexpr float EFF[2][N_TILINGS] = {{0.95f, 1.f, 0.84f}, {1.f, 1.f, 0.86f}};

template <class L, bool JAC, int C, int ROWS>
cudaError_t prepare() {
  return cudaFuncSetAttribute(Kernel<L, JAC, C, ROWS>::fn(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<L, JAC, C, ROWS>::SMEM);
}

template <class L, bool JAC, int C, int ROWS>
cudaLaunchConfig_t launch_config(int tiles, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Cfg<L, JAC, C, ROWS>::SMEM;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cfg;
}

// Clusters of the tiling resident on the card at once (cached after the
// first query; one card per process), or minus a cudaError_t.
template <class L, bool JAC, int C, int ROWS>
int resident() {
  static int cached = 0;
  if (cached > 0) return cached;
  cudaError_t err = prepare<L, JAC, C, ROWS>();
  if (err != cudaSuccess) return -int(err);
  int n = 0;
  if (C == 1) {
    int dev = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, Kernel<L, JAC, C, ROWS>::fn(), NT, Cfg<L, JAC, C, ROWS>::SMEM)) !=
            cudaSuccess)
      return -int(err);
    n *= per_sm;
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config<L, JAC, C, ROWS>(1024, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&n, Kernel<L, JAC, C, ROWS>::fn(), &cfg);
    if (err != cudaSuccess) return -int(err);
  }
  cached = n > 0 ? n : 1;
  return cached;
}

template <class L, bool JAC>
int resident_of(int i) {
  return i == 0 ? resident<L, JAC, 1, 32>() : i == 1 ? resident<L, JAC, 2, 64>()
                : resident<L, JAC, 2, 32>();
}

// The tiling for n rows: the least time in units of one CTA's work at the
// relative speed EFF, counting whole waves of resident clusters; or the one
// forced (`mlp_sdf_f32_force_tiling`, both layouts).
template <class L, bool JAC>
int pick_tiling(int n) {
  if (mlp_sdf_f32_forced_tiling >= 0) return mlp_sdf_f32_forced_tiling;
  int best = 0;
  float best_cost = 0.f;
  for (int i = 0; i < N_TILINGS; ++i) {
    const int res = resident_of<L, JAC>(i);
    if (res < 0) return res;
    const int tiles = (n + TILE_ROWS[i] - 1) / TILE_ROWS[i];
    const float cost = float((tiles + res - 1) / res) * TILE_ROWS[i] / TILE_C[i] / EFF[JAC][i];
    if (i == 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

template <class L, bool JAC, int C, int ROWS>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err = prepare<L, JAC, C, ROWS>();
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<L, JAC, C, ROWS>((a.n + ROWS - 1) / ROWS, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, Kernel<L, JAC, C, ROWS>::fn(), a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <class L, bool JAC>
int launch_picked(const Args& a, cudaStream_t stream) {
  const int i = pick_tiling<L, JAC>(a.n);
  if (i < 0) return -i;
  return i == 0 ? launch<L, JAC, 1, 32>(a, stream) : i == 1 ? launch<L, JAC, 2, 64>(a, stream)
                : launch<L, JAC, 2, 32>(a, stream);
}

// Launch on `stream`: code (C, LATENT) f32, row g uses code row g /
// rows_per_code; xyz (n, 3) f32; fwd = pack_value_tiles_f32(w0, W), bwd =
// pack_backward_tiles_f32(w0, W) (f32; bwd for the Jacobian only); W (8,
// 512, 512) f32 for layer 8's column; b (9, 512) f32; sdf (n,) f32 and,
// for the Jacobian, grad (n, LATENT + 3) f32.  Returns the launch's
// cudaError_t.  n > 0.
template <class L>
int launch_f32(int jac, const void* code, int rows_per_code, const void* xyz, int n,
               const void* fwd, const void* bwd, const void* W, const void* b, void* sdf,
               void* grad, void* stream) {
  const Args a{static_cast<const float*>(code), rows_per_code,
               static_cast<const float*>(xyz),  n,
               static_cast<const float*>(fwd),  static_cast<const float*>(bwd),
               static_cast<const float*>(W),    static_cast<const float*>(b),
               static_cast<float*>(sdf),        static_cast<float*>(grad)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return jac ? launch_picked<L, true>(a, st) : launch_picked<L, false>(a, st);
}

constexpr int CONFIG_INTS = 9;

template <class L, bool JAC, int C, int ROWS>
int config_of(int* out) {
  using K = Cfg<L, JAC, C, ROWS>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, Kernel<L, JAC, C, ROWS>::fn());
  if (err != cudaSuccess) return int(err);
  const int res = resident<L, JAC, C, ROWS>();
  if (res < 0) return -res;
  const int v[CONFIG_INTS] = {K::SMEM, NT,     ROWS, C, attr.numRegs, int(attr.localSizeBytes),
                              K::NSLOT, K::SLOT_BYTES, res};
  for (int i = 0; i < CONFIG_INTS; ++i) out[i] = v[i];
  return 0;
}

template <class L, bool JAC>
int configs_of(int* out) {
  int err = 0;
  if ((err = config_of<L, JAC, 1, 32>(out)) ||
      (err = config_of<L, JAC, 2, 64>(out + CONFIG_INTS)) ||
      (err = config_of<L, JAC, 2, 32>(out + 2 * CONFIG_INTS)))
    return err;
  return 0;
}

// For the value kernel, then the Jacobian, each at its 3 tilings (rows x
// C: 32 x 1, 64 x 2, 32 x 2): shared memory per CTA, threads per CTA,
// rows per tile, C, registers per thread, local (spill) bytes, ring slots,
// bytes per slot, clusters resident at once; 54 ints.
template <class L>
int f32_config(int* out) {
  int err = configs_of<L, false>(out);
  return err ? err : configs_of<L, true>(out + N_TILINGS * CONFIG_INTS);
}

}  // namespace fk
}  // namespace
