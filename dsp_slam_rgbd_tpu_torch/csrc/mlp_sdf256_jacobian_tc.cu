// The bf16 tensor-core Jacobian kernel (mlp_sdf_jacobian_tc.cuh) for
// DeepSDF's published ShapeNet layout: latent 256, the code's products
// folded per code (mlp_sdf_tc.cuh).  Each launch runs the fold kernel first.
// d sdf / d code of a row is then g0 . W0,z^T + g4 . W4,z^T: the second term
// comes out of backward step 4 (the re-injected columns), the first out of
// the last product, whose 320 outputs cover the whole input row.
#include "mlp_sdf_jacobian_tc.cuh"

namespace {

using L256 = Layout<256>;

__global__ void __launch_bounds__(FOLD_THREADS)
    mlp_sdf256_jacobian_tc_fold_kernel(const float* __restrict__ code, int codes,
                                       const __nv_bfloat16* __restrict__ w0,
                                       const __nv_bfloat16* __restrict__ W,
                                       const float* __restrict__ bias,
                                       float* __restrict__ fold) {
  fold_body<L256>(code, codes, w0, W, bias, fold);
}

__global__ void __launch_bounds__(NT, 1)
    mlp_sdf256_jacobian_tc_kernel(const float* __restrict__ code, int rows_per_code,
                                  const float* __restrict__ xyz, int n,
                                  const uint8_t* __restrict__ fwd,
                                  const uint8_t* __restrict__ bwd,
                                  const __nv_bfloat16* __restrict__ W,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ fold, int codes,
                                  float* __restrict__ sdf, float* __restrict__ grad,
                                  uint8_t* __restrict__ relu) {
  jacobian_body<L256>(code, rows_per_code, xyz, n, fwd, bwd, W, bias, fold, codes, sdf, grad,
                      relu);
}

}  // namespace

// Launch on `stream`: code (C, 256) f32, row g uses code row g / rows_per_code;
// xyz (n, 3) f32; fwd = pack_value_tiles(w0, W), bwd = pack_backward_tiles(w0,
// W) (bf16); w0 (384, 512) and W (8, 512, 512) bf16 for the fold and layer
// 8's column; b (9, 512) f32; fold (2, C, 512) f32 scratch; sdf (n,) f32,
// grad (n, 259) f32; relu, if not null, (n, 8, 512) uint8 gets the ReLU
// masks the kernel took.  Returns the launches' cudaError_t.  n > 0.
int mlp_sdf256_jacobian_tc(const void* code, int rows_per_code, const void* xyz, int n,
                           const void* fwd, const void* bwd, const void* w0, const void* W,
                           const void* b, void* fold, void* sdf, void* grad, void* relu,
                           void* stream) {
  constexpr size_t SMEM = Jac<L256>::SMEM;
  const int codes = (n + rows_per_code - 1) / rows_per_code;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_sdf256_jacobian_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM));
  if (err != cudaSuccess) return int(err);
  mlp_sdf256_jacobian_tc_fold_kernel<<<dim3(codes, 2), FOLD_THREADS, 0, st>>>(
      static_cast<const float*>(code), codes, static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(b),
      static_cast<float*>(fold));
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  mlp_sdf256_jacobian_tc_kernel<<<(n + BM - 1) / BM, NT, SMEM, st>>>(
      static_cast<const float*>(code), rows_per_code, static_cast<const float*>(xyz), n,
      static_cast<const uint8_t*>(fwd), static_cast<const uint8_t*>(bwd),
      static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(b),
      static_cast<const float*>(fold), codes, static_cast<float*>(sdf),
      static_cast<float*>(grad), static_cast<uint8_t*>(relu));
  return int(cudaGetLastError());
}

extern "C" int mlp_sdf256_jacobian_tc_config(int* out) {
  return jacobian_config<L256>(mlp_sdf256_jacobian_tc_kernel, out);
}
