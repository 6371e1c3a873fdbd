// The bf16 tensor-core Jacobian kernel (mlp_sdf_jacobian_tc.cuh) for the
// cars/chairs_64 layout: latent 64, the whole input row in the row tile.
#include "mlp_sdf_jacobian_tc.cuh"

namespace {

using L64 = Layout<64>;

__global__ void __launch_bounds__(NT, 1)
    mlp_sdf_jacobian_tc_kernel(const float* __restrict__ code, int rows_per_code,
                               const float* __restrict__ xyz, int n,
                               const uint8_t* __restrict__ fwd, const uint8_t* __restrict__ bwd,
                               const __nv_bfloat16* __restrict__ W,
                               const float* __restrict__ bias, float* __restrict__ sdf,
                               float* __restrict__ grad, uint8_t* __restrict__ relu) {
  jacobian_body<L64>(code, rows_per_code, xyz, n, fwd, bwd, W, bias, nullptr, 0, sdf, grad,
                     relu);
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
  constexpr size_t SMEM = Jac<L64>::SMEM;
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

extern "C" int mlp_sdf_jacobian_tc_config(int* out) {
  return jacobian_config<L64>(mlp_sdf_jacobian_tc_kernel, out);
}
