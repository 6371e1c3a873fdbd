// The f32 FMA kernels (mlp_sdf_f32.cuh) for DeepSDF's published ShapeNet
// layout: latent 256, layer 0 over 272 rows, a last product of three
// 128-column blocks.
#include "mlp_sdf_f32.cuh"

namespace {
namespace fk {

using L256 = Layout<256>;

template <bool JAC, int C, int ROWS>
__global__ void __launch_bounds__(NT, 1) mlp_sdf256_f32_kernel(Args a) {
  f32_body<L256, JAC, C, ROWS>(a);
}

template <bool JAC, int C, int ROWS>
struct Kernel<L256, JAC, C, ROWS> {
  static auto fn() { return mlp_sdf256_f32_kernel<JAC, C, ROWS>; }
};

}  // namespace fk
}  // namespace

// Launch on `stream` (called by mlp_sdf.cu's C interface): fk::launch_f32 at
// latent 256, grad (n, 259).
int mlp_sdf256_f32(int jac, const void* code, int rows_per_code, const void* xyz, int n,
                   const void* fwd, const void* bwd, const void* W, const void* b, void* sdf,
                   void* grad, void* stream) {
  return fk::launch_f32<fk::L256>(jac, code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                  stream);
}

// fk::f32_config of the latent-256 kernels: 54 ints.
extern "C" int mlp_sdf256_f32_config(int* out) { return fk::f32_config<fk::L256>(out); }

// The tiling the latent-256 launcher takes for n rows, or minus a cudaError_t.
extern "C" int mlp_sdf256_f32_tiling(int jac, int n) {
  return jac ? fk::pick_tiling<fk::L256, true>(n) : fk::pick_tiling<fk::L256, false>(n);
}
