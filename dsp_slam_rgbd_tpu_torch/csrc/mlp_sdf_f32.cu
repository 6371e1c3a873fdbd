// The f32 FMA kernels (mlp_sdf_f32.cuh) for the cars/chairs_64 layout.
#include "mlp_sdf_f32.cuh"

int mlp_sdf_f32_forced_tiling = -1;

namespace {
namespace fk {

using L64 = Layout<64>;

template <bool JAC, int C, int ROWS>
__global__ void __launch_bounds__(NT, 1) mlp_sdf_f32_kernel(Args a) {
  f32_body<L64, JAC, C, ROWS>(a);
}

template <bool JAC, int C, int ROWS>
struct Kernel<L64, JAC, C, ROWS> {
  static auto fn() { return mlp_sdf_f32_kernel<JAC, C, ROWS>; }
};

}  // namespace fk
}  // namespace

// Launch on `stream` (called by mlp_sdf.cu's C interface): fk::launch_f32 at
// latent 64, grad (n, 67).
int mlp_sdf_f32(int jac, const void* code, int rows_per_code, const void* xyz, int n,
                const void* fwd, const void* bwd, const void* W, const void* b, void* sdf,
                void* grad, void* stream) {
  return fk::launch_f32<fk::L64>(jac, code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                 stream);
}

// fk::f32_config of the latent-64 kernels: 54 ints.
extern "C" int mlp_sdf_f32_config(int* out) { return fk::f32_config<fk::L64>(out); }

// The tiling (index into the config's 3) the launcher takes for n rows
// (jac: the Jacobian kernel), or minus a cudaError_t.
extern "C" int mlp_sdf_f32_tiling(int jac, int n) {
  return jac ? fk::pick_tiling<fk::L64, true>(n) : fk::pick_tiling<fk::L64, false>(n);
}

// Forces the tiling of every later launch at either latent size (0..2; -1
// picks by row count again), for timing each choice.  Returns the previous
// setting.
extern "C" int mlp_sdf_f32_force_tiling(int i) {
  const int prev = mlp_sdf_f32_forced_tiling;
  mlp_sdf_f32_forced_tiling = (i >= 0 && i < fk::N_TILINGS) ? i : -1;
  return prev;
}
