// The C interface of the fused DeepSDF decoder kernels for Hopper (sm_90a):
// the 9-layer cars_64 MLP forward (value) and forward + input Jacobian over
// rows of [code 64 | xyz 3], routed by operand type to
//   bf16, on the tensor cores:  mlp_sdf_value_tc.cu, mlp_sdf_jacobian_tc.cu
//   f32, on the FMA pipes:       mlp_sdf_f32.cu
// Together they replace the two Pallas TPU kernels of
// dsp_slam_rgbd_tpu/ops/pallas/mlp_sdf.py (`_make_value_kernel`,
// `_make_kernel`); each source's note says what bounds it and how.
#include <cuda_runtime.h>
#include <stdint.h>

int mlp_sdf_value_tc(const void* code, int rows_per_code, const void* xyz, int n,
                     const void* tiles, const void* W, const void* b, void* sdf, void* stream);
int mlp_sdf_jacobian_tc(const void* code, int rows_per_code, const void* xyz, int n,
                        const void* fwd, const void* bwd, const void* W, const void* b,
                        void* sdf, void* grad, void* relu, void* stream);
int mlp_sdf_f32(int jac, const void* code, int rows_per_code, const void* xyz, int n,
                const void* fwd, const void* bwd, const void* W, const void* b, void* sdf,
                void* grad, void* stream);

// C interface, bound with ctypes.  code (C, 64) f32, row g uses code
// row g / rows_per_code; xyz (n, 3) f32; w0 (128, 512), W (8, 512, 512)
// in f32 (bf16 = 0) or bf16 (bf16 = 1); b (9, 512) f32.  Outputs
// sdf (n,) f32 and, for the Jacobian, grad (n, 67) f32.  Returns the
// launch's cudaError_t.  n > 0.  The kernels read their weights from
// host-packed streams and only layer 8's column from W (w0 is unused): in
// bf16 pack_value_tiles(w0, W) (tiles, fwd) and pack_backward_tiles(w0, W)
// (bwd), in f32 pack_value_tiles_f32 and pack_backward_tiles_f32.  The bf16
// Jacobian can report the ReLU masks it took into relu ((n, 8, 512) uint8,
// or null); in f32 relu is unused.
extern "C" int mlp_sdf_value(const void* code, int rows_per_code, const void* xyz,
                             int n, const void* w0, const void* W, const void* b,
                             int bf16, const void* tiles, void* sdf, void* stream) {
  (void)w0;
  return bf16 ? mlp_sdf_value_tc(code, rows_per_code, xyz, n, tiles, W, b, sdf, stream)
              : mlp_sdf_f32(0, code, rows_per_code, xyz, n, tiles, nullptr, W, b, sdf, nullptr,
                            stream);
}

extern "C" const char* mlp_sdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int mlp_sdf_jacobian(const void* code, int rows_per_code, const void* xyz,
                                int n, const void* w0, const void* W, const void* b,
                                int bf16, const void* fwd, const void* bwd, void* sdf,
                                void* grad, void* relu, void* stream) {
  (void)w0;
  return bf16 ? mlp_sdf_jacobian_tc(code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                    relu, stream)
              : mlp_sdf_f32(1, code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad, stream);
}
