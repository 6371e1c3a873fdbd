// The C interface of the fused DeepSDF decoder kernels for Hopper (sm_90a):
// the 9-layer DeepSDF MLP forward (value) and forward + input Jacobian over
// rows of [code | xyz], routed by latent size and operand type to
//   latent 64 (cars/chairs_64),    bf16 on the tensor cores:
//     mlp_sdf_value_tc.cu, mlp_sdf_jacobian_tc.cu;  f32 on the FMA pipes:
//     mlp_sdf_f32.cu
//   latent 256 (DeepSDF ShapeNet), bf16: mlp_sdf256_value_tc.cu,
//     mlp_sdf256_jacobian_tc.cu;  f32: mlp_sdf256_f32.cu
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
int mlp_sdf256_value_tc(const void* code, int rows_per_code, const void* xyz, int n,
                        const void* tiles, const void* w0, const void* W, const void* b,
                        void* fold, void* sdf, void* stream);
int mlp_sdf256_jacobian_tc(const void* code, int rows_per_code, const void* xyz, int n,
                           const void* fwd, const void* bwd, const void* w0, const void* W,
                           const void* b, void* fold, void* sdf, void* grad, void* relu,
                           void* stream);
int mlp_sdf256_f32(int jac, const void* code, int rows_per_code, const void* xyz, int n,
                   const void* fwd, const void* bwd, const void* W, const void* b, void* sdf,
                   void* grad, void* stream);

// C interface, bound with ctypes.  latent: 64 or 256 (any other returns
// cudaErrorInvalidValue).  code (C, latent) f32, row g uses code row
// g / rows_per_code; xyz (n, 3) f32; w0 (128 or 384, 512), W (8, 512, 512)
// in f32 (bf16 = 0) or bf16 (bf16 = 1); b (9, 512) f32.  Outputs sdf (n,)
// f32 and, for the Jacobian, grad (n, latent + 3) f32.  Returns the
// launch's cudaError_t.  n > 0.  The kernels read their weights from
// host-packed streams and only layer 8's column from W: in bf16
// pack_value_tiles(w0, W) (tiles, fwd) and pack_backward_tiles(w0, W)
// (bwd), in f32 pack_value_tiles_f32 and pack_backward_tiles_f32.  At
// latent 256 in bf16 a fold kernel first forms the code's products from w0
// and W into fold ((2, C, 512) f32 scratch); elsewhere w0 and fold are
// unused.  The bf16 Jacobian can report the ReLU masks it took into relu
// ((n, 8, 512) uint8, or null); in f32 relu is unused.
extern "C" int mlp_sdf_value(int latent, const void* code, int rows_per_code, const void* xyz,
                             int n, const void* w0, const void* W, const void* b, int bf16,
                             const void* tiles, void* fold, void* sdf, void* stream) {
  if (latent == 64)
    return bf16 ? mlp_sdf_value_tc(code, rows_per_code, xyz, n, tiles, W, b, sdf, stream)
                : mlp_sdf_f32(0, code, rows_per_code, xyz, n, tiles, nullptr, W, b, sdf,
                              nullptr, stream);
  if (latent == 256)
    return bf16 ? mlp_sdf256_value_tc(code, rows_per_code, xyz, n, tiles, w0, W, b, fold, sdf,
                                      stream)
                : mlp_sdf256_f32(0, code, rows_per_code, xyz, n, tiles, nullptr, W, b, sdf,
                                 nullptr, stream);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mlp_sdf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int mlp_sdf_jacobian(int latent, const void* code, int rows_per_code,
                                const void* xyz, int n, const void* w0, const void* W,
                                const void* b, int bf16, const void* fwd, const void* bwd,
                                void* fold, void* sdf, void* grad, void* relu, void* stream) {
  if (latent == 64)
    return bf16 ? mlp_sdf_jacobian_tc(code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                      relu, stream)
                : mlp_sdf_f32(1, code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                              stream);
  if (latent == 256)
    return bf16 ? mlp_sdf256_jacobian_tc(code, rows_per_code, xyz, n, fwd, bwd, w0, W, b, fold,
                                         sdf, grad, relu, stream)
                : mlp_sdf256_f32(1, code, rows_per_code, xyz, n, fwd, bwd, W, b, sdf, grad,
                                 stream);
  return int(cudaErrorInvalidValue);
}
