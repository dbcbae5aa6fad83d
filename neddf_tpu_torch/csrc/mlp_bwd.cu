// Value-only MLP backward (mlp_seg's VJP) for sm_90a.
//
// Replaces the Pallas backward neddf_tpu/kernels/mlp.py::_run_backward
// (kernel body _bwd_kernel, stashed variant). The Python wrapper
// (kernels/mlp.py::mlp_seg_bwd) walks the layers in reverse and
// launches, per layer l:
//
// * neddf_mlp_bwd_gpre: from the output cotangent g [M, C] (f32) and the
//   forward's stash z [M, C] (type T) the cotangent of the
//   pre-activation gpre = g f'(z), rounded to T (the Pallas _mm_nt /
//   _mm_tn cast it before both products), and one f32 partial of
//   db = sum_rows gpre per block of rows;
// * neddf_mlp_act: the layer's input f(z_{l-1}) recomputed from the stash
//   of layer l-1, rounded to T;
// * neddf_gemm_tc (dual_mlp_bwd.cu): dx = gpre W^T and dW = h_in^T
//   gpre, per input segment of layer 0 and per block of rows of a
//   post-skip layer's W ([h, seg0]: the seg0 rows' cotangent goes to
//   layer 0's first segment);
// * neddf_sum_splits (dual_mlp_bwd.cu): the fixed-order sum of the dW /
//   db partials, so that two runs give bitwise-equal dW and db.
//
// What bounds it on the H100: the two products per layer, 2 * M * C *
// fan_in FLOPs each, on the tensor cores (bf16, or f32 by the 3xTF32
// split; see dual_mlp_bwd.cu); the two
// elementwise kernels here move ~(4 + 2 * sizeof(T)) bytes per element
// and are bound by device memory.
#include "mlp_tile.cuh"

namespace {

using neddf::from_f32;
using neddf::grid_1d;
using neddf::kReLU;
using neddf::kTanhExp;
using neddf::to_f32;

template <typename T, int ACT>
__global__ void gpre_kernel(int C, int M, int rows_per_block,
                            const float* __restrict__ g,
                            const T* __restrict__ z, T* __restrict__ gs,
                            float* __restrict__ db_part) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  float db = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + c;
    float f, d1;
    neddf::act_fn<ACT>(to_f32(z[i]), f, d1);
    const float gv = g[i] * d1;
    db += gv;
    gs[i] = from_f32<T>(gv);
  }
  db_part[(size_t)blockIdx.x * C + c] = db;
}

template <typename T, int ACT>
__global__ void act_kernel(size_t n, const T* __restrict__ z, T* __restrict__ h) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float f, d1;
    neddf::act_fn<ACT>(to_f32(z[i]), f, d1);
    h[i] = from_f32<T>(f);
  }
}

template <typename T>
cudaError_t gpre(int act, int width, int M, int rows_per_block, const void* g,
                 const void* z, void* gs, void* db_part, cudaStream_t s) {
  const dim3 block(256);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  const float* gf = static_cast<const float*>(g);
  const T* zt = static_cast<const T*>(z);
  T* gt = static_cast<T*>(gs);
  float* dbp = static_cast<float*>(db_part);
  if (act == kReLU)
    gpre_kernel<T, kReLU><<<grid, block, 0, s>>>(width, M, rows_per_block, gf, zt, gt, dbp);
  else
    gpre_kernel<T, kTanhExp><<<grid, block, 0, s>>>(width, M, rows_per_block, gf, zt, gt, dbp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t act_run(int act, size_t n, const void* z, void* h, cudaStream_t s) {
  const int grid = grid_1d(n, 256);
  const T* zt = static_cast<const T*>(z);
  T* ht = static_cast<T*>(h);
  if (act == kReLU)
    act_kernel<T, kReLU><<<grid, 256, 0, s>>>(n, zt, ht);
  else
    act_kernel<T, kTanhExp><<<grid, 256, 0, s>>>(n, zt, ht);
  return cudaGetLastError();
}

}  // namespace

extern "C" int neddf_mlp_bwd_gpre(int dtype, int act, int width, int M,
                                  int rows_per_block, const void* g, const void* z,
                                  void* gs, void* db_part, void* stream) {
  if ((act != kTanhExp && act != kReLU) || width <= 0 || M <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? gpre<__nv_bfloat16>(act, width, M, rows_per_block, g, z, gs, db_part, s)
                   : gpre<float>(act, width, M, rows_per_block, g, z, gs, db_part, s));
}

extern "C" int neddf_mlp_act(int dtype, int act, long long n, const void* z, void* h,
                             void* stream) {
  if ((act != kTanhExp && act != kReLU) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? act_run<__nv_bfloat16>(act, (size_t)n, z, h, s)
                          : act_run<float>(act, (size_t)n, z, h, s));
}
