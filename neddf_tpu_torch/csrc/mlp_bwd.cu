// Value-only MLP backward (mlp_seg's VJP) for sm_90a.
//
// Replaces the Pallas backward neddf_tpu/kernels/mlp.py::_run_backward
// (kernel body _bwd_kernel, stashed variant). The Python wrapper
// (kernels/mlp.py::mlp_seg_bwd_route) walks the layers in reverse:
//
// * neddf_mlp_bwd_gpre, for the top layer (on the per-layer route, for
//   every layer after its reduce-scatter): from the output cotangent
//   g [M, C] (f32) and the forward's stash z [M, C] (type T) the cotangent
//   of the pre-activation gpre = g f'(z), rounded to T (the Pallas _mm_nt
//   / _mm_tn cast it before both products), and one f32 partial of db =
//   sum_rows gpre per block of rows;
// * per layer l, two products on the tensor cores (route_products.cu):
//   dW = f(z_{l-1})^T gpre with the activation applied to the stash as the
//   prologue of the tn product (the input rounded to T, as the forward
//   fed it), and dx = gpre W^T over all of W's rows with the epilogue
//   gpre_{l-1} = T(dx f'(z_{l-1})) and its db partials per 128-row tile;
//   the columns of a post-skip layer's seg0 rows leave raw and go to
//   layer 0's first segment;
// * neddf_sum_rows / neddf_sum_splits: the fixed-order sums of the db /
//   dW partials, so that two runs give bitwise-equal dW and db.
//
// What bounds it on the H100: the two products per layer, 2 * M * C *
// fan_in FLOPs each, on the tensor cores (bf16, or f32 by the 3xTF32
// split; see route_products.cu); gpre moves ~(4 + 2 * sizeof(T)) bytes per
// element of the top layer and is bound by device memory.
#include "mlp_tile.cuh"

namespace {

using neddf::from_f32;
using neddf::to_f32;

template <typename T, int ACT>
__global__ void gpre_kernel(int C, int M, int rows_per_block,
                            const float* __restrict__ g,
                            const T* __restrict__ z, const float* __restrict__ add,
                            T* __restrict__ gs, float* __restrict__ db_part) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  float db = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + c;
    float f, d1;
    neddf::act_fn<ACT>(to_f32(z[i]), f, d1);
    const float gv = g[i] * d1 + (add != nullptr ? add[i] : 0.f);
    db += gv;
    gs[i] = from_f32<T>(gv);
  }
  if (db_part != nullptr) db_part[(size_t)blockIdx.x * C + c] = db;
}

template <typename T>
cudaError_t gpre(int act, int width, int M, int rows_per_block, const void* g,
                 const void* z, const void* add, void* gs, void* db_part, cudaStream_t s) {
  const dim3 block(256);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  const float* gf = static_cast<const float*>(g);
  const T* zt = static_cast<const T*>(z);
  const float* af = static_cast<const float*>(add);
  T* gt = static_cast<T*>(gs);
  float* dbp = static_cast<float*>(db_part);
  return neddf::by_act(act, [&](auto a_) {
    gpre_kernel<T, decltype(a_)::value><<<grid, block, 0, s>>>(width, M, rows_per_block, gf, zt,
                                                               af, gt, dbp);
    return cudaGetLastError();
  });
}

}  // namespace

// gs = T(g f'(z) + add) [M, width] and one f32 db partial per block of
// rows_per_block rows; add (f32) and db_part may be null. The top layer's
// cotangent of the fused backwards (every lower layer's runs in the
// epilogue of its nt product); on the per-layer route (a column shard of
// each layer, kernels/dual_mlp.py::dual_mlp_layers_bwd and
// kernels/sdf_mlp.py's walks) every layer's, from the f32 cotangent that
// the reduce-scatter over the model group summed: the sum of the ranks'
// partial products has to be whole before f'(z) multiplies it, so it
// cannot be an nt product's epilogue there. The sdf sweep's step p = q
// f'(z) takes it without db.
extern "C" int neddf_mlp_bwd_gpre(int dtype, int act, int width, int M,
                                  int rows_per_block, const void* g, const void* z,
                                  const void* add, void* gs, void* db_part, void* stream) {
  if (width <= 0 || M <= 0 || rows_per_block <= 0 || g == nullptr || z == nullptr ||
      gs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? gpre<__nv_bfloat16>(act, width, M, rows_per_block, g, z, add, gs, db_part,
                                         s)
                   : gpre<float>(act, width, M, rows_per_block, g, z, add, gs, db_part, s));
}
