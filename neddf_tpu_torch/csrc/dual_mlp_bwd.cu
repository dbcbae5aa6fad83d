// Dual-MLP backward (the dual chain rule in reverse) for sm_90a: the top
// layer's stacked cotangent and the fixed-order sums.
//
// Replaces, with route_products.cu, the Pallas backward
// neddf_tpu/kernels/dual_mlp.py::_run_backward (kernel body
// _bwd_kernel:728, stashed variant). The Python walk
// (kernels/dual_mlp.py::dual_mlp_seg_bwd_route) goes through the layers
// in reverse with S = K+1 stacked streams [S, M, C]:
//
// * neddf_dual_bwd_gstack, once per call that starts from the output
//   cotangent (gv, gj), which no product produces (a call given the top
//   layer's stacked cotangent, the NeDDF trunk's from neddf_epilogue.cu's
//   top mode, launches none): from g and the stash z (type T) the
//   stacked cotangent of the pre-activation,
//       G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a   (the f'' coupling)
//       G_a = g_a f'(z_v),
//   rounded to T (the Pallas _mm casts it before both products), and one
//   f32 partial of db = sum_rows G_v per block of 64 rows;
// * per layer l > 0, two products with the elementwise work folded in,
//   on route_products.cu's wgmma kernels (DualProducts.tn_dual_act: dW_l
//   = h_in^T G_l with the layer input h_in = (f(z_v), f'(z_v) z_a) of the
//   stash z_{l-1} as the prologue; DualProducts.nt_gstack: G_l W_l^T with
//   G_{l-1}, rounded to T, and its db partials as the epilogue), over rows
//   grouped by point;
// * layer 0 (input segments, no activation) and a post-skip layer's seg0
//   rows (dx of seg0 is raw) take plain products (route_products.cu's
//   route_nt / route_tn; an nt of a depth under 8, a 3-wide layer's dx,
//   its shallow_nt); neddf_sum_rows sums the db partials in a fixed order
//   over the whole card (groups of rows, then the groups);
//   neddf_sum_splits the dW split partials.
// Determinism. The Pallas kernel accumulates dW/db across its sequential
// TPU grid; blocks here run concurrently, so every cross-block reduction
// writes per-block (or per-split) f32 partials that a second pass sums
// in a fixed order. No float atomics: two runs give bitwise-equal dW.
#include "mlp_tile.cuh"

namespace {

using neddf::grid_1d;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr int kMaxStreams = 4;

// the top layer's stacked cotangent from g = (gv [M, C], gj [K, M, C])
// in G (T, or f32: the per-layer route's cotangents, summed over the
// ranks' column shards in f32); the layers below get theirs from the dx
// product's epilogue, or on the per-layer route from this kernel again
template <typename T, typename G, int ACT>
__global__ void gstack_kernel(int S, int C, int M, int rows_per_block,
                              const G* __restrict__ gv, const G* __restrict__ gj,
                              const T* __restrict__ z, T* __restrict__ gs,
                              float* __restrict__ db_part) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  const size_t plane = (size_t)M * C;
  float db = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + c;
    float f, d1, d2;
    neddf::act_fn3<ACT>(ld(z, i), f, d1, d2);
    float coupling = 0.f;
    float gt[kMaxStreams];
    for (int a = 1; a < S; ++a) {
      gt[a] = ld(gj, (a - 1) * plane + i);
      if constexpr (!neddf::kZeroDeriv2<ACT>)
        coupling = fmaf(gt[a], ld(z, a * plane + i), coupling);
    }
    const float g0 = neddf::dual_gv(ld(gv, i), d1, d2, coupling);
    db += g0;
    st(gs, i, g0);
    for (int a = 1; a < S; ++a) st(gs, a * plane + i, gt[a] * d1);
  }
  db_part[(size_t)blockIdx.x * C + c] = db;
}

__global__ void sum_splits_kernel(long long n, int splits,
                                  const float* __restrict__ parts,
                                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += parts[z * n + i];
    out[i] = s;
  }
}

// the first level of the db sum: block (column group x, row group y) adds
// its rows of 32 columns, warp w taking rows w, w + 8, ... in order, and
// the 8 warps' sums in warp order; group_sums [gridDim.y, C]
__global__ void sum_rows_kernel(int R, int C, int rows_per_group,
                                const float* __restrict__ parts,
                                float* __restrict__ group_sums) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rows_per_group;
  const int r1 = min(R, r0 + rows_per_group);
  float s = 0.f;
  if (c < C)
    for (int r = r0 + warp; r < r1; r += 8) s += parts[(size_t)r * C + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    group_sums[(size_t)blockIdx.y * C + c] = t;
  }
}

}  // namespace

// The top layer's stacked cotangent (gstack_kernel): gv [M, width], gj
// [n_tan, M, width] (dtype 1 bf16 or 0 f32, or f32 where g_f32) and the
// stash z [n_tan + 1, M, width] (dtype), into gs (same shape and type as
// z) and the f32 db partials [ceil(M / rows_per_block), width].
extern "C" int neddf_dual_bwd_gstack(int dtype, int g_f32, int act, int n_tan, int width,
                                     int M, int rows_per_block, const void* gv,
                                     const void* gj, const void* z, void* gs,
                                     void* db_part, void* stream) {
  if (n_tan < 1 || n_tan + 1 > kMaxStreams || M <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dbp = static_cast<float*>(db_part);
  return (int)neddf::by_act(act, [&](auto a_) {
    constexpr int ACT = decltype(a_)::value;
    if (dtype == 1 && g_f32)
      gstack_kernel<bf16, float, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const float*>(gv),
          static_cast<const float*>(gj), static_cast<const bf16*>(z), static_cast<bf16*>(gs),
          dbp);
    else if (dtype == 1)
      gstack_kernel<bf16, bf16, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const bf16*>(gv),
          static_cast<const bf16*>(gj), static_cast<const bf16*>(z), static_cast<bf16*>(gs),
          dbp);
    else
      gstack_kernel<float, float, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const float*>(gv),
          static_cast<const float*>(gj), static_cast<const float*>(z), static_cast<float*>(gs),
          dbp);
    return cudaGetLastError();
  });
}

// out [C] = the sum over the R rows of parts [R, C] in a fixed order: the
// rows in groups of rows_per_group (sum_rows_kernel, columns x groups
// spread over the card) into scratch [ceil(R / rows_per_group), C], then
// the groups in order (sum_splits_kernel). Two runs give the same bits.
extern "C" int neddf_sum_rows(int R, int C, int rows_per_group, const void* parts,
                              void* scratch, void* out, void* stream) {
  if (R <= 0 || C <= 0 || rows_per_group <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (R + rows_per_group - 1) / rows_per_group;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  sum_rows_kernel<<<dim3((C + 31) / 32, groups), 256, 0, s>>>(
      R, C, rows_per_group, static_cast<const float*>(parts), sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<grid_1d((size_t)C, 256), 256, 0, s>>>(C, groups, sc,
                                                            static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int neddf_sum_splits(long long n, int splits, const void* parts,
                                void* out, void* stream) {
  if (n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_splits_kernel<<<grid_1d((size_t)n, 256), 256, 0, s>>>(
      n, splits, static_cast<const float*>(parts), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
