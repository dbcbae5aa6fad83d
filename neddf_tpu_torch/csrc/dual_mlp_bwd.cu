// Dual-MLP backward (the dual chain rule in reverse) for sm_90a.
//
// Replaces the Pallas backward neddf_tpu/kernels/dual_mlp.py::
// _run_backward (kernel body _bwd_kernel:728, stashed variant). The
// Python wrapper (kernels/dual_mlp.py::dual_mlp_seg_bwd) walks the layers
// in reverse and launches, per layer l with stacked streams S = K+1:
//
// * neddf_dual_bwd_gstack: from the output cotangent g [S, M, C] (f32)
//   and the forward's stash z [S, M, C] (type T) the stacked cotangent
//   of the pre-activation,
//       G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a   (the f'' coupling)
//       G_a = g_a f'(z_v),
//   rounded to T (the Pallas _mm casts it before both products), and one
//   f32 partial of db = sum_rows G_v per block of rows;
// * neddf_dual_act: the layer's input h_in = (f(z_v), f'(z_v) z_a)
//   recomputed from the stash of layer l-1, rounded to T;
// * neddf_gemm_f32acc twice: dx = G W^T and dW = h_in^T G (for layer 0
//   and a post-skip layer, per input block of rows of W);
// * neddf_sum_splits: the fixed-order sum of the dW / db partials.
//
// Determinism. The Pallas kernel accumulates dW/db across its sequential
// TPU grid; blocks here run concurrently, so every cross-block reduction
// writes per-block (or per-split) f32 partials that a second pass sums
// in a fixed order. No float atomics: two runs give bitwise-equal dW.
//
// What bounds it on the H100: the two products per layer are
// 2 * S*M * C * fan_in FLOPs each (about 0.1 TFLOP per trunk layer at
// the training batch), done here as a plain tiled FMA product on the
// CUDA cores (64x64 output tile, 4x4 per thread, f32 accumulators,
// operands converted from T in shared memory): bound by the CUDA cores'
// FMA rate and shared-memory loads. The elementwise kernels move
// ~(3 * 4 + 4 * 2) bytes per stacked element in bf16 and are bound by
// device memory. Tensor-core (mma.sync / wgmma) products are the next
// step.
#include "mlp_tile.cuh"

namespace {

using neddf::grid_1d;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr int kMaxStreams = 4;

template <typename T>
__global__ void gstack_kernel(int S, int C, int M, int rows_per_block,
                              const float* __restrict__ g,
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
    neddf::act_fn3<neddf::kTanhExp>(ld(z, i), f, d1, d2);
    float coupling = 0.f;
    float gt[kMaxStreams];
    for (int a = 1; a < S; ++a) {
      gt[a] = g[a * plane + i];
      coupling = fmaf(gt[a], ld(z, a * plane + i), coupling);
    }
    const float gv = g[i] * d1 + d2 * coupling;
    db += gv;
    st(gs, i, gv);
    for (int a = 1; a < S; ++a) st(gs, a * plane + i, gt[a] * d1);
  }
  db_part[(size_t)blockIdx.x * C + c] = db;
}

template <typename T>
__global__ void dual_act_kernel(int S, int C, int M, const T* __restrict__ z,
                                T* __restrict__ h) {
  const size_t plane = (size_t)M * C;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float f, d1, d2;
    neddf::act_fn3<neddf::kTanhExp>(ld(z, i), f, d1, d2);
    st(h, i, f);
    for (int a = 1; a < S; ++a) st(h, a * plane + i, d1 * ld(z, a * plane + i));
  }
}

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kGemmThreads = 256;

// out[z][m][n] = sum over k in split z of A(m, k) B(k, n), with
// A(m, k) = A[m*sam + k*sak] and B(k, n) = B[k*sbk + n*sbn] (type T),
// f32 accumulators. Loads follow the unit stride of each operand.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(int M, int N, int K, int k_chunk, const T* __restrict__ A,
                long long sam, long long sak, const T* __restrict__ B,
                long long sbk, long long sbn, float* __restrict__ out) {
  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Bs[kDepth][kTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  float acc[4][4] = {};
  for (int k0 = kb; k0 < ke; k0 += kDepth) {
    for (int idx = tid; idx < kTile * kDepth; idx += kGemmThreads) {
      int mm, kk;
      if (sak == 1) {
        mm = idx / kDepth;
        kk = idx % kDepth;
      } else {
        mm = idx % kTile;
        kk = idx / kTile;
      }
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < ke) ? ld(A, (size_t)m * sam + (size_t)k * sak) : 0.f;
      int nn;
      if (sbk == 1) {
        nn = idx / kDepth;
        kk = idx % kDepth;
      } else {
        nn = idx % kTile;
        kk = idx / kTile;
      }
      const int n = n0 + nn, k2 = k0 + kk;
      Bs[kk][nn] = (n < N && k2 < ke) ? ld(B, (size_t)k2 * sbk + (size_t)n * sbn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) o[(size_t)m * N + n] = acc[i][j];
    }
  }
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

}  // namespace

extern "C" int neddf_dual_bwd_gstack(int dtype, int act, int n_tan, int width,
                                     int M, int rows_per_block, const void* g,
                                     const void* z, void* gs, void* db_part,
                                     void* stream) {
  if (act != 0 || n_tan < 1 || n_tan + 1 > kMaxStreams || M <= 0 ||
      rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  float* dbp = static_cast<float*>(db_part);
  if (dtype == 1)
    gstack_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        n_tan + 1, width, M, rows_per_block, gf,
        static_cast<const __nv_bfloat16*>(z), static_cast<__nv_bfloat16*>(gs), dbp);
  else
    gstack_kernel<float><<<grid, block, 0, s>>>(
        n_tan + 1, width, M, rows_per_block, gf, static_cast<const float*>(z),
        static_cast<float*>(gs), dbp);
  return (int)cudaGetLastError();
}

extern "C" int neddf_dual_act(int dtype, int act, int n_tan, int width, int M,
                              const void* z, void* h, void* stream) {
  if (act != 0 || n_tan < 1 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_1d((size_t)M * width, 256);
  if (dtype == 1)
    dual_act_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        n_tan + 1, width, M, static_cast<const __nv_bfloat16*>(z),
        static_cast<__nv_bfloat16*>(h));
  else
    dual_act_kernel<float><<<grid, 256, 0, s>>>(
        n_tan + 1, width, M, static_cast<const float*>(z), static_cast<float*>(h));
  return (int)cudaGetLastError();
}

extern "C" int neddf_gemm_f32acc(int dtype, int M, int N, int K, const void* A,
                                 long long sam, long long sak, const void* B,
                                 long long sbk, long long sbn, int splits,
                                 void* out, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, splits);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    gemm_kernel<__nv_bfloat16><<<grid, kGemmThreads, 0, s>>>(
        M, N, K, k_chunk, static_cast<const __nv_bfloat16*>(A), sam, sak,
        static_cast<const __nv_bfloat16*>(B), sbk, sbn, o);
  else
    gemm_kernel<float><<<grid, kGemmThreads, 0, s>>>(
        M, N, K, k_chunk, static_cast<const float*>(A), sam, sak,
        static_cast<const float*>(B), sbk, sbn, o);
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
