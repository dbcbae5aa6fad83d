// SDF trunk with its channel-0 gradient (the NeuS trunk) for sm_90a.
//
// Replaces the Pallas kernels of neddf_tpu/kernels/sdf_mlp.py:
//
// * forward, _run_forward / _fwd_kernel (_trunk_and_sweep:69): one block
//   per row tile of 128 samples runs the trunk h = f(z_l), z_l = in_l W_l
//   + b_l (mlp_tile.cuh's tile_forward, K=0; the post-skip layer reads
//   [h, e], kSplitHiddenFirst), writing the stash z_l [M, C] and h [M, C];
//   then, in the same block, the reverse sweep of channel 0:
//       p_{L-1} = onehot0 * f'(z_{L-1});  q_l = p_l W_l^T;
//       p_{l-1} = q_l[hidden] * f'(z_{l-1});  gE += q_l[e rows]
//   (the e rows of layer 0 and of every post-skip layer). p lives in the
//   shared buffer of h, gE in shared memory after the weight tile; z_{l-1} is
//   read back from the stash this block wrote (L2-resident). No other
//   activation reaches device memory. Out: h, gE [M, E], the stash.
// * backward, _run_backward / _bwd_kernel:176-242, is run by the Python
//   wrapper (kernels/sdf_mlp.py::sdf_mlp_bwd) as launches of the
//   elementwise kernels below and of neddf_gemm_f32acc /
//   neddf_sum_splits (dual_mlp_bwd.cu) for every product and every
//   cross-row sum (dW, db in a fixed order: bitwise reproducible):
//     replay: p_l and q_l[hidden] from the stash (neddf_sdf_sweep_p);
//     ascending adjoint of the sweep: qbar_0 = cg; for l >= 1
//       qbar_l[hidden] = pbar_{l-1} f'(z_{l-1}), qbar_l[e] = cg,
//       zs_{l-1} = pbar_{l-1} q_l[hidden] f''(z_{l-1}) (neddf_sdf_adjoint),
//       dW_l += qbar_l^T p_l, pbar_l = qbar_l W_l;
//       top: zs_{L-1} = onehot0 * pbar_{L-1} f''(z_{L-1});
//     descending trunk backward: zbar_l = hbar_l f'(z_l) + zs_l and its db
//       partials (neddf_sdf_zbar), dW_l += in_l^T zbar_l, hbar_{l-1} and
//       ebar from zbar_l W_l^T, in_l = f(z_{l-1}) (neddf_sdf_act) or e.
//
// Numerics: f32 throughout (NeuS runs its trunk in f32); sums in f32.
//
// What bounds it on the H100: the forward does 2 * M * C * fan_in FLOPs
// per layer for the trunk and as many for the sweep, the backward five
// times the trunk's products; all are plain FMA on the CUDA cores (67
// TFLOP/s of f32 at 700 W), so the FMA issue rate and shared-memory loads
// bound them, not the bytes (a few hundred bytes per row per layer). The
// elementwise kernels are bound by device memory.
#include "mlp_tile.cuh"

namespace {

using neddf::kColGroups;
using neddf::kKTile;
using neddf::kReLU;
using neddf::kRows;
using neddf::kTanhExp;
using neddf::kThreads;
using neddf::TileArgs;

constexpr int kC = 256;
// row stride of the transposed weight tile (padded: fewer bank conflicts
// when it is staged, still 16-byte aligned rows)
constexpr int kWtStride = kC + 4;

template <int ACT>
__device__ __forceinline__ float dact(float x) {
  float f, df;
  neddf::act_fn<ACT>(x, f, df);
  return df;
}

template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_fwd_kernel(const TileArgs a, float* __restrict__ ge_out) {
  constexpr int C = kC;
  constexpr int TM = kRows;
  constexpr int RG = kThreads / kColGroups;
  constexpr int SPT = TM / RG;
  constexpr int CPT = C / kColGroups;
  constexpr int NQ = CPT / 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float *x0, *h, *wt;
  neddf::tile_buffers<float, C>(a, smem_raw, x0, h, wt);
  neddf::tile_forward<float, 0, C, ACT>(a, x0, h, wt);
  __syncthreads();  // the stash is written; h is free

  const int E = a.seg_w[0];
  const int L = a.n_layers;
  const int M = a.M;
  const int tid = threadIdx.x;
  const int tr = tid / kColGroups;
  const int tc = tid % kColGroups;
  const int m0 = blockIdx.x * TM;
  float* p = h;                          // [TM, C]
  float* ge = wt + kKTile * kWtStride;   // [TM, E]

  {
    const float* z = static_cast<const float*>(a.stash[L - 1]);
    for (int idx = tid; idx < TM * C; idx += kThreads) {
      const int i = idx / C;
      const int m = m0 + i;
      p[idx] = (idx - i * C == 0 && m < M) ? dact<ACT>(z[(size_t)m * C]) : 0.f;
    }
    for (int idx = tid; idx < TM * E; idx += kThreads) ge[idx] = 0.f;
  }
  __syncthreads();

  for (int l = L - 1; l >= 0; --l) {
    const float* W = static_cast<const float*>(a.w[l]);
    if (l == 0 || a.split[l]) {
      // gE += p W[e rows]^T; layer 0's rows are all e, a post-skip layer's
      // e rows follow its C hidden rows
      const float* we = W + (size_t)(l == 0 ? 0 : C) * C;
      for (int idx = tid; idx < TM * E; idx += kThreads) {
        const int i = idx / E;
        const float4* pr = reinterpret_cast<const float4*>(p + (size_t)i * C);
        const float4* wr = reinterpret_cast<const float4*>(we + (size_t)(idx - i * E) * C);
        float s = 0.f;
        for (int n = 0; n < C / 4; ++n) {
          const float4 pv = pr[n];
          const float4 wv = __ldg(wr + n);
          s = fmaf(pv.x, wv.x, s);
          s = fmaf(pv.y, wv.y, s);
          s = fmaf(pv.z, wv.z, s);
          s = fmaf(pv.w, wv.w, s);
        }
        ge[idx] += s;
      }
    }
    if (l == 0) break;

    // q = p W[hidden rows]^T, one register tile per thread as in the trunk
    float acc[SPT][CPT];
#pragma unroll
    for (int pp = 0; pp < SPT; ++pp)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[pp][c] = 0.f;
    for (int n0 = 0; n0 < C; n0 += kKTile) {
      for (int idx = tid; idx < kKTile * C; idx += kThreads) {
        const int k = idx / kKTile;
        const int nn = idx - k * kKTile;
        wt[nn * kWtStride + k] = __ldg(W + (size_t)k * C + n0 + nn);
      }
      __syncthreads();
      for (int nn = 0; nn < kKTile; ++nn) {
        float av[SPT];
#pragma unroll
        for (int pp = 0; pp < SPT; ++pp) av[pp] = p[(size_t)(tr + pp * RG) * C + n0 + nn];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float wv[4];
          neddf::load4(wt + nn * kWtStride + q * 4 * kColGroups + tc * 4, wv);
#pragma unroll
          for (int pp = 0; pp < SPT; ++pp)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[pp][q * 4 + e] = fmaf(av[pp], wv[e], acc[pp][q * 4 + e]);
        }
      }
      __syncthreads();
    }

    // p_{l-1} = q * f'(z_{l-1}) over p (every read of p is done)
    const float* z = static_cast<const float*>(a.stash[l - 1]);
#pragma unroll
    for (int pp = 0; pp < SPT; ++pp) {
      const int i = tr + pp * RG;
      const int m = m0 + i;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = q * 4 * kColGroups + tc * 4;
        float zv[4] = {0.f, 0.f, 0.f, 0.f};
        if (m < M) neddf::load4(z + (size_t)m * C + col, zv);
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[e] = m < M ? acc[pp][q * 4 + e] * dact<ACT>(zv[e]) : 0.f;
        neddf::store4(p + (size_t)i * C + col, out);
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < TM * E; idx += kThreads) {
    const int i = idx / E;
    const int m = m0 + i;
    if (m < M) ge_out[(size_t)m * E + (idx - i * E)] = ge[idx];
  }
}

template <int ACT>
cudaError_t launch_fwd(const TileArgs& a, float* ge, cudaStream_t stream) {
  size_t smem = neddf::smem_bytes<float, kC>(a);
  // the transposed weight tile is padded to kWtStride columns; gE follows
  smem += ((size_t)kKTile * (kWtStride - kC) + (size_t)kRows * a.seg_w[0]) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fwd_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.M + kRows - 1) / kRows;
  sdf_fwd_kernel<ACT><<<grid, kThreads, smem, stream>>>(a, ge);
  return cudaGetLastError();
}

// p = q f'(z), or onehot0 * f'(z) when q is null (the top of the sweep)
template <int ACT>
__global__ void sweep_p_kernel(size_t n, int C, const float* __restrict__ q,
                               const float* __restrict__ z, float* __restrict__ p) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float d = dact<ACT>(z[i]);
    p[i] = q != nullptr ? q[i] * d : (i % C == 0 ? d : 0.f);
  }
}

// qbar = pbar f'(z) and zs = pbar q f''(z); with q null (the top of the
// sweep) only zs = onehot0 * pbar f''(z)
template <int ACT>
__global__ void adjoint_kernel(size_t n, int C, const float* __restrict__ pbar,
                               const float* __restrict__ q, const float* __restrict__ z,
                               float* __restrict__ qbar, float* __restrict__ zs) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float f, d1, d2;
    neddf::act_fn3<ACT>(z[i], f, d1, d2);
    if (q != nullptr) {
      qbar[i] = pbar[i] * d1;
      zs[i] = pbar[i] * q[i] * d2;
    } else {
      zs[i] = i % C == 0 ? pbar[i] * d2 : 0.f;
    }
  }
}

// zbar = hbar f'(z) + zs, and one f32 partial of db per block of rows
template <int ACT>
__global__ void zbar_kernel(int C, int M, int rows_per_block, const float* __restrict__ hbar,
                            const float* __restrict__ z, const float* __restrict__ zs,
                            float* __restrict__ zbar, float* __restrict__ db_part) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  float db = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + c;
    const float v = hbar[i] * dact<ACT>(z[i]) + zs[i];
    zbar[i] = v;
    db += v;
  }
  db_part[(size_t)blockIdx.x * C + c] = db;
}

template <int ACT>
__global__ void act_kernel(size_t n, const float* __restrict__ z, float* __restrict__ h) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float f, df;
    neddf::act_fn<ACT>(z[i], f, df);
    h[i] = f;
  }
}

int grid_1d(size_t n) { return neddf::grid_1d(n, 256); }

bool bad_act(int act) { return act != kTanhExp && act != kReLU; }

}  // namespace

extern "C" int neddf_sdf_fwd(int act, int M, int e_dim, int n_layers, const void* e,
                             const void* const* w, const void* const* b, const int* split,
                             void* const* stash, void* h_out, void* ge_out, void* stream) {
  if (bad_act(act) || M <= 0 || e_dim < 1 || n_layers < 2 || n_layers > neddf::kMaxLayers ||
      stash == nullptr)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  a.seg_v[0] = e;
  a.seg_j[0] = nullptr;
  a.seg_w[0] = e_dim;
  a.n_seg = 1;
  for (int l = 0; l < n_layers; ++l) {
    if ((l == 0 && split[l] != 0) ||
        (split[l] != 0 && split[l] != neddf::kSplitHiddenFirst) || stash[l] == nullptr)
      return (int)cudaErrorInvalidValue;
    a.w[l] = w[l];
    a.b[l] = static_cast<const float*>(b[l]);
    a.split[l] = split[l];
    a.stash[l] = stash[l];
  }
  a.n_layers = n_layers;
  a.M = M;
  a.v_out = h_out;
  a.j_out = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ge = static_cast<float*>(ge_out);
  return (int)(act == kReLU ? launch_fwd<kReLU>(a, ge, s) : launch_fwd<kTanhExp>(a, ge, s));
}

extern "C" int neddf_sdf_sweep_p(int act, long long n, int width, const void* q,
                                 const void* z, void* p, void* stream) {
  if (bad_act(act) || n <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* zf = static_cast<const float*>(z);
  float* pf = static_cast<float*>(p);
  if (act == kReLU)
    sweep_p_kernel<kReLU><<<grid_1d(n), 256, 0, s>>>(n, width, qf, zf, pf);
  else
    sweep_p_kernel<kTanhExp><<<grid_1d(n), 256, 0, s>>>(n, width, qf, zf, pf);
  return (int)cudaGetLastError();
}

extern "C" int neddf_sdf_adjoint(int act, long long n, int width, const void* pbar,
                                 const void* q, const void* z, void* qbar, void* zs,
                                 void* stream) {
  if (bad_act(act) || n <= 0 || width <= 0 || (q != nullptr && qbar == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pb = static_cast<const float*>(pbar);
  const float* qf = static_cast<const float*>(q);
  const float* zf = static_cast<const float*>(z);
  float* qb = static_cast<float*>(qbar);
  float* zsf = static_cast<float*>(zs);
  if (act == kReLU)
    adjoint_kernel<kReLU><<<grid_1d(n), 256, 0, s>>>(n, width, pb, qf, zf, qb, zsf);
  else
    adjoint_kernel<kTanhExp><<<grid_1d(n), 256, 0, s>>>(n, width, pb, qf, zf, qb, zsf);
  return (int)cudaGetLastError();
}

extern "C" int neddf_sdf_zbar(int act, int width, int M, int rows_per_block,
                              const void* hbar, const void* z, const void* zs, void* zbar,
                              void* db_part, void* stream) {
  if (bad_act(act) || width <= 0 || M <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  const float* hb = static_cast<const float*>(hbar);
  const float* zf = static_cast<const float*>(z);
  const float* zsf = static_cast<const float*>(zs);
  float* zb = static_cast<float*>(zbar);
  float* dbp = static_cast<float*>(db_part);
  if (act == kReLU)
    zbar_kernel<kReLU><<<grid, 256, 0, s>>>(width, M, rows_per_block, hb, zf, zsf, zb, dbp);
  else
    zbar_kernel<kTanhExp><<<grid, 256, 0, s>>>(width, M, rows_per_block, hb, zf, zsf, zb, dbp);
  return (int)cudaGetLastError();
}

extern "C" int neddf_sdf_act(int act, long long n, const void* z, void* h, void* stream) {
  if (bad_act(act) || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* hf = static_cast<float*>(h);
  if (act == kReLU)
    act_kernel<kReLU><<<grid_1d(n), 256, 0, s>>>(n, zf, hf);
  else
    act_kernel<kTanhExp><<<grid_1d(n), 256, 0, s>>>(n, zf, hf);
  return (int)cudaGetLastError();
}
