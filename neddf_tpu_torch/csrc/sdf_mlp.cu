// SDF trunk with its channel-0 gradient (the NeuS trunk) for sm_90a.
//
// Replaces the Pallas kernels of neddf_tpu/kernels/sdf_mlp.py:
//
// * forward, _run_forward / _fwd_kernel (_trunk_and_sweep:69), as two
//   launches: the trunk h = f(z_l), z_l = in_l W_l + b_l is mlp_fwd.cu's
//   f32 row tile (mlp_tile.cuh's tile_forward_tc, K=0; the post-skip
//   layer reads [h, e], kSplitHiddenFirst), writing the stash z_l [M, C]
//   and h [M, C]; then sdf_sweep_kernel, one block per row tile of 128
//   samples, runs the reverse sweep of channel 0:
//       p_{L-1} = onehot0 * f'(z_{L-1});  q_l = p_l W_l^T;
//       p_{l-1} = q_l[hidden] * f'(z_{l-1});  gE += q_l[e rows]
//   (the e rows of layer 0 and of every post-skip layer). p and gE live
//   in shared memory; z_{l-1} is read back from the stash (the trunk
//   wrote it just before; 2.2 MB per layer at the NeuS step, inside the
//   50 MB L2). Two kernels rather than one: the sweep's fragments beside
//   the trunk's, in one kernel, spilled registers. Out: h, gE [M, E], the
//   stash.
// * backward, _run_backward / _bwd_kernel:176-242, is run by the Python
//   wrapper (kernels/sdf_mlp.py::sdf_mlp_bwd_route) as products of
//   neddf_gemm_tc (dual_mlp_bwd.cu, f32: 3xTF32) whose epilogues and
//   prologues do the elementwise work, so no [M, C] plane makes a round
//   trip through device memory for it:
//     replay: p_{L-1} = onehot0 f'(z_{L-1}) (neddf_sdf_top); q_l = p_l
//       W_l[hidden]^T with the epilogue p_{l-1} = q_l f'(z_{l-1});
//     ascending adjoint of the sweep: qbar_0 = cg; pbar_l = [qbar_l | cg]
//       W_l (one product over both K segments) with the epilogue
//       qbar_{l+1} = pbar_l f'(z_l), and where f'' != 0 (tanhExp) zs_l =
//       pbar_l q_{l+1} f''(z_l); dW_l += qbar_l^T p_l;
//     descending trunk backward: zbar_{L-1} = ch f'(z_{L-1}) + zs_{L-1}
//       (mlp_bwd.cu's gpre); hbar = zbar_l W_l^T over all of W's rows
//       with the epilogue zbar_{l-1} = hbar f'(z_{l-1}) + zs_{l-1} and its
//       db partials, ebar from the e rows' columns; dW_l += f(z_{l-1})^T
//       zbar_l (the activation as the prologue of the product).
//   Under ReLU and LeakyReLU f'' = 0: q is not kept after the replay and zs is neither
//   written nor read. The db partials are summed by neddf_sum_rows, the
//   dW splits by neddf_sum_splits (fixed orders: bitwise reproducible).
//
// Numerics: f32 throughout (NeuS runs its trunk in f32); sums in f32; the
// products by the 3xTF32 split (tc_ops.cuh), about 2^-21 of each product.
//
// What bounds it on the H100: the forward does 2 * M * C * fan_in FLOPs
// per layer for the trunk and as many for the sweep, the backward five
// times the trunk's products; on the tensor cores at three TF32 mma per
// f32 multiply-add they are bound by 165 TFLOP/s of f32 work (495 TF32
// at 700 W), not by the bytes (a few hundred bytes per row per layer).
// The sweep's q = p W[hidden]^T runs as the trunk does (8 warps, 32 rows x
// 128 columns each, the same 3xTF32 step); its B operand W^T is read as
// [n][k] tiles of W's rows, K contiguous, so ldmatrix builds its
// fragments too. gE += p W[e]^T stays on the FMA units: E = 36 columns
// against the C = 256 of q, and only at layer 0 and the post-skip layer,
// about 4% of the sweep's multiply-adds (reckoned from the shapes; not
// timed apart). sdf_top_kernel is bound by device memory.
#include "mlp_tile.cuh"

namespace {

using neddf::kRows;
using neddf::TileArgs;

constexpr int kC = 256;
constexpr int kThreads = neddf::kTcTileThreads;
// the sweep's weight tiles: the C rows n of W[hidden], kSweepK columns k
// at a time ([n][k], K contiguous), rows padded to 80 bytes (ldmatrix
// without bank conflicts), double-buffered in the trunk's weight ring
constexpr int kSweepK = 16;
constexpr int kSweepPitch = kSweepK + 4;
constexpr int kSweepSlot = kC * kSweepPitch;
constexpr int kSweepStages = 2;
constexpr int kSweepHP = kC + 4;  // p's row pitch: ldmatrix without bank conflicts

template <int ACT>
__device__ __forceinline__ float dact(float x) {
  float f, df;
  neddf::act_fn<ACT>(x, f, df);
  return df;
}

// the reverse sweep of channel 0 over one row tile, from the stash that
// the trunk (mlp_tile_fwd<float, 0>) wrote; a.w, a.split, a.stash,
// a.n_layers, a.M and a.seg_w[0] = E are read
template <int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_sweep_kernel(const TileArgs a, float* __restrict__ ge_out) {
  constexpr int C = kC;
  constexpr int TM = kRows;
  constexpr int HP = kSweepHP;
  // the K=0 warp tiling of tile_forward_tc: 4 sample slices of 32 rows
  // (two m16 tiles) x 2 column bands of 128 (16 n8 tiles)
  constexpr int MT = 2, NI = 16, WC = 128;
  constexpr int NKT = C / kSweepK;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* p = reinterpret_cast<float*>(smem_raw);  // [TM, HP]
  float* wt = p + TM * HP;                         // the sweep's weight tiles
  float* ge = wt + kSweepStages * kSweepSlot;      // [TM, E]

  const int E = a.seg_w[0];
  const int L = a.n_layers;
  const int M = a.M;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q = warp / 2, cg = warp % 2;  // sample slice, column band
  const int m0 = blockIdx.x * TM;

  {
    const float* z = static_cast<const float*>(a.stash[L - 1]);
    for (int idx = tid; idx < TM * C; idx += kThreads) {
      const int i = idx / C;
      const int c = idx - i * C;
      const int m = m0 + i;
      p[i * HP + c] = (c == 0 && m < M) ? dact<ACT>(z[(size_t)m * C]) : 0.f;
    }
  for (int idx = tid; idx < TM * E; idx += kThreads) ge[idx] = 0.f;
  }
  __syncthreads();

  // this lane's ldmatrix rows: A from p as in the trunk; B from a sweep
  // tile (rows n 0-7 of the band's n8 tile pair, lanes 16-31 rows 8-15;
  // lanes 8-15 and 24-31 at k + 4)
  const uint32_t a_lane =
      neddf::smem_u32(p) + 4 * ((q * 16 * MT + (lane & 15)) * HP) + (lane >> 4) * 16;
  const uint32_t b_lane = neddf::smem_u32(wt) +
                          4 * ((cg * WC + (lane & 7) + (lane >> 4) * 8) * kSweepPitch) +
                          ((lane >> 3) & 1) * 16;

  for (int l = L - 1; l >= 0; --l) {
    const float* W = static_cast<const float*>(a.w[l]);
    if (l == 0 || a.split[l]) {
      // gE += p W[e rows]^T (FMA: E columns against the C of q); layer 0's
      // rows are all e, a post-skip layer's e rows follow its C hidden rows
      const float* we = W + (size_t)(l == 0 ? 0 : C) * C;
      for (int idx = tid; idx < TM * E; idx += kThreads) {
        const int i = idx / E;
        const float4* pr = reinterpret_cast<const float4*>(p + (size_t)i * HP);
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

    // q = p W[hidden rows]^T on the tensor cores (3xTF32): B(k, n) = W[n][k]
    auto load = [&](int kt) {
      float* dst = wt + (kt % kSweepStages) * kSweepSlot;
      constexpr int CPR = kSweepK / 4;  // 16-byte chunks per row
#pragma unroll 1
      for (int idx = tid; idx < C * CPR; idx += kThreads) {
        const int r = idx / CPR;
        const int c = (idx - r * CPR) * 4;
        neddf::cp_async<16>(neddf::smem_u32(dst + r * kSweepPitch + c),
                            W + (size_t)r * C + kt * kSweepK + c, 16);
      }
    };
    float acc[MT][NI][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][ni][e] = 0.f;
    for (int s = 0; s < kSweepStages - 1; ++s) {
      load(s);
      neddf::cp_async_commit();
    }
    for (int kt = 0; kt < NKT; ++kt) {
      neddf::cp_async_wait<kSweepStages - 2>();
      __syncthreads();  // tile kt has landed; the slot of kt-1 is free
      if (kt + kSweepStages - 1 < NKT) load(kt + kSweepStages - 1);
      neddf::cp_async_commit();
      const uint32_t b_slot = b_lane + 4 * (kt % kSweepStages) * kSweepSlot;
#pragma unroll 1
      for (int kk = 0; kk < kSweepK; kk += 8) {
        const uint32_t a_k = a_lane + 4 * (kt * kSweepK + kk);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          neddf::ldsm_x4(ah[mt], a_k + 4 * mt * 16 * HP);
          neddf::split_tf32(ah[mt], al[mt]);
        }
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t bh[4], bl[4];
          neddf::ldsm_x4(bh, b_slot + 4 * (nj * 16 * kSweepPitch + kk));
          neddf::split_tf32(bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            neddf::mma_3xtf32(acc[mt][2 * nj], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
            neddf::mma_3xtf32(acc[mt][2 * nj + 1], ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
    }
    neddf::cp_async_wait<0>();
    __syncthreads();  // every read of p and of the sweep tiles is done

    // p_{l-1} = q * f'(z_{l-1}) over p: q goes to p first, then one pass
    // in 16-byte rows reads z (coalesced) with no accumulator live
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = cg * WC + ni * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) {
        const int mt = r >> 1, hh = r & 1;
        const int i = (q * MT + mt) * 16 + g + 8 * hh;
        *reinterpret_cast<float2*>(p + (size_t)i * HP + col) =
            make_float2(acc[mt][ni][2 * hh], acc[mt][ni][2 * hh + 1]);
      }
    }
    __syncthreads();
    const float* z = static_cast<const float*>(a.stash[l - 1]);
    for (int idx = tid; idx < TM * (C / 4); idx += kThreads) {
      const int i = idx / (C / 4);
      const int c = (idx - i * (C / 4)) * 4;
      const int m = m0 + i;
      float4* pv = reinterpret_cast<float4*>(p + (size_t)i * HP + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const float4 zv = *reinterpret_cast<const float4*>(z + (size_t)m * C + c);
        const float4 qv = *pv;
        v = make_float4(qv.x * dact<ACT>(zv.x), qv.y * dact<ACT>(zv.y), qv.z * dact<ACT>(zv.z),
                        qv.w * dact<ACT>(zv.w));
      }
      *pv = v;
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
cudaError_t launch_sweep(const TileArgs& a, float* ge, cudaStream_t stream) {
  const size_t smem =
      ((size_t)kRows * (kSweepHP + a.seg_w[0]) + kSweepStages * kSweepSlot) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_sweep_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.M + kRows - 1) / kRows;
  sdf_sweep_kernel<ACT><<<grid, kThreads, smem, stream>>>(a, ge);
  return cudaGetLastError();
}

// the top of the replayed sweep: p = onehot0 * f'(z), channel 0 only
template <int ACT>
__global__ void sdf_top_kernel(size_t n, int C, const float* __restrict__ z,
                               float* __restrict__ p) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    p[i] = i % C == 0 ? dact<ACT>(z[i]) : 0.f;
}

int grid_1d(size_t n) { return neddf::grid_1d(n, 256); }

}  // namespace

// gE [M, E] of the trunk whose per-layer pre-activations mlp_seg's
// forward (mlp_fwd.cu, f32, [h, e] post-skip layers) wrote to stash
extern "C" int neddf_sdf_sweep(int act, int M, int e_dim, int n_layers, const void* const* w,
                               const int* split, void* const* stash, void* ge_out,
                               void* stream) {
  if (M <= 0 || e_dim < 1 || n_layers < 2 || n_layers > neddf::kMaxLayers ||
      stash == nullptr)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  a.seg_w[0] = e_dim;
  a.n_seg = 1;
  for (int l = 0; l < n_layers; ++l) {
    if ((l == 0 && split[l] != 0) ||
        (split[l] != 0 && split[l] != neddf::kSplitHiddenFirst) || stash[l] == nullptr)
      return (int)cudaErrorInvalidValue;
    a.w[l] = w[l];
    a.split[l] = split[l];
    a.stash[l] = stash[l];
  }
  a.n_layers = n_layers;
  a.M = M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ge = static_cast<float*>(ge_out);
  return (int)neddf::by_act(
      act, [&](auto a_) { return launch_sweep<decltype(a_)::value>(a, ge, s); });
}

// p [M, width] = onehot0 * f'(z): the top of the backward's replayed sweep
extern "C" int neddf_sdf_top(int act, long long n, int width, const void* z, void* p,
                             void* stream) {
  if (n <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* pf = static_cast<float*>(p);
  return (int)neddf::by_act(act, [&](auto a_) {
    sdf_top_kernel<decltype(a_)::value><<<grid_1d(n), 256, 0, s>>>(n, width, zf, pf);
    return cudaGetLastError();
  });
}
