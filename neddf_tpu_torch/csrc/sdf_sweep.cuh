// The NeuS trunk's reverse sweep of channel 0 (sdf_mlp.cu's forward, its
// second launch), one block per row tile, for one width class C; built
// into csrc/tile_fwd.cu's f32 objects, one per class (kernels/_build.py).
// Design and bound: see sdf_mlp.cu.
#pragma once

#include "mlp_tile.cuh"

namespace neddf {

// the sweep's weight tiles: the C rows n of W[hidden], kSweepK columns k
// at a time ([n][k], K contiguous), rows padded to 80 bytes (ldmatrix
// without bank conflicts), double-buffered
constexpr int kSweepK = 16;
constexpr int kSweepPitch = kSweepK + 4;
constexpr int kSweepStages = 2;

template <int ACT>
__device__ __forceinline__ float dact(float x) {
  float f, df;
  act_fn<ACT>(x, f, df);
  return df;
}

// rows of a sweep block and its shared bytes at width class C, E = e_dim
template <int C>
constexpr int sweep_rows() {
  return tile_rows<float, C>();
}
template <int C>
inline size_t sweep_smem(int e_dim) {
  return ((size_t)sweep_rows<C>() * (C + 4 + e_dim) + kSweepStages * C * kSweepPitch) *
         sizeof(float);
}

// q's B tile kt: W[hidden] rows n < N (row stride N), columns kt * kSweepK
// + [0, kSweepK) < N, into [C][kSweepPitch]; zeros elsewhere. V elements
// per cp.async
template <int C, int V>
__device__ __forceinline__ void sweep_load(float* dst, const float* W, int N, int kt) {
  constexpr int CPR = kSweepK / V;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < C * CPR; idx += kTcTileThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int k = kt * kSweepK + c;
    const int valid = r < N ? max(0, min(V, N - k)) : 0;
    cp_async<4 * V>(smem_u32(dst + r * kSweepPitch + c),
                    valid > 0 ? W + (size_t)r * N + k : W, 4 * valid);
  }
}

// the reverse sweep of channel 0 over one row tile, from the stash that
// the trunk (tile_hopper.cuh's mlp_tile_fwd<float, 0>) wrote; a.w, a.split, a.stash,
// a.n_layers, a.M, a.width = N and a.seg_w[0] = E are read; VEC: N is a
// multiple of 4 (rows of whole 16-byte vectors)
template <int C, int ACT, bool VEC>
__global__ void __launch_bounds__(kTcTileThreads, 1)
    sdf_sweep_kernel(const TileArgs a, float* __restrict__ ge_out) {
  // the K=0 f32 warp tiling of the class (mlp_tile.cuh's TileGeo)
  using G = TileGeo<float, 0, C>;
  constexpr int TM = G::ROWS;
  constexpr int HP = C + 4;  // p's row pitch: ldmatrix without bank conflicts
  constexpr int MT = G::MT, NI = G::NI, WC = G::WC, NCG = G::NCG;
  constexpr int SLOT = C * kSweepPitch;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* p = reinterpret_cast<float*>(smem_raw);  // [TM, HP]
  float* wt = p + TM * HP;                         // the sweep's weight tiles
  float* ge = wt + kSweepStages * SLOT;            // [TM, E]

  const int E = a.seg_w[0];
  const int L = a.n_layers;
  const int M = a.M;
  const int N = a.width;
  constexpr bool vec4 = VEC;
  const int nkt = (N + kSweepK - 1) / kSweepK;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q = warp / NCG, cg = warp % NCG;  // sample slice, column band
  const int m0 = blockIdx.x * TM;

  {
    const float* z = static_cast<const float*>(a.stash[L - 1]);
    // (the elementwise loops are not unrolled: unrolled, their loads in
    // flight cost ReLU's and LeakyReLU's sweeps 12-16 bytes of spill)
#pragma unroll 1
    for (int idx = tid; idx < TM * C; idx += kTcTileThreads) {
      const int i = idx / C;
      const int c = idx - i * C;
      const int m = m0 + i;
      p[i * HP + c] = (c == 0 && m < M) ? dact<ACT>(z[(size_t)m * N]) : 0.f;
    }
    for (int idx = tid; idx < TM * E; idx += kTcTileThreads) ge[idx] = 0.f;
  }
  __syncthreads();

  // this lane's ldmatrix rows: A from p as in the trunk; B from a sweep
  // tile (rows n 0-7 of the band's n8 tile pair, lanes 16-31 rows 8-15;
  // lanes 8-15 and 24-31 at k + 4)
  const uint32_t a_lane =
      smem_u32(p) + 4 * ((q * 16 * MT + (lane & 15)) * HP) + (lane >> 4) * 16;
  const uint32_t b_lane = smem_u32(wt) +
                          4 * ((cg * WC + (lane & 7) + (lane >> 4) * 8) * kSweepPitch) +
                          ((lane >> 3) & 1) * 16;

  for (int l = L - 1; l >= 0; --l) {
    const float* W = static_cast<const float*>(a.w[l]);
    if (l == 0 || a.split[l]) {
      // gE += p W[e rows]^T (FMA: E columns against the N of q); layer 0's
      // rows are all e, a post-skip layer's e rows follow its N hidden rows
      const float* we = W + (size_t)(l == 0 ? 0 : N) * N;
#pragma unroll 1
      for (int idx = tid; idx < TM * E; idx += kTcTileThreads) {
        const int i = idx / E;
        const float* pr = p + (size_t)i * HP;
        const float* wr = we + (size_t)(idx - i * E) * N;
        float s = 0.f;
        if (vec4) {
#pragma unroll 1
          for (int n = 0; n < N / 4; ++n) {
            const float4 pv = reinterpret_cast<const float4*>(pr)[n];
            const float4 wv = __ldg(reinterpret_cast<const float4*>(wr) + n);
            s = fmaf(pv.x, wv.x, s);
            s = fmaf(pv.y, wv.y, s);
            s = fmaf(pv.z, wv.z, s);
            s = fmaf(pv.w, wv.w, s);
          }
        } else {
          for (int n = 0; n < N; ++n) s = fmaf(pr[n], __ldg(wr + n), s);
        }
        ge[idx] += s;
      }
    }
    if (l == 0) break;

    // q = p W[hidden rows]^T on the tensor cores (3xTF32): B(k, n) = W[n][k]
    // (16-byte copies where N allows them, else 4-byte ones: the choice
    // is the template argument VEC, since a run-time branch between the
    // two beside the accumulators spilled 24-32 bytes under ReLU and
    // LeakyReLU, and 4-byte copies alone cost the sweep 13% at width 256)
    auto load = [&](int kt) {
      sweep_load<C, VEC ? 4 : 1>(wt + (kt % kSweepStages) * SLOT, W, N, kt);
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
      cp_async_commit();
    }
    // (a run-time trip count: not unrolled, or the unrolled copies' live
    // addresses beside the accumulators spill)
#pragma unroll 1
    for (int kt = 0; kt < nkt; ++kt) {
      cp_async_wait<kSweepStages - 2>();
      __syncthreads();  // tile kt has landed; the slot of kt-1 is free
      if (kt + kSweepStages - 1 < nkt) load(kt + kSweepStages - 1);
      cp_async_commit();
      const uint32_t b_slot = b_lane + 4 * (kt % kSweepStages) * SLOT;
#pragma unroll 1
      for (int kk = 0; kk < kSweepK; kk += 8) {
        const uint32_t a_k = a_lane + 4 * (kt * kSweepK + kk);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldsm_x4(ah[mt], a_k + 4 * mt * 16 * HP);
          split_tf32(ah[mt], al[mt]);
        }
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) {
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, b_slot + 4 * (nj * 16 * kSweepPitch + kk));
          split_tf32(bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_3xtf32(acc[mt][2 * nj], ah[mt], al[mt], bh[0], bh[1], bl[0], bl[1]);
            mma_3xtf32(acc[mt][2 * nj + 1], ah[mt], al[mt], bh[2], bh[3], bl[2], bl[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every read of p and of the sweep tiles is done

    // p_{l-1} = q * f'(z_{l-1}) over p: q goes to p first, then one pass
    // reads z (coalesced; 16-byte rows where N allows) with no accumulator
    // live; the columns past N are zeros
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
#pragma unroll 1
    for (int idx = tid; idx < TM * (C / 4); idx += kTcTileThreads) {
      const int i = idx / (C / 4);
      const int c = (idx - i * (C / 4)) * 4;
      const int m = m0 + i;
      float4* pv = reinterpret_cast<float4*>(p + (size_t)i * HP + c);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && c < N) {
        const float4 qv = *pv;
        const float* zr = z + (size_t)m * N + c;
        if (vec4) {
          const float4 zv = *reinterpret_cast<const float4*>(zr);
          v = make_float4(qv.x * dact<ACT>(zv.x), qv.y * dact<ACT>(zv.y),
                          qv.z * dact<ACT>(zv.z), qv.w * dact<ACT>(zv.w));
        } else {
          v.x = qv.x * dact<ACT>(zr[0]);
          if (c + 1 < N) v.y = qv.y * dact<ACT>(zr[1]);
          if (c + 2 < N) v.z = qv.z * dact<ACT>(zr[2]);
          if (c + 3 < N) v.w = qv.w * dact<ACT>(zr[3]);
        }
      }
      *pv = v;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < TM * E; idx += kTcTileThreads) {
    const int i = idx / E;
    const int m = m0 + i;
    if (m < M) ge_out[(size_t)m * E + (idx - i * E)] = ge[idx];
  }
}

template <int C, int ACT>
cudaError_t launch_sweep(const TileArgs& a, float* ge, cudaStream_t stream) {
  if (width_class(a.width) != C) return cudaErrorInvalidValue;
  const size_t smem = sweep_smem<C>(a.seg_w[0]);
  const int grid = (a.M + sweep_rows<C>() - 1) / sweep_rows<C>();
  // rows of whole 16-byte vectors (N % 4 == 0) or not
  auto kernel = (a.width & 3) == 0 ? sdf_sweep_kernel<C, ACT, true>
                                   : sdf_sweep_kernel<C, ACT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcTileThreads, smem, stream>>>(a, ge);
  return cudaGetLastError();
}

// the sweep at width class C (csrc/tile_fwd.cu's f32 objects)
extern "C" int neddf_sdf_sweep_64(int act, const TileArgs* a, float* ge, void* stream);
extern "C" int neddf_sdf_sweep_128(int act, const TileArgs* a, float* ge, void* stream);
extern "C" int neddf_sdf_sweep_256(int act, const TileArgs* a, float* ge, void* stream);
extern "C" int neddf_sdf_sweep_512(int act, const TileArgs* a, float* ge, void* stream);

}  // namespace neddf
