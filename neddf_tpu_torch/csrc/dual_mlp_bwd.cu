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
// * two products: dx = G W^T and dW = h_in^T G (for layer 0 and a
//   post-skip layer, per input block of rows of W): neddf_gemm_tc, on
//   the tensor cores for bf16 and for f32 operands;
// * neddf_sum_splits: the fixed-order sum of the dW / db partials.
// The same products serve the backwards of mlp_bwd.cu and sdf_mlp.cu.
//
// Determinism. The Pallas kernel accumulates dW/db across its sequential
// TPU grid; blocks here run concurrently, so every cross-block reduction
// writes per-block (or per-split) f32 partials that a second pass sums
// in a fixed order. No float atomics: two runs give bitwise-equal dW.
//
// What bounds it on the H100: the two products per layer are
// 2 * S*M * C * fan_in FLOPs each (about 0.1 TFLOP per trunk layer at
// the training batch). They run on the tensor cores (tc_gemm_kernel): a
// 128x128 output tile per block of 8 warps, each warp 64x32 as 4x4 mma
// tiles with f32 accumulators in registers; both operands stream through
// a ring of 3 shared-memory stages of 128 bytes per row (64 bf16 or 32
// f32) filled by cp.async, so the copy of stage k+2 overlaps the
// products of stage k. bf16 operands: mma.sync m16n8k16, fragments by
// ldmatrix (.trans for an operand whose M or N side is contiguous), rows
// padded by 16 bytes against bank conflicts. f32 operands (NeuS, and the
// f32 reference steps): the 3xTF32 split of tc_ops.cuh, three mma.sync
// m16n8k8 tf32 per f32 multiply-add, each fragment split into hi/lo as
// it is read from shared memory; a K-contiguous tile gives its
// fragments by the same ldmatrix byte addresses as bf16, an M- or
// N-contiguous one (dW = in^T G, the NeuS sweep's pbar = qbar W) by
// element loads whose lanes fall on distinct banks. The f32 bound is
// then 3 TF32 FLOPs per FLOP at 495 TFLOP/s (165 TFLOP/s of f32 work),
// or the bytes. dx (M = S*M rows, N = fan-in, K = C) writes 4 bytes of
// f32 per output against 2*K FLOPs: about 130 FLOP per byte, below the
// 295 at which the bf16 tensor cores, and not device memory, are the
// limit, so its tile leaves through shared memory in coalesced streaming
// stores. dW reduces over S*M rows in fixed-order split partials.
// The elementwise kernels (gstack, dual_act, sum_splits) and the f32
// round trip of g move ~(3 * 4 + 4 * 2) bytes per stacked element and are
// bound by device memory; with the products on the tensor cores they
// take most of the bf16 backward (fusing gstack into the product is next).
#include "mlp_tile.cuh"
#include "tc_ops.cuh"

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

// ---- the products on the tensor cores: bf16 operands by mma.sync
// m16n8k16, f32 operands by the 3xTF32 split (tc_ops.cuh: mma_3xtf32)
using bf16 = __nv_bfloat16;

constexpr int kTcBM = 128;  // output rows per block
constexpr int kTcBN = 128;  // output columns per block
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;

// the shared tiles of operand type T. A stage is 128 bytes deep (64 bf16
// or 32 f32) and one mma 32 bytes (k16 bf16, k8 tf32), so the byte
// addresses of the ldmatrix fragments are the same for both types.
// Tiles are [rows][BK] when K is the operand's contiguous side (rows
// padded by 16 bytes: ldmatrix without bank conflicts) and [BK][128] when
// M (or N) is (padded by 8 elements: conflict-free for ldmatrix .trans in
// bf16, and for the element loads of f32, whose lanes (k t, m g) then
// fall on banks 8t + g).
template <typename T>
struct TcShape {
  static constexpr int BK = 128 / (int)sizeof(T);   // depth of one stage
  static constexpr int KSTEP = 32 / (int)sizeof(T);  // depth of one mma
  static constexpr int PK = BK + 16 / (int)sizeof(T);
  static constexpr int PMN = kTcBM + 8;
  static constexpr int OP = kTcBM * PK;  // elements of one operand's stage
  static_assert(BK * PMN <= OP, "stage size");
};
constexpr int kTcSmem = 2 * kTcStages * TcShape<bf16>::OP * (int)sizeof(bf16);
static_assert(kTcSmem == 2 * kTcStages * TcShape<float>::OP * (int)sizeof(float), "stages");

// one operand: element (outer o, inner i) at p[o * ld + i], the inner
// side contiguous, copied `vec` elements at a time
template <typename T>
struct TcOperand {
  const T* p;
  long long ld;
  int vec;
};

// the OUTER x INNER tile at (o0, i0) into shared s (row pitch P), zeros
// past (olim, ilim); copies of V elements (cp.async from 4 bytes up)
template <typename T, int OUTER, int INNER, int P, int V>
__device__ __forceinline__ void tc_copy_tile(T* s, const TcOperand<T>& op, int o0, int olim,
                                             int i0, int ilim, int tid) {
  constexpr int CPR = INNER / V;
  constexpr int BYTES = V * (int)sizeof(T);
#pragma unroll 1
  for (int idx = tid; idx < OUTER * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int go = o0 + r, gi = i0 + c;
    const int valid = go < olim ? max(0, min(V, ilim - gi)) : 0;
    const T* src = valid > 0 ? op.p + (size_t)go * op.ld + gi : op.p;
    if constexpr (BYTES < 4) {
      s[r * P + c] = valid > 0 ? *src : neddf::from_f32<T>(0.f);
    } else {
      neddf::cp_async<BYTES>(neddf::smem_u32(s + r * P + c), src, (int)sizeof(T) * valid);
    }
  }
}

template <typename T, int OUTER, int INNER, int P>
__device__ __forceinline__ void tc_load_tile(T* s, const TcOperand<T>& op, int o0, int olim,
                                             int i0, int ilim, int tid) {
  constexpr int E = (int)sizeof(T);
  switch (op.vec * E) {
    case 16: tc_copy_tile<T, OUTER, INNER, P, 16 / E>(s, op, o0, olim, i0, ilim, tid); break;
    case 8: tc_copy_tile<T, OUTER, INNER, P, 8 / E>(s, op, o0, olim, i0, ilim, tid); break;
    case 4: tc_copy_tile<T, OUTER, INNER, P, 4 / E>(s, op, o0, olim, i0, ilim, tid); break;
    default: tc_copy_tile<T, OUTER, INNER, P, 1>(s, op, o0, olim, i0, ilim, tid);
  }
}

// out[z][m][n] = sum over k in split z of A(m, k) B(k, n) (f32). A_K: A is
// [M, K] with K contiguous (else [K, M], M contiguous); B_K: B is [N, K]
// with K contiguous (else [K, N], N contiguous).
template <typename T, bool A_K, bool B_K>
__global__ void __launch_bounds__(kTcThreads, 2)
    tc_gemm_kernel(int M, int N, int K, int k_chunk, const TcOperand<T> A,
                   const TcOperand<T> B, float* __restrict__ out) {
  using Sh = TcShape<T>;
  constexpr int BK = Sh::BK, PK = Sh::PK, PMN = Sh::PMN, OP = Sh::OP;
  constexpr bool kF32 = std::is_same_v<T, float>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* sA = reinterpret_cast<T*>(tc_smem);
  T* sB = sA + kTcStages * OP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps of 64 rows x 32 columns
  const int wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  auto load = [&](int t) {
    const int k0 = kb + t * BK;
    T* a = sA + (t % kTcStages) * OP;
    T* b = sB + (t % kTcStages) * OP;
    if constexpr (A_K) {
      tc_load_tile<T, kTcBM, BK, PK>(a, A, m0, M, k0, ke, tid);
    } else {
      tc_load_tile<T, BK, kTcBM, PMN>(a, A, k0, ke, m0, M, tid);
    }
    if constexpr (B_K) {
      tc_load_tile<T, kTcBN, BK, PK>(b, B, n0, N, k0, ke, tid);
    } else {
      tc_load_tile<T, BK, kTcBN, PMN>(b, B, k0, ke, n0, N, tid);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s);
    neddf::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    neddf::cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage t has landed; stage t-1 is free for refill
    if (t + kTcStages - 1 < nk) load(t + kTcStages - 1);
    neddf::cp_async_commit();
    const T* a = sA + (t % kTcStages) * OP;
    const T* b = sB + (t % kTcStages) * OP;
    const int k_left = ke - (kb + t * BK);  // zeros past it: skip their mma
#pragma unroll
    for (int kk = 0; kk < BK; kk += Sh::KSTEP) {
      if (kk >= k_left) break;
      // the warp's B fragments first, then one A fragment at a time: fewer
      // live registers than all of A first.
      // bfr[nj]: b0, b1 of column tile 2nj, then of 2nj+1
      uint32_t bfr[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn + nj * 16;
        if constexpr (B_K) {
          neddf::ldsm_x4(bfr[nj], neddf::smem_u32(b + (n + (lane & 7) + (lane >> 4) * 8) * PK +
                                                  kk) + ((lane >> 3) & 1) * 16);
        } else if constexpr (!kF32) {
          neddf::ldsm_x4_t(bfr[nj], neddf::smem_u32(
              b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * PMN + n + (lane >> 4) * 8));
        } else {
          const T* p = b + (kk + tq) * PMN + n + g;  // (k t, n g)
          bfr[nj][0] = __float_as_uint(p[0]);
          bfr[nj][1] = __float_as_uint(p[4 * PMN]);
          bfr[nj][2] = __float_as_uint(p[8]);
          bfr[nj][3] = __float_as_uint(p[4 * PMN + 8]);
        }
      }
      uint32_t blo[2][4];
      if constexpr (kF32) {
        neddf::split_tf32(bfr[0], blo[0]);
        neddf::split_tf32(bfr[1], blo[1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm + mi * 16;
        uint32_t af[4];
        if constexpr (A_K) {
          neddf::ldsm_x4(af, neddf::smem_u32(a + (m + (lane & 7) + ((lane >> 3) & 1) * 8) * PK +
                                             kk) + (lane >> 4) * 16);
        } else if constexpr (!kF32) {
          neddf::ldsm_x4_t(af, neddf::smem_u32(
              a + (kk + (lane & 7) + (lane >> 4) * 8) * PMN + m + ((lane >> 3) & 1) * 8));
        } else {
          const T* p = a + (kk + tq) * PMN + m + g;  // (row g, k t)
          af[0] = __float_as_uint(p[0]);
          af[1] = __float_as_uint(p[8]);
          af[2] = __float_as_uint(p[4 * PMN]);
          af[3] = __float_as_uint(p[4 * PMN + 8]);
        }
        if constexpr (kF32) {
          uint32_t alo[4];
          neddf::split_tf32(af, alo);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            neddf::mma_3xtf32(acc[mi][2 * nj], af, alo, bfr[nj][0], bfr[nj][1], blo[nj][0],
                              blo[nj][1]);
            neddf::mma_3xtf32(acc[mi][2 * nj + 1], af, alo, bfr[nj][2], bfr[nj][3],
                              blo[nj][2], blo[nj][3]);
          }
        } else {
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            neddf::mma_bf16_16816(acc[mi][2 * nj], af, bfr[nj][0], bfr[nj][1]);
            neddf::mma_bf16_16816(acc[mi][2 * nj + 1], af, bfr[nj][2], bfr[nj][3]);
          }
        }
      }
    }
  }
  neddf::cp_async_wait<0>();

  float* o = out + (size_t)blockIdx.z * M * N;
  if constexpr (A_K && B_K) {
    // dx (nt, N of a whole tile or more): its f32 output is most of the
    // bytes, so the tile goes through the free ring in shared memory and
    // out in coalesced 16-byte rows, streaming (nothing reads it again
    // here); the other layouts keep their partials in L2 for the split sum
    if (N >= kTcBN && (N & 3) == 0) {
      constexpr int kOP = kTcBN + 4;  // padded row of the staged f32 tile
      static_assert(kTcBM * kOP * (int)sizeof(float) <= kTcSmem, "staged tile");
      float* so = reinterpret_cast<float*>(tc_smem);
      __syncthreads();  // every warp is done with the ring
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(so + (wm + mi * 16 + g + 8 * hh) * kOP + wn + ni * 8 +
                                       2 * tq) =
                make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      __syncthreads();
      for (int idx = tid; idx < kTcBM * (kTcBN / 4); idx += kTcThreads) {
        const int r = idx / (kTcBN / 4);
        const int c = (idx - r * (kTcBN / 4)) * 4;
        if (m0 + r >= M || n0 + c >= N) continue;
        __stcs(reinterpret_cast<float4*>(o + (size_t)(m0 + r) * N + n0 + c),
               *reinterpret_cast<const float4*>(so + r * kOP + c));
      }
      return;
    }
  }
  const bool pairs = (N & 1) == 0;  // then (r*N + c) is even: 8-byte stores
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wm + mi * 16 + g + 8 * hh;
        const int c = n0 + wn + ni * 8 + 2 * tq;
        if (r >= M || c >= N) continue;
        float* p = o + (size_t)r * N + c;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
        } else {
          p[0] = acc[mi][ni][2 * hh];
          if (c + 1 < N) p[1] = acc[mi][ni][2 * hh + 1];
        }
      }
}

template <typename T, bool A_K, bool B_K>
cudaError_t launch_tc_gemm(dim3 grid, cudaStream_t s, int M, int N, int K, int k_chunk,
                           const TcOperand<T>& a, const TcOperand<T>& b, float* out) {
  const cudaError_t err = cudaFuncSetAttribute(
      tc_gemm_kernel<T, A_K, B_K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  tc_gemm_kernel<T, A_K, B_K><<<grid, kTcThreads, kTcSmem, s>>>(M, N, K, k_chunk, a, b, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gemm_tc(int layout, int M, int N, int K, const void* A, long long lda, int vec_a,
                    const void* B, long long ldb, int vec_b, int splits, void* out,
                    cudaStream_t s) {
  constexpr int E = (int)sizeof(T);
  auto misaligned = [](const void* ptr, long long ld, int vec) {
    return (vec != 1 && vec != 2 && vec != 4 && vec * E != 16) || ld < 1 || ld % vec != 0 ||
           reinterpret_cast<uintptr_t>(ptr) % (E * vec) != 0;
  };
  if (misaligned(A, lda, vec_a) || misaligned(B, ldb, vec_b)) return cudaErrorInvalidValue;
  constexpr int BK = TcShape<T>::BK;
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + BK - 1) / BK * BK;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const TcOperand<T> a{static_cast<const T*>(A), lda, vec_a};
  const TcOperand<T> b{static_cast<const T*>(B), ldb, vec_b};
  float* o = static_cast<float*>(out);
  if (layout == 0) return launch_tc_gemm<T, true, true>(grid, s, M, N, K, k_chunk, a, b, o);
  if (layout == 1) return launch_tc_gemm<T, false, false>(grid, s, M, N, K, k_chunk, a, b, o);
  return launch_tc_gemm<T, true, false>(grid, s, M, N, K, k_chunk, a, b, o);
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

// The products on the tensor cores, out[z] = A B over split z of K (f32
// partials [splits, M, N]): dtype 1 bf16 operands (mma m16n8k16), 0 f32
// operands (3xTF32). layout 0 (nt): A [M, K] and B [N, K], K contiguous in
// both; 1 (tn): A [K, M] and B [K, N]; 2 (nn): A [M, K] and B [K, N].
// lda / ldb: elements between rows; vec_a / vec_b: elements per copy (8,
// 4, 2 or 1 bf16; 4, 2 or 1 f32), which the row stride and the pointer
// must allow. Any other layout, or a misaligned vector width, is refused.
extern "C" int neddf_gemm_tc(int dtype, int layout, int M, int N, int K, const void* A,
                             long long lda, int vec_a, const void* B, long long ldb, int vec_b,
                             int splits, void* out, void* stream) {
  if (dtype < 0 || dtype > 1 || layout < 0 || layout > 2 || M <= 0 || N <= 0 || K <= 0 ||
      splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
                   ? gemm_tc<bf16>(layout, M, N, K, A, lda, vec_a, B, ldb, vec_b, splits, out, s)
                   : gemm_tc<float>(layout, M, N, K, A, lda, vec_a, B, ldb, vec_b, splits, out,
                                    s));
}

extern "C" int neddf_sum_splits(long long n, int splits, const void* parts,
                                void* out, void* stream) {
  if (n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_splits_kernel<<<grid_1d((size_t)n, 256), 256, 0, s>>>(
      n, splits, static_cast<const float*>(parts), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
