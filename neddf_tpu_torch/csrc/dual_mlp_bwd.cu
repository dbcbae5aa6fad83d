// Dual-MLP backward (the dual chain rule in reverse) for sm_90a: the top
// layer's stacked cotangent, the plain products of tc_gemm_kernel and the
// fixed-order sums.
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
//   route_nt / route_tn; an nt of a depth under 8, a 3-wide last layer's
//   dx, tc_gemm_kernel below); neddf_sum_rows sums the db
//   partials in a fixed order over the whole card (groups of rows, then
//   the groups); neddf_sum_splits the dW split partials.
// Determinism. The Pallas kernel accumulates dW/db across its sequential
// TPU grid; blocks here run concurrently, so every cross-block reduction
// writes per-block (or per-split) f32 partials that a second pass sums
// in a fixed order. No float atomics: two runs give bitwise-equal dW.
//
// tc_gemm_kernel (Products.gemm): the plain nt product out = A B^T, both
// operands K-contiguous, of a depth under 8, which route_products.cu's
// route_nt does not take (a 3-wide layer's dx: G [R, 3] W [N, 3]^T), on
// the tensor cores by mma.sync: a 128x128 output tile per block of 8
// warps, each warp 64x32 as 4x4 mma tiles with f32 accumulators in
// registers; both operands stream through a ring of 3 shared-memory stages
// of 128 bytes per row (64 bf16 or 32 f32) filled by cp.async, so the copy
// of stage k+2 overlaps the products of stage k (one stage at such a
// depth; the ring takes any K). bf16 operands: mma.sync m16n8k16,
// fragments by ldmatrix, rows padded by 16 bytes against bank conflicts.
// f32 operands: the 3xTF32 split of tc_ops.cuh, three mma.sync m16n8k8
// tf32 per f32 multiply-add, each fragment split into hi/lo as it is read
// from shared memory by the same ldmatrix byte addresses as bf16. The dx
// writes 4 bytes of f32 per output against 2*K FLOPs, so its tile leaves
// through shared memory in coalesced streaming stores.
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

// ---- the shallow nt product on the tensor cores: bf16 operands by
// mma.sync m16n8k16, f32 operands by the 3xTF32 split (tc_ops.cuh:
// mma_3xtf32)
using bf16 = __nv_bfloat16;

constexpr int kTcBM = 128;  // output rows per block
constexpr int kTcBN = 128;  // output columns per block
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;

// the shared tiles of operand type T, [rows][BK] (rows padded by 16
// bytes: ldmatrix without bank conflicts). A stage is 128 bytes deep (64
// bf16 or 32 f32) and one mma 32 bytes (k16 bf16, k8 tf32), so the byte
// addresses of the ldmatrix fragments are the same for both types.
template <typename T>
struct TcShape {
  static constexpr int BK = 128 / (int)sizeof(T);   // depth of one stage
  static constexpr int KSTEP = 32 / (int)sizeof(T);  // depth of one mma
  static constexpr int PK = BK + 16 / (int)sizeof(T);
  static constexpr int OP = kTcBM * PK;  // elements of one operand's stage
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

// one copy of V elements from src (valid of them, zeros past) to s
template <typename T, int V>
__device__ __forceinline__ void tc_copy(T* s, const T* src, int valid) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES < 4) {
    *s = valid > 0 ? *src : neddf::from_f32<T>(0.f);
  } else {
    neddf::cp_async<BYTES>(neddf::smem_u32(s), src, (int)sizeof(T) * valid);
  }
}

// the OUTER x INNER tile at (o0, i0) into shared s (row pitch P), zeros
// past (olim, ilim); copies of V elements (cp.async from 4 bytes up)
template <typename T, int OUTER, int INNER, int P, int V>
__device__ __forceinline__ void tc_copy_tile(T* s, const TcOperand<T>& op, int o0, int olim,
                                             int i0, int ilim, int tid) {
  constexpr int CPR = INNER / V;
#pragma unroll 1
  for (int idx = tid; idx < OUTER * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int go = o0 + r, gi = i0 + c;
    const int valid = go < olim ? max(0, min(V, ilim - gi)) : 0;
    tc_copy<T, V>(s + r * P + c, valid > 0 ? op.p + (size_t)go * op.ld + gi : op.p, valid);
  }
}

// the tile at the operand's copy width
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

// out[m][n] = sum over k of A(m, k) B(n, k) (f32), A [M, K] and B [N, K]
// with K contiguous
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    tc_gemm_kernel(int M, int N, int K, const TcOperand<T> A, const TcOperand<T> B,
                   float* __restrict__ out) {
  using Sh = TcShape<T>;
  constexpr int BK = Sh::BK, PK = Sh::PK, OP = Sh::OP;
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
  const int nk = (K + BK - 1) / BK;

  auto load = [&](int t) {
    const int k0 = t * BK;
    tc_load_tile<T, kTcBM, BK, PK>(sA + (t % kTcStages) * OP, A, m0, M, k0, K, tid);
    tc_load_tile<T, kTcBN, BK, PK>(sB + (t % kTcStages) * OP, B, n0, N, k0, K, tid);
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
    const int k_left = K - t * BK;  // zeros past it: skip their mma
    // one mma depth: the warp's B fragments first, then one A fragment at
    // a time (fewer live registers than all of A first)
    auto step = [&](int kk) {
      // bfr[nj]: b0, b1 of column tile 2nj, then of 2nj+1
      uint32_t bfr[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn + nj * 16;
        neddf::ldsm_x4(bfr[nj], neddf::smem_u32(b + (n + (lane & 7) + (lane >> 4) * 8) * PK +
                                                kk) + ((lane >> 3) & 1) * 16);
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
        neddf::ldsm_x4(af, neddf::smem_u32(a + (m + (lane & 7) + ((lane >> 3) & 1) * 8) * PK +
                                           kk) + (lane >> 4) * 16);
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
    };
#pragma unroll
    for (int kk = 0; kk < BK; kk += Sh::KSTEP) {
      if (kk >= k_left) break;
      step(kk);
    }
  }
  neddf::cp_async_wait<0>();

  // N of a whole tile or more: the f32 output is most of the bytes, so the
  // tile goes through the free ring in shared memory and out in coalesced
  // 16-byte rows, streaming (nothing reads it again here)
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
      __stcs(reinterpret_cast<float4*>(out + (size_t)(m0 + r) * N + n0 + c),
             *reinterpret_cast<const float4*>(so + r * kOP + c));
    }
    return;
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
        float* p = out + (size_t)r * N + c;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
        } else {
          p[0] = acc[mi][ni][2 * hh];
          if (c + 1 < N) p[1] = acc[mi][ni][2 * hh + 1];
        }
      }
}

// the nt product, f32 out
template <typename T>
cudaError_t gemm_tc(int M, int N, int K, const void* A, long long lda, int vec_a,
                    const void* B, long long ldb, int vec_b, void* out, cudaStream_t s) {
  constexpr int E = (int)sizeof(T);
  auto misaligned = [](const void* ptr, long long ld, int vec) {
    return (vec != 1 && vec != 2 && vec != 4 && vec * E != 16) || ld < 1 || ld % vec != 0 ||
           reinterpret_cast<uintptr_t>(ptr) % (E * vec) != 0;
  };
  if (misaligned(A, lda, vec_a) || misaligned(B, ldb, vec_b)) return cudaErrorInvalidValue;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const TcOperand<T> a{static_cast<const T*>(A), lda, vec_a};
  const TcOperand<T> b{static_cast<const T*>(B), ldb, vec_b};
  auto kernel = tc_gemm_kernel<T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, kTcSmem, s>>>(M, N, K, a, b, static_cast<float*>(out));
  return cudaGetLastError();
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

// The nt product on the tensor cores, out [M, N] = A [M, K] B [N, K]^T
// (f32), K contiguous in both: dtype 1 bf16 operands (mma m16n8k16), 0 f32
// operands (3xTF32). lda / ldb: elements between rows; vec_a / vec_b:
// elements per copy (8, 4, 2 or 1 bf16; 4, 2 or 1 f32), which the row
// stride and the pointer must allow; a misaligned vector width is refused.
// (Every other product runs on route_products.cu's wgmma kernels.)
extern "C" int neddf_gemm_tc(int dtype, int M, int N, int K, const void* A, long long lda,
                             int vec_a, const void* B, long long ldb, int vec_b, void* out,
                             void* stream) {
  if (dtype < 0 || dtype > 1 || M <= 0 || N <= 0 || K <= 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? gemm_tc<bf16>(M, N, K, A, lda, vec_a, B, ldb, vec_b, out, s)
                          : gemm_tc<float>(M, N, K, A, lda, vec_a, B, ldb, vec_b, out, s));
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
