// The per-layer route's plain backward products for sm_90a, on wgmma fed
// by TMA: route_nt (dx = G W^T) and route_tn (dW = X^T G), f32 out.
//
// Replaces, one layer at a time, the products inside the Pallas backward
// neddf_tpu/kernels/dual_mlp.py::_bwd_kernel:728 (_mm_nt and _mm_tn,
// :208-228), as the per-layer walks run them (the layer loops of
// dual_mlp.py::_run_backward:935, mlp.py::_run_backward:248 and
// sdf_mlp.py::_run_backward:304, walked by kernels/dual_mlp.py::
// dual_mlp_layers_bwd, kernels/mlp.py's and kernels/sdf_mlp.py's walks):
// Products.nt / Products.tn with no activation folded in and one stream
// of rows, and the fused route's plain nt / tn calls (layer 0's narrow
// side, a post-skip layer's seg0 rows). Their folded modes stay on
// dual_mlp_bwd.cu's tc_gemm_kernel.
//
// * route_nt: out [R, N] = A [R, K] B [N, K]^T, A (the cotangent G) and
//   B (the weight rows W) both K-contiguous, as wgmma wants them. The
//   persistent 128 x 128 tile ring of hopper.cuh (Wide<T>, layer_fwd.cu's
//   wide layer forward's; bf16 with a fifth stage): one block per SM
//   walking the output tiles, N fastest, so the blocks working at one time
//   share A's rows in L2; one producer thread keeps a ring of 128-byte
//   k-blocks of A's 128 rows and B's 128 columns filled by TMA (128-byte
//   swizzle, zero fill past every edge); warpgroups 0 and 1 take 64 rows
//   each, bf16 by m64n128k16 from shared memory, f32 at f32 accuracy by
//   the 3xTF32 split (B's hi and lo planes from the w_split pre-pass, A
//   split as its fragments are read, each k8 step's three products summed
//   from zero and added with a rounded add: hopper.cuh::wg_3xtf32_k8). A
//   finished tile goes to the epilogue's warps through shared memory (one
//   64 KB tile, its 16-byte chunks permuted by row against bank
//   conflicts) and leaves as whole 16-byte f32 vectors (element stores
//   where N leaves a row off 16 bytes) while the next tile's products run.
//   (A ping-pong of two warpgroups, each a whole tile with its stores
//   from registers beside the other's products, took 1.72 ms at 1024 x
//   1024 against this design's 1.53.)
// * route_tn: out [M, N] = A [R, M]^T B [R, N], a reduction over R rows
//   (the activations X and the cotangent G), both M/N-contiguous. R is
//   cut into `splits` fixed ranges of k_chunk rows (kernels/dual_mlp.py::
//   route_plan picks the count that fills the SMs; a whole number of
//   k-blocks each), and each (split, tile) unit is one block's reduction,
//   written to its split's partial [M, N] plane; neddf_sum_splits adds the
//   planes in order, so two runs give the same bits (no atomics). The
//   ring holds [BK rows x 64 (bf16) or 32 (f32) columns] boxes of both
//   operands. bf16: wgmma takes MN-major 16-bit tiles from shared memory
//   through its transpose bits, so the landed boxes feed m64n128k16
//   directly (three warpgroups: the products and the producer's), each
//   64 k-blocks' sum taken from zero and added with a rounded add. f32:
//   TF32 wgmma takes B only K-major, so warpgroup 3 transposes each landed
//   G tile into K-major hi and lo tiles (split as it goes, 16-byte stores
//   under the swizzle, an mbarrier `ready` to the products), and the
//   products read A's fragments from the landed X boxes, split them, and
//   run the 3xTF32 k8 steps as route_nt does.
// * w_split_kernel, before an f32 route_nt: W [N, K] into its tf32 hi and
//   lo planes [N, ldw] (W is at most a few MB).
//
// What bounds them on the H100: 2 R K N operations against the bytes of
// the operands and the f32 output. The main path's dx at 1024 x 1024 over
// 4 x 99,328 rows (bf16): 0.84 ms of operations at 989 TFLOP/s, 0.49 ms of
// the 1.6 GB f32 output and 0.24 ms of G at 3.35 TB/s, so the tensor cores
// bind and the output's stores must run beside them (the epilogue's own
// warps); its dW the same operations against 1.6 GB of reads. f32 does
// three TF32 products per operation at 495 TFLOP/s (165 TFLOP/s of f32
// work): the tensor cores bind further. A 128 x 128 tile reads 64
// operations per byte of L2.
#include <cuda.h>

#include <algorithm>

#include "hopper.cuh"
#include "mlp_tile.cuh"
#include "tc_ops.cuh"

// One operand type's launches (the arguments of neddf_route_product below
// without dtype): kernels/_build.py compiles this file with
// -DNEDDF_ROUTE_BF16 and with -DNEDDF_ROUTE_F32, each object one type's
// instantiations, beside the object of the entry point (no define).
extern "C" int neddf_route_product_bf16(int layout, int M, int N, int K, const void* a,
                                        long long lda, const void* b, long long ldb, void* w_hi,
                                        void* w_lo, long long ldw, int splits, int k_chunk,
                                        void* out, void* stream);
extern "C" int neddf_route_product_f32(int layout, int M, int N, int K, const void* a,
                                       long long lda, const void* b, long long ldb, void* w_hi,
                                       void* w_lo, long long ldw, int splits, int k_chunk,
                                       void* out, void* stream);

#if defined(NEDDF_ROUTE_BF16) || defined(NEDDF_ROUTE_F32)
namespace {

using namespace neddf::hopper;
using bf16 = __nv_bfloat16;
using neddf::smem_u32;

// the reduction's ring by operand type: a stage holds a k-block of BK rows
// of A's 128 columns and of B's 128 columns, as NB boxes of BOXW columns
// (128 bytes: 64 bf16, 32 f32) each, BOX bytes a box; f32 adds B's
// transposed hi and lo tiles (16 KB each). Warps:
// 0-7 the products, warpgroup 2 the producer's (one thread of warp 8);
// f32: warpgroup 3 the transposer (from EPI_FIRST on), setmaxnreg as
// Wide<float>'s
template <typename T>
struct Tn;
template <>
struct Tn<bf16> {
  static constexpr int BK = 64, BOXW = 64, NB = 2, BOX = BK * 128, STAGES = 6;
  static constexpr int LOAD = 2 * 16384, STAGE = LOAD;
  static constexpr int THREADS = 3 * 128, EPI_FIRST = 3 * 128;
  static constexpr bool REG_SPLIT = false;
  static constexpr int PROD_REGS = 0, MMA_REGS = 0, EPI_REGS = 0;
};
template <>
struct Tn<float> {
  static constexpr int BK = 32, BOXW = 32, NB = 4, BOX = BK * 128, STAGES = 3;
  static constexpr int LOAD = 2 * 16384, STAGE = 4 * 16384;
  static constexpr int THREADS = 4 * 128, EPI_FIRST = 3 * 128;
  static constexpr bool REG_SPLIT = true;
  static constexpr int PROD_REGS = 40, MMA_REGS = 184, EPI_REGS = 104;
};
static_assert(regs_fit<Tn<bf16>>() && regs_fit<Tn<float>>(), "setmaxnreg budget");
static_assert(Tn<bf16>::NB * Tn<bf16>::BOX == 16384 && Tn<float>::NB * Tn<float>::BOX == 16384,
              "an operand's boxes fill 16 KB of a stage");

// bf16: the k-blocks (of 64 rows) whose products are summed from zero
// before a rounded add to the running sum; warpgroup 1's first chunk is
// half as long, so that the two warpgroups wait for their partials at
// different times and the tensor cores stay busy with the other's
constexpr int kTnChunk = 64;

// the ring and its barriers: full[ST], empty[ST], ready[ST]
template <typename T>
constexpr int tn_smem() {
  return Tn<T>::STAGES * Tn<T>::STAGE + 3 * Tn<T>::STAGES * 8;
}

// cudaFuncSetAttribute(kernel, max dynamic shared memory) once per device
// and process (done: the kernel's own flags), not per launch
template <typename K>
cudaError_t smem_once(K kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ void sts_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

// ------------------------------------------------------------------- route_nt
// route_nt's ring: Wide<T>'s stage shapes and warps, and one handed-over
// tile of 128 x 128 f32 (64 KB, swizzled instead of padded), which leaves
// bf16 room for a fifth stage
template <typename T>
struct Nt;
template <>
struct Nt<bf16> : Wide<bf16> {
  static constexpr int STAGES = 5;
};
template <>
struct Nt<float> : Wide<float> {};
constexpr int kHandTile = kTileRows * kTileCols * 4;

// the ring, the handed-over tile and the barriers: full[ST], empty[ST],
// hand_full, hand_empty
template <typename G>
constexpr int nt_smem() {
  return G::STAGES * G::STAGE + kHandTile + (2 * G::STAGES + 2) * 8;
}

// the f32 offset of (row r, column c) of a handed-over tile: rows of 128
// f32, their 16-byte chunks permuted by the row (chunk ^ 2 (r % 8)), so
// that the products' 8-byte writes of four rows and the epilogue's 16-byte
// reads of a row each fall on distinct banks
__device__ __forceinline__ int hand_at(int r, int c) {
  return r * kTileCols + ((((c >> 2) ^ ((r & 7) << 1))) << 2) + (c & 3);
}

struct NtArgs {
  int R, N, nk;
  int tiles_n, tiles;
  float* out;  // [R, N]
};

// the epilogue's warps on one handed-over tile h: a thread takes 8 columns
// of a row (16 lanes a row's 128 columns, so that a warp's stores are
// whole lines); t is its index among the n of the epilogue
template <int UNROLL>
__device__ __forceinline__ void nt_epilogue(const NtArgs& a, const float* h, int r0, int n0, int t,
                                            int n) {
  const int c = (t & 15) * 8;
  const int col = n0 + c;
  if (col >= a.N) return;
  const int n_in = min(8, a.N - col);
  const bool whole = n_in == 8 && a.N % 4 == 0;
#pragma unroll(UNROLL)
  for (int pl = t >> 4; pl < kTileRows; pl += n >> 4) {
    const int row = r0 + pl;
    if (row >= a.R) break;
    float z[8];
    const float4 lo = *reinterpret_cast<const float4*>(h + hand_at(pl, c));
    const float4 hi = *reinterpret_cast<const float4*>(h + hand_at(pl, c + 4));
    z[0] = lo.x; z[1] = lo.y; z[2] = lo.z; z[3] = lo.w;
    z[4] = hi.x; z[5] = hi.y; z[6] = hi.z; z[7] = hi.w;
    float* o = a.out + (size_t)row * a.N + col;
    if (whole) {
      neddf::vec_store<8>(o, z);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n_in) o[e] = z[e];
    }
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(G::THREADS, 1)
    route_nt(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             const __grid_constant__ CUtensorMap mb_lo, const __grid_constant__ NtArgs a) {
  constexpr int ST = G::STAGES;
  // the ring (1024-byte aligned for the swizzle: checked), the handed-over
  // tile, the barriers
  extern __shared__ __align__(1024) unsigned char nt_smem_raw[];
  const uint32_t base = smem_u32(nt_smem_raw);
  if (base % kAlign != 0) __trap();
  const uint32_t bars = base + ST * G::STAGE + kHandTile;
  const uint32_t hand_full = bars + 16 * ST, hand_empty = hand_full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);         // the producer's arrive + the bytes
      mbar_init(bars + 8 * (ST + s), 8);  // one arrive per consumer warp
    }
    mbar_init(hand_full, 8);                                  // the consumers wrote the tile
    mbar_init(hand_empty, (G::THREADS - G::EPI_FIRST) / 32);  // the epilogue read it
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* h = reinterpret_cast<float*>(nt_smem_raw + ST * G::STAGE);
  if (warp == 8 || (G::REG_SPLIT && wg == 2)) {
    // ---- the producer: one thread keeps the ring full
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PROD_REGS) : "memory");
    if (threadIdx.x == 8 * 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int tm = tile / a.tiles_n;
        const int r0 = tm * kTileRows, n0 = (tile - tm * a.tiles_n) * kTileCols;
        for (int kb = 0; kb < a.nk; ++kb) {
          const uint32_t full = bars + 8 * stage, st = base + stage * G::STAGE;
          mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
          mbar_expect_tx(full, G::STAGE);
          tma_load_2d(st, &ma, full, kb * G::BK, r0);
          tma_load_2d(st + 16384, &mb, full, kb * G::BK, n0);
          if constexpr (std::is_same_v<T, float>)
            tma_load_2d(st + 32768, &mb_lo, full, kb * G::BK, n0);
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (threadIdx.x >= G::EPI_FIRST) {
    // ---- the epilogue: each handed-over tile while the next one's products run
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::EPI_REGS) : "memory");
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int tm = tile / a.tiles_n;
      mbar_wait(hand_full, phase);
      constexpr int U = G::REG_SPLIT ? 2 : 1, NE = G::THREADS - G::EPI_FIRST;
      nt_epilogue<U>(a, h, tm * kTileRows, (tile - tm * a.tiles_n) * kTileCols,
                     threadIdx.x - G::EPI_FIRST, NE);
      __syncwarp();
      if (lane == 0) mbar_arrive(hand_empty);
      phase ^= 1;
    }
  } else {
    // ---- the products: 64 rows of every tile each
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::MMA_REGS) : "memory");
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;  // its row g; g + 8 too
    int stage = 0;
    uint32_t phase = 0, hphase = 0;
    float acc[64];
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      kmajor_tile<T, G>(acc, base, bars, a.nk, stage, phase, wg, r0, g, tq, lane);
      // hand the tile over once the epilogue has read the previous one:
      // thread (g, tq) holds columns 8 j + 2 tq (+1) of rows r0 and r0 + 8
      mbar_wait(hand_empty, hphase ^ 1);
      hphase ^= 1;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(h + hand_at(r0 + 8 * hh, 8 * j + 2 * tq)) =
              make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(hand_full);
    }
  }
}

// W [N, K] (row stride ldw_in) into its tf32 hi and lo planes [N, ldw]
// (zero past K)
__global__ void w_split_kernel(const float* __restrict__ w, long long ldw_in, int N, int K,
                               long long ldw, float* __restrict__ hi, float* __restrict__ lo) {
  const long long n_all = (long long)N * ldw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_all;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / ldw;
    const int k = (int)(i - r * ldw);
    const float v = k < K ? w[r * ldw_in + k] : 0.f;
    const float hv = __uint_as_float(neddf::tf32_rna(v));
    hi[i] = hv;
    lo[i] = __uint_as_float(neddf::tf32_rna(v - hv));
  }
}

// ------------------------------------------------------------------- route_tn
struct TnArgs {
  int M, N, R;
  int k_chunk;  // rows of a split (a whole number of k-blocks; the last may hold fewer)
  int tiles_n, tiles, units;
  float* out;   // [splits, M, N]
};

// unit u: split u / tiles, output tile u % tiles (N fastest): its corner
// (m0, n0), its first row and k-blocks
struct TnUnit {
  int split, m0, n0, row0, nk;
};
template <int BK>
__device__ __forceinline__ TnUnit tn_unit(const TnArgs& a, int u) {
  TnUnit t;
  t.split = u / a.tiles;
  const int tile = u - t.split * a.tiles;
  const int tm = tile / a.tiles_n;
  t.m0 = tm * kTileRows;
  t.n0 = (tile - tm * a.tiles_n) * kTileCols;
  t.row0 = t.split * a.k_chunk;
  const int rows = min(a.R - t.row0, a.k_chunk);
  t.nk = rows > 0 ? (rows + BK - 1) / BK : 0;
  return t;
}

// the f32 sum of a unit into its split's plane: thread (g, tq) holds
// columns 8 j + 2 tq (+1) of rows r0 and r0 + 8 of the tile
__device__ __forceinline__ void tn_store(const TnArgs& a, const TnUnit& t, const float (&acc)[64],
                                         int r0, int tq) {
  float* plane = a.out + (size_t)t.split * a.M * a.N;
  const bool pairs = a.N % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = t.m0 + r0 + 8 * hh;
    if (m >= a.M) continue;
    float* row = plane + (size_t)m * a.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.n0 + 8 * j + 2 * tq;
      const float x = acc[4 * j + 2 * hh], y = acc[4 * j + 2 * hh + 1];
      if (pairs && col + 1 < a.N) {
        *reinterpret_cast<float2*>(row + col) = make_float2(x, y);
      } else {
        if (col < a.N) row[col] = x;
        if (col + 1 < a.N) row[col + 1] = y;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Tn<T>::THREADS, 1)
    route_tn(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             const __grid_constant__ TnArgs a) {
  using G = Tn<T>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int ST = G::STAGES;
  extern __shared__ __align__(1024) unsigned char tn_smem_raw[];
  const uint32_t base = smem_u32(tn_smem_raw);
  if (base % kAlign != 0) __trap();
  const uint32_t bars = base + ST * G::STAGE;  // full[ST], empty[ST], ready[ST]
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer's arrive + the bytes
      mbar_init(bars + 8 * (ST + s), 8);      // one arrive per consumer warp
      mbar_init(bars + 8 * (2 * ST + s), 4);  // one arrive per transposer warp (f32)
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (wg == 2) {
    // ---- the producer's warpgroup: one thread keeps the ring full
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PROD_REGS) : "memory");
    if (threadIdx.x == 8 * 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const TnUnit t = tn_unit<G::BK>(a, u);
        for (int kb = 0; kb < t.nk; ++kb) {
          const uint32_t full = bars + 8 * stage, st = base + stage * G::STAGE;
          const int row = t.row0 + kb * G::BK;
          mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
          mbar_expect_tx(full, G::LOAD);
#pragma unroll
          for (int b = 0; b < G::NB; ++b) {
            tma_load_2d(st + b * G::BOX, &ma, full, t.m0 + b * G::BOXW, row);
            tma_load_2d(st + 16384 + b * G::BOX, &mb, full, t.n0 + b * G::BOXW, row);
          }
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (wg == 3) {
    // ---- f32: the transposer. Thread n of warpgroup 3 turns column n of
    // each landed G tile [32 k][128 n] into row n of B's K-major hi and lo
    // tiles [128 n][32 k] (the swizzle TMA would give them), 16 bytes of
    // four k at a time
    if constexpr (kF32) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::EPI_REGS) : "memory");
      const int n = threadIdx.x - G::EPI_FIRST;
      const uint32_t col = 16384 + (n >> 5) * G::BOX + ((n & 3) << 2);
      const int nc = (n & 31) >> 2;
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int nk = tn_unit<G::BK>(a, u).nk;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(bars + 8 * stage, phase);
          const uint32_t st = base + stage * G::STAGE;
#pragma unroll
          for (int kc = 0; kc < 8; ++kc) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int k = 4 * kc + e;
              neddf::split_tf32(neddf::lds_u32(st + col + k * 128 + ((nc ^ (k & 7)) << 4)), hi[e],
                                lo[e]);
            }
            const uint32_t at = n * 128 + ((kc ^ (n & 7)) << 4);
            sts_v4(st + 32768 + at, hi);
            sts_v4(st + 49152 + at, lo);
          }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) mbar_arrive(bars + 8 * (2 * ST + stage));
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- the products: 64 rows (of M) of every tile each
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::MMA_REGS) : "memory");
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + g;  // its row g; g + 8 too
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const TnUnit t = tn_unit<G::BK>(a, u);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if constexpr (!kF32) {
        // A: warpgroup wg's box of 64 M columns; B: the two boxes of the
        // tile's 128 N columns (the leading offset between them). The sum
        // of each kTnChunk k-blocks is taken from zero in part and added to
        // acc with a rounded add: the tensor core's accumulation truncates,
        // and a running sum over a split's ~200,000 rows drifted 2.3e-4
        // toward zero (5.6e-6 by chunks of 16, 6.7e-6 of 64)
        float part[64];
        int prev = 0;
        for (int c0 = 0, c1; c0 < t.nk; c0 = c1) {
          c1 = min(t.nk, c0 + (c0 == 0 && wg == 1 ? kTnChunk / 2 : kTnChunk));
          for (int kb = c0; kb < c1; ++kb) {
            mbar_wait(bars + 8 * stage, phase);
            const uint32_t st = base + stage * G::STAGE;
            const uint64_t da = wg_desc_mn(st + wg * G::BOX, G::BOX);
            const uint64_t db = wg_desc_mn(st + 16384, G::BOX);
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_bf16_m64n128<1, 1>(part, da + 128 * kk, db + 128 * kk, kb > c0 || kk > 0);
            wg_commit();
            wg_wait<1>();  // the previous k-block's products are done: release its stage
            if (kb > 0 && lane == 0) mbar_arrive(bars + 8 * (ST + prev));
            prev = stage;
            if (++stage == ST) {
              stage = 0;
              phase ^= 1;
            }
          }
          wg_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
        if (t.nk > 0 && lane == 0) mbar_arrive(bars + 8 * (ST + prev));
      } else {
        // A's fragments from the landed X boxes [32 k][32 m] (a0 (g, t), a1
        // (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of each k8 step, m
        // the row of A), split into tf32 hi and lo; B from the transposer
        float part[64];
        uint32_t moff[2];
        int mc[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = r0 + 8 * hh;
          moff[hh] = (m >> 5) * G::BOX + ((m & 3) << 2);
          mc[hh] = (m & 31) >> 2;
        }
        for (int kb = 0; kb < t.nk; ++kb) {
          mbar_wait(bars + 8 * stage, phase);
          mbar_wait(bars + 8 * (2 * ST + stage), phase);
          const uint32_t st = base + stage * G::STAGE;
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = kk * 8 + tq + 4 * (i >> 1);
              const uint32_t at = st + moff[i & 1] + k * 128 + ((mc[i & 1] ^ (k & 7)) << 4);
              neddf::split_tf32(neddf::lds_u32(at), ah[kk][i], al[kk][i]);
            }
          const uint64_t dh = wg_desc(st + 32768), dl = wg_desc(st + 49152);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wg_3xtf32_k8(acc, part, ah[kk], al[kk], dh + 2 * kk, dl + 2 * kk);
          if (lane == 0) mbar_arrive(bars + 8 * (ST + stage));
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      tn_store(a, t, acc, r0, tq);
    }
  }
}

// ---------------------------------------------------------------- host side
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_nt(int R, int N, int K, const T* a, long long lda, const T* b, long long ldb, T* w_hi,
              T* w_lo, long long ldw, float* out, cudaStream_t st) {
  using G = Nt<T>;
  constexpr int E = (int)sizeof(T);
  constexpr bool kF32 = std::is_same_v<T, float>;
  if (!aligned16(a) || (lda * E) % 16 != 0 || lda < K) return (int)cudaErrorInvalidValue;
  const T* bm = b;
  long long ldm = ldb;
  if constexpr (kF32) {
    // B's tf32 planes [N, ldw] from the pre-pass
    if (w_hi == nullptr || w_lo == nullptr || !aligned16(w_hi) || !aligned16(w_lo) ||
        (ldw * E) % 16 != 0 || ldw < K || ldb < K)
      return (int)cudaErrorInvalidValue;
    const long long n_all = (long long)N * ldw;
    const int blocks = (int)std::min<long long>((n_all + 255) / 256, 4096);
    w_split_kernel<<<blocks, 256, 0, st>>>(b, ldb, N, K, ldw, w_hi, w_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bm = w_hi;
    ldm = ldw;
  } else if (!aligned16(b) || (ldb * E) % 16 != 0 || ldb < K) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap ma, mb[2];
  {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)lda * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileRows};
    if (int r = encode<T>(&ma, a, 2, dims, strides, box)) return r;
  }
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)ldm * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileCols};
    if (int r = encode<T>(&mb[i], kF32 && i == 1 ? w_lo : bm, 2, dims, strides, box)) return r;
  }
  NtArgs na{};
  na.R = R;
  na.N = N;
  na.nk = (K + G::BK - 1) / G::BK;
  na.tiles_n = (N + kTileCols - 1) / kTileCols;
  const long long tiles = (long long)((R + kTileRows - 1) / kTileRows) * na.tiles_n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  na.tiles = (int)tiles;
  na.out = out;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  static bool attr_set[64] = {};
  auto kernel = route_nt<T, G>;
  if (cudaError_t e = smem_once(kernel, nt_smem<G>(), attr_set)) return (int)e;
  kernel<<<std::min(na.tiles, sms), G::THREADS, nt_smem<G>(), st>>>(ma, mb[0], mb[1], na);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tn(int M, int N, int R, const T* a, long long lda, const T* b, long long ldb,
              int splits, int k_chunk, float* out, cudaStream_t st) {
  using G = Tn<T>;
  constexpr int E = (int)sizeof(T);
  if (!aligned16(a) || !aligned16(b) || (lda * E) % 16 != 0 || (ldb * E) % 16 != 0 || lda < M ||
      ldb < N || k_chunk <= 0 || k_chunk % G::BK != 0 || splits != (R + k_chunk - 1) / k_chunk)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint32_t box[2] = {(cuuint32_t)G::BOXW, (cuuint32_t)G::BK};
  {
    const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)lda * E};
    if (int r = encode<T>(&ma, a, 2, dims, strides, box)) return r;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)ldb * E};
    if (int r = encode<T>(&mb, b, 2, dims, strides, box)) return r;
  }
  TnArgs ta{};
  ta.M = M;
  ta.N = N;
  ta.R = R;
  ta.k_chunk = k_chunk;
  ta.tiles_n = (N + kTileCols - 1) / kTileCols;
  const long long tiles = (long long)((M + kTileRows - 1) / kTileRows) * ta.tiles_n;
  if (tiles * splits > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ta.tiles = (int)tiles;
  ta.units = (int)(tiles * splits);
  ta.out = out;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  static bool attr_set[64] = {};
  auto kernel = route_tn<T>;
  if (cudaError_t e = smem_once(kernel, tn_smem<T>(), attr_set)) return (int)e;
  kernel<<<std::min(ta.units, sms), G::THREADS, tn_smem<T>(), st>>>(ma, mb, ta);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef NEDDF_ROUTE_BF16
using RouteT = bf16;
#define NEDDF_ROUTE_FN neddf_route_product_bf16
#else
using RouteT = float;
#define NEDDF_ROUTE_FN neddf_route_product_f32
#endif
extern "C" int NEDDF_ROUTE_FN(int layout, int M, int N, int K, const void* a, long long lda,
                              const void* b, long long ldb, void* w_hi, void* w_lo, long long ldw,
                              int splits, int k_chunk, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0)
    return launch_nt<RouteT>(M, N, K, static_cast<const RouteT*>(a), lda,
                             static_cast<const RouteT*>(b), ldb, static_cast<RouteT*>(w_hi),
                             static_cast<RouteT*>(w_lo), ldw, static_cast<float*>(out), st);
  return launch_tn<RouteT>(M, N, K, static_cast<const RouteT*>(a), lda,
                           static_cast<const RouteT*>(b), ldb, splits, k_chunk,
                           static_cast<float*>(out), st);
}
#else

// The per-layer route's plain products (kernels/dual_mlp.py::Products.nt
// and .tn through route_plan), dtype 1 bf16 or 0 f32 operands, f32 out:
// layout 0 (route_nt): out [M, N] = a [M, K] b [N, K]^T, a's and b's rows
// lda and ldb elements apart (K contiguous); f32 writes b's tf32 planes
// into w_hi and w_lo [N, ldw] first. layout 1 (route_tn): out [splits, M,
// N] = a [K, M]^T b [K, N] over K rows cut into `splits` ranges of k_chunk
// rows (a multiple of the k-block: 64 bf16, 32 f32), each range's sum in
// its own plane (the caller adds them in order). Operands 16-byte aligned
// with rows of whole 16-byte vectors, out 16-byte aligned. Returns a
// cudaError_t, or 20000 + the CUresult of a failed tensor-map encoding.
extern "C" int neddf_route_product(int dtype, int layout, int M, int N, int K, const void* a,
                                   long long lda, const void* b, long long ldb, void* w_hi,
                                   void* w_lo, long long ldw, int splits, int k_chunk, void* out,
                                   void* stream) {
  if (dtype < 0 || dtype > 1 || layout < 0 || layout > 1 || M <= 0 || N <= 0 || K <= 0 ||
      a == nullptr || b == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (layout == 1 && splits <= 0))
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_route_product_bf16 : neddf_route_product_f32;
  return fn(layout, M, N, K, a, lda, b, ldb, w_hi, w_lo, ldw, splits, k_chunk, out, stream);
}

#endif
