// The backward products for sm_90a, on wgmma fed by TMA: route_nt (dx = G
// W^T) and route_tn (dW = X^T G), alone (f32 out) or with an activation's
// elementwise work folded in (the epilogue of route_nt, the prologue of
// route_tn).
//
// Replace, one layer at a time, the products inside the Pallas backward
// neddf_tpu/kernels/dual_mlp.py::_bwd_kernel:728 (_mm_nt and _mm_tn,
// :208-228) and the elementwise work beside them in
// neddf_tpu/kernels/dual_mlp.py::_bwd_kernel (the stacked cotangent and
// the layer input), neddf_tpu/kernels/mlp.py::_bwd_kernel:248 (g f'(z),
// f(z_{l-1})) and neddf_tpu/kernels/sdf_mlp.py::_bwd_kernel:304 (the
// sweep's replay and adjoint), as the Python walks run them
// (kernels/dual_mlp.py::dual_mlp_seg_bwd_route and dual_mlp_layers_bwd,
// kernels/mlp.py's and kernels/sdf_mlp.py's walks):
//
// * plain (kFoldNone): Products.nt / .tn, one stream of rows, f32 out;
// * kFoldAct: Products.nt_act and .nn_adjoint on route_nt (the finished
//   f32 tile combined with the stash z, and a side plane where there is
//   one, by the epilogue's warps: v = acc f'(z) (+ side) rounded to T,
//   the raw acc, one f32 db partial per 128-row tile; or the sweep's
//   adjoint acc f'(z) and acc side f''(z); f32 columns [n_act, N) raw),
//   Products.tn_act on route_tn (dW = f(z)^T G, f applied to the landed
//   stash and rounded to T);
// * kFoldDual: DualProducts.nt_gstack and .tn_dual_act, the dual
//   backward's products over S = 2^SL streams [S, M, C], rows grouped by
//   point: route_nt's output tile holds the S streams of 128 / S points,
//   loaded by a 3-D tensor map (as layer_fwd.cu's wide layer groups its
//   streams), and its epilogue forms the stacked cotangent of the layer
//   below, G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a, G_a = g_a f'(z_v),
//   in T with one db partial per tile (under ReLU and LeakyReLU, f'' = 0,
//   only the value stream's stash is read); route_tn's k-block holds the
//   S streams of BK / S points, and its prologue forms the layer input
//   (f(z_v), f'(z_v) z_a) of the stash.
//
// * route_nt: out [R, N] = A [R, K] B [N, K]^T, A (the cotangent G) and
//   B (the weight rows W) both K-contiguous, as wgmma wants them. The
//   persistent 128 x 128 tile ring of hopper.cuh (Wide<T>, layer_fwd.cu's
//   wide layer forward's; plain bf16 with a fifth stage): one block per SM
//   walking the output tiles, N fastest, so the blocks working at one time
//   share A's rows in L2; one producer thread keeps a ring of 128-byte
//   k-blocks of A's 128 rows and B's 128 columns filled by TMA (128-byte
//   swizzle, zero fill past every edge; A may come in two K segments, the
//   sweep adjoint's [qbar | cg], each from its own tensor map); warpgroups
//   0 and 1 take 64 rows each, bf16 by m64n128k16 from shared memory, f32
//   at f32 accuracy by the 3xTF32 split (B's hi and lo planes from the
//   w_split pre-pass, which also transposes the nn adjoint's W [K, N] and
//   leaves zero columns between A's two segments; A split as its fragments
//   are read, each k8 step's three products summed from zero and added
//   with a rounded add: hopper.cuh::wg_3xtf32_k8). A finished tile goes to
//   the epilogue's warps through shared memory (one 64 KB tile, its
//   16-byte chunks permuted by row against bank conflicts) while the next
//   tile's products run. The folded epilogue reads the stash (and the side
//   plane) straight from device memory, 8 bytes (bf16) or 16 (f32) of a
//   row per thread, the loads of two rows in flight: a TMA stream of the
//   stash beside the ring would need another 32-64 KB of shared memory a
//   stage, which the ring holds. Its db partial: each thread sums its
//   rows in order, the two half-warps of a column group are added by a
//   shuffle, the warps in warp order (bitwise repeatable, no atomics).
//   (A ping-pong of two warpgroups, each a whole tile with its stores
//   from registers beside the other's products, took 1.72 ms at 1024 x
//   1024 against this design's 1.53.)
// * route_tn: out [M, N] = A [R, M]^T B [R, N], a reduction over R rows
//   (the activations X and the cotangent G), both M/N-contiguous. R is
//   cut into `splits` fixed ranges of k_chunk rows (kernels/dual_mlp.py::
//   route_plan / fold_plan pick the count that fills the SMs; a whole
//   number of k-blocks each), and each (split, tile) unit is one block's
//   reduction, written to its split's partial [M, N] plane;
//   neddf_sum_splits adds the planes in order, so two runs give the same
//   bits (no atomics). The ring holds [BK rows x 64 (bf16) or 32 (f32)
//   columns] boxes of both operands. bf16: wgmma takes MN-major 16-bit
//   tiles from shared memory through its transpose bits, so the landed
//   boxes feed m64n128k16 directly (three warpgroups: the products and the
//   producer's), each 64 k-blocks' sum taken from zero and added with a
//   rounded add; with a prologue, warps 9-11 of the producer's warpgroup
//   apply f (or form the dual layer input) to the landed A boxes in place,
//   rounded to bf16, and arrive on an mbarrier `ready` that the products
//   wait for. f32: TF32 wgmma takes B only K-major, so warpgroup 3
//   transposes each landed G tile into K-major hi and lo tiles (split as
//   it goes, 16-byte stores under the swizzle, `ready` to the products),
//   and the products read A's fragments from the landed X boxes, apply
//   the prologue's f there (the dual input: each thread's fragments of a
//   k-block hold every stream of its points), split them, and run the
//   3xTF32 k8 steps as route_nt does.
// * w_split_kernel, before an f32 route_nt: B into its tf32 hi and lo
//   planes [N, ldw] (W is at most a few MB).
//
// What bounds them on the H100: 2 R K N operations against the bytes of
// the operands and the output. The per-layer route's dx at 1024 x 1024
// over 4 x 99,328 rows (bf16): 0.84 ms of operations at 989 TFLOP/s, 0.49
// ms of the 1.6 GB f32 output and 0.24 ms of G at 3.35 TB/s, so the
// tensor cores bind and the output's stores must run beside them (the
// epilogue's own warps); its dW the same operations against 1.6 GB of
// reads. The folded modes at the shipped width of 256 in bf16 are bound
// by bytes instead: the K=3 trunk's nt_gstack reads G_l and the stash
// (203 MB each) and writes G_{l-1} (203 MB), 0.18 ms at 3.35 TB/s against
// 0.053 ms of operations, so each row of G is read from device memory once
// (the blocks working at one time share it in L2), the stash is read once
// beside the products and the cotangent leaves in bf16. f32 does three
// TF32 products per operation at 495 TFLOP/s (165 TFLOP/s of f32 work):
// the tensor cores bind (NeuS's 265,216 x 256 x 256: 0.211 ms a product).
// A 128 x 128 tile reads 64 operations per byte of L2.
#include <cuda.h>

#include <algorithm>

#include "hopper.cuh"
#include "mlp_tile.cuh"
#include "tc_ops.cuh"

// One operand type's launches (the arguments of neddf_route_product and
// neddf_fold_product below without dtype): kernels/_build.py compiles this
// file with -DNEDDF_ROUTE_BF16 and with -DNEDDF_ROUTE_F32 (the plain
// products), and with -DNEDDF_FOLD_BF16 / -DNEDDF_FOLD_F32 each with
// -DNEDDF_FOLD_NT or -DNEDDF_FOLD_TN (the folded modes of one kernel),
// each object one type's instantiations, beside the object of the entry
// points (no define).
extern "C" int neddf_route_product_bf16(int layout, int M, int N, int K, const void* a,
                                        long long lda, const void* b, long long ldb, void* w_hi,
                                        void* w_lo, long long ldw, int splits, int k_chunk,
                                        void* out, void* stream);
extern "C" int neddf_route_product_f32(int layout, int M, int N, int K, const void* a,
                                       long long lda, const void* b, long long ldb, void* w_hi,
                                       void* w_lo, long long ldw, int splits, int k_chunk,
                                       void* out, void* stream);
#define NEDDF_FOLD_NT_ARGS                                                                       \
  int nn, int act, int mode, int streams, int R, int N, int K, const void *a, long long lda,    \
      const void *a2, long long lda2, int k1, const void *b, long long ldb, void *w_hi,          \
      void *w_lo, long long ldw, const void *z, const void *side, int n_act, void *out_t,       \
      void *out2, void *raw, void *db, void *stream
#define NEDDF_FOLD_TN_ARGS                                                                       \
  int act, int streams, int M, int N, int R, const void *a, long long lda, const void *b,       \
      long long ldb, int splits, int k_chunk, void *out, void *stream
extern "C" int neddf_fold_nt_bf16(NEDDF_FOLD_NT_ARGS);
extern "C" int neddf_fold_nt_f32(NEDDF_FOLD_NT_ARGS);
extern "C" int neddf_fold_tn_bf16(NEDDF_FOLD_TN_ARGS);
extern "C" int neddf_fold_tn_f32(NEDDF_FOLD_TN_ARGS);

#if defined(NEDDF_ROUTE_BF16) || defined(NEDDF_ROUTE_F32) || defined(NEDDF_FOLD_BF16) || \
    defined(NEDDF_FOLD_F32)
namespace {

using namespace neddf::hopper;
using bf16 = __nv_bfloat16;
using neddf::smem_u32;

// what a product does besides its sum (template parameter FOLD)
constexpr int kFoldNone = 0;  // f32 out: the plain products
constexpr int kFoldAct = 1;   // nt / nn: the activation's epilogue; tn: f(A) as the prologue
constexpr int kFoldDual = 2;  // S = 2^SL streams grouped by point: nt the stacked
                              // cotangent, tn the dual layer input
// the modes of kFoldAct's epilogue (kernels/dual_mlp.py's _MODE_DACT, _MODE_ADJOINT)
constexpr int kModeDact = 1;
constexpr int kModeAdjoint = 2;

// the reduction's ring by operand type: a stage holds a k-block of BK rows
// of A's UM columns and of B's UN columns, as A_BOXES and B_BOXES boxes of
// BOXW columns (128 bytes: 64 bf16, 32 f32) each, BOX bytes a box, B's at
// B_AT; f32 adds B's transposed hi and lo tiles (16 KB each). A unit's
// output tile is UM x UN. Warps: 0-7 the products, warpgroup 2 the
// producer's (one thread of warp 8); f32: warpgroup 3 the transposer (from
// EPI_FIRST on), setmaxnreg as Wide<float>'s. bf16 with a prologue: the
// transform is warps 9-11 and a fourth warpgroup (seven warps: tanhExp's
// f and f' outran three), setmaxnreg giving the products the registers
// the plain kernel's 384 threads had; and a unit is 64 x 256, the two
// warpgroups on the same 64 columns of A against 128 columns of B each,
// so that each element of A is transformed once a split (a 128 x 128 tile
// transformed it once per column tile). READY: the warps that arrive on a
// stage's `ready`
template <typename T, int FOLD>
struct Tn;
template <int FOLD>
struct Tn<bf16, FOLD> {
  static constexpr bool kPro = FOLD != kFoldNone;
  static constexpr int BK = 64, BOXW = 64, BOX = BK * 128;
  static constexpr int A_BOXES = kPro ? 1 : 2, B_BOXES = kPro ? 4 : 2, B_AT = A_BOXES * BOX;
  static constexpr int UM = 64 * A_BOXES, UN = 64 * B_BOXES;
  static constexpr int LOAD = (A_BOXES + B_BOXES) * BOX, STAGE = LOAD, STAGES = kPro ? 5 : 6;
  static constexpr int THREADS = (kPro ? 4 : 3) * 128, EPI_FIRST = 3 * 128, READY = 7;
  static constexpr bool REG_SPLIT = kPro;
  static constexpr int PROD_REGS = kPro ? 88 : 0, MMA_REGS = kPro ? 168 : 0;
  static constexpr int EPI_REGS = kPro ? 88 : 0;
};
template <int FOLD>
struct Tn<float, FOLD> {
  static constexpr int BK = 32, BOXW = 32, BOX = BK * 128;
  static constexpr int A_BOXES = 4, B_BOXES = 4, B_AT = 16384, UM = 128, UN = 128;
  static constexpr int LOAD = 2 * 16384, STAGE = 4 * 16384, STAGES = 3;
  static constexpr int THREADS = 4 * 128, EPI_FIRST = 3 * 128, READY = 4;
  static constexpr bool REG_SPLIT = true;
  static constexpr int PROD_REGS = 40, MMA_REGS = 184, EPI_REGS = 104;
};
static_assert(regs_fit<Tn<bf16, kFoldNone>>() && regs_fit<Tn<bf16, kFoldAct>>() &&
                  regs_fit<Tn<float, kFoldNone>>(),
              "setmaxnreg budget");
static_assert(Tn<bf16, 0>::A_BOXES * Tn<bf16, 0>::BOX == 16384 &&
                  Tn<float, 0>::A_BOXES * Tn<float, 0>::BOX == 16384,
              "the plain kernels' operands fill 16 KB of a stage");

// bf16: the k-blocks (of 64 rows) whose products are summed from zero
// before a rounded add to the running sum; warpgroup 1's first chunk is
// half as long, so that the two warpgroups wait for their partials at
// different times and the tensor cores stay busy with the other's
constexpr int kTnChunk = 64;

// the ring and its barriers: full[ST], empty[ST], ready[ST]
template <typename G>
constexpr int tn_smem() {
  return G::STAGES * G::STAGE + 3 * G::STAGES * 8;
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
__device__ __forceinline__ void lds_v4(uint32_t addr, uint32_t (&v)[4]) {
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}
// 8 bf16 of shared memory as f32, and back rounded to bf16
__device__ __forceinline__ void lds_bf16x8(uint32_t addr, float (&x)[8]) {
  uint32_t w[4];
  lds_v4(addr, w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void sts_bf16x8(uint32_t addr, const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  sts_v4(addr, w);
}

// the epilogue's warps meet at a named barrier (0 is __syncthreads)
__device__ __forceinline__ void epi_bar(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <int ACT>
__device__ __forceinline__ float act_f(float x) {
  float f, df;
  neddf::act_fn<ACT>(x, f, df);
  return f;
}

// ------------------------------------------------------------------- route_nt
// route_nt's ring: Wide<T>'s stage shapes and warps, and one handed-over
// tile of 128 x 128 f32 (64 KB, swizzled instead of padded), which leaves
// the plain bf16 product room for a fifth stage (the folded modes keep
// that room for their db sums)
template <typename T, int FOLD>
struct Nt : Wide<T> {
  static constexpr int STAGES =
      std::is_same_v<T, bf16> && FOLD == kFoldNone ? 5 : Wide<T>::STAGES;
};
constexpr int kHandTile = kTileRows * kTileCols * 4;

// the folded epilogue's column sums: one row of kTileCols f32 per warp
template <typename G, int FOLD>
constexpr int nt_red_bytes() {
  return FOLD == kFoldNone ? 0 : (G::THREADS - G::EPI_FIRST) / 32 * kTileCols * 4;
}
// the ring, the handed-over tile, the barriers (full[ST], empty[ST],
// hand_full, hand_empty; 16-byte aligned) and the column sums
template <typename G>
__host__ __device__ constexpr int nt_bars_bytes() {
  return ((2 * G::STAGES + 2) * 8 + 15) / 16 * 16;
}
template <typename G, int FOLD>
constexpr int nt_smem() {
  return G::STAGES * G::STAGE + kHandTile + nt_bars_bytes<G>() + nt_red_bytes<G, FOLD>();
}
static_assert(nt_smem<Nt<bf16, kFoldNone>, kFoldNone>() <= 232448 &&
                  nt_smem<Nt<bf16, kFoldAct>, kFoldAct>() <= 232448 &&
                  nt_smem<Nt<float, kFoldAct>, kFoldAct>() <= 232448,
              "route_nt's shared memory");

// the f32 offset of (row r, column c) of a handed-over tile: rows of 128
// f32, their 16-byte chunks permuted by the row (chunk ^ 2 (r % 8)), so
// that the products' 8-byte writes of four rows and the epilogue's 16-byte
// reads of a row each fall on distinct banks
__device__ __forceinline__ int hand_at(int r, int c) {
  return r * kTileCols + ((((c >> 2) ^ ((r & 7) << 1))) << 2) + (c & 3);
}
// the W (4 or 8) values of row r from column c (a multiple of 4) of a
// handed-over tile
template <int W>
__device__ __forceinline__ void hand_n(const float* h, int r, int c, float (&v)[W]) {
#pragma unroll
  for (int q = 0; q < W; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(h + hand_at(r, c + q));
    v[q] = x.x;
    v[q + 1] = x.y;
    v[q + 2] = x.z;
    v[q + 3] = x.w;
  }
}

template <typename T>
struct NtArgs {
  int R, N, nk, kb1;  // output rows (points where grouped), columns, k-blocks: kb1 from ma
  int tiles_n, tiles;
  float* out;         // [R, N] (kFoldNone)
  // the epilogue's: the stash z ([R, n_act]; kFoldDual [S, R, N]), the
  // side plane [R, n_act] f32, the outputs out_t (T) and out2 (f32)
  // [R, n_act] (kFoldDual out_t [S, R, N]), raw [R, N - n_act] f32, db
  // [row tiles, n_act] f32; null where not asked for
  const T* z;
  const float* side;
  T* out_t;
  float* out2;
  float* raw;
  float* db;
  int n_act, mode;
};

// the epilogue's warps on one handed-over tile h: a thread takes 8 columns
// of a row (16 lanes a row's 128 columns, so that a warp's stores are
// whole lines); t is its index among the n of the epilogue
template <int UNROLL, typename T>
__device__ __forceinline__ void nt_epilogue(const NtArgs<T>& a, const float* h, int r0, int n0,
                                            int t, int n) {
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

// kFoldAct's epilogue on one handed-over tile (the thread's 8 columns of
// its rows, as nt_epilogue, all 8 at once: eight independent activations
// in flight): over columns [0, n_act) mode kModeDact v = acc f'(z) (+
// side) -> out_t = T(v), out2 = acc, dsum += v; kModeAdjoint (f'' != 0)
// out_t = acc f'(z), out2 = acc side f''(z), or with no side acc f''(z)
// in column 0 and 0 elsewhere (the top of the sweep's adjoint); columns
// [n_act, N) raw to `raw`. Rows whose n_act is a multiple of 16 bytes go
// by vectors, the others element by element
template <typename T, int ACT>
__device__ __forceinline__ void nt_epilogue_act(const NtArgs<T>& a, const float* h, int r0,
                                                int n0, int t, int n, float (&dsum)[8]) {
  const T* __restrict__ zp = a.z;
  const float* __restrict__ side = a.side;
  T* __restrict__ out = a.out_t;
  float* __restrict__ out2 = a.out2;
  float* __restrict__ raw = a.raw;
  const int n_act = a.n_act, n_raw = a.N - a.n_act;
  const bool vec = n_act % (16 / (int)sizeof(T)) == 0;
  const bool adjoint = !neddf::kZeroDeriv2<ACT> && a.mode == kModeAdjoint;
  const int c = (t & 15) * 8;
  const int col = n0 + c;
  if (col >= a.N) return;
  const int n_in = min(8, n_act - col);  // activated columns of the group (<= 0: none)
#pragma unroll 1
  for (int pl = t >> 4; pl < kTileRows; pl += n >> 4) {
    const int row = r0 + pl;
    if (row >= a.R) break;
    float av[8];
    hand_n<8>(h, pl, c, av);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j >= n_in && col + j < a.N) raw[(size_t)row * n_raw + col + j - n_act] = av[j];
    if (n_in <= 0) continue;
    const size_t i = (size_t)row * n_act + col;
    float zv[8], sv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    neddf::load_n<8>(zp + i, vec, n_in, zv);
    if (side != nullptr) neddf::load_n<8>(side + i, vec, n_in, sv);
    float v[8], w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f, d1, d2 = 0.f;
      if constexpr (neddf::kZeroDeriv2<ACT>) {
        neddf::act_fn<ACT>(zv[j], f, d1);
      } else {
        neddf::act_fn3<ACT>(zv[j], f, d1, d2);
      }
      if (adjoint) {
        v[j] = av[j] * d1;
        w[j] = av[j] * (side != nullptr ? sv[j] : (col + j == 0 ? 1.f : 0.f)) * d2;
      } else {
        v[j] = av[j] * d1 + sv[j];
        w[j] = av[j];
        dsum[j] += v[j];
      }
    }
    if (out != nullptr) neddf::store_n<8>(out + i, vec, n_in, v);
    if (out2 != nullptr) neddf::store_n<8>(out2 + i, vec, n_in, w);
  }
}

// 8 values of a row at p (n of them valid, zeros past): bf16 kept packed
// in pairs (four 32-bit words) until used, f32 as they are
__device__ __forceinline__ void load_packed8(const bf16* p, bool whole, int n, uint32_t (&w)[4]) {
  if (whole && n >= 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(
          2 * k < n ? __bfloat162float(p[2 * k]) : 0.f,
          2 * k + 1 < n ? __bfloat162float(p[2 * k + 1]) : 0.f);
      w[k] = *reinterpret_cast<const uint32_t*>(&h2);
    }
  }
}
__device__ __forceinline__ void unpack8(const uint32_t (&w)[4], float (&x)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

// kFoldDual's epilogue on one handed-over tile whose rows are grouped by
// point (tile row s P + r is point p0 + r of stream s, P = 128 / S): with
// g the product (g_{l-1} = G_l W^T) and z the stash z_{l-1} [S, R, N],
//     G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a,   G_a = g_a f'(z_v),
// rounded to T into out_t [S, R, N], dsum += G_v. The thread's 8 columns
// of its points, W at a time: all 8 (eight independent activations in
// flight), the tangent streams' stash loaded together and, in bf16, kept
// packed until used; f32 under the f'' coupling of four streams 4 at a
// time. Only z_v's stash where f'' = 0
template <typename T, int ACT, int SL>
__device__ __forceinline__ void nt_epilogue_dual(const NtArgs<T>& a, const float* h, int p0,
                                                 int n0, int t, int n, float (&dsum)[8]) {
  constexpr int S = 1 << SL, P = kTileRows >> SL;
  constexpr bool kCouple = !neddf::kZeroDeriv2<ACT>;
  constexpr bool kPacked = kCouple && std::is_same_v<T, bf16>;
  constexpr int W = S == 4 && kCouple && !kPacked ? 4 : 8;
  const T* __restrict__ zp = a.z;
  T* __restrict__ out = a.out_t;
  const size_t plane = (size_t)a.R * a.N;
  const bool vec = a.N % (W == 8 ? 16 / (int)sizeof(T) : 4) == 0;
  const int c = (t & 15) * 8;
  if (n0 + c >= a.N) return;
#pragma unroll 1
  for (int r = t >> 4; r < P; r += n >> 4) {
    const int pt = p0 + r;
    if (pt >= a.R) break;
#pragma unroll
    for (int hh = 0; hh < 8; hh += W) {
      const int col = n0 + c + hh;
      if (col >= a.N) break;
      const int n_in = min(W, a.N - col);
      const size_t i = (size_t)pt * a.N + col;
      float zv[S][W];
      uint32_t zq[S][4];  // kPacked: the tangent streams' stash as bf16 pairs
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if constexpr (kPacked) {
          if (s > 0) load_packed8(zp + s * plane + i, vec, n_in, zq[s]);
        }
        if (s == 0 || (kCouple && !kPacked)) neddf::load_n<W>(zp + s * plane + i, vec, n_in, zv[s]);
      }
      float d1[W], d2[W], cp[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float f;
        neddf::act_fn3<ACT>(zv[0][j], f, d1[j], d2[j]);
        cp[j] = 0.f;
      }
#pragma unroll
      for (int s = 1; s < S; ++s) {
        float g[W], ga[W];
        hand_n<W>(h, s * P + r, c + hh, g);
        if constexpr (kPacked) unpack8(zq[s], zv[s]);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if constexpr (kCouple) cp[j] = fmaf(g[j], zv[s][j], cp[j]);
          ga[j] = g[j] * d1[j];
        }
        neddf::store_n<W>(out + s * plane + i, vec, n_in, ga);
      }
      float g[W], v[W];
      hand_n<W>(h, r, c + hh, g);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        v[j] = kCouple ? g[j] * d1[j] + d2[j] * cp[j] : g[j] * d1[j];
        dsum[hh + j] += v[j];
      }
      neddf::store_n<W>(out + i, vec, n_in, v);
    }
  }
}

// the stash (and the side plane) of tile `tile`'s rows at the thread's 8
// columns on their way to L2, issued when the epilogue thread is done with
// the tile before: its loads then wait on L2, not on device memory
template <typename T, int FOLD, int ACT, int SL>
__device__ __forceinline__ void nt_prefetch(const NtArgs<T>& a, int tile, int t, int n) {
  if (tile >= a.tiles) return;
  constexpr int TR = kTileRows >> SL;
  const int tm = tile / a.tiles_n;
  const int width = FOLD == kFoldDual ? a.N : a.n_act;
  const int col = (tile - tm * a.tiles_n) * kTileCols + (t & 15) * 8;
  if (col >= width) return;
  const size_t plane = (size_t)a.R * a.N;
  for (int r = t >> 4; r < TR; r += n >> 4) {
    const int row = tm * TR + r;
    if (row >= a.R) break;
    const size_t i = (size_t)row * width + col;
    if constexpr (FOLD == kFoldDual) {
#pragma unroll
      for (int s = 0; s < (1 << SL); ++s)
        if (s == 0 || !neddf::kZeroDeriv2<ACT>) neddf::prefetch_l2(a.z + s * plane + i);
    } else {
      neddf::prefetch_l2(a.z + i);
      if (a.side != nullptr) neddf::prefetch_l2(a.side + i);
    }
  }
}

// a tile's db partial from the epilogue threads' column sums dsum (thread
// t: columns (t % 16) 8 ... + 7 of its rows): the two half-warps of a
// column group added by a shuffle, the warps' rows in red [NE / 32][128]
// added in warp order, into db[tm, n0 + c] for the columns under n_db
__device__ __forceinline__ void nt_db(float* db, int n_db, float* red, int tm, int n0, int t,
                                      int ne, float (&dsum)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], 16);
  const int lane = t & 31;
  if (lane < 16) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[(t >> 5) * kTileCols + lane * 8 + e] = dsum[e];
  }
  epi_bar(ne);
  if (t < kTileCols && n0 + t < n_db) {
    float s = 0.f;
    for (int w = 0; w < ne / 32; ++w) s += red[w * kTileCols + t];
    db[(size_t)tm * n_db + n0 + t] = s;
  }
  epi_bar(ne);  // red is free for the next tile
}

template <typename T, typename G, int FOLD, int ACT, int SL>
__global__ void __launch_bounds__(G::THREADS, 1)
    route_nt(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap ma2,
             const __grid_constant__ CUtensorMap mb, const __grid_constant__ CUtensorMap mb_lo,
             const __grid_constant__ NtArgs<T> a) {
  constexpr int ST = G::STAGES;
  constexpr int TR = kTileRows >> SL;  // output rows (grouped: points) of a tile
  // the ring (1024-byte aligned for the swizzle: checked), the handed-over
  // tile, the barriers, the column sums
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
        const int r0 = tm * TR, n0 = (tile - tm * a.tiles_n) * kTileCols;
        for (int kb = 0; kb < a.nk; ++kb) {
          const uint32_t full = bars + 8 * stage, st = base + stage * G::STAGE;
          mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
          mbar_expect_tx(full, G::STAGE);
          if constexpr (SL > 0) {  // the S streams of TR points: [S][TR][BK]
            tma_load_3d(st, &ma, full, kb * G::BK, r0, 0);
          } else if (kb < a.kb1) {
            tma_load_2d(st, &ma, full, kb * G::BK, r0);
          } else {
            tma_load_2d(st, &ma2, full, (kb - a.kb1) * G::BK, r0);
          }
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
    constexpr int NE = G::THREADS - G::EPI_FIRST;
    const int t = threadIdx.x - G::EPI_FIRST;
    float* red = reinterpret_cast<float*>(nt_smem_raw + ST * G::STAGE + kHandTile +
                                          nt_bars_bytes<G>());
    uint32_t phase = 0;
    if constexpr (FOLD != kFoldNone) nt_prefetch<T, FOLD, ACT, SL>(a, blockIdx.x, t, NE);
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int tm = tile / a.tiles_n;
      const int n0 = (tile - tm * a.tiles_n) * kTileCols;
      mbar_wait(hand_full, phase);
      if constexpr (FOLD == kFoldNone) {
        constexpr int U = G::REG_SPLIT ? 2 : 1;
        nt_epilogue<U>(a, h, tm * kTileRows, n0, t, NE);
        __syncwarp();
        if (lane == 0) mbar_arrive(hand_empty);
      } else {
        float dsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if constexpr (FOLD == kFoldAct) {
          nt_epilogue_act<T, ACT>(a, h, tm * TR, n0, t, NE, dsum);
        } else {
          nt_epilogue_dual<T, ACT, SL>(a, h, tm * TR, n0, t, NE, dsum);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(hand_empty);
        nt_prefetch<T, FOLD, ACT, SL>(a, tile + gridDim.x, t, NE);
        if (a.db != nullptr) nt_db(a.db, FOLD == kFoldDual ? a.N : a.n_act, red, tm, n0, t, NE, dsum);
      }
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

// B into its tf32 hi and lo planes [N, ldw]: element (n, k) of B at
// b[n s_n + k s_k]; plane column kc holds k = kc for kc < k1 and k = k1 +
// kc - c2 for c2 <= kc (A's second K segment from its own k-blocks), zero
// elsewhere and past K
__global__ void w_split_kernel(const float* __restrict__ w, long long s_n, long long s_k, int N,
                               int k1, int K, int c2, long long ldw, float* __restrict__ hi,
                               float* __restrict__ lo) {
  const long long n_all = (long long)N * ldw;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_all;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / ldw;
    const int kc = (int)(i - r * ldw);
    const int k = kc < k1 ? kc : kc >= c2 ? k1 + kc - c2 : K;
    const float v = k < K ? w[r * s_n + k * s_k] : 0.f;
    const float hv = __uint_as_float(neddf::tf32_rna(v));
    hi[i] = hv;
    lo[i] = __uint_as_float(neddf::tf32_rna(v - hv));
  }
}

// ------------------------------------------------------------------- route_tn
struct TnArgs {
  int M, N, R;  // R: rows of the reduction (grouped: points of each stream)
  int k_chunk;  // rows (points) of a split (a whole number of k-blocks; the last may hold fewer)
  int tiles_n, tiles, units;
  float* out;   // [splits, M, N]
};

// unit u: split u / tiles, output tile u % tiles (N fastest) of UM x UN:
// its corner (m0, n0), its first row and k-blocks of KSTEP rows (points)
// each
struct TnUnit {
  int split, m0, n0, row0, nk;
};
template <int KSTEP, int UM = kTileRows, int UN = kTileCols>
__device__ __forceinline__ TnUnit tn_unit(const TnArgs& a, int u) {
  TnUnit t;
  t.split = u / a.tiles;
  const int tile = u - t.split * a.tiles;
  const int tm = tile / a.tiles_n;
  t.m0 = tm * UM;
  t.n0 = (tile - tm * a.tiles_n) * UN;
  t.row0 = t.split * a.k_chunk;
  const int rows = min(a.R - t.row0, a.k_chunk);
  t.nk = rows > 0 ? (rows + KSTEP - 1) / KSTEP : 0;
  return t;
}

// the f32 sum of a unit into its split's plane: thread (g, tq) holds
// columns c0 + 8 j + 2 tq (+1) of rows r0 and r0 + 8 of the tile
__device__ __forceinline__ void tn_store(const TnArgs& a, const TnUnit& t, const float (&acc)[64],
                                         int r0, int c0, int tq) {
  float* plane = a.out + (size_t)t.split * a.M * a.N;
  const bool pairs = a.N % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = t.m0 + r0 + 8 * hh;
    if (m >= a.M) continue;
    float* row = plane + (size_t)m * a.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.n0 + c0 + 8 * j + 2 * tq;
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

// bf16's prologue on one landed stage's A boxes (NB boxes of [BK rows][64
// columns], 128-byte swizzled rows), in place, rounded to bf16, by the n
// threads of the transform's warps (t their index): f of every element (kFoldAct);
// or, over rows grouped by point (row s P + r is point r of stream s, P =
// BK / S, a multiple of 8, so the rows of a point share their swizzle),
// the dual layer input f(z_v), f'(z_v) z_a (kFoldDual). Zero-filled rows
// (past the reduction) become f(0), but the G rows beside them are zero
// too; zero-filled columns lie past M, whose sums are not stored
template <int FOLD, int ACT, int SL>
__device__ __forceinline__ void tn_prologue_bf16(uint32_t st, int t, int n) {
  using G = Tn<bf16, FOLD>;
  if constexpr (FOLD == kFoldAct) {
#pragma unroll 2
    for (int i = t; i < G::A_BOXES * G::BK * 8; i += n) {
      float x[8];
      lds_bf16x8(st + 16 * i, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = act_f<ACT>(x[j]);
      sts_bf16x8(st + 16 * i, x);
    }
  } else {
    constexpr int S = 1 << SL, P = G::BK >> SL;
    static_assert(P % 8 == 0, "a point's rows share their swizzle");
#pragma unroll 1
    for (int i = t; i < G::A_BOXES * P * 8; i += n) {
      const int b = i / (P * 8), r = (i >> 3) % P, q = i & 7;
      const uint32_t at = st + b * G::BOX + r * 128 + ((q ^ (r & 7)) << 4);
      float x[8], d1[8];
      lds_bf16x8(at, x);
#pragma unroll
      for (int j = 0; j < 8; ++j) neddf::act_fn<ACT>(x[j], x[j], d1[j]);
      sts_bf16x8(at, x);
#pragma unroll
      for (int s = 1; s < S; ++s) {
        const uint32_t as = at + s * P * 128;
        lds_bf16x8(as, x);
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] *= d1[j];
        sts_bf16x8(as, x);
      }
    }
  }
}

// the transform's stage loop (bf16 with a prologue): each landed stage's A
// boxes by tn_prologue_bf16, then an arrive per warp on its `ready`
template <int FOLD, int ACT, int SL, int KSTEP>
__device__ __forceinline__ void tn_prologue_loop(const TnArgs& a, uint32_t base, uint32_t bars,
                                                 int t, int n) {
  using G = Tn<bf16, FOLD>;
  constexpr int ST = G::STAGES;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int nk = tn_unit<KSTEP, G::UM, G::UN>(a, u).nk;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(bars + 8 * stage, phase);
      tn_prologue_bf16<FOLD, ACT, SL>(base + stage * G::STAGE, t, n);
      fence_async_smem();
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(bars + 8 * (2 * ST + stage));
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

template <typename T, int FOLD, int ACT, int SL>
__global__ void __launch_bounds__(Tn<T, FOLD>::THREADS, 1)
    route_tn(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
             const __grid_constant__ TnArgs a) {
  using G = Tn<T, FOLD>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int ST = G::STAGES;
  constexpr int KSTEP = G::BK >> SL;  // rows (grouped: points of each stream) of a k-block
  extern __shared__ __align__(1024) unsigned char tn_smem_raw[];
  const uint32_t base = smem_u32(tn_smem_raw);
  if (base % kAlign != 0) __trap();
  const uint32_t bars = base + ST * G::STAGE;  // full[ST], empty[ST], ready[ST]
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);                     // the producer's arrive + the bytes
      mbar_init(bars + 8 * (ST + s), 8);              // one arrive per consumer warp
      mbar_init(bars + 8 * (2 * ST + s), G::READY);   // the transposer's / prologue's warps
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
        const TnUnit t = tn_unit<KSTEP, G::UM, G::UN>(a, u);
        for (int kb = 0; kb < t.nk; ++kb) {
          const uint32_t full = bars + 8 * stage, st = base + stage * G::STAGE;
          const int row = t.row0 + kb * KSTEP;
          mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
          mbar_expect_tx(full, G::LOAD);
          // the S streams of KSTEP points where grouped: [S][KSTEP][BOXW]
#pragma unroll
          for (int b = 0; b < G::A_BOXES; ++b) {
            if constexpr (SL > 0) {
              tma_load_3d(st + b * G::BOX, &ma, full, t.m0 + b * G::BOXW, row, 0);
            } else {
              tma_load_2d(st + b * G::BOX, &ma, full, t.m0 + b * G::BOXW, row);
            }
          }
#pragma unroll
          for (int b = 0; b < G::B_BOXES; ++b) {
            if constexpr (SL > 0) {
              tma_load_3d(st + G::B_AT + b * G::BOX, &mb, full, t.n0 + b * G::BOXW, row, 0);
            } else {
              tma_load_2d(st + G::B_AT + b * G::BOX, &mb, full, t.n0 + b * G::BOXW, row);
            }
          }
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if constexpr (!kF32 && FOLD != kFoldNone) {
      // ---- bf16's prologue: warps 9-11 beside warpgroup 3
      if (threadIdx.x >= 9 * 32)
        tn_prologue_loop<FOLD, ACT, SL, KSTEP>(a, base, bars, threadIdx.x - 9 * 32,
                                               G::READY * 32);
    }
  } else if (wg == 3) {
    // ---- f32: the transposer. Thread n of warpgroup 3 turns column n of
    // each landed G tile [32 k][128 n] into row n of B's K-major hi and lo
    // tiles [128 n][32 k] (the swizzle TMA would give them), 16 bytes of
    // four k at a time; bf16 with a prologue: the rest of the transform
    if constexpr (!kF32 && FOLD != kFoldNone) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::EPI_REGS) : "memory");
      tn_prologue_loop<FOLD, ACT, SL, KSTEP>(a, base, bars, threadIdx.x - G::EPI_FIRST + 3 * 32,
                                             G::READY * 32);
    } else if constexpr (kF32) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::EPI_REGS) : "memory");
      const int n = threadIdx.x - G::EPI_FIRST;
      const uint32_t col = 16384 + (n >> 5) * G::BOX + ((n & 3) << 2);
      const int nc = (n & 31) >> 2;
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int nk = tn_unit<KSTEP, G::UM, G::UN>(a, u).nk;
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
    // the warpgroup's rows and columns of a unit's tile: 64 rows each of
    // the same 128 columns, or (A_BOXES == 1) the same 64 rows against 128
    // columns each; the thread's row g (g + 8 too)
    constexpr bool kOneA = G::A_BOXES == 1;
    const int r0 = (kOneA ? 0 : wg * 64) + ((threadIdx.x & 127) >> 5) * 16 + g;
    const int c0 = kOneA ? wg * 128 : 0;
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const TnUnit t = tn_unit<KSTEP, G::UM, G::UN>(a, u);
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
            if constexpr (FOLD != kFoldNone) mbar_wait(bars + 8 * (2 * ST + stage), phase);
            const uint32_t st = base + stage * G::STAGE;
            const uint64_t da = wg_desc_mn(st + (kOneA ? 0 : wg * G::BOX), G::BOX);
            const uint64_t db = wg_desc_mn(st + G::B_AT + (kOneA ? wg * 2 * G::BOX : 0), G::BOX);
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
          const uint64_t dh = wg_desc(st + 32768), dl = wg_desc(st + 49152);
          auto frag = [&](int kk, int i) {
            const int k = kk * 8 + tq + 4 * (i >> 1);
            return neddf::lds_u32(st + moff[i & 1] + k * 128 + ((mc[i & 1] ^ (k & 7)) << 4));
          };
          if constexpr (FOLD == kFoldNone) {
            uint32_t ah[4][4], al[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i) neddf::split_tf32(frag(kk, i), ah[kk][i], al[kk][i]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wg_3xtf32_k8(acc, part, ah[kk], al[kk], dh + 2 * kk, dl + 2 * kk);
          } else {
            // the prologue on the fragments, one k8 step at a time: f
            // (kFoldAct); or the dual input, rows grouped by point (step
            // kk holds stream kk / PV, its points those of step kk % PV)
            constexpr int PV = KSTEP / 8;  // k8 steps of a stream
            float d1[PV][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              uint32_t ah[4], al[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float x = __uint_as_float(frag(kk, i));
                if constexpr (FOLD == kFoldAct) {
                  x = act_f<ACT>(x);
                } else if (kk < PV) {
                  neddf::act_fn<ACT>(x, x, d1[kk % PV][i]);
                } else {
                  x *= d1[kk % PV][i];
                }
                neddf::split_tf32(__float_as_uint(x), ah[i], al[i]);
              }
              wg_3xtf32_k8(acc, part, ah, al, dh + 2 * kk, dl + 2 * kk);
            }
          }
          if (lane == 0) mbar_arrive(bars + 8 * (ST + stage));
          if (++stage == ST) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      tn_store(a, t, acc, r0, c0, tq);
    }
  }
}

// ---------------------------------------------------------------- host side
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// route_nt over A [R, K] (grouped: [S, R, K] planes R lda apart, R
// points) in one segment, or two (a [R, k1], a2 [R, K - k1]); B [N, K]
// (rows ldb apart) or, nn (f32 only), W [K, N]; f32's tf32 planes of B
// [N, ldw] in w_hi, w_lo (A's second segment from column ceil(k1 / BK) BK
// on); na's fold fields set by the caller
template <typename T, int FOLD, int ACT, int SL>
int launch_nt(int K, const T* a, long long lda, const T* a2, long long lda2, int k1, const T* b,
              long long ldb, bool nn, T* w_hi, T* w_lo, long long ldw, NtArgs<T> na,
              cudaStream_t st) {
  using G = Nt<T, FOLD>;
  constexpr int E = (int)sizeof(T);
  constexpr bool kF32 = std::is_same_v<T, float>;
  const int R = na.R, N = na.N;
  const bool two = a2 != nullptr;
  const int kb1 = two ? (k1 + G::BK - 1) / G::BK : (K + G::BK - 1) / G::BK;
  const int k2 = two ? K - k1 : 0;
  if (!aligned16(a) || (lda * E) % 16 != 0 || lda < (two ? k1 : K) ||
      (two && (SL > 0 || k1 <= 0 || k2 <= 0 || !aligned16(a2) || (lda2 * E) % 16 != 0 ||
               lda2 < k2)) ||
      (nn && !kF32))
    return (int)cudaErrorInvalidValue;
  const T* bm = b;
  long long ldm = ldb;
  int kb_dims = K;  // B's (planes') K extent
  if constexpr (kF32) {
    // B's tf32 planes [N, ldw] from the pre-pass, A's second segment at kb1 BK
    const int c2 = kb1 * G::BK;
    if (w_hi == nullptr || w_lo == nullptr || !aligned16(w_hi) || !aligned16(w_lo) ||
        (ldw * E) % 16 != 0 || ldw < (two ? c2 + k2 : K) || ldb < (nn ? N : K))
      return (int)cudaErrorInvalidValue;
    const long long n_all = (long long)N * ldw;
    const int blocks = (int)std::min<long long>((n_all + 255) / 256, 4096);
    w_split_kernel<<<blocks, 256, 0, st>>>(b, nn ? 1 : ldb, nn ? ldb : 1, N, two ? k1 : K, K,
                                           two ? c2 : (int)ldw, ldw, w_hi, w_lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    bm = w_hi;
    ldm = ldw;
    kb_dims = (int)ldw;
  } else if (!aligned16(b) || (ldb * E) % 16 != 0 || ldb < K) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap ma, ma2, mb[2];
  if constexpr (SL > 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)R, (cuuint64_t)(1 << SL)};
    const cuuint64_t strides[2] = {(cuuint64_t)lda * E, (cuuint64_t)R * lda * E};
    const cuuint32_t box[3] = {(cuuint32_t)G::BK, (cuuint32_t)(kTileRows >> SL),
                               (cuuint32_t)(1 << SL)};
    if (int r = encode<T>(&ma, a, 3, dims, strides, box)) return r;
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)(two ? k1 : K), (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)lda * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileRows};
    if (int r = encode<T>(&ma, a, 2, dims, strides, box)) return r;
  }
  ma2 = ma;
  if (two) {
    const cuuint64_t dims[2] = {(cuuint64_t)k2, (cuuint64_t)R};
    const cuuint64_t strides[1] = {(cuuint64_t)lda2 * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileRows};
    if (int r = encode<T>(&ma2, a2, 2, dims, strides, box)) return r;
  }
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)kb_dims, (cuuint64_t)N};
    const cuuint64_t strides[1] = {(cuuint64_t)ldm * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileCols};
    if (int r = encode<T>(&mb[i], kF32 && i == 1 ? w_lo : bm, 2, dims, strides, box)) return r;
  }
  na.kb1 = kb1;
  na.nk = kb1 + (k2 + G::BK - 1) / G::BK;
  na.tiles_n = (N + kTileCols - 1) / kTileCols;
  const int tr = kTileRows >> SL;
  const long long tiles = (long long)((R + tr - 1) / tr) * na.tiles_n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  na.tiles = (int)tiles;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  static bool attr_set[64] = {};
  auto kernel = route_nt<T, G, FOLD, ACT, SL>;
  if (cudaError_t e = smem_once(kernel, nt_smem<G, FOLD>(), attr_set)) return (int)e;
  kernel<<<std::min(na.tiles, sms), G::THREADS, nt_smem<G, FOLD>(), st>>>(ma, ma2, mb[0], mb[1],
                                                                          na);
  return (int)cudaGetLastError();
}

// route_tn over A [R, M] and B [R, N] (grouped: [S, R, M] and [S, R, N],
// R points), rows lda / ldb apart, R cut into splits of k_chunk rows
// (points)
template <typename T, int FOLD, int ACT, int SL>
int launch_tn(int M, int N, int R, const T* a, long long lda, const T* b, long long ldb,
              int splits, int k_chunk, float* out, cudaStream_t st) {
  using G = Tn<T, FOLD>;
  constexpr int E = (int)sizeof(T);
  constexpr int KSTEP = G::BK >> SL;
  if (!aligned16(a) || !aligned16(b) || (lda * E) % 16 != 0 || (ldb * E) % 16 != 0 || lda < M ||
      ldb < N || k_chunk <= 0 || k_chunk % KSTEP != 0 || splits != (R + k_chunk - 1) / k_chunk)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  for (int i = 0; i < 2; ++i) {
    const long long ld = i == 0 ? lda : ldb;
    const int cols = i == 0 ? M : N;
    const void* p = i == 0 ? static_cast<const void*>(a) : static_cast<const void*>(b);
    CUtensorMap* map = i == 0 ? &ma : &mb;
    if constexpr (SL > 0) {
      const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)R, (cuuint64_t)(1 << SL)};
      const cuuint64_t strides[2] = {(cuuint64_t)ld * E, (cuuint64_t)R * ld * E};
      const cuuint32_t box[3] = {(cuuint32_t)G::BOXW, (cuuint32_t)KSTEP, (cuuint32_t)(1 << SL)};
      if (int r = encode<T>(map, p, 3, dims, strides, box)) return r;
    } else {
      const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)R};
      const cuuint64_t strides[1] = {(cuuint64_t)ld * E};
      const cuuint32_t box[2] = {(cuuint32_t)G::BOXW, (cuuint32_t)G::BK};
      if (int r = encode<T>(map, p, 2, dims, strides, box)) return r;
    }
  }
  TnArgs ta{};
  ta.M = M;
  ta.N = N;
  ta.R = R;
  ta.k_chunk = k_chunk;
  ta.tiles_n = (N + G::UN - 1) / G::UN;
  const long long tiles = (long long)((M + G::UM - 1) / G::UM) * ta.tiles_n;
  if (tiles * splits > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ta.tiles = (int)tiles;
  ta.units = (int)(tiles * splits);
  ta.out = out;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  static bool attr_set[64] = {};
  auto kernel = route_tn<T, FOLD, ACT, SL>;
  if (cudaError_t e = smem_once(kernel, tn_smem<G>(), attr_set)) return (int)e;
  kernel<<<std::min(ta.units, sms), G::THREADS, tn_smem<G>(), st>>>(ma, mb, ta);
  return (int)cudaGetLastError();
}

// fn(integral_constant<int, SL>) for 2^SL = streams (1, 2 or 4)
template <typename F>
int by_streams(int streams, F&& fn) {
  switch (streams) {
    case 1: return fn(std::integral_constant<int, 0>{});
    case 2: return fn(std::integral_constant<int, 1>{});
    case 4: return fn(std::integral_constant<int, 2>{});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#if defined(NEDDF_ROUTE_BF16) || defined(NEDDF_FOLD_BF16)
using RouteT = bf16;
#else
using RouteT = float;
#endif

#if defined(NEDDF_ROUTE_BF16) || defined(NEDDF_ROUTE_F32)
#ifdef NEDDF_ROUTE_BF16
#define NEDDF_ROUTE_FN neddf_route_product_bf16
#else
#define NEDDF_ROUTE_FN neddf_route_product_f32
#endif
extern "C" int NEDDF_ROUTE_FN(int layout, int M, int N, int K, const void* a, long long lda,
                              const void* b, long long ldb, void* w_hi, void* w_lo, long long ldw,
                              int splits, int k_chunk, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    NtArgs<RouteT> na{};
    na.R = M;
    na.N = N;
    na.out = static_cast<float*>(out);
    return launch_nt<RouteT, kFoldNone, 0, 0>(
        K, static_cast<const RouteT*>(a), lda, nullptr, 0, 0, static_cast<const RouteT*>(b), ldb,
        false, static_cast<RouteT*>(w_hi), static_cast<RouteT*>(w_lo), ldw, na, st);
  }
  return launch_tn<RouteT, kFoldNone, 0, 0>(M, N, K, static_cast<const RouteT*>(a), lda,
                                            static_cast<const RouteT*>(b), ldb, splits, k_chunk,
                                            static_cast<float*>(out), st);
}
#endif

#ifdef NEDDF_FOLD_NT
#ifdef NEDDF_FOLD_BF16
#define NEDDF_FOLD_NT_FN neddf_fold_nt_bf16
#else
#define NEDDF_FOLD_NT_FN neddf_fold_nt_f32
#endif
extern "C" int NEDDF_FOLD_NT_FN(NEDDF_FOLD_NT_ARGS) {
  NtArgs<RouteT> na{};
  na.R = R;
  na.N = N;
  na.z = static_cast<const RouteT*>(z);
  na.side = static_cast<const float*>(side);
  na.out_t = static_cast<RouteT*>(out_t);
  na.out2 = static_cast<float*>(out2);
  na.raw = static_cast<float*>(raw);
  na.db = static_cast<float*>(db);
  na.n_act = n_act;
  na.mode = mode;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_streams(streams, [&](auto sl_) {
    constexpr int SL = decltype(sl_)::value;
    constexpr int FOLD = SL > 0 ? kFoldDual : kFoldAct;
    return (int)neddf::by_act(act, [&](auto a_) {
      return (cudaError_t)launch_nt<RouteT, FOLD, decltype(a_)::value, SL>(
          K, static_cast<const RouteT*>(a), lda, static_cast<const RouteT*>(a2), lda2, k1,
          static_cast<const RouteT*>(b), ldb, nn != 0, static_cast<RouteT*>(w_hi),
          static_cast<RouteT*>(w_lo), ldw, na, st);
    });
  });
}
#endif

#ifdef NEDDF_FOLD_TN
#ifdef NEDDF_FOLD_BF16
#define NEDDF_FOLD_TN_FN neddf_fold_tn_bf16
#else
#define NEDDF_FOLD_TN_FN neddf_fold_tn_f32
#endif
extern "C" int NEDDF_FOLD_TN_FN(NEDDF_FOLD_TN_ARGS) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_streams(streams, [&](auto sl_) {
    constexpr int SL = decltype(sl_)::value;
    constexpr int FOLD = SL > 0 ? kFoldDual : kFoldAct;
    return (int)neddf::by_act(act, [&](auto a_) {
      return (cudaError_t)launch_tn<RouteT, FOLD, decltype(a_)::value, SL>(
          M, N, R, static_cast<const RouteT*>(a), lda, static_cast<const RouteT*>(b), ldb, splits,
          k_chunk, static_cast<float*>(out), st);
    });
  });
}
#endif

#else

namespace {

// ---- shallow_nt: out [M, N] = A [M, K] B [N, K]^T (f32) for a depth K
// under kernels/dual_mlp.py::ROUTE_NT_MIN_K (8), which route_nt's k8 steps
// do not take: a 3-wide layer's dx, G [R, 3] W [N, 3]^T (NeRF's and NeuS's
// 3-wide outputs), the product _mm_nt (neddf_tpu/kernels/dual_mlp.py:
// 208-228) inside the Pallas backward bodies. At K <= 7 it does at most 14
// FLOPs per 4-byte output: the tensor cores have nothing to do, and what
// bounds it is the bytes, the f32 output above all (M N 4 + M K s + N K s
// over 3.35 TB/s: 0.061 ms at 198,656 x 256 x 3 in bf16). So: f32 FMAs;
// W's K x cols (a chunk of its columns, all of them up to ~1750 at K = 7)
// in shared memory once per block, as f32 [K][cols]; each thread holds a
// row's K values of A in registers and writes 4 adjacent outputs as one
// 16-byte streaming store (rows of whole 16-byte vectors; else element by
// element), consecutive threads along a row, so a warp writes whole lines;
// a persistent grid of blocks walking rows.
constexpr int kShallowMaxK = 7;
constexpr int kShallowThreads = 256;
constexpr int kShallowSmem = 48 * 1024;  // W's chunk, f32
constexpr int kShallowBlocksPerSm = 8;

// the columns of W a block holds at once (a multiple of 4)
inline int shallow_cols(int N, int K) {
  const int all = (N + 3) / 4 * 4;
  const int fit = kShallowSmem / 4 / K / 4 * 4;
  return all < fit ? all : fit;
}

template <typename T>
__global__ void __launch_bounds__(kShallowThreads)
    shallow_nt_kernel(int M, int N, int K, const T* __restrict__ a, long long lda,
                      const T* __restrict__ b, long long ldb, int cols, float* __restrict__ out) {
  extern __shared__ __align__(16) float sw[];  // [K][cols]
  const bool vec = (N & 3) == 0;
  for (int c0 = 0; c0 < N; c0 += cols) {
    const int nc = min(cols, N - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < K * cols; i += kShallowThreads) {
      const int k = i / cols, n = i - k * cols;
      sw[i] = n < nc ? neddf::to_f32(b[(size_t)(c0 + n) * ldb + k]) : 0.f;
    }
    __syncthreads();
    const int qn = (nc + 3) / 4;  // 4-column groups of the chunk
    const int rows = max(1, kShallowThreads / qn);  // rows a block takes at once
    const int r_in = threadIdx.x / qn, q0 = threadIdx.x % qn;
    if (r_in >= rows) continue;
    for (int m = blockIdx.x * rows + r_in; m < M; m += gridDim.x * rows) {
      float av[kShallowMaxK];
#pragma unroll
      for (int k = 0; k < kShallowMaxK; ++k)
        av[k] = k < K ? neddf::to_f32(a[(size_t)m * lda + k]) : 0.f;
      for (int q = q0; q < qn; q += kShallowThreads) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kShallowMaxK; ++k) {
          if (k >= K) break;
          const float4 w = *reinterpret_cast<const float4*>(sw + k * cols + 4 * q);
          acc.x = fmaf(av[k], w.x, acc.x);
          acc.y = fmaf(av[k], w.y, acc.y);
          acc.z = fmaf(av[k], w.z, acc.z);
          acc.w = fmaf(av[k], w.w, acc.w);
        }
        const int n = c0 + 4 * q;
        float* o = out + (size_t)m * N + n;
        if (vec) {
          __stcs(reinterpret_cast<float4*>(o), acc);
        } else {
          const float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) o[e] = v[e];
        }
      }
    }
  }
}

}  // namespace

// The shallow nt product (kernels/dual_mlp.py::Products.nt through
// route_plan's "shallow"), dtype 1 bf16 or 0 f32 operands: out [M, N] f32
// = a [M, K] b [N, K]^T, K from 1 to 7, a's and b's rows lda and ldb
// elements apart (K contiguous), out dense and 16-byte aligned; `cols`
// the columns of W a block holds (route_plan's, which the launcher
// recomputes and refuses where it differs). Returns a cudaError_t.
extern "C" int neddf_shallow_nt(int dtype, int M, int N, int K, const void* a, long long lda,
                                const void* b, long long ldb, int cols, void* out,
                                void* stream) {
  if (dtype < 0 || dtype > 1 || M <= 0 || N <= 0 || K < 1 || K > kShallowMaxK || lda < K ||
      ldb < K || a == nullptr || b == nullptr || out == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || cols != shallow_cols(N, K))
    return (int)cudaErrorInvalidValue;
  const int sms = neddf::hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int qn = (min(cols, N) + 3) / 4;
  const int rows = max(1, kShallowThreads / qn);
  const int grid = (int)std::min<long long>((M + rows - 1) / rows, (long long)sms * kShallowBlocksPerSm);
  const size_t smem = (size_t)K * cols * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    shallow_nt_kernel<__nv_bfloat16><<<grid, kShallowThreads, smem, s>>>(
        M, N, K, static_cast<const __nv_bfloat16*>(a), lda, static_cast<const __nv_bfloat16*>(b),
        ldb, cols, o);
  else
    shallow_nt_kernel<float><<<grid, kShallowThreads, smem, s>>>(
        M, N, K, static_cast<const float*>(a), lda, static_cast<const float*>(b), ldb, cols, o);
  return (int)cudaGetLastError();
}

// The plain products (kernels/dual_mlp.py::Products.nt and .tn through
// route_plan), dtype 1 bf16 or 0 f32 operands, f32 out: layout 0
// (route_nt): out [M, N] = a [M, K] b [N, K]^T, a's and b's rows lda and
// ldb elements apart (K contiguous); f32 writes b's tf32 planes into w_hi
// and w_lo [N, ldw] first. layout 1 (route_tn): out [splits, M, N] = a [K,
// M]^T b [K, N] over K rows cut into `splits` ranges of k_chunk rows (a
// multiple of the k-block: 64 bf16, 32 f32), each range's sum in its own
// plane (the caller adds them in order). Operands 16-byte aligned with
// rows of whole 16-byte vectors, out 16-byte aligned. Returns a
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

// The folded products (kernels/dual_mlp.py::Products.nt_act, .nn_adjoint,
// .tn_act, DualProducts.nt_gstack, .tn_dual_act through fold_plan), dtype
// 1 bf16 or 0 f32 operands, act 0 tanhExp, 1 ReLU, 2 LeakyReLU, 3
// Softplus, 4 Sigmoid, streams 1, or 2 / 4 for the dual backward's
// products over S = streams planes [S, points, width] grouped by point.
//
// neddf_fold_nt (route_nt with the epilogue; nn: W [K, N] N-contiguous,
// f32 only): acc = [a | a2] B over R rows (points), a [R, k1] and a2 [R,
// K - k1] (a2 null: a [R, K], k1 unused), B = b [N, K] (nt) or [K, N]
// (nn), rows ldb apart; f32 writes B's tf32 planes into w_hi, w_lo [N,
// ldw] (ldw >= ceil(k1 / 32) 32 + K - k1 with a2) first. streams 1: over
// columns [0, n_act) the stash z [R, n_act] and the side plane (f32 or
// null), mode 1: out_t = T(acc f'(z) + side), out2 = acc, db = per-128-row
// tile column sums of acc f'(z) + side [ceil(R / 128), n_act]; mode 2
// (f'' != 0, no db): out_t = acc f'(z), out2 = acc side f''(z) (no side:
// column 0 only); columns [n_act, N) raw to `raw` [R, N - n_act]; null
// outputs are not written. streams S: a [S, R, K], z and out_t [S, R, N],
// n_act = N, mode 0: the stacked cotangent out_t = T(G) (G_v = acc_v
// f'(z_v) + f''(z_v) sum_a acc_a z_a, G_a = acc_a f'(z_v)), db = per-tile
// column sums of G_v [ceil(R / (128 / S)), N].
// neddf_fold_tn (route_tn with the prologue): out [splits, M, N] = h^T b
// over R rows (points) in splits of k_chunk, h = T(f(a)) of a [R, M]
// (streams 1), or over S planes a [S, R, M], b [S, R, N] the dual layer
// input h_v = f(a_v), h_s = f'(a_v) a_s.
// Operands and planes 16-byte aligned with rows of whole 16-byte vectors
// (the stash and the side plane: any rows, element loads where n_act is
// not a multiple of 4). Returns a cudaError_t, or 20000 + the CUresult of
// a failed tensor-map encoding.
extern "C" int neddf_fold_nt(int dtype, int nn, int act, int mode, int streams, int R, int N,
                             int K, const void* a, long long lda, const void* a2,
                             long long lda2, int k1, const void* b, long long ldb, void* w_hi,
                             void* w_lo, long long ldw, const void* z, const void* side,
                             int n_act, void* out_t, void* out2, void* raw, void* db,
                             void* stream) {
  auto bad = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  const bool dual = streams > 1;
  const bool adjoint = mode == 2;
  if (dtype < 0 || dtype > 1 || R <= 0 || N <= 0 || K <= 0 || a == nullptr || b == nullptr ||
      z == nullptr || bad(z) || bad(side) || bad(out_t) || bad(out2) || bad(db) ||
      (dual ? (mode != 0 || n_act != N || out_t == nullptr || db == nullptr || side != nullptr ||
               out2 != nullptr || raw != nullptr || a2 != nullptr || nn)
            : (streams != 1 || n_act <= 0 || n_act > N || (n_act < N) != (raw != nullptr) ||
               (mode != 1 && !adjoint) || (adjoint && (neddf::zero_deriv2(act) || db)))))
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_fold_nt_bf16 : neddf_fold_nt_f32;
  return fn(nn, act, mode, streams, R, N, K, a, lda, a2, lda2, k1, b, ldb, w_hi, w_lo, ldw, z,
            side, n_act, out_t, out2, raw, db, stream);
}

extern "C" int neddf_fold_tn(int dtype, int act, int streams, int M, int N, int R,
                             const void* a, long long lda, const void* b, long long ldb,
                             int splits, int k_chunk, void* out, void* stream) {
  if (dtype < 0 || dtype > 1 || M <= 0 || N <= 0 || R <= 0 || a == nullptr || b == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_fold_tn_bf16 : neddf_fold_tn_f32;
  return fn(act, streams, M, N, R, a, lda, b, ldb, splits, k_chunk, out, stream);
}

#endif
