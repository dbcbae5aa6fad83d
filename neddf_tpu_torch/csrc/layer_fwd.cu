// The per-layer route's layer forward for sm_90a: a bytes-bound kernel
// for narrow outputs and a wgmma + TMA product for wide ones.
//
// Replaces, one layer at a time, the layer loop of the Pallas forwards
// neddf_tpu/kernels/dual_mlp.py::_run_forward:635, mlp.py::_run_forward:192
// and the trunk of sdf_mlp.py::_run_forward:257, as the route of
// kernels/dual_mlp.py::dual_mlp_layers_walk (and kernels/mlp.py's and
// kernels/sdf_mlp.py's value-only walks) runs it: a tensor-parallel
// column shard, a width over the tile forward's 512, a trunk deeper than
// the fused kernels hold. One layer of S = 1, 2 or 4 streams (value, then
// K tangents) of M points, x [S, M, K] in one or two K segments, times the
// weight columns W [K, N] (N contiguous), with the f32 bias b [N]:
//     z_v = x_v W + b,   z_a = x_a W,   out_v = f(z_v),   out_a = f'(z_v) z_a,
// out [S, M, N] rounded to T and the stash z [S, M, N] rounded to T.
//
// * layer_fwd_narrow (N <= 32, W in at most 64 KB of shared memory): the
//   layer is a dot of every row of x with N columns, bound by the read of
//   x (NeuS's colour output, 1024 -> 3: 1.09 GB of f32 at 265,216 rows,
//   0.326 ms at 3.35 TB/s, against 1.6 GFLOP). W sits transposed in
//   shared memory, [N] columns of each segment, zero past N up to NB (4
//   or 32, a template class, as S is); one warp per point streams its S
//   rows of x in 16-byte loads (element loads where a segment's rows are
//   not 16-byte aligned), four loads in flight a lane at NB = 4, sums in
//   f32 with FMAs (bf16 products exact), each lane its own columns of K,
//   then a butterfly over the warp per stream and column; lane c applies
//   the epilogue to column c of all S streams and writes out and the
//   stash. Each W element read from shared memory serves the S rows of a
//   point. As many blocks as fit on the card walk the points.
// * layer_fwd_wide (any N, the rest): a persistent product on the tensor
//   cores, one block per SM walking 128 x 128 output tiles, N fastest so
//   that the blocks working at one time share the rows of x in L2. Warp 8
//   is the producer: one thread keeps a ring of stages in shared memory
//   filled by TMA against mbarriers (a 128-byte k-block of x's 128 rows
//   and of W's 128 columns, 128-byte swizzle; bf16 4 stages of 32 KB,
//   f32 3 of 48 KB), released by the consumers' warps. Warpgroups 0 and
//   1 take 64 rows of the tile each with wgmma (f32: setmaxnreg gives
//   them the registers the others do not need; struct Wide):
//   - bf16: m64n128k16 from shared memory, the f32 sum in 64 registers
//     across the whole K, one k-block's group in flight while the previous
//     stage is released;
//   - f32 at f32 accuracy by the 3xTF32 split (tc_ops.cuh): W's columns
//     are split into tf32 hi and lo by the pre-pass; x is split as its
//     fragments are read from shared memory (m64n128k8, A from registers),
//     and each k8 step's lo_a hi_b + hi_a lo_b + hi_a hi_b are summed from
//     zero in a partial that is added to the running sum with a rounded
//     f32 add, as the fused kernels do (the tensor core's accumulation
//     truncates: tc_ops.cuh; partials over a whole 32-deep k-block moved
//     a tensor-parallel NeRF step's gradient 2.1e-6 from the fused one).
//   The stream grouping: a tile's rows are point * S + stream, from a 3-D
//   tensor map over each [S, M, k] segment with its dims ordered (k, S, M)
//   and the box (BK, S, 128 / S), so the S rows of a point are in one
//   tile. A finished tile is handed over to the epilogue's warps (bf16
//   11, f32 4) through shared memory (f32, 66 KB, an mbarrier each way)
//   and the consumers go on to the next tile's products: the epilogue
//   (bias, f and f' once per point and column, out = f(z_v) and f'(z_v)
//   z_a, the stash z, rounded to T) runs beside them, each thread 8
//   columns of a point's S rows, its stores whole 16-byte vectors, a
//   warp's whole lines (element stores, masked, where N leaves rows off
//   16 bytes). A second K segment starts
//   at a k-block of its own (W's rows padded with zeros between), and
//   TMA's zero fill past a box's bounds pads every ragged edge. TMA needs
//   16-byte row strides: the launcher (kernels/dual_mlp.py::
//   Products.layer_fwd) pads a segment whose rows are not (the 60- and
//   87-wide bf16 ones) to the next multiple of 16 bytes with zero columns.
// * wt_prep_kernel, before each wide launch: W [K, N] into W^T [N, Kp]
//   (K contiguous, as TF32 wgmma needs, and the segments' k-blocks padded
//   with zero rows), in f32 split into the hi and lo planes.
// The tile ring (Wide<T>), the mbarrier, TMA and wgmma helpers, the
// 3xTF32 k8 step and the tensor-map encoding are hopper.cuh's, shared
// with route_products.cu.
//
// What bounds it on the H100: the wide layers are products of 2 S M K N
// FLOPs against 2 S M (K + 2 N) bytes of bf16 (the K=3 trunk's 1024 ->
// 1024 at 99,328 points: 0.84 ms of operations, 0.73 ms of bytes at 3.35
// TB/s), so the tensor cores and the stores both bind; f32 does three
// TF32 products per FLOP at 495 TFLOP/s. The narrow ones are the read of
// x.
#include <cuda.h>

#include <algorithm>

#include "hopper.cuh"
#include "mlp_tile.cuh"
#include "tc_ops.cuh"

// One operand type's launches (the arguments of neddf_layer_fwd below
// without dtype): kernels/_build.py compiles this file with
// -DNEDDF_FWD_BF16 and with -DNEDDF_FWD_F32, each object one type's
// instantiations, beside the object of the entry point (no define).
extern "C" int neddf_layer_fwd_bf16(int act, int kernel, int streams, int M, int N,
                                    const void* x0, int k0, const void* x1, int k1, int wk0,
                                    int wk1, const void* w, const void* bias, void* out,
                                    void* stash, void* wt_hi, void* wt_lo, int kp,
                                    void* stream);
extern "C" int neddf_layer_fwd_f32(int act, int kernel, int streams, int M, int N,
                                   const void* x0, int k0, const void* x1, int k1, int wk0,
                                   int wk1, const void* w, const void* bias, void* out,
                                   void* stash, void* wt_hi, void* wt_lo, int kp,
                                   void* stream);

#if defined(NEDDF_FWD_BF16) || defined(NEDDF_FWD_F32)
namespace {

using namespace neddf::hopper;
using bf16 = __nv_bfloat16;
using neddf::from_f32;
using neddf::smem_u32;
using neddf::to_f32;

// the launch plan's constants (kernels/dual_mlp.py::layer_fwd_plan holds
// the same); the wide kernel's tile ring, Wide<T>, is hopper.cuh's
constexpr int kNarrowThreads = 256;
constexpr int kNarrowMaxN = 32;
constexpr int kNarrowMaxSmem = 64 * 1024;

template <typename T>
struct LayerArgs {
  const T* x[2];  // the K segments [S, M, k_i]
  int k[2];       // their widths (k[1] = 0: one segment)
  int wk[2];      // W's rows of each segment (<= k[i]: the wide launcher's padding)
  int S, sl, M, N;
  const float* bias;  // [N]
  T* out;             // [S, M, N]
  T* stash;           // [S, M, N] or null
};

// ------------------------------------------------------------ narrow outputs
// the smem pitch of a segment's columns: 8 elements, 16-byte vectors of both types
__host__ __device__ __forceinline__ int narrow_pitch(int k) { return (k + 7) / 8 * 8; }

// the column class of a narrow layer: 4 (NeuS's colour output) or 32
__host__ __device__ __forceinline__ int narrow_class(int n) { return n <= 4 ? 4 : 32; }

// one segment of a point's S rows (x at its stream-0 row, planes `plane`
// apart) against the NB columns of ws [NB][kp], V elements a load, U loads
// of every row issued before their sums (the read's latency is what
// bounds a warp)
template <typename T, int S, int NB, int V>
__device__ __forceinline__ void narrow_segment(float (&acc)[S][NB], const T* __restrict__ x,
                                               size_t plane, int k, int kp, const T* ws,
                                               int lane) {
  constexpr int U = NB > 4 ? 1 : 4 / S;
  for (int c0 = lane * V; c0 < k; c0 += 32 * V * U) {
    float xv[U][S][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * 32 * V;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (c < k) {
          neddf::vec_load<V>(x + s * plane + c, xv[u][s]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) xv[u][s][v] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * 32 * V;
      if (c >= k) break;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float wv[V];
        neddf::vec_load<V>(ws + j * kp + c, wv);
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[s][j] = fmaf(xv[u][s][v], wv[v], acc[s][j]);
      }
    }
  }
}

template <typename T, int ACT, int S, int NB>
__global__ void __launch_bounds__(kNarrowThreads)
    layer_fwd_narrow(const __grid_constant__ LayerArgs<T> a, const T* __restrict__ w, int vec0,
                     int vec1) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char narrow_smem[];
  T* ws = reinterpret_cast<T*>(narrow_smem);
  const int kp0 = narrow_pitch(a.k[0]), kp1 = narrow_pitch(a.k[1]);
  const int N = a.N;
  // W transposed: column j of segment i at ws[i * NB * kp0 + j * kp_i + k]
  for (int i = threadIdx.x; i < NB * (kp0 + kp1); i += kNarrowThreads) {
    const int seg = i >= NB * kp0;
    const int r = seg ? i - NB * kp0 : i;
    const int kp = seg ? kp1 : kp0;
    const int j = r / kp, k = r - j * kp;
    float v = 0.f;
    if (j < N && k < a.k[seg]) v = to_f32(w[(size_t)(seg ? a.k[0] + k : k) * N + j]);
    ws[i] = from_f32<T>(v);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kNarrowThreads / 32);
  const size_t out_plane = (size_t)a.M * N;
  for (int p = blockIdx.x * (kNarrowThreads / 32) + (threadIdx.x >> 5); p < a.M; p += warps) {
    float acc[S][NB];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[s][j] = 0.f;
#pragma unroll
    for (int seg = 0; seg < 2; ++seg) {
      const int k = a.k[seg];
      if (k == 0) continue;
      const T* x = a.x[seg] + (size_t)p * k;
      const size_t plane = (size_t)a.M * k;
      const T* wseg = ws + (seg ? NB * kp0 : 0);
      const int kp = seg ? kp1 : kp0;
      if (seg ? vec1 : vec0)
        narrow_segment<T, S, NB, V>(acc, x, plane, k, kp, wseg, lane);
      else
        narrow_segment<T, S, NB, 1>(acc, x, plane, k, kp, wseg, lane);
    }
    // the sums over the warp; lane c keeps column c's of every stream
    float tot[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      tot[s] = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (j >= N) break;
        float v = acc[s][j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == j) tot[s] = v;
      }
    }
    if (lane < N) {
      const size_t i = (size_t)p * N + lane;
      const float zv = tot[0] + a.bias[lane];
      float f, df;
      neddf::act_fn<ACT>(zv, f, df);
      a.out[i] = from_f32<T>(f);
      if (a.stash != nullptr) a.stash[i] = from_f32<T>(zv);
#pragma unroll
      for (int s = 1; s < S; ++s) {
        a.out[s * out_plane + i] = from_f32<T>(df * tot[s]);
        if (a.stash != nullptr) a.stash[s * out_plane + i] = from_f32<T>(tot[s]);
      }
    }
  }
}

// ------------------------------------------------------------- wide outputs
struct WideArgs {
  int S, sl, M, N;
  int nk0, nk1;  // k-blocks of segment 0 and 1
  int tiles_n, tiles;
  const float* bias;
  void* out;
  void* stash;
};

// f and f' as neddf::act_fn gives them, bit for bit, without its branch
// past 20 (tanhExp, Softplus pass x through there): the epilogue's
// elements then interleave instead of taking their branches one by one
// (mlp_tile.cuh: tanh_exp, act_fn's kSoftplus; the same expressions)
template <int ACT>
__device__ __forceinline__ void act_flat(float x, float& f, float& df) {
  if constexpr (ACT == neddf::kTanhExp || ACT == neddf::kSoftplus) {
    const bool through = x > 20.f;
    const float xc = through ? 20.f : x;
    const float ex = expf(xc);
    float fx, dx;
    if constexpr (ACT == neddf::kTanhExp) {
      const float tx = tanhf(ex);
      fx = xc * tx;
      dx = tx - xc * ex * (tx * tx - 1.f);
    } else {
      fx = log1pf(ex);
      dx = ex / (1.f + ex);
    }
    f = through ? x : fx;
    df = through ? 1.f : dx;
  } else {
    neddf::act_fn<ACT>(x, f, df);
  }
}

// 8 consecutive values rounded to T at p (16-byte aligned for bf16, 32 for
// f32), or the first n of them one by one
template <typename T>
__device__ __forceinline__ void store8(T* p, bool whole, int n, const float (&x)[8]) {
  if (whole) {
    neddf::vec_store<8>(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) p[e] = from_f32<T>(x[e]);
  }
}

// the epilogue warpgroups' work on one handed-over tile h [128 rows of
// point * S + stream][kHandPitch] f32 (the products, no bias): a thread
// takes 8 columns of a point (16 lanes a row's 128 columns, so that a
// warp's stores are whole lines), reads its value row, adds the bias,
// takes f and f' once for the point's S rows, and writes out and the
// stash of every stream (ONE: S = 1, where f' is not needed); t is the
// thread's index among the n of the epilogue (a multiple of 16)
template <typename T, int ACT, int UNROLL, bool ONE>
__device__ __forceinline__ void wide_epilogue(const WideArgs& a, const float* h, int p0, int n0,
                                              int t, int n) {
  const int c = (t & 15) * 8;  // the thread's columns of the tile
  const int col = n0 + c;
  const int N = a.N;
  if (col >= N) return;
  const int n_in = min(8, N - col);
  const bool whole = n_in == 8 && (N * (int)sizeof(T)) % 16 == 0;
  float b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = e < n_in ? __ldg(a.bias + col + e) : 0.f;
  const int points = kTileRows >> a.sl;
  const size_t plane = (size_t)a.M * N;
  T* out = static_cast<T*>(a.out);
  T* zs = static_cast<T*>(a.stash);
#pragma unroll(UNROLL)
  for (int pl = t >> 4; pl < points; pl += n >> 4) {
    const int pt = p0 + pl;
    if (pt >= a.M) break;
    const float* row = h + (pl << a.sl) * kHandPitch + c;
    float z[8], f[8], d[8];
    neddf::vec_load<8>(row, z);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      z[e] += b[e];
      act_flat<ACT>(z[e], f[e], d[e]);
    }
    const size_t i = (size_t)pt * N + col;
    store8(out + i, whole, n_in, f);
    if (zs != nullptr) store8(zs + i, whole, n_in, z);
    if constexpr (ONE) continue;
    for (int s = 1; s < a.S; ++s) {
      neddf::vec_load<8>(row + s * kHandPitch, z);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = d[e] * z[e];
      store8(out + s * plane + i, whole, n_in, f);
      if (zs != nullptr) store8(zs + s * plane + i, whole, n_in, z);
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(Wide<T>::THREADS, 1)
    layer_fwd_wide(const __grid_constant__ CUtensorMap ma0, const __grid_constant__ CUtensorMap ma1,
                   const __grid_constant__ CUtensorMap mb0, const __grid_constant__ CUtensorMap mb1,
                   const __grid_constant__ WideArgs a) {
  using G = Wide<T>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int ST = G::STAGES;
  // the ring (1024-byte aligned for the swizzle: checked), the handed-over
  // tile, the barriers: full[ST], empty[ST], hand_full, hand_empty
  extern __shared__ __align__(1024) unsigned char wide_smem_raw[];
  const uint32_t base = smem_u32(wide_smem_raw);
  if (base % kAlign != 0) __trap();
  const uint32_t hand = base + ST * G::STAGE;
  const uint32_t bars = hand + kHandBytes;
  const uint32_t hand_full = bars + 16 * ST, hand_empty = hand_full + 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);         // the producer's arrive + the bytes
      mbar_init(bars + 8 * (ST + s), 8);  // one arrive per consumer warp
    }
    mbar_init(hand_full, 8);             // the consumer warps have written the tile
    mbar_init(hand_empty, (G::THREADS - G::EPI_FIRST) / 32);  // the epilogue warps have read it
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int nk = a.nk0 + a.nk1;
  const int points = kTileRows >> a.sl;  // points of a tile
  const int warp = threadIdx.x >> 5;
  if (warp == 8 || (G::REG_SPLIT && wg == 2)) {
    // ---- the producer: one thread keeps the ring full
    if constexpr (G::REG_SPLIT)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PROD_REGS) : "memory");
    if (threadIdx.x == 8 * 32) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        const int tm = tile / a.tiles_n;
        const int p0 = tm * points, n0 = (tile - tm * a.tiles_n) * kTileCols;
        for (int kb = 0; kb < nk; ++kb) {
          const uint32_t full = bars + 8 * stage, st = base + stage * G::STAGE;
          mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
          mbar_expect_tx(full, G::STAGE);
          if (kb < a.nk0)
            tma_load_3d(st, &ma0, full, kb * G::BK, 0, p0);
          else
            tma_load_3d(st, &ma1, full, (kb - a.nk0) * G::BK, 0, p0);
          tma_load_2d(st + 16384, &mb0, full, kb * G::BK, n0);
          if constexpr (kF32) tma_load_2d(st + 32768, &mb1, full, kb * G::BK, n0);
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
    const float* h = reinterpret_cast<const float*>(wide_smem_raw + (hand - smem_u32(wide_smem_raw)));
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const int tm = tile / a.tiles_n;
      mbar_wait(hand_full, phase);
      const int p0 = tm * points, n0 = (tile - tm * a.tiles_n) * kTileCols;
      constexpr int U = G::REG_SPLIT ? 2 : 1, NE = G::THREADS - G::EPI_FIRST;
      if (a.S == 1)
        wide_epilogue<T, ACT, U, true>(a, h, p0, n0, threadIdx.x - G::EPI_FIRST, NE);
      else
        wide_epilogue<T, ACT, U, false>(a, h, p0, n0, threadIdx.x - G::EPI_FIRST, NE);
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
    float* h = reinterpret_cast<float*>(wide_smem_raw + (hand - smem_u32(wide_smem_raw)));
    int stage = 0;
    uint32_t phase = 0, hphase = 0;
    float acc[64];
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      kmajor_tile<T>(acc, base, bars, nk, stage, phase, wg, r0, g, tq, lane);
      hand_over(acc, h, hand_full, hand_empty, hphase, r0, tq, lane);
    }
  }
}

// W [K, N] (K = k0 + k1 rows, N contiguous) into W^T [N, Kp], K contiguous:
// row kp < k0p of W^T's columns from W's row kp (zero from k0 up), row
// k0p + r from W's row k0 + r (zero from k1 up); f32 into the tf32 hi and
// lo planes. 32 x 32 tiles through shared memory
template <typename T>
__global__ void wt_prep_kernel(const T* __restrict__ w, int N, int k0, int k0p, int k1, int Kp,
                               T* __restrict__ hi, T* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int kb = blockIdx.x * 32, nb = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int kp = kb + r, n = nb + tx;
    const int k = kp < k0p ? (kp < k0 ? kp : -1) : (kp - k0p < k1 ? k0 + kp - k0p : -1);
    tile[r][tx] = k >= 0 && n < N ? to_f32(w[(size_t)k * N + n]) : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int n = nb + r, kp = kb + tx;
    if (n >= N || kp >= Kp) continue;
    const float v = tile[tx][r];
    const size_t i = (size_t)n * Kp + kp;
    if constexpr (std::is_same_v<T, float>) {
      const float h = __uint_as_float(neddf::tf32_rna(v));
      hi[i] = h;
      lo[i] = __uint_as_float(neddf::tf32_rna(v - h));
    } else {
      hi[i] = from_f32<T>(v);
    }
  }
}

// ---------------------------------------------------------------- host side
template <typename T>
int launch_narrow(int act, const LayerArgs<T>& a, const T* w, cudaStream_t st) {
  constexpr int E = (int)sizeof(T);
  auto vec = [](const void* p, int k) {
    return (int)(p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 && (k * E) % 16 == 0);
  };
  const int nb = narrow_class(a.N);
  const int smem = nb * (narrow_pitch(a.k[0]) + narrow_pitch(a.k[1])) * E;
  if (a.N > kNarrowMaxN || smem > kNarrowMaxSmem) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int v0 = vec(a.x[0], a.k[0]), v1 = vec(a.x[1], a.k[1]);
  return (int)neddf::by_act(act, [&](auto a_) {
    constexpr int ACT = decltype(a_)::value;
    // as many blocks as fit on the card at once, each walking points
    auto run = [&](auto kernel) {
      cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      int per_sm = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNarrowThreads, smem);
      if (err != cudaSuccess) return err;
      const int blocks = std::min((a.M + kNarrowThreads / 32 - 1) / (kNarrowThreads / 32),
                                  std::max(per_sm, 1) * sms);
      kernel<<<blocks, kNarrowThreads, smem, st>>>(a, w, v0, v1);
      return cudaGetLastError();
    };
    auto by_nb = [&](auto s_) {
      constexpr int S = decltype(s_)::value;
      return nb == 4 ? run(layer_fwd_narrow<T, ACT, S, 4>) : run(layer_fwd_narrow<T, ACT, S, 32>);
    };
    if (a.S == 1) return by_nb(std::integral_constant<int, 1>{});
    if (a.S == 2) return by_nb(std::integral_constant<int, 2>{});
    return by_nb(std::integral_constant<int, 4>{});
  });
}

template <typename T>
int launch_wide(int act, const LayerArgs<T>& a, const T* w, T* wt_hi, T* wt_lo, int wt_k,
                cudaStream_t st) {
  using G = Wide<T>;
  constexpr int E = (int)sizeof(T);
  constexpr bool kF32 = std::is_same_v<T, float>;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  for (int i = 0; i < 2; ++i)
    if (a.k[i] > 0 && (!aligned(a.x[i]) || (a.k[i] * E) % 16 != 0)) return (int)cudaErrorInvalidValue;
  if (wt_hi == nullptr || !aligned(wt_hi) || (kF32 && (wt_lo == nullptr || !aligned(wt_lo))))
    return (int)cudaErrorInvalidValue;
  const int nk0 = (a.k[0] + G::BK - 1) / G::BK, nk1 = (a.k[1] + G::BK - 1) / G::BK;
  const int kp = (nk0 + nk1) * G::BK;
  if (wt_k != kp) return (int)cudaErrorInvalidValue;  // W^T's buffer is [planes, N, wt_k]
  wt_prep_kernel<T><<<dim3(kp / 32, (a.N + 31) / 32), dim3(32, 8), 0, st>>>(
      w, a.N, a.wk[0], nk0 * G::BK, a.wk[1], kp, wt_hi, wt_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // x's segments [S, M, k] as (k, S, M): a box's rows are point * S + stream
  CUtensorMap ma[2], mb[2];
  for (int i = 0; i < 2; ++i) {
    const int seg = a.k[i] > 0 ? i : 0;
    const cuuint64_t dims[3] = {(cuuint64_t)a.k[seg], (cuuint64_t)a.S, (cuuint64_t)a.M};
    const cuuint64_t strides[2] = {(cuuint64_t)a.M * a.k[seg] * E, (cuuint64_t)a.k[seg] * E};
    const cuuint32_t box[3] = {(cuuint32_t)G::BK, (cuuint32_t)a.S,
                               (cuuint32_t)(kTileRows / a.S)};
    if (int r = encode<T>(&ma[i], a.x[seg], 3, dims, strides, box)) return r;
  }
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)a.N};
    const cuuint64_t strides[1] = {(cuuint64_t)kp * E};
    const cuuint32_t box[2] = {(cuuint32_t)G::BK, (cuuint32_t)kTileCols};
    if (int r = encode<T>(&mb[i], kF32 && i == 1 ? wt_lo : wt_hi, 2, dims, strides, box))
      return r;
  }
  WideArgs wa{};
  wa.S = a.S;
  wa.sl = a.sl;
  wa.M = a.M;
  wa.N = a.N;
  wa.nk0 = nk0;
  wa.nk1 = nk1;
  wa.tiles_n = (a.N + kTileCols - 1) / kTileCols;
  const long long tiles_m = (a.M + (kTileRows >> a.sl) - 1) / (kTileRows >> a.sl);
  if (tiles_m * wa.tiles_n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  wa.tiles = (int)(tiles_m * wa.tiles_n);
  wa.bias = a.bias;
  wa.out = a.out;
  wa.stash = a.stash;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = std::min(wa.tiles, sms);
  return (int)neddf::by_act(act, [&](auto a_) {
    auto kernel = layer_fwd_wide<T, decltype(a_)::value>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide_smem<T>());
    if (e != cudaSuccess) return e;
    kernel<<<grid, Wide<T>::THREADS, wide_smem<T>(), st>>>(ma[0], ma[1], mb[0], mb[1], wa);
    return cudaGetLastError();
  });
}

}  // namespace

#ifdef NEDDF_FWD_BF16
using FwdT = bf16;
#define NEDDF_FWD_FN neddf_layer_fwd_bf16
#else
using FwdT = float;
#define NEDDF_FWD_FN neddf_layer_fwd_f32
#endif
extern "C" int NEDDF_FWD_FN(int act, int kernel, int streams, int M, int N, const void* x0,
                            int k0, const void* x1, int k1, int wk0, int wk1, const void* w,
                            const void* bias, void* out, void* stash, void* wt_hi, void* wt_lo,
                            int kp, void* stream) {
  LayerArgs<FwdT> a{};
  a.x[0] = static_cast<const FwdT*>(x0);
  a.x[1] = static_cast<const FwdT*>(x1);
  a.k[0] = k0;
  a.k[1] = k1;
  a.wk[0] = wk0;
  a.wk[1] = wk1;
  a.S = streams;
  a.sl = streams == 4 ? 2 : streams == 2 ? 1 : 0;
  a.M = M;
  a.N = N;
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<FwdT*>(out);
  a.stash = static_cast<FwdT*>(stash);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 0) return launch_narrow<FwdT>(act, a, static_cast<const FwdT*>(w), st);
  return launch_wide<FwdT>(act, a, static_cast<const FwdT*>(w), static_cast<FwdT*>(wt_hi),
                           static_cast<FwdT*>(wt_lo), kp, st);
}
#else

// The per-layer forward (kernels/dual_mlp.py::Products.layer_fwd): one
// layer of streams (1, 2 or 4 planes, value first) of M points, dtype 1
// bf16 or 0 f32 operands, act the activation code (mlp_tile.cuh's kTanhExp ... kSigmoid).
// x in one segment x0 [S, M, k0] or two, x1 [S, M, k1] the columns after
// x0's; w [wk0 + wk1, N] the weight columns (N contiguous), wk_i of them
// for segment i (wk_i <= k_i: the segment's columns past wk_i, which the
// wide launcher pads with, are zero and have no rows); bias [N] f32; out
// and stash (or null) [S, M, N], 16-byte aligned. kernel 0: the narrow
// kernel (N <= 32, W in 64 KB of shared memory, k_i = wk_i); 1: the wide
// one, whose segments' rows must be whole 16-byte vectors and which
// writes W^T into wt_hi [N, kp] (and f32 wt_lo), kp the segments'
// k-blocks (64 bf16, 32 f32) times their depth (any other kp is refused).
// Returns a cudaError_t, or 20000 + the CUresult of a failed tensor-map
// encoding.
extern "C" int neddf_layer_fwd(int dtype, int act, int kernel, int streams, int M, int N,
                               const void* x0, int k0, const void* x1, int k1, int wk0, int wk1,
                               const void* w, const void* bias, void* out, void* stash,
                               void* wt_hi, void* wt_lo, int kp, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (dtype < 0 || dtype > 1 || kernel < 0 || kernel > 1 || M <= 0 || N <= 0 || k0 <= 0 ||
      k1 < 0 || (k1 > 0) != (x1 != nullptr) || (streams != 1 && streams != 2 && streams != 4) ||
      wk0 <= 0 || wk0 > k0 || wk1 < 0 || wk1 > k1 || (k1 > 0) != (wk1 > 0) ||
      (kernel == 0 && (wk0 != k0 || wk1 != k1)) || x0 == nullptr || w == nullptr ||
      bias == nullptr || out == nullptr || !aligned(out) || !aligned(stash))
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_layer_fwd_bf16 : neddf_layer_fwd_f32;
  return fn(act, kernel, streams, M, N, x0, k0, x1, k1, wk0, wk1, w, bias, out, stash, wt_hi,
            wt_lo, kp, stream);
}

#endif
