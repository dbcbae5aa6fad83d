// Row-tile MLP forward shared by the trunk kernels (dual_mlp_fwd.cu,
// mlp_fwd.cu, sdf_mlp.cu), and the activations the backward kernels share
// (mlp_bwd.cu, dual_mlp_bwd.cu, sdf_mlp.cu). Built by neddf_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// Replaces the row tile of the Pallas forwards neddf_tpu/kernels/
// dual_mlp.py::_fwd_kernel and neddf_tpu/kernels/mlp.py::_fwd_kernel (and
// the trunk part of sdf_mlp.py::_fwd_kernel). One block owns a tile of
// samples and runs EVERY layer of the MLP on it without writing an
// activation to device memory, as the Pallas kernels keep a row tile in
// VMEM across the layers:
//
// * the block stacks S = K+1 streams (the values and K tangent planes)
//   as kRows = S*TM rows, stream-major: row st*TM + i is stream st of
//   sample i. K=3 is the NeDDF distance trunk (d/dxyz planes), K=1 the
//   colour trunk's directional tangent (training), K=0 the value-only
//   trunks (eval colour, NeRF, NeuS). A segment without tangents stages
//   zeros in its tangent rows.
// * optionally (stash[l] != null) each layer's pre-activation stack
//   [S, M, C] (z with the bias on the value rows, before the activation)
//   is written rounded to T, for the backward (dual_mlp_bwd.cu).
// * the layer-0 input is staged once into shared memory as the concat of
//   the input segments (x0); its weight rows are read in place, so no
//   concat ever exists in device memory. A post-skip layer reads segment
//   0 again from x0 and the hidden state from h, in either order:
//   kSplitSegFirst ([seg0, h], NeDDF) or kSplitHiddenFirst ([h, seg0],
//   NeRF/NeuS), each piece against its own rows of W.
// * the hidden state h [kRows, C] lives in shared memory and is written
//   back after each layer as f(z) on the value rows and f'(z_value) *
//   z_tangent on the tangent rows, rounded to the storage type T; the
//   activation is a template parameter: tanhExp (kTanhExp), ReLU (kReLU,
//   with f'(0) = 0) or LeakyReLU (kLeakyReLU, slope 0.01, f'(0) = 1), as
//   neddf_tpu/kernels/dual_mlp.py::_act_fns defines them. Sums and
//   activations are f32; the f32 bias is added to the value rows only.
//
// One body for both operand types, tile_forward_tc: each layer's product
// [kRows x fan_in] x [fan_in x C] runs on the tensor cores with f32
// accumulators in registers: 128 per thread, so the block has 8 warps
// (256 threads, up to 255 registers each; 512 threads would leave 64
// registers beside the accumulators, and spill). Each warp owns one sample
// slice (16 samples, 32 for K=0) of EVERY stream and a band of columns, so
// the value and the tangents of one sample and column sit in the same
// thread and the epilogue f'(z_v) * z_t needs no exchange. x0 is staged in
// 16- or 8-byte loads where a segment's rows allow them. A operands come
// from x0 / h by ldmatrix (rows padded to an odd multiple of 16 bytes: no
// bank conflicts), B from a ring of 3 weight tiles filled by cp.async,
// walked as one schedule across pieces and layers, so the copy of the next
// tiles (the next layer's too) overlaps the products. A fan-in that is not
// a multiple of the mma depth (60, 343, 256+60, 39, 286) reads zero-padded
// x0 columns against weight rows zero-filled in shared memory past the
// piece; no padded weight exists in device memory.
//
// * bf16: mma.sync m16n8k16, weight tiles of 32 rows, B fragments by
//   ldmatrix .trans.
// * f32 (NeuS, and the f32 reference steps): the 3xTF32 split of
//   tc_ops.cuh, three mma.sync m16n8k8 tf32 per f32 multiply-add, each
//   fragment split into hi and lo as it is read from shared memory. TF32
//   alone keeps about three decimal digits, which the f32 gates (1e-4
//   kernel vs plain version, 1e-3 against the JAX package) would not
//   hold; the split leaves about 2^-21 of each product, the order of an
//   f32 FMA sum's own rounding over a fan-in of 256. A fragments come by
//   the same ldmatrix byte addresses as in bf16 (a stage row of 32-bit
//   elements is read as pairs of b16), B fragments by element loads (no
//   32-bit ldmatrix .trans) from weight rows padded by 8 elements, so the
//   lanes (k t, column g) fall on banks 8t + g. Shared memory doubles per
//   element, so f32 weight tiles hold 16 rows, x0 is padded only to the
//   mma depth of 8 (the loop stops at a piece's last mma) and h by 4
//   elements: the largest f32 configuration, the K=1 colour trunk with
//   its 343-wide x0, takes 229,728 of the 232,448 bytes a block may use.
//
// What bounds it on the H100: at C = 256 a stacked row costs
// 2*C*fan_in FLOPs per layer against 2*(C0 + C) bytes of input and output
// per sample stream, i.e. over a thousand FLOPs per byte without a stash:
// in bf16 the tensor cores' rate (989 TFLOP/s) is the bound, with the
// stash (2*C bytes per stacked row and layer) the bytes come within a
// factor of a few of it; in f32 the 3xTF32 rate (165 TFLOP/s of f32 work
// at 700 W; 67 on the FMA units). The kernel runs far from both: per
// layer each block waits on one barrier per weight tile, its epilogue
// (tanhExp: two transcendentals per value element, the stash's stores)
// does not overlap the products, and one block of 8 warps per SM hides
// little latency; in f32 the split adds three ALU operations per
// fragment element read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_ops.cuh"

namespace neddf {

constexpr int kMaxSeg = 4;
constexpr int kMaxLayers = 12;
constexpr int kTcTileThreads = 256;  // threads of a block
constexpr int kRows = 128;      // stacked rows (streams x samples) per block
constexpr int kTcWStages = 3;   // weight ring stages

// the tile body's shapes by operand type: weight rows per ring stage (two
// mma depths), the mma depth, x0's column alignment and the row paddings
// of x0, h and the weight tiles in shared memory (see above)
template <typename T>
struct TileShape {
  static constexpr int KT = 32, KSTEP = 16, X_ALIGN = 32, X_PAD = 8, H_PAD = 8, W_PAD = 8;
};
template <>
struct TileShape<float> {
  static constexpr int KT = 16, KSTEP = 8, X_ALIGN = 8, X_PAD = 4, H_PAD = 4, W_PAD = 8;
};

// post-skip layer inputs (TileArgs::split)
constexpr int kSplitSegFirst = 1;     // [seg0, h]
constexpr int kSplitHiddenFirst = 2;  // [h, seg0]

// activations (template parameter ACT)
constexpr int kTanhExp = 0;
constexpr int kReLU = 1;
constexpr int kLeakyReLU = 2;
constexpr float kLeakySlope = 0.01f;

// f'' is identically zero (ReLU, LeakyReLU): the backwards form no f'' term
template <int ACT>
constexpr bool kZeroDeriv2 = ACT != kTanhExp;

// fn(std::integral_constant<int, ACT>{}) for the run-time activation code
// act; cudaErrorInvalidValue for any other code
template <typename F>
cudaError_t by_act(int act, F&& fn) {
  switch (act) {
    case kTanhExp: return fn(std::integral_constant<int, kTanhExp>{});
    case kReLU: return fn(std::integral_constant<int, kReLU>{});
    case kLeakyReLU: return fn(std::integral_constant<int, kLeakyReLU>{});
  }
  return cudaErrorInvalidValue;
}

struct TileArgs {
  const void* seg_v[kMaxSeg];  // [M, seg_w] values, type T
  const void* seg_j[kMaxSeg];  // [K, M, seg_w] tangents, or null (zeros)
  int seg_w[kMaxSeg];
  int n_seg;
  const void* w[kMaxLayers];   // [fan_in, C] row-major, type T
  const float* b[kMaxLayers];  // [C]
  int split[kMaxLayers];       // 0, kSplitSegFirst or kSplitHiddenFirst
  void* stash[kMaxLayers];     // [S, M, C] pre-activations, type T, or null
  int n_layers;
  int M;
  void* v_out;                 // [M, C], type T
  void* j_out;                 // [K, M, C], type T
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// tanhExp and its derivative, passing x through above 20
// (neddf_tpu/kernels/dual_mlp.py::_act_fns)
__device__ __forceinline__ void tanh_exp(float x, float& f, float& df) {
  if (x > 20.f) {
    f = x;
    df = 1.f;
    return;
  }
  const float ex = expf(x);
  const float tx = tanhf(ex);
  f = x * tx;
  df = tx - x * ex * (tx * tx - 1.f);
}

template <int ACT>
__device__ __forceinline__ void act_fn(float x, float& f, float& df) {
  if constexpr (ACT == kReLU) {
    f = fmaxf(x, 0.f);
    df = x > 0.f ? 1.f : 0.f;
  } else if constexpr (ACT == kLeakyReLU) {
    f = x >= 0.f ? x : kLeakySlope * x;
    df = x >= 0.f ? 1.f : kLeakySlope;
  } else {
    tanh_exp(x, f, df);
  }
}

// f, f' and f'' for the backward kernels (dual_mlp_bwd.cu, sdf_mlp.cu)
template <int ACT>
__device__ __forceinline__ void act_fn3(float x, float& f, float& df, float& ddf) {
  act_fn<ACT>(x, f, df);
  if constexpr (kZeroDeriv2<ACT>) {
    ddf = 0.f;
  } else if (x > 20.f) {
    ddf = 0.f;
  } else {
    const float ex = expf(x);
    const float tx = tanhf(ex);
    ddf = ex * (1.f - tx * tx) * (2.f + x - 2.f * x * ex * tx);
  }
}

// the value row of a stacked cotangent, G_v = g_v f'(z_v) + f''(z_v) c
// with c = sum_a g_a z_a, in one rounding order for every kernel that
// forms it outside a product (gstack_kernel, neddf_epilogue.cu's top
// mode), so that the two give the same bits
__device__ __forceinline__ float dual_gv(float g, float d1, float d2, float coupling) {
  return fmaf(g, d1, d2 * coupling);
}

// blocks of a grid-stride elementwise launch: at most 32 per SM of the H100
inline int grid_1d(size_t n, int threads) {
  const size_t blocks = (n + threads - 1) / threads;
  return (int)(blocks < 132 * 32 ? blocks : 132 * 32);
}

__host__ __device__ inline int x0_width(const TileArgs& a) {
  int s = 0;
  for (int i = 0; i < a.n_seg; ++i) s += a.seg_w[i];
  return s;
}

__host__ __device__ inline bool has_split(const TileArgs& a) {
  for (int l = 0; l < a.n_layers; ++l)
    if (a.split[l]) return true;
  return false;
}

// the layer's input pieces: (from x0 or h, width, first weight row)
__host__ __device__ __forceinline__ int layer_pieces(const TileArgs& a, int l, int C,
                                                     bool from_x0[2], int width[2],
                                                     int wrow[2]) {
  const int w0 = a.seg_w[0];
  if (l == 0) {
    from_x0[0] = true; width[0] = x0_width(a); wrow[0] = 0;
    return 1;
  }
  if (a.split[l] == kSplitSegFirst) {
    from_x0[0] = true; width[0] = w0; wrow[0] = 0;
    from_x0[1] = false; width[1] = C; wrow[1] = w0;
    return 2;
  }
  if (a.split[l] == kSplitHiddenFirst) {
    from_x0[0] = false; width[0] = C; wrow[0] = 0;
    from_x0[1] = true; width[1] = w0; wrow[1] = C;
    return 2;
  }
  from_x0[0] = false; width[0] = C; wrow[0] = 0;
  return 1;
}

// weight tiles of the body's schedule: every layer, each layer's pieces,
// KT rows at a time
template <typename T>
__host__ __device__ inline int weight_tile_count(const TileArgs& a, int C) {
  constexpr int KT = TileShape<T>::KT;
  int n = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int np = layer_pieces(a, l, C, from_x0, width, wrow);
    for (int pc = 0; pc < np; ++pc) n += (width[pc] + KT - 1) / KT;
  }
  return n;
}

// one entry of that schedule, kept in shared memory: the tile's first
// weight row in device memory and its rows inside the piece
template <typename T>
struct __align__(16) WeightTile {
  const T* src;
  int rows;
};

// row pitches in shared memory: x0 padded with zeros to X_ALIGN columns,
// every row padded (TileShape)
template <typename T>
__host__ __device__ inline int x0_pitch(const TileArgs& a) {
  using Sh = TileShape<T>;
  return (x0_width(a) + Sh::X_ALIGN - 1) / Sh::X_ALIGN * Sh::X_ALIGN + Sh::X_PAD;
}

template <typename T, int C>
__host__ __device__ constexpr int h_pitch() {
  return C + TileShape<T>::H_PAD;
}

template <typename T, int C>
__host__ __device__ constexpr int w_pitch() {
  return C + TileShape<T>::W_PAD;
}

// elements of the x0 + h region; without a post-skip layer h reuses x0,
// which is dead once layer 0 has read it
template <typename T, int C>
__host__ __device__ inline size_t act_elems(const TileArgs& a) {
  const size_t x0 = (size_t)kRows * x0_pitch<T>(a);
  const size_t h = (size_t)kRows * h_pitch<T, C>();
  if (has_split(a)) return x0 + h;
  return x0 > h ? x0 : h;
}

// elements of the weight ring: kTcWStages tiles of KT padded rows
template <typename T, int C>
__host__ __device__ constexpr size_t wt_elems() {
  return (size_t)kTcWStages * TileShape<T>::KT * w_pitch<T, C>();
}

// bytes of the block's shared buffers: x0 and h, the weight ring and the
// weight schedule
template <typename T, int C>
__host__ __device__ inline size_t smem_bytes(const TileArgs& a) {
  return (act_elems<T, C>(a) + wt_elems<T, C>()) * sizeof(T) +
         weight_tile_count<T>(a, C) * sizeof(WeightTile<T>);
}

// tile t of the weight schedule (every layer, each layer's pieces, KT rows
// at a time): its first row and its rows inside the piece; false past the
// last tile
template <typename T, int C>
__device__ __forceinline__ bool weight_tile(const TileArgs& a, int t, const T*& src,
                                            int& rows) {
  constexpr int KT = TileShape<T>::KT;
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int n = layer_pieces(a, l, C, from_x0, width, wrow);
    for (int pc = 0; pc < n; ++pc) {
      const int tiles = (width[pc] + KT - 1) / KT;
      if (t < tiles) {
        src = static_cast<const T*>(a.w[l]) + (size_t)(wrow[pc] + t * KT) * C;
        rows = min(KT, width[pc] - t * KT);
        return true;
      }
      t -= tiles;
    }
  }
  return false;
}

// copy weight tile t of the schedule into ring slot dst (rows past the
// piece are zeros); nothing past the last tile
template <typename T, int C>
__device__ __forceinline__ void load_weight_tile(const WeightTile<T>* sched, int n_tiles, int t,
                                                 T* dst) {
  if (t >= n_tiles) return;
  const T* src = sched[t].src;
  const int rows = sched[t].rows;
  constexpr int WP = w_pitch<T, C>();
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = C / EPC;              // chunks per row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < TileShape<T>::KT * CPR; idx += kTcTileThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * EPC;
    const bool ok = r < rows;
    cp_async<16>(smem_u32(dst + r * WP + c), ok ? src + (size_t)r * C + c : src,
                 ok ? 16 : 0);
  }
}

// stage segment s of the layer-0 input into x0's columns at dst (row pitch
// xp), V elements per load (the rows' alignment allows it); tangent rows
// of a segment without tangents, and rows past M, are zeros
template <typename T, int V, int K>
__device__ __forceinline__ void stage_segment(const TileArgs& a, int s, T* dst, int xp, int m0,
                                              int M) {
  using Elem = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  constexpr int BYTES = V * (int)sizeof(T);
  using Vec = std::conditional_t<BYTES == 16, uint4, std::conditional_t<BYTES == 8, uint2, Elem>>;
  constexpr int TM = kRows / (K + 1);
  const int w = a.seg_w[s];
  const int cpr = w / V;  // loads per row
  const T* sv = static_cast<const T*>(a.seg_v[s]);
  const T* sj = static_cast<const T*>(a.seg_j[s]);
  Elem* de = reinterpret_cast<Elem*>(dst);
  for (int idx = threadIdx.x; idx < kRows * cpr; idx += kTcTileThreads) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * V;
    const int st = r / TM;
    const int m = m0 + (r - st * TM);
    union {
      Vec v;
      Elem e[V];
    } u;
    u.v = Vec{};
    if (m < M) {
      if (st == 0) {
        u.v = *reinterpret_cast<const Vec*>(sv + (size_t)m * w + c);
      } else if (sj != nullptr) {
        u.v = *reinterpret_cast<const Vec*>(sj + ((size_t)(st - 1) * M + m) * w + c);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) de[(size_t)r * xp + c + e] = u.e[e];
  }
}

// two adjacent f32 values stored as T
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The whole trunk on one row tile: x0, h and wt are the block's shared
// buffers (tile_buffers, smem_bytes); the last layer goes to a.v_out /
// a.j_out.
template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_tc(const TileArgs& a, T* x0, T* h, T* wt) {
  using Sh = TileShape<T>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int E = (int)sizeof(T);
  constexpr int S = K + 1;
  constexpr int TM = kRows / S;          // samples per block
  constexpr int MT = S == 1 ? 2 : 1;     // m16 tiles per stream and warp
  constexpr int RT = S * MT;             // m16 tiles per warp
  constexpr int NSL = TM / (16 * MT);    // sample slices
  constexpr int NCG = (kTcTileThreads / 32) / NSL;  // column bands
  constexpr int WC = C / NCG;            // columns per warp
  constexpr int NI = WC / 8;             // n8 tiles per warp
  constexpr int HP = h_pitch<T, C>();
  constexpr int WP = w_pitch<T, C>();
  constexpr int KT = Sh::KT;
  constexpr int WSLOT = KT * WP;
  static_assert(kRows % S == 0 && TM % (16 * MT) == 0 && (kTcTileThreads / 32) % NSL == 0,
                "row tile");
  static_assert(WC % 16 == 0 && RT * NI * 4 == 128, "column band");

  const int x0w = x0_width(a);
  const int xp = x0_pitch<T>(a);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = warp / NCG;   // sample slice
  const int cg = warp % NCG;  // column band
  const int m0 = blockIdx.x * TM;
  const int M = a.M;

  // the weight schedule (after the ring), one entry per tile
  WeightTile<T>* sched = reinterpret_cast<WeightTile<T>*>(wt + wt_elems<T, C>());
  const int n_tiles = weight_tile_count<T>(a, C);
  for (int i = tid; i < n_tiles; i += kTcTileThreads) {
    const T* src;
    int rows;
    weight_tile<T, C>(a, i, src, rows);
    sched[i].src = src;
    sched[i].rows = rows;
  }
  __syncthreads();
  // the first weight tiles start loading while x0 is staged
  for (int s = 0; s < kTcWStages - 1; ++s) {
    load_weight_tile<T, C>(sched, n_tiles, s, wt + s * WSLOT);
    cp_async_commit();
  }

  // stage the layer-0 input, each segment in loads of as many elements as
  // its rows' alignment allows; rows past M (the ragged edge) and the
  // padding columns are zeros
  {
    int off = 0;
    for (int s = 0; s < a.n_seg; ++s) {
      const int w = a.seg_w[s];
      const uintptr_t align = reinterpret_cast<uintptr_t>(a.seg_v[s]) |
                              reinterpret_cast<uintptr_t>(a.seg_j[s]) | (uintptr_t)(E * w);
      T* dst = x0 + off;
      if (align % 16 == 0) {
        stage_segment<T, 16 / E, K>(a, s, dst, xp, m0, M);
      } else if (align % 8 == 0) {
        stage_segment<T, 8 / E, K>(a, s, dst, xp, m0, M);
      } else {
        stage_segment<T, 1, K>(a, s, dst, xp, m0, M);
      }
      off += w;
    }
    const int pad = xp - x0w;
    for (int idx = tid; idx < kRows * pad; idx += kTcTileThreads) {
      const int r = idx / pad;
      x0[(size_t)r * xp + x0w + (idx - r * pad)] = from_f32<T>(0.f);
    }
  }
  // (the first wait below is followed by a barrier, which publishes x0)

  const int g = lane >> 2, tq = lane & 3;
  // bf16: this lane's ldmatrix .trans row of a weight tile (B: k rows 0-15
  // of the column band; lanes 16-31 eight columns on), in ring slot 0
  const uint32_t w_lane = smem_u32(wt) + E * (((lane & 7) + ((lane >> 3) & 1) * 8) * WP +
                                              cg * WC + (lane >> 4) * 8);
  // f32: this lane's element (k t, column g) of the band's first n8 tile,
  // in ring slot 0
  const uint32_t w_elem_s = smem_u32(wt + tq * WP + cg * WC + g);
  // first row of the warp's m16 tile rt (stream rt / MT) over its slice's
  auto tile_row = [](int rt) { return (rt / MT) * TM + (rt % MT) * 16; };
  int t = 0;  // weight tile of the schedule
  // acc[st * MT + mt]: stream st, m16 tile mt of the warp's sample slice
  float acc[RT][NI][4];
  for (int l = 0; l < a.n_layers; ++l) {
#pragma unroll
    for (int st = 0; st < RT; ++st)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[st][ni][e] = 0.f;

    bool from_x0[2];
    int width[2], wrow[2];
    const int n_pieces = layer_pieces(a, l, C, from_x0, width, wrow);
    for (int pc = 0; pc < n_pieces; ++pc) {
      const int pitch = from_x0[pc] ? xp : HP;
      // this lane's ldmatrix row of stream 0 (A: rows of 16 samples, lanes
      // 0-15 at column 0, lanes 16-31 16 bytes on), as a 32-bit
      // shared-memory address
      const uint32_t a_lane = smem_u32(from_x0[pc] ? x0 : h) +
                              E * ((q * 16 * MT + (lane & 15)) * pitch) + (lane >> 4) * 16;
      for (int k0 = 0; k0 < width[pc]; k0 += KT, ++t) {
        cp_async_wait<kTcWStages - 2>();
        __syncthreads();  // tile t has landed; slot t-1 is free
        load_weight_tile<T, C>(sched, n_tiles, t + kTcWStages - 1,
                               wt + ((t + kTcWStages - 1) % kTcWStages) * WSLOT);
        cp_async_commit();
        const int slot = t % kTcWStages;
        // f32: one mma depth at a time (fewer live fragments: 0 spills)
        constexpr int kUnrollK = kF32 ? 1 : KT / Sh::KSTEP;
#pragma unroll kUnrollK
        for (int kk = 0; kk < KT; kk += Sh::KSTEP) {
          if (k0 + kk >= width[pc]) break;  // past the piece: zeros only
          const uint32_t a_k = a_lane + E * (k0 + kk);
          if constexpr (kF32) {
            // the A fragments of AG m16 tiles, split, against every pair of
            // n8 tiles of B (K=3: one tile at a time, B read RT times; the
            // split fragments of all four streams beside 128 accumulators
            // would spill)
            constexpr int AG = RT > 2 ? 1 : RT;
            const uint32_t w_k = w_elem_s + E * (slot * WSLOT + kk * WP);
#pragma unroll
            for (int s0 = 0; s0 < RT; s0 += AG) {
              uint32_t ah[AG][4], al[AG][4];
#pragma unroll
              for (int s = 0; s < AG; ++s) {
                ldsm_x4(ah[s], a_k + E * tile_row(s0 + s) * pitch);
                split_tf32(ah[s], al[s]);
              }
#pragma unroll
              for (int nj = 0; nj < NI / 2; ++nj) {
                // b0 (k t), b1 (k t+4) of n8 tiles 2nj and 2nj+1
                uint32_t bh[4] = {lds_u32(w_k + 64 * nj), lds_u32(w_k + 64 * nj + 16 * WP),
                                  lds_u32(w_k + 64 * nj + 32),
                                  lds_u32(w_k + 64 * nj + 32 + 16 * WP)};
                uint32_t bl[4];
                split_tf32(bh, bl);
#pragma unroll
                for (int s = 0; s < AG; ++s) {
                  mma_3xtf32(acc[s0 + s][2 * nj], ah[s], al[s], bh[0], bh[1], bl[0], bl[1]);
                  mma_3xtf32(acc[s0 + s][2 * nj + 1], ah[s], al[s], bh[2], bh[3], bl[2],
                             bl[3]);
                }
              }
            }
          } else {
            // all of A (one fragment per m16 tile), then B per pair of n8 tiles
            uint32_t af[RT][4];
#pragma unroll
            for (int st = 0; st < RT; ++st) ldsm_x4(af[st], a_k + E * tile_row(st) * pitch);
            const uint32_t w_k = w_lane + E * (slot * WSLOT + kk * WP);
#pragma unroll
            for (int nj = 0; nj < NI / 2; ++nj) {
              uint32_t bfr[4];
              ldsm_x4_t(bfr, w_k + 32u * nj);
#pragma unroll
              for (int st = 0; st < RT; ++st) {
                mma_bf16_16816(acc[st][2 * nj], af[st], bfr[0], bfr[1]);
                mma_bf16_16816(acc[st][2 * nj + 1], af[st], bfr[2], bfr[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every warp has read this layer's input: h may be overwritten

    // epilogue: bias on the values, stash, values f(z), tangents f'(z_v) z_t
    const bool last = (l == a.n_layers - 1);
    T* vout = static_cast<T*>(a.v_out);
    T* jout = static_cast<T*>(a.j_out);
    T* pre = static_cast<T*>(a.stash[l]);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = cg * WC + ni * 8 + 2 * tq;
      const float b0 = a.b[l][col], b1 = a.b[l][col + 1];
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) {
        // in place: z (bias on the values), then f(z_v) and f'(z_v) z_t;
        // acc[st * MT + mt][ni][e0, e0 + 1] holds stream st of sample i
        const int mt = r >> 1, hh = r & 1;
        const int e0 = 2 * hh;
        acc[mt][ni][e0] += b0;
        acc[mt][ni][e0 + 1] += b1;
        const int i = (q * MT + mt) * 16 + g + 8 * hh;
        const int m = m0 + i;
        if (pre != nullptr && m < M) {
#pragma unroll
          for (int st = 0; st < S; ++st)
            store2(pre + ((size_t)st * M + m) * C + col, acc[st * MT + mt][ni][e0],
                   acc[st * MT + mt][ni][e0 + 1]);
        }
#pragma unroll
        for (int e = e0; e < e0 + 2; ++e) {
          float f, df;
          act_fn<ACT>(acc[mt][ni][e], f, df);
          acc[mt][ni][e] = f;
#pragma unroll
          for (int st = 1; st < S; ++st) acc[st * MT + mt][ni][e] *= df;
        }
        if (!last) {
#pragma unroll
          for (int st = 0; st < S; ++st)
            store2(h + (size_t)(st * TM + i) * HP + col, acc[st * MT + mt][ni][e0],
                   acc[st * MT + mt][ni][e0 + 1]);
        } else if (m < M) {
          store2(vout + (size_t)m * C + col, acc[mt][ni][e0], acc[mt][ni][e0 + 1]);
#pragma unroll
          for (int st = 1; st < S; ++st)
            store2(jout + ((size_t)(st - 1) * M + m) * C + col, acc[st * MT + mt][ni][e0],
                   acc[st * MT + mt][ni][e0 + 1]);
        }
      }
    }
    if (!last) __syncthreads();  // h is complete before the next layer reads it
  }
  cp_async_wait<0>();
}

// the block's shared buffers: x0, then h (or h over x0), then wt
template <typename T, int C>
__device__ __forceinline__ void tile_buffers(const TileArgs& a, unsigned char* raw,
                                             T*& x0, T*& h, T*& wt) {
  T* smem = reinterpret_cast<T*>(raw);
  x0 = smem;
  h = has_split(a) ? smem + (size_t)kRows * x0_pitch<T>(a) : smem;
  wt = smem + act_elems<T, C>(a);
}

template <typename T, int K, int C, int ACT>
__global__ void __launch_bounds__(kTcTileThreads, 1) mlp_tile_fwd(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *x0, *h, *wt;
  tile_buffers<T, C>(a, smem_raw, x0, h, wt);
  tile_forward_tc<T, K, C, ACT>(a, x0, h, wt);
}

template <typename T, int K, int C, int ACT>
cudaError_t launch_mlp_tile(const TileArgs& a, cudaStream_t stream) {
  if (a.M <= 0) return cudaSuccess;
  const size_t smem = smem_bytes<T, C>(a);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tile_fwd<T, K, C, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int TM = kRows / (K + 1);
  const int grid = (a.M + TM - 1) / TM;
  mlp_tile_fwd<T, K, C, ACT><<<grid, kTcTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace neddf
