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
//   activation is a template parameter: tanhExp (kTanhExp) or ReLU
//   (kReLU, with f'(0) = 0 as neddf_tpu/kernels/dual_mlp.py::_act_fns
//   defines it). Sums and activations are f32; the f32 bias is added to
//   the value rows only.
//
// Two bodies, chosen by T:
//
// * bf16 (tile_forward_tc): each layer's product [kRows x fan_in] x
//   [fan_in x C] runs on the tensor cores, mma.sync m16n8k16 with f32
//   accumulators in registers: 128 per thread, so the block has 8 warps
//   (256 threads, up to 255 registers each; 512 threads would leave 64
//   registers beside the accumulators, and spill). Each warp owns one
//   sample slice (16 samples, 32 for K=0) of EVERY stream and a band of
//   columns, so the value and the tangents of one sample and column sit
//   in the same thread and the epilogue f'(z_v) * z_t needs no exchange.
//   x0 is staged in 16- or 8-byte loads where a segment's rows allow
//   them. A operands come from x0 / h
//   by ldmatrix (rows padded by 16 bytes: no bank conflicts), B from a
//   ring of 3 weight tiles of 32 rows filled by cp.async, walked as one
//   schedule across pieces and layers, so the copy of the next tiles
//   (the next layer's too) overlaps the products. A fan-in that is not a
//   multiple of 32 (60, 343, 256+60) reads zero-padded x0 columns against
//   weight rows zero-filled in shared memory past the piece; no padded
//   weight exists in device memory.
// * f32 (tile_forward_fma): plain FMA on the CUDA cores, weights through
//   shared memory kKTile rows at a time, each thread an output sub-tile
//   (SPT samples x S streams x 16 columns) in registers. f32 keeps this
//   body: its gates hold f32 to 1e-4, which TF32 products would not.
//
// What bounds it on the H100: at C = 256 a stacked row costs
// 2*C*fan_in FLOPs per layer against 2*(C0 + C) bytes of input and output
// per sample stream, i.e. over a thousand FLOPs per byte without a stash:
// in bf16 the tensor cores' rate (989 TFLOP/s) is the bound, with the
// stash (2*C bytes per stacked row and layer) the bytes come within a
// factor of a few of it. The kernel runs far from both: per layer each
// block waits on one barrier per 32 weight rows, its epilogue (tanhExp:
// two transcendentals per value element, the stash's 4-byte stores) does
// not overlap the products, and one block of 8 warps per SM hides little
// latency. In f32 the bound is the FMA issue rate (67 TFLOP/s at 700 W).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_ops.cuh"

namespace neddf {

constexpr int kMaxSeg = 4;
constexpr int kMaxLayers = 12;
constexpr int kThreads = 512;        // threads of a block (FMA body)
constexpr int kTcTileThreads = 256;  // threads of a block (tensor-core body)
constexpr int kRows = 128;      // stacked rows (streams x samples) per block
constexpr int kColGroups = 16;  // threads across the output columns (FMA body)
constexpr int kKTile = 16;      // weight rows staged per step (FMA body)
constexpr int kTcKTile = 32;    // weight rows per ring stage (tensor-core body)
constexpr int kTcWStages = 3;   // weight ring stages (tensor-core body)
constexpr int kTcPad = 8;       // elements (16 bytes) of row padding in shared memory

// post-skip layer inputs (TileArgs::split)
constexpr int kSplitSegFirst = 1;     // [seg0, h]
constexpr int kSplitHiddenFirst = 2;  // [h, seg0]

// activations (template parameter ACT)
constexpr int kTanhExp = 0;
constexpr int kReLU = 1;

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

__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]);
  const float2 hi = __bfloat1622float2(q[1]);
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
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
  } else {
    tanh_exp(x, f, df);
  }
}

// f, f' and f'' for the backward kernels (dual_mlp_bwd.cu, sdf_mlp.cu)
template <int ACT>
__device__ __forceinline__ void act_fn3(float x, float& f, float& df, float& ddf) {
  act_fn<ACT>(x, f, df);
  if constexpr (ACT == kReLU) {
    ddf = 0.f;
  } else if (x > 20.f) {
    ddf = 0.f;
  } else {
    const float ex = expf(x);
    const float tx = tanhf(ex);
    ddf = ex * (1.f - tx * tx) * (2.f + x - 2.f * x * ex * tx);
  }
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

// weight tiles of the tensor-core body's schedule: every layer, each
// layer's pieces, kTcKTile rows at a time
__host__ __device__ inline int weight_tile_count(const TileArgs& a, int C) {
  int n = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int np = layer_pieces(a, l, C, from_x0, width, wrow);
    for (int pc = 0; pc < np; ++pc) n += (width[pc] + kTcKTile - 1) / kTcKTile;
  }
  return n;
}

// one entry of that schedule, kept in shared memory: the tile's first
// weight row in device memory and its rows inside the piece
struct __align__(16) WeightTile {
  const __nv_bfloat16* src;
  int rows;
};

// row pitches in shared memory: the FMA body packs rows; the tensor-core
// body pads x0 to whole weight tiles (zeros) and every row by kTcPad
template <typename T>
__host__ __device__ inline int x0_pitch(const TileArgs& a) {
  if constexpr (std::is_same_v<T, float>) return x0_width(a);
  return (x0_width(a) + kTcKTile - 1) / kTcKTile * kTcKTile + kTcPad;
}

template <typename T, int C>
__host__ __device__ constexpr int h_pitch() {
  return std::is_same_v<T, float> ? C : C + kTcPad;
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

// elements of the weight tiles: one kKTile x C tile (FMA body), a ring of
// kTcWStages tiles of kTcKTile padded rows (tensor-core body)
template <typename T, int C>
__host__ __device__ constexpr size_t wt_elems() {
  return std::is_same_v<T, float> ? (size_t)kKTile * C
                                  : (size_t)kTcWStages * kTcKTile * h_pitch<T, C>();
}

// bytes of the block's shared buffers: x0 and h, the weight tiles and
// (tensor-core body) the weight schedule
template <typename T, int C>
inline size_t smem_bytes(const TileArgs& a) {
  const size_t bytes = (act_elems<T, C>(a) + wt_elems<T, C>()) * sizeof(T);
  if constexpr (std::is_same_v<T, float>) return bytes;
  return bytes + weight_tile_count(a, C) * sizeof(WeightTile);
}

template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_fma(const TileArgs& a, T* x0, T* h, T* wt);
template <int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_tc(const TileArgs& a, __nv_bfloat16* x0,
                                                __nv_bfloat16* h, __nv_bfloat16* wt);

// The whole trunk on one row tile: x0, h and wt are the block's shared
// buffers (tile_buffers, smem_bytes); the last layer goes to a.v_out /
// a.j_out. bf16 runs on the tensor cores, f32 on the CUDA cores.
template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward(const TileArgs& a, T* x0, T* h, T* wt) {
  if constexpr (std::is_same_v<T, float>) {
    tile_forward_fma<T, K, C, ACT>(a, x0, h, wt);
  } else {
    tile_forward_tc<K, C, ACT>(a, x0, h, wt);
  }
}

// tile t of the tensor-core body's weight schedule (every layer, each
// layer's pieces, kTcKTile rows at a time): its first row and its rows
// inside the piece; false past the last tile
template <int C>
__device__ __forceinline__ bool weight_tile(const TileArgs& a, int t,
                                            const __nv_bfloat16*& src, int& rows) {
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int n = layer_pieces(a, l, C, from_x0, width, wrow);
    for (int pc = 0; pc < n; ++pc) {
      const int tiles = (width[pc] + kTcKTile - 1) / kTcKTile;
      if (t < tiles) {
        src = static_cast<const __nv_bfloat16*>(a.w[l]) +
              (size_t)(wrow[pc] + t * kTcKTile) * C;
        rows = min(kTcKTile, width[pc] - t * kTcKTile);
        return true;
      }
      t -= tiles;
    }
  }
  return false;
}

// copy weight tile t of the schedule into ring slot dst (rows past the
// piece are zeros); nothing past the last tile
template <int C>
__device__ __forceinline__ void load_weight_tile(const WeightTile* sched, int n_tiles, int t,
                                                 __nv_bfloat16* dst) {
  if (t >= n_tiles) return;
  const __nv_bfloat16* src = sched[t].src;
  const int rows = sched[t].rows;
  constexpr int WP = C + kTcPad;
  constexpr int CPR = C / 8;  // 16-byte chunks per row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kTcKTile * CPR; idx += kTcTileThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * 8;
    const bool ok = r < rows;
    cp_async<16>(smem_u32(dst + r * WP + c), ok ? src + (size_t)r * C + c : src,
                 ok ? 16 : 0);
  }
}

// stage segment s of the layer-0 input into x0's columns at dst (row pitch
// xp) for the tensor-core body, V elements per load (the rows' alignment
// allows it); tangent rows of a segment without tangents, and rows past
// M, are zeros
template <int V, int K>
__device__ __forceinline__ void stage_segment(const TileArgs& a, int s, __nv_bfloat16* dst,
                                              int xp, int m0, int M) {
  using T = __nv_bfloat16;
  using Vec = std::conditional_t<V == 8, uint4, std::conditional_t<V == 4, uint2, uint16_t>>;
  constexpr int TM = kRows / (K + 1);
  const int w = a.seg_w[s];
  const int cpr = w / V;  // loads per row
  const T* sv = static_cast<const T*>(a.seg_v[s]);
  const T* sj = static_cast<const T*>(a.seg_j[s]);
  uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
  for (int idx = threadIdx.x; idx < kRows * cpr; idx += kTcTileThreads) {
    const int r = idx / cpr;
    const int c = (idx - r * cpr) * V;
    const int st = r / TM;
    const int m = m0 + (r - st * TM);
    union {
      Vec v;
      uint16_t e[V];
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
    for (int e = 0; e < V; ++e) d16[(size_t)r * xp + c + e] = u.e[e];
  }
}

template <int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_tc(const TileArgs& a, __nv_bfloat16* x0,
                                                __nv_bfloat16* h, __nv_bfloat16* wt) {
  using T = __nv_bfloat16;
  constexpr int S = K + 1;
  constexpr int TM = kRows / S;          // samples per block
  constexpr int MT = S == 1 ? 2 : 1;     // m16 tiles per stream and warp
  constexpr int RT = S * MT;             // m16 tiles per warp
  constexpr int NSL = TM / (16 * MT);    // sample slices
  constexpr int NCG = (kTcTileThreads / 32) / NSL;  // column bands
  constexpr int WC = C / NCG;            // columns per warp
  constexpr int NI = WC / 8;             // n8 tiles per warp
  constexpr int HP = C + kTcPad;         // h and weight-tile row pitch
  constexpr int WSLOT = kTcKTile * HP;
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
  WeightTile* sched = reinterpret_cast<WeightTile*>(wt + wt_elems<T, C>());
  const int n_tiles = weight_tile_count(a, C);
  for (int i = tid; i < n_tiles; i += kTcTileThreads) {
    const __nv_bfloat16* src;
    int rows;
    weight_tile<C>(a, i, src, rows);
    sched[i].src = src;
    sched[i].rows = rows;
  }
  __syncthreads();
  // the first weight tiles start loading while x0 is staged
  for (int s = 0; s < kTcWStages - 1; ++s) {
    load_weight_tile<C>(sched, n_tiles, s, wt + s * WSLOT);
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
                              reinterpret_cast<uintptr_t>(a.seg_j[s]) | (uintptr_t)(2 * w);
      T* dst = x0 + off;
      if (align % 16 == 0) {
        stage_segment<8, K>(a, s, dst, xp, m0, M);
      } else if (align % 8 == 0) {
        stage_segment<4, K>(a, s, dst, xp, m0, M);
      } else {
        stage_segment<1, K>(a, s, dst, xp, m0, M);
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
  // this lane's ldmatrix row of a weight tile (B, .trans: k rows 0-15 of
  // the column band; lanes 16-31 eight columns on), in ring slot 0
  const uint32_t w_lane = smem_u32(wt) + 2u * (((lane & 7) + ((lane >> 3) & 1) * 8) * HP +
                                               cg * WC + (lane >> 4) * 8);
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
      // this lane's ldmatrix row of stream 0 (A: rows of 16 samples,
      // lanes 0-15 at column 0, lanes 16-31 at column 8), as a 32-bit
      // shared-memory address
      const uint32_t a_lane =
          smem_u32(from_x0[pc] ? x0 : h) +
          2u * ((q * 16 * MT + (lane & 15)) * pitch + (lane >> 4) * 8);
      for (int k0 = 0; k0 < width[pc]; k0 += kTcKTile, ++t) {
        cp_async_wait<kTcWStages - 2>();
        __syncthreads();  // tile t has landed; slot t-1 is free
        load_weight_tile<C>(sched, n_tiles, t + kTcWStages - 1,
                            wt + ((t + kTcWStages - 1) % kTcWStages) * WSLOT);
        cp_async_commit();
        const uint32_t w_tile = w_lane + 2u * (t % kTcWStages) * WSLOT;
#pragma unroll
        for (int kk = 0; kk < kTcKTile; kk += 16) {
          const uint32_t a_k = a_lane + 2u * (k0 + kk);
          const uint32_t w_k = w_tile + 2u * kk * HP;
          if constexpr (RT * 4 > NI * 2) {
            // more A than B registers: all of B, then A per m16 tile
            uint32_t bfr[NI / 2][4];
#pragma unroll
            for (int nj = 0; nj < NI / 2; ++nj) ldsm_x4_t(bfr[nj], w_k + 32u * nj);
#pragma unroll
            for (int st = 0; st < RT; ++st) {
              uint32_t af[4];
              ldsm_x4(af, a_k + 2u * tile_row(st) * pitch);
#pragma unroll
              for (int nj = 0; nj < NI / 2; ++nj) {
                mma_bf16_16816(acc[st][2 * nj], af, bfr[nj][0], bfr[nj][1]);
                mma_bf16_16816(acc[st][2 * nj + 1], af, bfr[nj][2], bfr[nj][3]);
              }
            }
          } else {
            // all of A (one fragment per m16 tile), then B per pair of n8 tiles
            uint32_t af[RT][4];
#pragma unroll
            for (int st = 0; st < RT; ++st) ldsm_x4(af[st], a_k + 2u * tile_row(st) * pitch);
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
            *reinterpret_cast<__nv_bfloat162*>(pre + ((size_t)st * M + m) * C + col) =
                __floats2bfloat162_rn(acc[st * MT + mt][ni][e0], acc[st * MT + mt][ni][e0 + 1]);
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
            *reinterpret_cast<__nv_bfloat162*>(h + (size_t)(st * TM + i) * HP + col) =
                __floats2bfloat162_rn(acc[st * MT + mt][ni][e0], acc[st * MT + mt][ni][e0 + 1]);
        } else if (m < M) {
          *reinterpret_cast<__nv_bfloat162*>(vout + (size_t)m * C + col) =
              __floats2bfloat162_rn(acc[mt][ni][e0], acc[mt][ni][e0 + 1]);
#pragma unroll
          for (int st = 1; st < S; ++st)
            *reinterpret_cast<__nv_bfloat162*>(jout + ((size_t)(st - 1) * M + m) * C + col) =
                __floats2bfloat162_rn(acc[st * MT + mt][ni][e0], acc[st * MT + mt][ni][e0 + 1]);
        }
      }
    }
    if (!last) __syncthreads();  // h is complete before the next layer reads it
  }
  cp_async_wait<0>();
}

template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_fma(const TileArgs& a, T* x0, T* h, T* wt) {
  constexpr int S = K + 1;
  constexpr int TM = kRows / S;             // samples per block
  constexpr int RG = kThreads / kColGroups; // thread rows
  constexpr int SPT = TM / RG;              // samples per thread
  constexpr int CPT = C / kColGroups;       // columns per thread
  constexpr int NQ = CPT / 4;               // runs of 4 adjacent columns
  static_assert(kRows % S == 0 && TM % RG == 0, "row tile");
  static_assert(C % (4 * kColGroups) == 0, "column tile");

  const int x0w = x0_width(a);
  const int tid = threadIdx.x;
  const int tr = tid / kColGroups;
  const int tc = tid % kColGroups;
  const int m0 = blockIdx.x * TM;
  const int M = a.M;

  // stage the layer-0 input; rows past M (the ragged edge) are zeros
  {
    int off = 0;
    for (int s = 0; s < a.n_seg; ++s) {
      const int w = a.seg_w[s];
      const T* sv = static_cast<const T*>(a.seg_v[s]);
      const T* sj = static_cast<const T*>(a.seg_j[s]);
      for (int idx = tid; idx < kRows * w; idx += kThreads) {
        const int r = idx / w;
        const int c = idx - r * w;
        const int st = r / TM;
        const int m = m0 + (r - st * TM);
        T val = from_f32<T>(0.f);
        if (m < M) {
          if (st == 0) {
            val = sv[(size_t)m * w + c];
          } else if (sj != nullptr) {
            val = sj[((size_t)(st - 1) * M + m) * w + c];
          }
        }
        x0[(size_t)r * x0w + off + c] = val;
      }
      off += w;
    }
  }
  __syncthreads();

  float acc[S][SPT][CPT];
  for (int l = 0; l < a.n_layers; ++l) {
    const T* W = static_cast<const T*>(a.w[l]);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bias = a.b[l][q * 4 * kColGroups + tc * 4 + e];
#pragma unroll
        for (int p = 0; p < SPT; ++p) {
          acc[0][p][q * 4 + e] = bias;
#pragma unroll
          for (int st = 1; st < S; ++st) acc[st][p][q * 4 + e] = 0.f;
        }
      }
    }

    // the layer's input pieces: (buffer, row stride, width, first weight row)
    const T* src[2];
    int stride[2], width[2], wrow[2];
    int n_pieces = 1;
    if (l == 0) {
      src[0] = x0; stride[0] = x0w; width[0] = x0w; wrow[0] = 0;
    } else if (a.split[l] == kSplitSegFirst) {
      src[0] = x0; stride[0] = x0w; width[0] = a.seg_w[0]; wrow[0] = 0;
      src[1] = h; stride[1] = C; width[1] = C; wrow[1] = a.seg_w[0];
      n_pieces = 2;
    } else if (a.split[l] == kSplitHiddenFirst) {
      src[0] = h; stride[0] = C; width[0] = C; wrow[0] = 0;
      src[1] = x0; stride[1] = x0w; width[1] = a.seg_w[0]; wrow[1] = C;
      n_pieces = 2;
    } else {
      src[0] = h; stride[0] = C; width[0] = C; wrow[0] = 0;
    }

    for (int pc = 0; pc < n_pieces; ++pc) {
      for (int k0 = 0; k0 < width[pc]; k0 += kKTile) {
        const int kt = min(kKTile, width[pc] - k0);
        // weight rows [wrow + k0, wrow + k0 + kt) are contiguous
        const uint4* g =
            reinterpret_cast<const uint4*>(W + (size_t)(wrow[pc] + k0) * C);
        uint4* d = reinterpret_cast<uint4*>(wt);
        const int n16 = kt * C * (int)sizeof(T) / 16;
        for (int idx = tid; idx < n16; idx += kThreads) d[idx] = g[idx];
        __syncthreads();

        const T* base = src[pc] + k0;
        for (int kk = 0; kk < kt; ++kk) {
          float av[S][SPT];
#pragma unroll
          for (int st = 0; st < S; ++st)
#pragma unroll
            for (int p = 0; p < SPT; ++p)
              av[st][p] = to_f32(
                  base[(size_t)(st * TM + tr + p * RG) * stride[pc] + kk]);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            float wv[4];
            load4(wt + kk * C + q * 4 * kColGroups + tc * 4, wv);
#pragma unroll
            for (int st = 0; st < S; ++st)
#pragma unroll
              for (int p = 0; p < SPT; ++p)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[st][p][q * 4 + e] =
                      fmaf(av[st][p], wv[e], acc[st][p][q * 4 + e]);
          }
        }
        __syncthreads();
      }
    }

    // activation: values get f(z), tangents f'(z_value) * z_tangent
    const bool last = (l == a.n_layers - 1);
    T* vout = static_cast<T*>(a.v_out);
    T* jout = static_cast<T*>(a.j_out);
    T* pre = static_cast<T*>(a.stash[l]);
#pragma unroll
    for (int p = 0; p < SPT; ++p) {
      const int i = tr + p * RG;
      const int m = m0 + i;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = q * 4 * kColGroups + tc * 4;
        if (pre != nullptr && m < M) {
#pragma unroll
          for (int st = 0; st < S; ++st)
            store4(pre + ((size_t)st * M + m) * C + col, &acc[st][p][q * 4]);
        }
        float out[S][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float f, df;
          act_fn<ACT>(acc[0][p][q * 4 + e], f, df);
          out[0][e] = f;
#pragma unroll
          for (int st = 1; st < S; ++st) out[st][e] = df * acc[st][p][q * 4 + e];
        }
        if (!last) {
#pragma unroll
          for (int st = 0; st < S; ++st)
            store4(h + (size_t)(st * TM + i) * C + col, out[st]);
        } else if (m < M) {
          store4(vout + (size_t)m * C + col, out[0]);
#pragma unroll
          for (int st = 1; st < S; ++st)
            store4(jout + ((size_t)(st - 1) * M + m) * C + col, out[st]);
        }
      }
    }
    if (!last) __syncthreads();
  }
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

template <typename T>
__host__ __device__ constexpr int tile_threads() {
  return std::is_same_v<T, float> ? kThreads : kTcTileThreads;
}

template <typename T, int K, int C, int ACT>
__global__ void __launch_bounds__(tile_threads<T>(), 1) mlp_tile_fwd(const TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *x0, *h, *wt;
  tile_buffers<T, C>(a, smem_raw, x0, h, wt);
  tile_forward<T, K, C, ACT>(a, x0, h, wt);
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
  mlp_tile_fwd<T, K, C, ACT><<<grid, tile_threads<T>(), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace neddf
