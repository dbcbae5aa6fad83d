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
//   as S*TM rows (TileGeo), stream-major: row st*TM + i is stream st of
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
// * the hidden state h [rows, C] lives in shared memory and is written
//   back after each layer as f(z) on the value rows and f'(z_value) *
//   z_tangent on the tangent rows, rounded to the storage type T; the
//   activation is a template parameter: tanhExp (kTanhExp), ReLU (kReLU,
//   with f'(0) = 0), LeakyReLU (kLeakyReLU, slope 0.01, f'(0) = 1),
//   Softplus (kSoftplus, linear above 20) or Sigmoid (kSigmoid), as
//   neddf_tpu/kernels/dual_mlp.py::_act_fns defines them. Sums and
//   activations are f32; the f32 bias is added to the value rows only.
//
// Widths. The body is instantiated for the width classes C = 64, 128,
// 256 and 512; a layer width N (TileArgs::width) runs on the smallest
// class C >= N (width_class). Weight rows are N wide in device memory and
// are copied into shared memory with the columns past N zero-filled
// (16-byte cp.async where N allows it, else 4 or 2 bytes at a time); the
// bias past N reads as 0, so those columns of z are exactly 0 and of h
// f(0), a finite value that the next layer multiplies by zero-filled
// weight rows (its hidden piece is N rows). Outputs and the stash are
// stored for the columns < N only (in pairs where N is even), so no padded
// copy of a weight, an activation or an output exists in device memory.
//
// One body for both operand types, tile_forward_tc: each layer's product
// [rows x fan_in] x [fan_in x C] runs on the tensor cores with f32
// accumulators in registers, the block of 8 warps (256 threads, up to 255
// registers each; 512 threads would leave 64 registers beside 128
// accumulators, and spill). The rows of a block follow the width class
// (TileGeo): 32768 / C stacked rows, i.e. 128 accumulators per thread
// (512 rows at C = 64, 64 at C = 512), but f32 below C = 256 keeps 128
// rows (64 or 32 accumulators): 256 or 512 f32 rows of the colour
// trunk's wide x0 do not fit in shared memory. Each warp owns one sample
// slice of EVERY stream and a band of columns, so
// the value and the tangents of one sample and column sit in the same
// thread and the epilogue f'(z_v) * z_t needs no exchange. x0 is staged in
// 16- or 8-byte loads where a segment's rows allow them. A operands come
// from x0 / h by ldmatrix (rows padded to an odd multiple of 16 bytes: no
// bank conflicts), B from a ring of 3 weight tiles (tile_stages) filled by cp.async,
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
//   element, so f32 weight tiles hold 16 rows (in 2 ring stages at C =
//   512, where 64 rows of h take 132 kB), x0 is padded only to the mma
//   depth of 8 (the loop stops at a piece's last mma) and h by 4
//   elements: at C = 256 the K=1 colour trunk with its 343-wide x0 takes
//   229,728 of the 232,448 bytes a block may use.
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
constexpr int kMaxWidth = 512;  // the widest class

// the tile body's shapes by operand type: the mma depth, x0's column
// alignment and the row paddings of x0, h and the weight tiles in shared
// memory (see above)
template <typename T>
struct TileShape {
  static constexpr int KSTEP = 16, X_ALIGN = 32, X_PAD = 8, H_PAD = 8, W_PAD = 8;
};
template <>
struct TileShape<float> {
  static constexpr int KSTEP = 8, X_ALIGN = 8, X_PAD = 4, H_PAD = 4, W_PAD = 8;
};

// the width class of a layer width n (0 past kMaxWidth)
__host__ __device__ constexpr int width_class(int n) {
  return n < 1 ? 0 : n <= 64 ? 64 : n <= 128 ? 128 : n <= 256 ? 256 : n <= kMaxWidth ? 512 : 0;
}

// stacked rows (streams x samples) of a block of width class C
template <typename T, int C>
__host__ __device__ constexpr int tile_rows() {
  return std::is_same_v<T, float> && C < 256 ? 128 : 32768 / C;
}

// weight rows per ring stage: two mma depths
template <typename T, int C>
__host__ __device__ constexpr int tile_kt() {
  return std::is_same_v<T, float> ? 16 : 32;
}

// stages of the weight ring: three, two for f32 at C = 512 (64 rows of h
// take 132 kB; tiles of 8 rows in three stages spilled 24 bytes of the
// K=3 body)
template <typename T, int C>
__host__ __device__ constexpr int tile_stages() {
  return std::is_same_v<T, float> && C >= 512 ? 2 : 3;
}

// the warp tiling of a block: RT m16 tiles (MT per stream) of a sample
// slice by WC columns (NI n8 tiles) per warp, NSL sample slices x NCG
// column bands over the 8 warps; every warp holds all S streams of its
// samples
template <typename T, int K, int C>
struct TileGeo {
  static constexpr int S = K + 1;
  static constexpr int ROWS = tile_rows<T, C>();
  static constexpr int TM = ROWS / S;  // samples per block
  static constexpr int RT_MIN = ROWS / 128 > 2 ? ROWS / 128 : 2;
  static constexpr int RT = S > RT_MIN ? S : RT_MIN;
  static constexpr int MT = RT / S;
  static constexpr int WC = ROWS * C / 128 / RT;
  static constexpr int NCG = C / WC;
  static constexpr int NSL = (kTcTileThreads / 32) / NCG;
  static constexpr int NI = WC / 8;
  static_assert(ROWS % S == 0 && RT == S * MT && NSL * NCG == kTcTileThreads / 32 &&
                    NSL * 16 * MT == TM && WC % 16 == 0 && RT * NI * 4 == ROWS * C / 256,
                "tile geometry");
};

// post-skip layer inputs (TileArgs::split)
constexpr int kSplitSegFirst = 1;     // [seg0, h]
constexpr int kSplitHiddenFirst = 2;  // [h, seg0]

// activations (template parameter ACT)
constexpr int kTanhExp = 0;
constexpr int kReLU = 1;
constexpr int kLeakyReLU = 2;
constexpr int kSoftplus = 3;
constexpr int kSigmoid = 4;
constexpr float kLeakySlope = 0.01f;

// f'' is identically zero (ReLU, LeakyReLU): the backwards form no f''
// term; tanhExp, Softplus and Sigmoid take the f'' routes
template <int ACT>
constexpr bool kZeroDeriv2 = ACT == kReLU || ACT == kLeakyReLU;
inline bool zero_deriv2(int act) { return act == kReLU || act == kLeakyReLU; }

// fn(std::integral_constant<int, ACT>{}) for the run-time activation code
// act; cudaErrorInvalidValue for any other code
template <typename F>
cudaError_t by_act(int act, F&& fn) {
  switch (act) {
    case kTanhExp: return fn(std::integral_constant<int, kTanhExp>{});
    case kReLU: return fn(std::integral_constant<int, kReLU>{});
    case kLeakyReLU: return fn(std::integral_constant<int, kLeakyReLU>{});
    case kSoftplus: return fn(std::integral_constant<int, kSoftplus>{});
    case kSigmoid: return fn(std::integral_constant<int, kSigmoid>{});
  }
  return cudaErrorInvalidValue;
}

// fn(std::integral_constant<int, P>{}) for the width class P of a layer
// width n; cudaErrorInvalidValue past kMaxWidth
template <typename F>
cudaError_t by_class(int n, F&& fn) {
  switch (width_class(n)) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    case 512: return fn(std::integral_constant<int, 512>{});
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
  int width;                   // N, every layer's output width (<= the class C)
  void* v_out;                 // [M, N], type T
  void* j_out;                 // [K, M, N], type T
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

// V consecutive elements (shared or device memory, aligned to V elements)
// as f32, and back rounded to T as from_f32 rounds, by vector loads and
// stores of V * sizeof(T) bytes (f32 V = 8: two 16-byte vectors; in shared
// memory the copy's own width: 16-byte lanes keep it free of bank
// conflicts)
template <int V>
__device__ __forceinline__ void vec_load(const float* e, float (&x)[V]) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(e)[0];
    const float4 b = reinterpret_cast<const float4*>(e)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(e);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(e);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = e[0];
  }
}
template <int V>
__device__ __forceinline__ void vec_store(float* e, const float (&x)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(e)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(e)[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(e) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(e) = make_float2(x[0], x[1]);
  } else {
    e[0] = x[0];
  }
}
template <int V>
__device__ __forceinline__ void vec_load(const __nv_bfloat16* e, float (&x)[V]) {
  if constexpr (V % 2 == 0) {
    uint32_t w[V / 2];
    if constexpr (V == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(e);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (V == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(e);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(e);
    }
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  } else {
    x[0] = __bfloat162float(e[0]);
  }
}
template <int V>
__device__ __forceinline__ void vec_store(__nv_bfloat16* e, const float (&x)[V]) {
  if constexpr (V % 2 == 0) {
    uint32_t w[V / 2];
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(e) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(e) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(e) = w[0];
    }
  } else {
    e[0] = __float2bfloat16_rn(x[0]);
  }
}


// V elements of a row at p as f32, n of them valid (zeros past n): one
// vec_load where `whole` (the row allows aligned V-element vectors) and
// n >= V, else element by element; store_n writes the n valid ones the
// same way. Every masked access to a row of any width goes through these.
template <int V, typename T>
__device__ __forceinline__ void load_n(const T* p, bool whole, int n, float (&x)[V]) {
  if (whole && n >= V) {
    vec_load<V>(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = e < n ? to_f32(p[e]) : 0.f;
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_n(T* p, bool whole, int n, const float (&x)[V]) {
  if (whole && n >= V) {
    vec_store<V>(p, x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < n) p[e] = from_f32<T>(x[e]);
  }
}

// tanhExp and its derivative, passing x through above 20
// (neddf_tpu/kernels/dual_mlp.py::_act_fns), and f'' where ddf is given
// (from the same e^x and tanh)
__device__ __forceinline__ void tanh_exp(float x, float& f, float& df,
                                         float* ddf = nullptr) {
  if (x > 20.f) {
    f = x;
    df = 1.f;
    if (ddf) *ddf = 0.f;
    return;
  }
  const float ex = expf(x);
  const float tx = tanhf(ex);
  f = x * tx;
  df = tx - x * ex * (tx * tx - 1.f);
  if (ddf) *ddf = ex * (1.f - tx * tx) * (2.f + x - 2.f * x * ex * tx);
}

// the logistic sigmoid 1 / (1 + e^-x)
__device__ __forceinline__ float logistic(float x) { return 1.f / (1.f + expf(-x)); }

template <int ACT>
__device__ __forceinline__ void act_fn(float x, float& f, float& df) {
  if constexpr (ACT == kReLU) {
    f = fmaxf(x, 0.f);
    df = x > 0.f ? 1.f : 0.f;
  } else if constexpr (ACT == kLeakyReLU) {
    f = x >= 0.f ? x : kLeakySlope * x;
    df = x >= 0.f ? 1.f : kLeakySlope;
  } else if constexpr (ACT == kSoftplus) {
    // log(1 + e^x) with f' = sigmoid(x) = e^x / (1 + e^x) (one exp for
    // both), passing x through above 20
    if (x > 20.f) {
      f = x;
      df = 1.f;
    } else {
      const float ex = expf(x);
      f = log1pf(ex);
      df = ex / (1.f + ex);
    }
  } else if constexpr (ACT == kSigmoid) {
    f = logistic(x);
    df = f * (1.f - f);
  } else {
    tanh_exp(x, f, df);
  }
}

// f and f' for a run-time activation code (neddf_epilogue.cu's density,
// one scalar per row: not worth an instantiation per code)
__device__ __forceinline__ void act_fn_code(int act, float x, float& f, float& df) {
  switch (act) {
    case kReLU: act_fn<kReLU>(x, f, df); break;
    case kLeakyReLU: act_fn<kLeakyReLU>(x, f, df); break;
    case kSoftplus: act_fn<kSoftplus>(x, f, df); break;
    case kSigmoid: act_fn<kSigmoid>(x, f, df); break;
    default: act_fn<kTanhExp>(x, f, df);
  }
}

// f, f' and f'' for the backward kernels (dual_mlp_bwd.cu, sdf_mlp.cu,
// route_products.cu); tanhExp's three from one e^x and one tanh
template <int ACT>
__device__ __forceinline__ void act_fn3(float x, float& f, float& df, float& ddf) {
  if constexpr (ACT == kTanhExp) {
    tanh_exp(x, f, df, &ddf);
    return;
  }
  act_fn<ACT>(x, f, df);
  if constexpr (kZeroDeriv2<ACT>) {
    ddf = 0.f;
  } else if constexpr (ACT == kSoftplus) {
    ddf = x > 20.f ? 0.f : df * (1.f - df);  // s (1 - s) with s = f'
  } else if constexpr (ACT == kSigmoid) {
    ddf = df * (1.f - 2.f * f);  // s (1 - s) (1 - 2 s)
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

// the layer's input pieces: (from x0 or h, width, first weight row); the
// hidden piece is the N = a.width columns of h
__host__ __device__ __forceinline__ int layer_pieces(const TileArgs& a, int l, bool from_x0[2],
                                                     int width[2], int wrow[2]) {
  const int w0 = a.seg_w[0];
  const int n = a.width;
  if (l == 0) {
    from_x0[0] = true; width[0] = x0_width(a); wrow[0] = 0;
    return 1;
  }
  if (a.split[l] == kSplitSegFirst) {
    from_x0[0] = true; width[0] = w0; wrow[0] = 0;
    from_x0[1] = false; width[1] = n; wrow[1] = w0;
    return 2;
  }
  if (a.split[l] == kSplitHiddenFirst) {
    from_x0[0] = false; width[0] = n; wrow[0] = 0;
    from_x0[1] = true; width[1] = w0; wrow[1] = n;
    return 2;
  }
  from_x0[0] = false; width[0] = n; wrow[0] = 0;
  return 1;
}

// weight tiles of the body's schedule: every layer, each layer's pieces,
// KT rows at a time
template <int KT>
__host__ __device__ inline int weight_tile_count(const TileArgs& a) {
  int n = 0;
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int np = layer_pieces(a, l, from_x0, width, wrow);
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
  constexpr size_t kRows = tile_rows<T, C>();
  const size_t x0 = kRows * x0_pitch<T>(a);
  const size_t h = kRows * h_pitch<T, C>();
  if (has_split(a)) return x0 + h;
  return x0 > h ? x0 : h;
}

// elements of the weight ring: tile_stages tiles of KT padded rows
template <typename T, int C>
__host__ __device__ constexpr size_t wt_elems() {
  return (size_t)tile_stages<T, C>() * tile_kt<T, C>() * w_pitch<T, C>();
}

// bytes of the block's shared buffers: x0 and h, the weight ring and the
// weight schedule
template <typename T, int C>
__host__ __device__ inline size_t smem_bytes(const TileArgs& a) {
  return (act_elems<T, C>(a) + wt_elems<T, C>()) * sizeof(T) +
         weight_tile_count<tile_kt<T, C>()>(a) * sizeof(WeightTile<T>);
}

// tile t of the weight schedule (every layer, each layer's pieces, KT rows
// at a time): its first row and its rows inside the piece; false past the
// last tile. Weight rows are N = a.width elements apart.
template <int KT, typename T>
__device__ __forceinline__ bool weight_tile(const TileArgs& a, int t, const T*& src,
                                            int& rows) {
  for (int l = 0; l < a.n_layers; ++l) {
    bool from_x0[2];
    int width[2], wrow[2];
    const int n = layer_pieces(a, l, from_x0, width, wrow);
    for (int pc = 0; pc < n; ++pc) {
      const int tiles = (width[pc] + KT - 1) / KT;
      if (t < tiles) {
        src = static_cast<const T*>(a.w[l]) + (size_t)(wrow[pc] + t * KT) * a.width;
        rows = min(KT, width[pc] - t * KT);
        return true;
      }
      t -= tiles;
    }
  }
  return false;
}

// copy the rows of one weight tile (rows of n elements from src) into dst
// (row pitch WP, C columns), V elements per copy: 16-, 8- or 4-byte
// cp.async (V * sizeof(T) >= 4) or single bf16 elements; rows past `rows`
// and columns past n are zeros
template <typename T, int C, int KT, int WP, int V>
__device__ __forceinline__ void copy_weight_rows(const T* src, int rows, int n, T* dst) {
  constexpr int E = (int)sizeof(T);
  constexpr int CPR = C / V;  // copies per row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < KT * CPR; idx += kTcTileThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int valid = r < rows ? max(0, min(V, n - c)) : 0;
    if constexpr (V * E >= 4) {
      cp_async<V * E>(smem_u32(dst + r * WP + c), valid > 0 ? src + (size_t)r * n + c : src,
                      valid * E);
    } else {
      dst[r * WP + c] = valid > 0 ? src[(size_t)r * n + c] : from_f32<T>(0.f);
    }
  }
}

// copy weight tile t of the schedule into ring slot dst (rows past the
// piece and columns past N are zeros); nothing past the last tile. The
// copy width follows N: 16 bytes where a row is a whole number of them
// (the weights are 16-byte aligned), else 4 bytes (f32, or bf16 at an even
// N), else single bf16 elements
template <typename T, int C>
__device__ __forceinline__ void load_weight_tile(const WeightTile<T>* sched, int n_tiles, int t,
                                                 int n, T* dst) {
  if (t >= n_tiles) return;
  constexpr int E = (int)sizeof(T);
  constexpr int KT = tile_kt<T, C>();
  constexpr int WP = w_pitch<T, C>();
  const T* src = sched[t].src;
  const int rows = sched[t].rows;
  if ((n * E) % 16 == 0) {
    copy_weight_rows<T, C, KT, WP, 16 / E>(src, rows, n, dst);
  } else if ((n * E) % 4 == 0) {
    copy_weight_rows<T, C, KT, WP, 4 / E>(src, rows, n, dst);
  } else {
    copy_weight_rows<T, C, KT, WP, 1>(src, rows, n, dst);
  }
}

// stage segment s of the layer-0 input into x0's columns at dst (row pitch
// xp), V elements per load (the rows' alignment allows it); tangent rows
// of a segment without tangents, and rows past M, are zeros
template <typename T, int V, int K, int ROWS>
__device__ __forceinline__ void stage_segment(const TileArgs& a, int s, T* dst, int xp, int m0,
                                              int M) {
  using Elem = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  constexpr int BYTES = V * (int)sizeof(T);
  using Vec = std::conditional_t<BYTES == 16, uint4, std::conditional_t<BYTES == 8, uint2, Elem>>;
  constexpr int TM = ROWS / (K + 1);
  const int w = a.seg_w[s];
  const int cpr = w / V;  // loads per row
  const T* sv = static_cast<const T*>(a.seg_v[s]);
  const T* sj = static_cast<const T*>(a.seg_j[s]);
  Elem* de = reinterpret_cast<Elem*>(dst);
  for (int idx = threadIdx.x; idx < ROWS * cpr; idx += kTcTileThreads) {
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

// the rows of streams [st_begin, st_end) of the block's tile in h (pitch
// HP, row st * TM + i: stream st of sample m0 + i) to device memory, row
// (st, m) at dst + ((st - st0) * M + m) * N, the columns < N and the rows
// < M only: a cooperative pass, 16-byte vectors where a row of N elements
// is a whole number of them, else element by element. Per-thread stores
// of the accumulators at a run-time row stride cost the K=3 bodies their
// registers (ptxas spilled 300-870 bytes): the accumulators go through h
// (compile-time pitch) and leave from there.
template <typename T, int C, int HP, int TM>
__device__ __forceinline__ void store_rows(const T* h, int st_begin, int st_end, T* dst,
                                           int st0, int M, int N, int m0) {
  constexpr int E = (int)sizeof(T);
  constexpr int V = 16 / E;
  constexpr int CPR = C / V;  // vectors per row
  const bool vec = (N * E) % 16 == 0;
  const int rows = (st_end - st_begin) * TM;
#pragma unroll 1
  for (int idx = threadIdx.x; idx < rows * CPR; idx += kTcTileThreads) {
    const int rr = idx / CPR;
    const int c = (idx - rr * CPR) * V;
    const int st = st_begin + rr / TM;
    const int i = rr % TM;
    const int m = m0 + i;
    if (m >= M || c >= N) continue;
    const T* src = h + (size_t)(st * TM + i) * HP + c;
    T* d = dst + ((size_t)(st - st0) * M + m) * N + c;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e < N) d[e] = src[e];
    }
  }
}

// The whole trunk on one row tile: x0, h and wt are the block's shared
// buffers (tile_buffers, smem_bytes); the last layer goes to a.v_out /
// a.j_out.
template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward_tc(const TileArgs& a, T* x0, T* h, T* wt) {
  using Sh = TileShape<T>;
  using G = TileGeo<T, K, C>;
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int E = (int)sizeof(T);
  constexpr int S = G::S;
  constexpr int TM = G::TM;    // samples per block
  constexpr int MT = G::MT;    // m16 tiles per stream and warp
  constexpr int RT = G::RT;    // m16 tiles per warp
  constexpr int NCG = G::NCG;  // column bands
  constexpr int WC = G::WC;    // columns per warp
  constexpr int NI = G::NI;    // n8 tiles per warp
  constexpr int HP = h_pitch<T, C>();
  constexpr int WP = w_pitch<T, C>();
  constexpr int KT = tile_kt<T, C>();
  constexpr int WSLOT = KT * WP;

  const int x0w = x0_width(a);
  const int xp = x0_pitch<T>(a);
  const int N = a.width;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = warp / NCG;   // sample slice
  const int cg = warp % NCG;  // column band
  const int m0 = blockIdx.x * TM;
  const int M = a.M;

  // the weight schedule (after the ring), one entry per tile
  WeightTile<T>* sched = reinterpret_cast<WeightTile<T>*>(wt + wt_elems<T, C>());
  const int n_tiles = weight_tile_count<KT>(a);
  for (int i = tid; i < n_tiles; i += kTcTileThreads) {
    const T* src;
    int rows;
    weight_tile<KT>(a, i, src, rows);
    sched[i].src = src;
    sched[i].rows = rows;
  }
  __syncthreads();
  // the first weight tiles start loading while x0 is staged
  constexpr int NST = tile_stages<T, C>();
  for (int s = 0; s < NST - 1; ++s) {
    load_weight_tile<T, C>(sched, n_tiles, s, N, wt + s * WSLOT);
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
        stage_segment<T, 16 / E, K, G::ROWS>(a, s, dst, xp, m0, M);
      } else if (align % 8 == 0) {
        stage_segment<T, 8 / E, K, G::ROWS>(a, s, dst, xp, m0, M);
      } else {
        stage_segment<T, 1, K, G::ROWS>(a, s, dst, xp, m0, M);
      }
      off += w;
    }
    const int pad = xp - x0w;
    for (int idx = tid; idx < G::ROWS * pad; idx += kTcTileThreads) {
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
    const int n_pieces = layer_pieces(a, l, from_x0, width, wrow);
    for (int pc = 0; pc < n_pieces; ++pc) {
      const int pitch = from_x0[pc] ? xp : HP;
      // this lane's ldmatrix row of stream 0 (A: rows of 16 samples, lanes
      // 0-15 at column 0, lanes 16-31 16 bytes on), as a 32-bit
      // shared-memory address
      const uint32_t a_lane = smem_u32(from_x0[pc] ? x0 : h) +
                              E * ((q * 16 * MT + (lane & 15)) * pitch) + (lane >> 4) * 16;
      for (int k0 = 0; k0 < width[pc]; k0 += KT, ++t) {
        cp_async_wait<NST - 2>();
        __syncthreads();  // tile t has landed; slot t-1 is free
        load_weight_tile<T, C>(sched, n_tiles, t + NST - 1, N,
                               wt + ((t + NST - 1) % NST) * WSLOT);
        cp_async_commit();
        const int slot = t % NST;
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

    // epilogue: bias on the values; the stash z through h (store_rows);
    // values f(z), tangents f'(z_v) z_t into h, and from there the last
    // layer's outputs. The columns past N have z = 0 (zero weights and
    // bias) and are not stored
    const bool last = (l == a.n_layers - 1);
    T* pre = static_cast<T*>(a.stash[l]);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = cg * WC + ni * 8 + 2 * tq;
      const float b0 = col < N ? a.b[l][col] : 0.f;
      const float b1 = col + 1 < N ? a.b[l][col + 1] : 0.f;
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) {
        // acc[st * MT + mt][ni][e0, e0 + 1] holds stream st of sample i
        const int mt = r >> 1, e0 = 2 * (r & 1);
        acc[mt][ni][e0] += b0;
        acc[mt][ni][e0 + 1] += b1;
        if (pre != nullptr) {
          const int i = (q * MT + mt) * 16 + g + 8 * (r & 1);
#pragma unroll
          for (int st = 0; st < S; ++st)
            store2(h + (size_t)(st * TM + i) * HP + col, acc[st * MT + mt][ni][e0],
                   acc[st * MT + mt][ni][e0 + 1]);
        }
      }
    }
    if (pre != nullptr) {
      __syncthreads();  // z is in h
      store_rows<T, C, HP, TM>(h, 0, S, pre, 0, M, N, m0);
      __syncthreads();  // every z has left before h takes f(z)
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = cg * WC + ni * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2 * MT; ++r) {
        // in place: f(z_v) and f'(z_v) z_t
        const int mt = r >> 1, e0 = 2 * (r & 1);
        const int i = (q * MT + mt) * 16 + g + 8 * (r & 1);
#pragma unroll
        for (int e = e0; e < e0 + 2; ++e) {
          float f, df;
          act_fn<ACT>(acc[mt][ni][e], f, df);
          acc[mt][ni][e] = f;
#pragma unroll
          for (int st = 1; st < S; ++st) acc[st * MT + mt][ni][e] *= df;
        }
#pragma unroll
        for (int st = 0; st < S; ++st)
          store2(h + (size_t)(st * TM + i) * HP + col, acc[st * MT + mt][ni][e0],
                 acc[st * MT + mt][ni][e0 + 1]);
      }
    }
    __syncthreads();  // h is complete before the next layer (or the output pass) reads it
    if (last) {
      store_rows<T, C, HP, TM>(h, 0, 1, static_cast<T*>(a.v_out), 0, M, N, m0);
      if (S > 1) store_rows<T, C, HP, TM>(h, 1, S, static_cast<T*>(a.j_out), 1, M, N, m0);
    }
  }
  cp_async_wait<0>();
}

// the block's shared buffers: x0, then h (or h over x0), then wt
template <typename T, int C>
__device__ __forceinline__ void tile_buffers(const TileArgs& a, unsigned char* raw,
                                             T*& x0, T*& h, T*& wt) {
  T* smem = reinterpret_cast<T*>(raw);
  x0 = smem;
  h = has_split(a) ? smem + (size_t)tile_rows<T, C>() * x0_pitch<T>(a) : smem;
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
  if (width_class(a.width) != C) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, C>(a);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tile_fwd<T, K, C, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int TM = TileGeo<T, K, C>::TM;
  const int grid = (a.M + TM - 1) / TM;
  mlp_tile_fwd<T, K, C, ACT><<<grid, kTcTileThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The row-tile forward of operand type T (dtype 1 bf16, 0 f32) over the
// width class of a.width, K = n_tan tangent planes (3, 1 or 0) and the
// activation code act: csrc/tile_fwd.cu, compiled once per (type, class)
// (kernels/_build.py) so that the instantiations build in parallel.
extern "C" int neddf_tile_fwd_bf16_64(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_bf16_128(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_bf16_256(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_bf16_512(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_f32_64(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_f32_128(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_f32_256(int n_tan, int act, const TileArgs* a, void* stream);
extern "C" int neddf_tile_fwd_f32_512(int n_tan, int act, const TileArgs* a, void* stream);

inline int tile_fwd(int dtype, int n_tan, int act, const TileArgs& a, cudaStream_t stream) {
  void* s = static_cast<void*>(stream);
  const bool bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (width_class(a.width)) {
    case 64: return bf16 ? neddf_tile_fwd_bf16_64(n_tan, act, &a, s)
                         : neddf_tile_fwd_f32_64(n_tan, act, &a, s);
    case 128: return bf16 ? neddf_tile_fwd_bf16_128(n_tan, act, &a, s)
                          : neddf_tile_fwd_f32_128(n_tan, act, &a, s);
    case 256: return bf16 ? neddf_tile_fwd_bf16_256(n_tan, act, &a, s)
                          : neddf_tile_fwd_f32_256(n_tan, act, &a, s);
    case 512: return bf16 ? neddf_tile_fwd_bf16_512(n_tan, act, &a, s)
                          : neddf_tile_fwd_f32_512(n_tan, act, &a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace neddf
