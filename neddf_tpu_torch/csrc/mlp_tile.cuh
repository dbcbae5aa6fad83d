// The row-tile forward's shared definitions, and the activations and
// helpers the other kernels share (mlp_bwd.cu, dual_mlp_bwd.cu,
// sdf_mlp.cu and its sweep, neddf_epilogue.cu, layer_fwd.cu,
// route_products.cu). Built by neddf_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// * TileArgs: a trunk call of the row-tile forward (tile_hopper.cuh's
//   mlp_tile_fwd, the Hopper design on wgmma + TMA): the input segments,
//   every layer's weights, biases, post-skip split and stash, the outputs;
//   tile_fwd picks the object of the call's operand type and width class
//   (csrc/tile_fwd.cu, one per pair).
// * Widths: every layer width N from 1 to kMaxWidth runs on the smallest
//   class C >= N of 64, 128, 256 and 512 (width_class).
// * The activations: tanhExp (kTanhExp), ReLU (kReLU, f'(0) = 0),
//   LeakyReLU (kLeakyReLU, slope 0.01, f'(0) = 1), Softplus (kSoftplus,
//   linear above 20) and Sigmoid (kSigmoid), as neddf_tpu/kernels/
//   dual_mlp.py::_act_fns defines them, with f' and f''.
// * SweepArgs: a call of the NeuS reverse sweep (sdf_sweep.cuh, on wgmma
//   + TMA), built per width class into csrc/tile_fwd.cu's f32 objects.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_ops.cuh"

namespace neddf {

constexpr int kMaxSeg = 4;
constexpr int kMaxLayers = 12;
constexpr int kMaxWidth = 512;  // the widest class

// the width class of a layer width n (0 past kMaxWidth)
__host__ __device__ constexpr int width_class(int n) {
  return n < 1 ? 0 : n <= 64 ? 64 : n <= 128 ? 128 : n <= 256 ? 256 : n <= kMaxWidth ? 512 : 0;
}

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
  void* stash[kMaxLayers];     // [S, M, N_l] pre-activations, type T, or null
  int n_layers;
  int M;
  int width;                   // N, every layer's output width (<= the class C) but the last's
  int last_width;              // the last layer's output width N_L (<= N)
  void* v_out;                 // [M, N_L], type T
  void* j_out;                 // [K, M, N_L], type T
  void* scratch;               // the plan's device scratch (f32: W^T's tf32 planes), or null
};

// a call of the NeuS reverse sweep (sdf_sweep.cuh): M rows, E = the
// input's width (the e rows of W at layer 0 and at each post-skip layer),
// N the width of every layer, L layers; W_l [fan_in_l, ld] (fan_in N, or
// N + E after a post-skip layer [h, e], or E at layer 0) and the stash z_l
// [M, ld] of the trunk's pre-activations, rows `ld` elements apart (N
// rounded up to whole 16-byte rows, zeros past N: TMA's rows); the output
// gE [M, E]; the plan's scratch (its parked outputs), or null
struct SweepArgs {
  int M, E, N, L;
  long long ld;
  const float* w[kMaxLayers];
  int split[kMaxLayers];
  const float* z[kMaxLayers];
  float* ge;
  void* scratch;
};

// the sweep of width class C (csrc/tile_fwd.cu's f32 objects), launched by
// the plan `plan` (sdf_sweep.cuh's sweep_ints, which the launcher
// recomputes and refuses where it differs)
#define NEDDF_SWEEP_DECL(c)                                                                \
  extern "C" int neddf_sdf_sweep_##c(int act, const SweepArgs* a, const int* plan,        \
                                     void* stream);
NEDDF_SWEEP_DECL(64)
NEDDF_SWEEP_DECL(128)
NEDDF_SWEEP_DECL(256)
NEDDF_SWEEP_DECL(512)
#undef NEDDF_SWEEP_DECL

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

template <int ACT>
__device__ __forceinline__ float dact(float x) {
  float f, df;
  act_fn<ACT>(x, f, df);
  return df;
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

// The row-tile forward of operand type T (dtype 1 bf16, 0 f32) over the
// width class of a.width, K = n_tan tangent planes (3, 1 or 0) and the
// activation code act, launched by the plan `plan` (tile_hopper.cuh's
// plan_ints, which the launcher recomputes and refuses where it differs):
// csrc/tile_fwd.cu, compiled once per (type, class) (kernels/_build.py) so
// that the instantiations build in parallel.
#define NEDDF_TILE_DECL(t, c)                                                             \
  extern "C" int neddf_tile_fwd_##t##_##c(int n_tan, int act, const TileArgs* a,         \
                                         const int* plan, void* stream);
NEDDF_TILE_DECL(bf16, 64)
NEDDF_TILE_DECL(bf16, 128)
NEDDF_TILE_DECL(bf16, 256)
NEDDF_TILE_DECL(bf16, 512)
NEDDF_TILE_DECL(f32, 64)
NEDDF_TILE_DECL(f32, 128)
NEDDF_TILE_DECL(f32, 256)
NEDDF_TILE_DECL(f32, 512)
#undef NEDDF_TILE_DECL

inline int tile_fwd(int dtype, int n_tan, int act, const TileArgs& a, const int* plan,
                    cudaStream_t stream) {
  void* s = static_cast<void*>(stream);
  const bool bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (width_class(a.width)) {
    case 64: return bf16 ? neddf_tile_fwd_bf16_64(n_tan, act, &a, plan, s)
                         : neddf_tile_fwd_f32_64(n_tan, act, &a, plan, s);
    case 128: return bf16 ? neddf_tile_fwd_bf16_128(n_tan, act, &a, plan, s)
                          : neddf_tile_fwd_f32_128(n_tan, act, &a, plan, s);
    case 256: return bf16 ? neddf_tile_fwd_bf16_256(n_tan, act, &a, plan, s)
                          : neddf_tile_fwd_f32_256(n_tan, act, &a, plan, s);
    case 512: return bf16 ? neddf_tile_fwd_bf16_512(n_tan, act, &a, plan, s)
                          : neddf_tile_fwd_f32_512(n_tan, act, &a, plan, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace neddf
