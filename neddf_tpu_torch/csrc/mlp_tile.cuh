// Row-tile MLP forward shared by the trunk kernels (dual_mlp_fwd.cu,
// mlp_fwd.cu, sdf_mlp.cu), and the activations the backward kernels share
// (mlp_bwd.cu, dual_mlp_bwd.cu, sdf_mlp.cu). Built by neddf_tpu_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// One block owns a tile of samples and runs EVERY layer of the MLP on it
// without writing an activation to device memory, as the Pallas kernels
// it replaces keep a row tile in VMEM across the layers:
//
// * the block stacks S = K+1 streams (the values and K tangent planes)
//   as kRows = S*TM rows, stream-major: row st*TM + i is stream st of
//   sample i. K=3 is the NeDDF distance trunk (d/dxyz planes), K=1 the
//   colour trunk's directional tangent (training), K=0 the value-only
//   colour trunk (eval). A segment without tangents stages zeros in its
//   tangent rows.
// * optionally (stash[l] != null) each layer's pre-activation stack
//   [S, M, C] (z with the bias on the value rows, before the activation)
//   is written rounded to T, for the backward (dual_mlp_bwd.cu).
// * the layer-0 input is staged once into shared memory as the concat of
//   the input segments (x0); its weight rows are read in place, so no
//   concat ever exists in device memory. A post-skip layer reads segment
//   0 again from x0 and the hidden state from h, in either order:
//   kSplitSegFirst ([seg0, h], NeDDF) or kSplitHiddenFirst ([h, seg0],
//   NeRF/NeuS), each piece against its own rows of W.
// * the hidden state h [kRows, C] lives in shared memory; weights stream
//   through shared memory kKTile rows at a time. Each thread keeps its
//   output sub-tile (SPT samples x S streams x 16 columns) in registers
//   for the whole K-loop, then all threads sync and write f(z) for the
//   value rows and f'(z_value) * z_tangent for the tangent rows back over
//   h, rounded to the storage type T (bf16 or f32).
// * the activation is a template parameter: tanhExp (kTanhExp) or ReLU
//   (kReLU, with f'(0) = 0 as neddf_tpu/kernels/dual_mlp.py::_act_fns
//   defines it).
// * arithmetic is plain FMA in f32 on the CUDA cores: operands are T
//   converted to f32, sums and activations are f32, the bias (f32) seeds
//   the value accumulators only.
//
// What bounds it on the H100: at C = 256 a stacked row costs
// 2*C*fan_in FLOPs per layer against 2*(C0 + C) bytes of input and output
// per sample stream, i.e. over a thousand FLOPs per byte of device
// memory: the kernel is bound by the FMA issue rate (67 TFLOP/s of f32 on
// the CUDA cores at 700 W) and by shared-memory loads (one 4-column weight
// vector and one activation per 4 FMAs of each accumulator group). The
// tensor cores (wgmma / mma.sync on bf16) are the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace neddf {

constexpr int kMaxSeg = 4;
constexpr int kMaxLayers = 12;
constexpr int kThreads = 512;
constexpr int kRows = 128;      // stacked rows (streams x samples) per block
constexpr int kColGroups = 16;  // threads across the output columns
constexpr int kKTile = 16;      // weight rows staged per step

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

// elements of the x0 + h region; without a post-skip layer h reuses x0,
// which is dead once layer 0 has read it
template <int C>
__host__ __device__ inline size_t act_elems(const TileArgs& a) {
  const size_t x0 = (size_t)kRows * x0_width(a);
  const size_t h = (size_t)kRows * C;
  if (has_split(a)) return x0 + h;
  return x0 > h ? x0 : h;
}

template <typename T, int C>
inline size_t smem_bytes(const TileArgs& a) {
  return (act_elems<C>(a) + (size_t)kKTile * C) * sizeof(T);
}

// The whole trunk on one row tile: x0, h and wt are the block's shared
// buffers (smem_bytes); the last layer goes to a.v_out / a.j_out.
template <typename T, int K, int C, int ACT>
__device__ __forceinline__ void tile_forward(const TileArgs& a, T* x0, T* h, T* wt) {
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
  h = has_split(a) ? smem + (size_t)kRows * x0_width(a) : smem;
  wt = smem + act_elems<C>(a);
}

template <typename T, int K, int C, int ACT>
__global__ void __launch_bounds__(kThreads, 1) mlp_tile_fwd(const TileArgs a) {
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
  mlp_tile_fwd<T, K, C, ACT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace neddf
