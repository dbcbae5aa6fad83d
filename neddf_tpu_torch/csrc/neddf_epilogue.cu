// NeDDF head/density/penalty epilogue, forward and backward, for sm_90a.
//
// Replaces the Pallas kernels neddf_tpu/kernels/neddf_epilogue.py::
// _run_fwd:329 (body _fwd_kernel:161) and _run_bwd:365 (body
// _bwd_kernel:183). Math and stop-gradient placements: see the Python
// wrapper kernels/neddf_epilogue.py, whose plain versions this mirrors.
//
// Design: one warp per sample row. At C = 256 a lane holds 8 columns of
// each of the 4 streams (v, j0, j1, j2) in registers; the 8 head dots
// (4 streams x 2 heads) are warp shuffle reductions, every lane then has
// the row's scalars and the per-row math runs redundantly in f32 on all
// lanes (no shared memory, no divergence). The stream and the head
// weights are rounded to the compute dtype T before the dots, sums in
// f32 (_heads:103-112). The forward writes the 10 per-row outputs as
// [10, M] f32 (row k = quantity k, coalesced across warps) and t_feat.
// The backward recomputes the heads (it reads the streams anyway), forms
// the head cotangents, writes dv / dj and accumulates dwd, dwa, db2 per
// lane across the block's rows; the block's 8 warps are then summed in a
// fixed order into one partial per block, and neddf_sum_splits
// (dual_mlp_bwd.cu) sums the partials in a fixed order: no atomics, the
// result is bitwise reproducible.
//
// What bounds it on the H100: ~2 KB (bf16) of stream reads per row
// against ~4 kFLOP: device-memory bandwidth (3.35 TB/s).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;
constexpr int kPerLane = kC / 32;
constexpr int kWarps = 8;
constexpr int kOut = 10;

__device__ __forceinline__ void load8(const float* p, float o[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float o[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(q[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float softplusf(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float relu(float x) { return x > 0.f ? x : 0.f; }
__device__ __forceinline__ float step(float x) { return x > 0.f ? 1.f : 0.f; }

// the forward quantities of one row (_epilogue_math:115)
struct Row {
  float ddf_out, aux_out, hj1[3], hj2[3], spd, distance, dg[3], sig_a, aux,
      auxd, agg[3], dgn, d_ddt, dinv, density, inv, norm[3], d2, rest, ag_scale,
      pen;
};

__device__ __forceinline__ Row row_math(const float h1[4], const float h2[4],
                                        const float* b2, const float* scal) {
  Row r;
  const float d_near = scal[0], ags = scal[1], drmax = scal[2];
  r.ddf_out = h1[0] + b2[0];
  r.aux_out = h2[0] + b2[1];
  r.spd = sigmoidf(r.ddf_out);
  r.distance = softplusf(r.ddf_out) + d_near;
  r.sig_a = sigmoidf(r.aux_out);
  r.aux = ags * r.sig_a;
  r.auxd = ags * r.sig_a * (1.f - r.sig_a);
  float grad_sq = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.hj1[a] = h1[1 + a];
    r.hj2[a] = h2[1 + a];
    r.dg[a] = r.spd * r.hj1[a];
    r.agg[a] = r.auxd * r.hj2[a];
    grad_sq += r.dg[a] * r.dg[a];
  }
  r.dgn = sqrtf(grad_sq);
  r.d_ddt = sqrtf(grad_sq + r.aux * r.aux);
  r.dinv = 1.f / r.distance;
  r.density = relu(r.dinv * (1.f - r.d_ddt));
  r.inv = 1.f / (r.dgn + 1e-7f);
  r.d2 = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.norm[a] = r.dg[a] * r.inv;
    r.d2 += r.agg[a] * r.norm[a];
  }
  r.rest = 3.f * r.aux * r.dinv;
  r.ag_scale = r.aux * r.dgn * r.distance;
  const float diff = r.d2 - r.rest;
  const float p1 = r.ag_scale * diff * diff;
  const float q2 = relu(r.d_ddt - 1.f);
  const float q3 = relu(-4.6f - r.ddf_out) + relu(r.ddf_out - drmax);
  const float q4 = relu(-4.6f - r.aux_out) + relu(r.aux_out - 4.6f);
  r.pen = scal[3] * p1 + scal[4] * q2 * q2 + scal[5] * q3 * q3 + scal[6] * q4 * q4;
  return r;
}

// loads a row's 4 streams (x), the rounded head weights, and the heads
template <typename T>
__device__ __forceinline__ void load_heads(int M, int m, int lane, const T* v,
                                           const T* j, const float wdr[8],
                                           const float war[8], float x[4][8],
                                           float h1[4], float h2[4]) {
  const int c0 = lane * kPerLane;
  load8(v + (size_t)m * kC + c0, x[0]);
#pragma unroll
  for (int a = 0; a < 3; ++a) load8(j + ((size_t)a * M + m) * kC + c0, x[1 + a]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float p1 = 0.f, p2 = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      p1 = fmaf(x[s][e], wdr[e], p1);
      p2 = fmaf(x[s][e], war[e], p2);
    }
    h1[s] = warp_sum(p1);
    h2[s] = warp_sum(p2);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    epi_fwd_kernel(int M, const T* __restrict__ v, const T* __restrict__ j,
                   const float* __restrict__ wd, const float* __restrict__ wa,
                   const float* __restrict__ b2, const float* __restrict__ scal,
                   float* __restrict__ out, T* __restrict__ t_feat) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  const int c0 = lane * kPerLane;
  float wdr[8], war[8];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    wdr[e] = round_to<T>(wd[c0 + e]);
    war[e] = round_to<T>(wa[c0 + e]);
  }
  float x[4][8], h1[4], h2[4];
  load_heads<T>(M, m, lane, v, j, wdr, war, x, h1, h2);
  const Row r = row_math(h1, h2, b2, scal);
  if (lane == 0) {
    const float vals[kOut] = {r.density, r.distance, r.aux,    r.norm[0], r.norm[1],
                              r.norm[2], r.dg[0],    r.dg[1], r.dg[2],   r.pen};
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[(size_t)k * M + m] = vals[k];
  }
  float tf[8];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    tf[e] = x[1][e] * r.dg[0] + x[2][e] * r.dg[1] + x[3][e] * r.dg[2];
  store8(t_feat + (size_t)m * kC + c0, tf);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    epi_bwd_kernel(int M, int rows_per_block, const T* __restrict__ v,
                   const T* __restrict__ j, const float* __restrict__ wd,
                   const float* __restrict__ wa, const float* __restrict__ b2,
                   const float* __restrict__ scal, const float* __restrict__ g_out,
                   const T* __restrict__ g_tfeat, T* __restrict__ dv,
                   T* __restrict__ dj, float* __restrict__ parts) {
  __shared__ float red[kWarps][2 * kC + 2];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c0 = lane * kPerLane;
  const float ags = scal[1], drmax = scal[2];
  const float w_ag = scal[3], w_ddt = scal[4], w_rd = scal[5], w_ra = scal[6];
  float wdr[8], war[8], wdf[8], waf[8];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    wdf[e] = wd[c0 + e];
    waf[e] = wa[c0 + e];
    wdr[e] = round_to<T>(wdf[e]);
    war[e] = round_to<T>(waf[e]);
  }
  float dwd[8] = {}, dwa[8] = {}, db0 = 0.f, db1 = 0.f;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  for (int m = m0 + warp; m < m1; m += kWarps) {
    float x[4][8], h1[4], h2[4];
    load_heads<T>(M, m, lane, v, j, wdr, war, x, h1, h2);
    const Row r = row_math(h1, h2, b2, scal);
    const float g_dens = g_out[m], g_dist_ext = g_out[(size_t)M + m];
    const float g_aux_ext = g_out[2 * (size_t)M + m];
    const float g_pen = g_out[9 * (size_t)M + m];

    const float g_diff = g_pen * w_ag * r.ag_scale * 2.f * (r.d2 - r.rest);
    float g_agg[3], g_norm_int[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g_agg[a] = g_diff * r.norm[a];
      g_norm_int[a] = g_diff * r.agg[a];
    }
    float g_aux = -g_diff * 3.f * r.dinv;
    float g_dddt = g_pen * w_ddt * 2.f * relu(r.d_ddt - 1.f);
    const float r3 = relu(-4.6f - r.ddf_out) + relu(r.ddf_out - drmax);
    float g_ddf_out = g_pen * w_rd * 2.f * r3 *
                      (step(r.ddf_out - drmax) - step(-4.6f - r.ddf_out));
    const float r4 = relu(-4.6f - r.aux_out) + relu(r.aux_out - 4.6f);
    float g_aux_out = g_pen * w_ra * 2.f * r4 *
                      (step(r.aux_out - 4.6f) - step(-4.6f - r.aux_out));
    const float u = r.dinv * (1.f - r.d_ddt);
    const float g_u = g_dens * step(u);
    const float g_dinv = g_u * (1.f - r.d_ddt);
    g_dddt -= g_u * r.dinv;
    g_aux += g_aux_ext;
    const float inv_dddt = 1.f / fmaxf(r.d_ddt, 1e-12f);
    float g_grad_sq = g_dddt * 0.5f * inv_dddt;
    g_aux += g_dddt * r.aux * inv_dddt;
    float g_dg[3];
    float dot = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g_dg[a] = g_norm_int[a] * r.inv;
      dot += g_norm_int[a] * r.dg[a];
    }
    const float g_dgn = -dot * r.inv * r.inv;
    g_grad_sq += g_dgn * 0.5f / fmaxf(r.dgn, 1e-12f);
    const float g_dist = g_dist_ext - g_dinv * r.dinv * r.dinv;
    float g_h1[4], g_h2[4], g_auxd = 0.f, g_spd = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g_dg[a] += 2.f * r.dg[a] * g_grad_sq;
      g_h2[1 + a] = g_agg[a] * r.auxd;
      g_auxd += g_agg[a] * r.hj2[a];
      g_h1[1 + a] = g_dg[a] * r.spd;
      g_spd += g_dg[a] * r.hj1[a];
    }
    g_aux_out += g_auxd * ags * r.sig_a * (1.f - r.sig_a) * (1.f - 2.f * r.sig_a);
    g_aux_out += g_aux * r.auxd;
    g_ddf_out += g_spd * r.spd * (1.f - r.spd);
    g_ddf_out += g_dist * r.spd;
    g_h1[0] = g_ddf_out;
    g_h2[0] = g_aux_out;

    float gt[8], o[8];
    load8(g_tfeat + (size_t)m * kC + c0, gt);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        o[e] = g_h1[s] * wdf[e] + g_h2[s] * waf[e];
        if (s > 0) o[e] += gt[e] * r.dg[s - 1];
        dwd[e] = fmaf(x[s][e], g_h1[s], dwd[e]);
        dwa[e] = fmaf(x[s][e], g_h2[s], dwa[e]);
      }
      if (s == 0)
        store8(dv + (size_t)m * kC + c0, o);
      else
        store8(dj + ((size_t)(s - 1) * M + m) * kC + c0, o);
    }
    db0 += g_ddf_out;
    db1 += g_aux_out;
  }
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    red[warp][c0 + e] = dwd[e];
    red[warp][kC + c0 + e] = dwa[e];
  }
  if (lane == 0) {
    red[warp][2 * kC] = db0;
    red[warp][2 * kC + 1] = db1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kC + 2; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][i];
    parts[(size_t)blockIdx.x * (2 * kC + 2) + i] = s;
  }
}

}  // namespace

extern "C" int neddf_epilogue_fwd(int dtype, int M, const void* v, const void* j,
                                  const void* wd, const void* wa, const void* b2,
                                  const void* scal, void* out, void* t_feat,
                                  void* stream) {
  if (M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (M + kWarps - 1) / kWarps;
  const float* f_wd = static_cast<const float*>(wd);
  const float* f_wa = static_cast<const float*>(wa);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_sc = static_cast<const float*>(scal);
  float* o = static_cast<float*>(out);
  if (dtype == 1)
    epi_fwd_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        M, static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(j),
        f_wd, f_wa, f_b2, f_sc, o, static_cast<__nv_bfloat16*>(t_feat));
  else
    epi_fwd_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        M, static_cast<const float*>(v), static_cast<const float*>(j), f_wd, f_wa,
        f_b2, f_sc, o, static_cast<float*>(t_feat));
  return (int)cudaGetLastError();
}

extern "C" int neddf_epilogue_bwd(int dtype, int M, int rows_per_block, const void* v,
                                  const void* j, const void* wd, const void* wa,
                                  const void* b2, const void* scal, const void* g_out,
                                  const void* g_tfeat, void* dv, void* dj, void* parts,
                                  void* stream) {
  if (M <= 0 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (M + rows_per_block - 1) / rows_per_block;
  const float* f_wd = static_cast<const float*>(wd);
  const float* f_wa = static_cast<const float*>(wa);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_sc = static_cast<const float*>(scal);
  const float* f_g = static_cast<const float*>(g_out);
  float* p = static_cast<float*>(parts);
  if (dtype == 1)
    epi_bwd_kernel<__nv_bfloat16><<<grid, kWarps * 32, 0, s>>>(
        M, rows_per_block, static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(j), f_wd, f_wa, f_b2, f_sc, f_g,
        static_cast<const __nv_bfloat16*>(g_tfeat), static_cast<__nv_bfloat16*>(dv),
        static_cast<__nv_bfloat16*>(dj), p);
  else
    epi_bwd_kernel<float><<<grid, kWarps * 32, 0, s>>>(
        M, rows_per_block, static_cast<const float*>(v), static_cast<const float*>(j),
        f_wd, f_wa, f_b2, f_sc, f_g, static_cast<const float*>(g_tfeat),
        static_cast<float*>(dv), static_cast<float*>(dj), p);
  return (int)cudaGetLastError();
}
