// NeDDF head/density/penalty epilogue, forward and backward, for sm_90a.
//
// Replaces the Pallas kernels neddf_tpu/kernels/neddf_epilogue.py::
// _run_fwd:329 (body _fwd_kernel:161) and _run_bwd:365 (body
// _bwd_kernel:183). Math and stop-gradient placements: see the Python
// wrapper kernels/neddf_epilogue.py, whose plain versions this mirrors.
//
// Forward (epi_fwd_kernel): one warp per sample row. At C = 256 a lane
// holds 8 columns of each of the 4 streams (v, j0, j1, j2) in registers
// (at C = 512 8 columns of each half);
// the 8 head dots (4 streams x 2 heads) are warp shuffle reductions, every
// lane then has the row's scalars and the per-row math runs redundantly
// in f32 on all lanes. The stream and the head weights are rounded to the
// compute dtype T before the dots, sums in f32 (_heads:103-112). It
// writes the 10 per-row outputs as [10, M] f32 (row k = quantity k) and
// t_feat.
//
// Backward (epi_bwd_kernel), the epilogue's second-order VJP, in two
// modes (template flag TOP):
// * standalone (neddf_epilogue_bwd): writes dv [M, C] and dj [3, M, C] in
//   T, for a caller of the epilogue on its own;
// * TOP (the training path, DDFTrunkEpilogue): also finishes the K=3
//   trunk's top layer. Per (row, column) it rounds dv and dj to T as the
//   standalone mode writes them, adds the colour trunk's cotangent of
//   v_feat as autograd's add in T does, gv = T(T(dv) + g_col), and applies
//   the top layer's stacked cotangent (gstack_kernel's math, dual_mlp_bwd.cu)
//   with the stash z [4, M, C]: G_v = gv f'(z_v) + f''(z_v) sum_a gj_a z_a,
//   G_a = gj_a f'(z_v), written as gs [4, M, C] in T, and sums the top
//   layer's db = sum_rows G_v. dv, dj and gv never reach device memory.
//   Under ReLU and LeakyReLU (f'' = 0) the tangent stash is not read;
//   tanhExp, Softplus and Sigmoid read it.
// Both modes sum dwd, dwa [C] and db2 [2] (and TOP the top db [C]) as one
// f32 partial per block, each summed over the block's tiles in a fixed
// order; neddf_sum_splits (dual_mlp_bwd.cu) sums the partials in a fixed
// order. No atomics: two runs give the same bits.
//
// What bounds it on the H100: device memory. Per row it must read the 4
// streams, g_tfeat, (TOP) g_col and the 4 planes of the stash (1 under
// f'' = 0) and write 4 planes: at 99,328 rows in bf16, 14 planes of 50.9
// MB, 0.213 ms at 3.35 TB/s (11 planes, 0.167 ms, under ReLU); ~4 kFLOP
// of head dots and a few hundred of scalar and activation math per row
// are far below the card's rate. What held the one-warp-per-row version
// back was latency: a warp loaded its row, then waited through the
// reductions and the dependent scalar chain before its next loads, with
// nothing else of its own in flight. The design here:
// * persistent blocks (as many as fit on the card) walk tiles of 8 rows
//   (4 at C > 256);
//   a ring of 2 shared-memory stages per block is filled by 16-byte
//   cp.async, each plane's rows of a tile one contiguous run, a commit
//   group and a barrier guarding each stage, so the copy of tile i+1
//   overlaps the math of tile i; two blocks per SM keep at least two
//   tiles' loads in flight per SM. The 4 g_out values a row needs are
//   loaded into registers one tile ahead.
// * phase a, per row: warp w takes row w of the tile with today's lane
//   mapping (a lane holds 8 consecutive columns; fmaf order, then the
//   butterfly), forms the 8 head dots from the staged tile and runs the
//   forward and backward scalar chain (row_math, row_vjp), and leaves
//   the row's head cotangents and grad D in shared memory;
// * phase b, per column: each thread owns 16-byte column vectors (one
//   row, 8 bf16 or 4 f32 columns; the same columns in every tile), every
//   access a 16-byte vector (where the width allows); it combines the row scalars with the head
//   weights, g_tfeat, g_col and the stash, writes dv / dj or gs, and keeps
//   dwd, dwa and the top db in registers across the block's tiles.
// Widths and the density. The kernels take any width C up to 512: a lane
// of the forward's warp and of phase a holds 8 consecutive columns of each
// 256-column chunk (one chunk up to C = 256, two at 512; at C = 256 the
// mapping, and so the order of the sums, of the 256-only kernels), with
// the columns past C read as zeros. The forward's loads and stores are
// unmasked 16-byte vectors where C is 256 or 512 (template flag FULL). The
// backward is compiled per width class P (64, 128, 256 or 512; a template
// parameter, so that its tile walks are loops of known length as in the
// 256-only kernel) and stages its planes at pitch P with the columns past
// C zero-filled (16-byte cp.async where a row of C elements allows it, else
// 4 bytes or single bf16 elements), in tiles of 8 rows (4 at P = 512, so
// that a stage stays within the shared memory of today's f32 tiles);
// phase b's vectors cover the P columns, its stores masked at C. Past
// C = 2048 (the per-layer route of a wider NeDDF) the staged row of the
// standalone mode (5 planes x C) outgrows shared memory, and the backward
// runs epi_bwd_wide_kernel instead: the forward's wide design, nothing
// staged (see there). The density activation (ReLU, LeakyReLU, Softplus,
// Sigmoid or tanhExp, the field's density_activation_type) is a run-time
// code: one scalar per row, applied in row_math and differentiated in
// row_vjp, so it does not multiply the instantiations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tile.cuh"
#include "tc_ops.cuh"

extern "C" int neddf_sum_splits(long long n, int splits, const void* parts, void* out,
                                void* stream);

namespace {

constexpr int kChunk = 256;  // columns of one lane mapping: 8 per lane
// the widest class of the backward's staged kernel: past the tile
// forward's 512 its standalone mode has the classes 1024 and 2048, and
// past 2048 it runs epi_bwd_wide_kernel; the forward loops over
// 256-column chunks past 512, at any width
constexpr int kMaxEpiWidth = 2048;

// the backward's width class of a width: the tile forward's classes up to
// 512, then 1024 and 2048 (0 past kMaxEpiWidth)
constexpr int epi_class(int n) {
  return n <= neddf::kMaxWidth ? neddf::width_class(n)
         : n <= 1024           ? 1024
         : n <= kMaxEpiWidth   ? 2048
                               : 0;
}
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kOut = 10;
// backward: rows per tile (at most one per warp in phase a), ring stages
// per block
constexpr int kMaxTileRows = kWarps;
constexpr int kStages = 2;
constexpr int kRowScalars = 12;  // g_h1[4], g_h2[4], grad D [3], a pad
// the planes of a stage, in order: v, j0..j2, g_tfeat; TOP: g_col, z_v,
// then (f'' != 0) z_0..z_2
constexpr int kPlaneGt = 4, kPlaneGc = 5, kPlaneZ = 6;
constexpr int kMaxPlanes = 10;

using neddf::load_n;
using neddf::store_n;
using neddf::vec_load;
using neddf::vec_store;

// one 16-byte vector: 8 bf16 or 4 f32 values
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(T);
};
// N f32 values (N a multiple of 4) by 16-byte loads
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    o[i] = a.x; o[i + 1] = a.y; o[i + 2] = a.z; o[i + 3] = a.w;
  }
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

// the forward quantities of one row (_epilogue_math:115); u the density's
// argument (1/D)(1 - |[grad D, aux]|), density = dact(u)
struct Row {
  float ddf_out, aux_out, hj1[3], hj2[3], spd, distance, dg[3], sig_a, aux,
      auxd, agg[3], dgn, d_ddt, dinv, u, density, d_density, inv, norm[3], d2, rest,
      ag_scale, pen;
};

__device__ __forceinline__ Row row_math(const float h1[4], const float h2[4],
                                        const float* b2, const float* scal, int dact) {
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
  r.u = r.dinv * (1.f - r.d_ddt);
  neddf::act_fn_code(dact, r.u, r.density, r.d_density);
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

// the head dots of one row from its 4 streams: x[k][s] the lane's 8
// columns of chunk k, fmaf over the lane's columns chunk by chunk, then
// the butterfly; wdr / war the rounded head weights at the same columns
template <int NCH>
__device__ __forceinline__ void head_dots(const float (&x)[NCH][8], const float (&wdr)[NCH][8],
                                          const float (&war)[NCH][8], float& h1, float& h2) {
  float p1 = 0.f, p2 = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p1 = fmaf(x[k][e], wdr[k][e], p1);
      p2 = fmaf(x[k][e], war[k][e], p2);
    }
  h1 = warp_sum(p1);
  h2 = warp_sum(p2);
}

// the backward's scalar chain of one row (_bwd_kernel:183-326): from the
// forward quantities and the cotangents of rows 0, 1, 2 and 9 of out, the
// cotangents of the 8 head dots (g_h1[0] and g_h2[0] are those of the two
// head outputs, whose sums are db2)
__device__ __forceinline__ void row_vjp(const Row& r, float g_dens, float g_dist_ext,
                                        float g_aux_ext, float g_pen, const float* scal,
                                        float g_h1[4], float g_h2[4]) {
  const float ags = scal[1], drmax = scal[2];
  const float w_ag = scal[3], w_ddt = scal[4], w_rd = scal[5], w_ra = scal[6];
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
  const float g_u = g_dens * r.d_density;
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
  float g_auxd = 0.f, g_spd = 0.f;
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
}

// one warp per row; NCH chunks of 256 columns (lane: 8 columns of each).
// FULL: C = 256 NCH, every lane's columns valid and 16-byte aligned, so
// the loads and stores are the unmasked vectors of the 256-only kernel;
// else masked at C
template <typename T, int NCH, bool FULL>
__global__ void __launch_bounds__(kWarps * 32)
    epi_fwd_kernel(int M, int C, int dact, const T* __restrict__ v, const T* __restrict__ j,
                   const float* __restrict__ wd, const float* __restrict__ wa,
                   const float* __restrict__ b2, const float* __restrict__ scal,
                   float* __restrict__ out, T* __restrict__ t_feat) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  if constexpr (FULL) C = NCH * kChunk;  // a constant for the addressing below
  const bool vec = FULL || C % 8 == 0;  // rows of whole 16-byte vectors (bf16; f32 two)
  float wdr[NCH][8], war[NCH][8], x[4][NCH][8];
  int n[NCH];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c0 = k * kChunk + lane * 8;
    n[k] = FULL ? 8 : max(0, min(8, C - c0));
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wdr[k][e] = e < n[k] ? round_to<T>(wd[c0 + e]) : 0.f;
      war[k][e] = e < n[k] ? round_to<T>(wa[c0 + e]) : 0.f;
    }
    load_n<8>(v + (size_t)m * C + c0, vec, n[k], x[0][k]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      load_n<8>(j + ((size_t)a * M + m) * C + c0, vec, n[k], x[1 + a][k]);
  }
  float h1[4], h2[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) head_dots<NCH>(x[s], wdr, war, h1[s], h2[s]);
  const Row r = row_math(h1, h2, b2, scal, dact);
  if (lane == 0) {
    const float vals[kOut] = {r.density, r.distance, r.aux,    r.norm[0], r.norm[1],
                              r.norm[2], r.dg[0],    r.dg[1], r.dg[2],   r.pen};
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[(size_t)k * M + m] = vals[k];
  }
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    float tf[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      tf[e] = x[1][k][e] * r.dg[0] + x[2][k][e] * r.dg[1] + x[3][k][e] * r.dg[2];
    store_n<8>(t_feat + (size_t)m * C + k * kChunk + lane * 8, vec, n[k], tf);
  }
}

// the forward past C = 512 (the per-layer route): one warp per row as
// above, the lane's 8 columns of each 256-column chunk in turn, so that
// only the 8 head-dot partials stay in registers: the dots in the order
// of head_dots (chunk by chunk, then the butterfly), then the scalar
// chain, then t_feat chunk by chunk, the tangent streams read again (4
// planes read, 1 read again, 1 written: the forward stays bound by device
// memory)
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    epi_fwd_wide_kernel(int M, int C, int dact, const T* __restrict__ v,
                        const T* __restrict__ j, const float* __restrict__ wd,
                        const float* __restrict__ wa, const float* __restrict__ b2,
                        const float* __restrict__ scal, float* __restrict__ out,
                        T* __restrict__ t_feat) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  const bool vec = C % 8 == 0;  // rows of whole 16-byte vectors (bf16; f32 two)
  const int nch = (C + kChunk - 1) / kChunk;
  float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const int c0 = k * kChunk + lane * 8;
    const int n = max(0, min(8, C - c0));
    float wdr[8], war[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wdr[e] = e < n ? round_to<T>(wd[c0 + e]) : 0.f;
      war[e] = e < n ? round_to<T>(wa[c0 + e]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float x[8];
      load_n<8>((s == 0 ? v + (size_t)m * C : j + ((size_t)(s - 1) * M + m) * C) + c0, vec, n,
                x);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p1[s] = fmaf(x[e], wdr[e], p1[s]);
        p2[s] = fmaf(x[e], war[e], p2[s]);
      }
    }
  }
  float h1[4], h2[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    h1[s] = warp_sum(p1[s]);
    h2[s] = warp_sum(p2[s]);
  }
  const Row r = row_math(h1, h2, b2, scal, dact);
  if (lane == 0) {
    const float vals[kOut] = {r.density, r.distance, r.aux,    r.norm[0], r.norm[1],
                              r.norm[2], r.dg[0],    r.dg[1], r.dg[2],   r.pen};
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[(size_t)k * M + m] = vals[k];
  }
#pragma unroll 1
  for (int k = 0; k < nch; ++k) {
    const int c0 = k * kChunk + lane * 8;
    const int n = max(0, min(8, C - c0));
    float tf[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float x[8];
      load_n<8>(j + ((size_t)a * M + m) * C + c0, vec, n, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) tf[e] = a == 0 ? x[e] * r.dg[0] : fmaf(x[e], r.dg[a], tf[e]);
    }
    store_n<8>(t_feat + (size_t)m * C + c0, vec, n, tf);
  }
}

// the backward's operands: the staged planes' row-0 pointers (row stride
// C, stage order above) and the outputs: out_v [M, C] and out_t [3, M, C]
// (dv, dj; TOP: the planes of gs)
template <typename T>
struct EpiBwdArgs {
  const T* plane[kMaxPlanes];
  T* out_v;
  T* out_t;
  const float* wd;
  const float* wa;
  const float* b2;
  const float* scal;
  const float* g_out;  // [10, M] f32
  float* parts;        // [gridDim.x, width] f32
  int M;
  int C;     // the width
  int dact;  // the density activation's code
};

// planes staged per tile: v, j, g_tfeat; TOP also g_col and z_v, and the
// tangent stash where f'' is not identically zero
template <int ACT, bool TOP>
constexpr int kPlanes = TOP ? (neddf::kZeroDeriv2<ACT> ? 7 : 10) : 5;

// rows of a tile at the pitch P (C's width class)
template <int P>
constexpr int kTileRowsAt = P > 1024 ? 1 : P > 512 ? 2 : P > kChunk ? 4 : kMaxTileRows;

// phase b's column vector at the pitch P: 16 bytes, or 8 f32 at P = 2048
// (so that the vectors of a row are at most one per thread)
template <typename T, int P>
constexpr int kVecAt = Vec16<T>::N * kThreads >= P ? Vec16<T>::N : P / kThreads;

// the dynamic shared memory of a block at pitch P: the stages, or the
// partial's reduction [kThreads / (P / V)][3 P] if that is larger
template <typename T, int ACT, bool TOP, int P>
constexpr size_t epi_bwd_smem() {
  constexpr size_t stages = (size_t)kStages * kPlanes<ACT, TOP> * kTileRowsAt<P> * P * sizeof(T);
  constexpr size_t red =
      (size_t)(kThreads / (P / kVecAt<T, P>)) * (TOP ? 3 : 2) * P * sizeof(float);
  return stages > red ? stages : red;
}

// one tile's rows [m0, min(M, m0 + rows)) of every staged plane (rows of C
// elements) into a stage at pitch P, V elements per copy (16-, 8- or
// 4-byte cp.async, or single bf16 elements), the columns past C zeros
// (rows past M are not copied). The 16-byte walk is unrolled as in the
// 256-only kernel; the narrower ones (odd widths) are loops
template <typename T, int NP, int P, int V>
__device__ __forceinline__ void load_tile_v(T* stage, const EpiBwdArgs<T>& a, int m0, int tid) {
  constexpr int E = (int)sizeof(T);
  constexpr int R = kTileRowsAt<P>;
  constexpr int CPR = P / V;                                  // copies per row
  constexpr int N = (R * CPR + kThreads - 1) / kThreads;      // per thread and plane
  const int C = a.C;
  auto copy = [&](int p, int i) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * V;
    if (i >= R * CPR || m0 + r >= a.M) return;
    const int valid = max(0, min(V, C - c));
    T* dst = stage + (p * R + r) * P + c;
    const T* src = a.plane[p] + (size_t)(m0 + r) * C + c;
    if constexpr (V * E >= 4) {
      neddf::cp_async<V * E>(neddf::smem_u32(dst), valid > 0 ? src : a.plane[p], valid * E);
    } else {
      *dst = valid > 0 ? *src : neddf::from_f32<T>(0.f);
    }
  };
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if constexpr (V * E == 16) {
#pragma unroll
      for (int k = 0; k < N; ++k) copy(p, tid + k * kThreads);
    } else {
#pragma unroll 1
      for (int k = 0; k < N; ++k) copy(p, tid + k * kThreads);
    }
  }
}

template <typename T, int NP, int P>
__device__ __forceinline__ void load_tile(T* stage, const EpiBwdArgs<T>& a, int m0, int tid) {
  constexpr int E = (int)sizeof(T);
  if ((a.C * E) % 16 == 0) {
    load_tile_v<T, NP, P, 16 / E>(stage, a, m0, tid);
  } else if ((a.C * E) % 4 == 0) {
    load_tile_v<T, NP, P, 4 / E>(stage, a, m0, tid);
  } else {
    load_tile_v<T, NP, P, 1>(stage, a, m0, tid);
  }
}

// lanes 0-3 of a warp: the cotangents of out rows 0, 1, 2 and 9 at row m
__device__ __forceinline__ float load_g_out(const float* g_out, int M, int m, int lane) {
  if (lane >= 4 || m >= M) return 0.f;
  return __ldg(g_out + (size_t)(lane == 3 ? 9 : lane) * M + m);
}

// P: the staged pitch, the width class of a.C (a template parameter, so
// that the tile walks are compiled loops as at the 256-only kernel's C)
template <typename T, int ACT, bool TOP, int P>
__global__ void __launch_bounds__(kThreads, 2) epi_bwd_kernel(const EpiBwdArgs<T> a) {
  constexpr int NP = kPlanes<ACT, TOP>;
  constexpr bool kCouple = TOP && !neddf::kZeroDeriv2<ACT>;
  constexpr int V = kVecAt<T, P>;
  constexpr int R = kTileRowsAt<P>;            // rows per tile
  constexpr int CV = P / V;                    // column vectors per row
  constexpr int kVecs = (R * CV + kThreads - 1) / kThreads;  // per thread per tile
  constexpr int kQ = kThreads / CV;            // threads per column vector
  constexpr int NC = (TOP ? 3 : 2) * P;        // columns of the partial's reduction
  constexpr int kStageElems = NP * R * P;
  constexpr int NCH = (P + kChunk - 1) / kChunk;  // phase a's 256-column chunks
  static_assert(kThreads % CV == 0, "phase b's columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  __shared__ float rows_s[R][kRowScalars];
  __shared__ __align__(16) float head[4][P];  // wd, wa; rounded to T: wdr, war
  __shared__ float red_db2[kWarps][2];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int M = a.M, C = a.C;
  const bool vec = (C * (int)sizeof(T)) % 16 == 0;  // 16-byte vectors in device memory
  const int n_tiles = (M + R - 1) / R;
  for (int c = tid; c < P; c += kThreads) {
    const bool in = c < C;
    head[0][c] = in ? a.wd[c] : 0.f;
    head[1][c] = in ? a.wa[c] : 0.f;
    head[2][c] = in ? round_to<T>(a.wd[c]) : 0.f;
    head[3][c] = in ? round_to<T>(a.wa[c]) : 0.f;
  }
  __syncthreads();
  // phase b's columns: the same in every tile
  const int cb = (tid % CV) * V;
  const int nb = max(0, min(V, C - cb));  // its columns < C
  float dwd[V], dwa[V], dbt[V];
#pragma unroll
  for (int e = 0; e < V; ++e) dwd[e] = dwa[e] = dbt[e] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  int tile = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = tile + s * (int)gridDim.x;
    if (t < n_tiles) load_tile<T, NP, P>(stages + (size_t)s * kStageElems, a, t * R, tid);
    neddf::cp_async_commit();
  }
  const bool row_warp = warp < R;  // this warp takes a row in phase a
  float g_next = row_warp ? load_g_out(a.g_out, M, tile * R + warp, lane) : 0.f;
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int m0 = tile * R;
    const float g_cur = g_next;
    g_next = row_warp ? load_g_out(a.g_out, M, (tile + (int)gridDim.x) * R + warp, lane) : 0.f;
    neddf::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; the stage of tile it - 1 is free
    {
      const int t = tile + (kStages - 1) * (int)gridDim.x;
      if (t < n_tiles)
        load_tile<T, NP, P>(stages + (size_t)((it + kStages - 1) % kStages) * kStageElems, a,
                            t * R, tid);
      neddf::cp_async_commit();
    }
    const T* st = stages + (size_t)(it % kStages) * kStageElems;

    // ---- phase a: warp w, row w of the tile (8 columns per lane and chunk)
    const int m = m0 + warp;
    if (row_warp && m < M) {
      float h1[4], h2[4];
      float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c0 = k * kChunk + lane * 8;
        if (c0 >= P) continue;  // P = 64, 128: the lanes past P
        float wdr[8], war[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          wdr[e] = head[2][c0 + e];
          war[e] = head[3][c0 + e];
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float x[8];
          vec_load<8>(st + (s * R + warp) * P + c0, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            p1[s] = fmaf(x[e], wdr[e], p1[s]);
            p2[s] = fmaf(x[e], war[e], p2[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        h1[s] = warp_sum(p1[s]);
        h2[s] = warp_sum(p2[s]);
      }
      const Row r = row_math(h1, h2, a.b2, a.scal, a.dact);
      float g_h1[4], g_h2[4];
      row_vjp(r, __shfl_sync(0xffffffffu, g_cur, 0), __shfl_sync(0xffffffffu, g_cur, 1),
              __shfl_sync(0xffffffffu, g_cur, 2), __shfl_sync(0xffffffffu, g_cur, 3), a.scal,
              g_h1, g_h2);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          rows_s[warp][s] = g_h1[s];
          rows_s[warp][4 + s] = g_h2[s];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) rows_s[warp][8 + k] = r.dg[k];
        db0 += g_h1[0];
        db1 += g_h2[0];
      }
    }
    __syncthreads();  // the row scalars

    // ---- phase b: this thread's column vectors
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / CV;
      if (i >= R * CV || m0 + r >= M) continue;
      const size_t row = (size_t)(m0 + r) * C + cb;
      const size_t plane = (size_t)M * C;
      auto at = [&](int p) { return st + (p * R + r) * P + cb; };
      float gt[V], d1[V], d2[V], coupling[V], o[V], wdf[V], waf[V];
      load_f32<V>(&head[0][cb], wdf);  // f32 head weights, read again per vector
      load_f32<V>(&head[1][cb], waf);  // (fewer registers across the tiles)
      vec_load<V>(at(kPlaneGt), gt);
      if constexpr (TOP) {
        float zv[V];
        vec_load<V>(at(kPlaneZ), zv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float f;
          neddf::act_fn3<ACT>(zv[e], f, d1[e], d2[e]);
          coupling[e] = 0.f;
        }
      }
      // the tangent streams: dj_a = g_h1 wd + g_h2 wa + g_tfeat grad D_a
#pragma unroll
      for (int s = 1; s < 4; ++s) {
        const float g1 = rows_s[r][s], g2 = rows_s[r][4 + s], dg = rows_s[r][7 + s];
        float x[V];
        vec_load<V>(at(s), x);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = fmaf(gt[e], dg, fmaf(g1, wdf[e], g2 * waf[e]));
          dwd[e] = fmaf(x[e], g1, dwd[e]);
          dwa[e] = fmaf(x[e], g2, dwa[e]);
        }
        if constexpr (TOP) {
          float za[V];
          if constexpr (kCouple) vec_load<V>(at(kPlaneZ + s), za);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float gj = round_to<T>(o[e]);
            if constexpr (kCouple) coupling[e] = fmaf(gj, za[e], coupling[e]);
            o[e] = gj * d1[e];
          }
        }
        store_n<V>(a.out_t + (s - 1) * plane + row, vec, nb, o);
      }
      // the value stream: dv = g_h1 wd + g_h2 wa
      {
        const float g1 = rows_s[r][0], g2 = rows_s[r][4];
        float x[V];
        vec_load<V>(at(0), x);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          o[e] = fmaf(g1, wdf[e], g2 * waf[e]);
          dwd[e] = fmaf(x[e], g1, dwd[e]);
          dwa[e] = fmaf(x[e], g2, dwa[e]);
        }
        if constexpr (TOP) {
          float gc[V];
          vec_load<V>(at(kPlaneGc), gc);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float gv = round_to<T>(round_to<T>(o[e]) + gc[e]);
            o[e] = kCouple ? neddf::dual_gv(gv, d1[e], d2[e], coupling[e])
                           : neddf::dual_gv(gv, d1[e], 0.f, 0.f);
            dbt[e] += o[e];
          }
        }
        store_n<V>(a.out_v + row, vec, nb, o);
      }
    }
  }

  // ---- the block's partial, summed in a fixed order (threads of one
  // column vector in thread order, the warps' db2 in warp order); the
  // columns past C (zeros) are not written
  neddf::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // [kQ][NC]
  const int q = tid / CV;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[q * NC + cb + e] = dwd[e];
    red[q * NC + P + cb + e] = dwa[e];
    if constexpr (TOP) red[q * NC + 2 * P + cb + e] = dbt[e];
  }
  if (lane == 0) {
    red_db2[warp][0] = db0;
    red_db2[warp][1] = db1;
  }
  __syncthreads();
  const int W = 2 * C + 2 + (TOP ? C : 0);
  float* part = a.parts + (size_t)blockIdx.x * W;
  for (int i = tid; i < NC; i += kThreads) {
    const int which = i / P, c = i - which * P;  // 0 dwd, 1 dwa, 2 the top db
    if (c >= C) continue;
    float s = 0.f;
    for (int k = 0; k < kQ; ++k) s += red[k * NC + i];
    part[which * C + c + (which == 2 ? 2 : 0)] = s;
  }
  if (tid < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_db2[w][tid];
    part[2 * C + tid] = s;
  }
}

// blocks of one instantiation on the current device: as many as fit on the
// card at once (its dynamic shared memory set once per device, which is
// where the attribute lives), at most one per tile
constexpr int kMaxDevices = 64;

template <typename T, int ACT, bool TOP, int P>
cudaError_t epi_bwd_blocks(int M, int* blocks) {
  static int per_sm[kMaxDevices] = {}, sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] < 1) {
    auto kernel = epi_bwd_kernel<T, ACT, TOP, P>;
    constexpr size_t smem = epi_bwd_smem<T, ACT, TOP, P>();
    int n = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev] = n;
  }
  constexpr int R = kTileRowsAt<P>;
  const int tiles = (M + R - 1) / R;
  const int fit = per_sm[dev] * sms[dev];
  *blocks = tiles < fit ? tiles : fit;
  return cudaSuccess;
}

// the standalone backward past C = 2048 (the per-layer route of a wider
// NeDDF), where a staged row of its 5 planes no longer fits a stage of
// shared memory. The forward's wide design, with nothing staged:
// persistent blocks of 8 warps walk tiles of 8 rows;
// * phase a, warp w and row w of the tile: the 8 head dots chunk by chunk
//   from device memory (a lane's 8 columns of each 256-column chunk, the
//   order of epi_fwd_wide_kernel, so the recomputed scalars are the
//   forward's), the row's scalar chain (row_math, row_vjp); the head
//   cotangents and grad D into shared memory;
// * phase b, per column: thread t owns the 8-column vectors t, t + 256, ...
//   of every row; it writes dv and dj of the tile's rows (streams 1-3,
//   then 0, as epi_bwd_kernel) and adds their dwd and dwa terms, rows in
//   order, to its columns of the block's partial row in `parts`, which
//   only it reads and writes (2 C f32 per block, small beside the planes
//   and mostly served by L2), so no width bounds the partial. db2: lane 0 of each warp over its rows, the warps
//   in order at the end.
// neddf_sum_splits sums the blocks' partials in block order: no atomics,
// two runs give the same bits. Bound by device memory as the staged
// kernel: 4 planes read twice (phase a, then b), g_tfeat once, 4 planes
// written, and 2 C f32 read and written per block and tile (at 8 rows
// and bf16 C = 4096: 13 plane-rows of 8 KB and 64 KB of partials).
constexpr int kWideBlocksPerSm = 4;  // the persistent grid: at most 4 blocks an SM

template <typename T>
__global__ void __launch_bounds__(kThreads) epi_bwd_wide_kernel(const EpiBwdArgs<T> a) {
  __shared__ float rows_s[kWarps][kRowScalars];
  __shared__ float red_db2[kWarps][2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int M = a.M, C = a.C;
  const bool vec = C % 8 == 0;  // rows of whole 16-byte vectors (bf16; f32 two)
  const size_t plane = (size_t)M * C;
  const int n_tiles = (M + kWarps - 1) / kWarps;
  float* part = a.parts + (size_t)blockIdx.x * (2 * C + 2);
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = 0.f;  // read back by its owner only
  float db0 = 0.f, db1 = 0.f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = tile * kWarps;
    // ---- phase a: warp w, row w of the tile
    const int m = m0 + warp;
    if (m < M) {
      const float g_row = load_g_out(a.g_out, M, m, lane);
      float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int c0 = lane * 8; c0 < C; c0 += kChunk) {
        const int n = min(8, C - c0);
        float wdr[8], war[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          wdr[e] = e < n ? round_to<T>(a.wd[c0 + e]) : 0.f;
          war[e] = e < n ? round_to<T>(a.wa[c0 + e]) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          float x[8];
          load_n<8>(a.plane[s] + (size_t)m * C + c0, vec, n, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            p1[s] = fmaf(x[e], wdr[e], p1[s]);
            p2[s] = fmaf(x[e], war[e], p2[s]);
          }
        }
      }
      float h1[4], h2[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        h1[s] = warp_sum(p1[s]);
        h2[s] = warp_sum(p2[s]);
      }
      const Row r = row_math(h1, h2, a.b2, a.scal, a.dact);
      float g_h1[4], g_h2[4];
      row_vjp(r, __shfl_sync(0xffffffffu, g_row, 0), __shfl_sync(0xffffffffu, g_row, 1),
              __shfl_sync(0xffffffffu, g_row, 2), __shfl_sync(0xffffffffu, g_row, 3), a.scal,
              g_h1, g_h2);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          rows_s[warp][s] = g_h1[s];
          rows_s[warp][4 + s] = g_h2[s];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) rows_s[warp][8 + k] = r.dg[k];
        db0 += g_h1[0];
        db1 += g_h2[0];
      }
    }
    __syncthreads();  // the row scalars

    // ---- phase b: this thread's 8-column vectors of the tile's rows
    const int rows = min(kWarps, M - m0);
#pragma unroll 1
    for (int c0 = tid * 8; c0 < C; c0 += kThreads * 8) {
      const int n = min(8, C - c0);
      float wdf[8], waf[8], dwd[8], dwa[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = e < n;
        wdf[e] = in ? a.wd[c0 + e] : 0.f;
        waf[e] = in ? a.wa[c0 + e] : 0.f;
        dwd[e] = in ? part[c0 + e] : 0.f;
        dwa[e] = in ? part[C + c0 + e] : 0.f;
      }
#pragma unroll 1
      for (int r = 0; r < rows; ++r) {
        const size_t row = (size_t)(m0 + r) * C + c0;
        float gt[8], x[8], o[8];
        load_n<8>(a.plane[kPlaneGt] + row, vec, n, gt);
        // the tangent streams: dj_a = g_h1 wd + g_h2 wa + g_tfeat grad D_a
#pragma unroll
        for (int s = 1; s < 4; ++s) {
          const float g1 = rows_s[r][s], g2 = rows_s[r][4 + s], dg = rows_s[r][7 + s];
          load_n<8>(a.plane[s] + row, vec, n, x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            o[e] = fmaf(gt[e], dg, fmaf(g1, wdf[e], g2 * waf[e]));
            dwd[e] = fmaf(x[e], g1, dwd[e]);
            dwa[e] = fmaf(x[e], g2, dwa[e]);
          }
          store_n<8>(a.out_t + (s - 1) * plane + row, vec, n, o);
        }
        // the value stream: dv = g_h1 wd + g_h2 wa
        const float g1 = rows_s[r][0], g2 = rows_s[r][4];
        load_n<8>(a.plane[0] + row, vec, n, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = fmaf(g1, wdf[e], g2 * waf[e]);
          dwd[e] = fmaf(x[e], g1, dwd[e]);
          dwa[e] = fmaf(x[e], g2, dwa[e]);
        }
        store_n<8>(a.out_v + row, vec, n, o);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < n) {
          part[c0 + e] = dwd[e];
          part[C + c0 + e] = dwa[e];
        }
      }
    }
    __syncthreads();  // phase a of the next tile rewrites the row scalars
  }
  if (lane == 0) {
    red_db2[warp][0] = db0;
    red_db2[warp][1] = db1;
  }
  __syncthreads();
  if (tid < 2) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red_db2[w][tid];
    part[2 * C + tid] = s;
  }
}

// the wide kernel's block count for M rows (its occupancy, at most
// kWideBlocksPerSm an SM, at most one per tile), or its launch over
// `blocks` blocks
template <typename T>
cudaError_t epi_bwd_wide(const EpiBwdArgs<T>& a, int blocks, int* fit, cudaStream_t s) {
  static int per_sm[kMaxDevices] = {}, sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] < 1) {
    int n = 0;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, epi_bwd_wide_kernel<T>, kThreads,
                                                          0);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    per_sm[dev] = n < kWideBlocksPerSm ? n : kWideBlocksPerSm;
  }
  if (blocks == 0) {
    const int tiles = (a.M + kWarps - 1) / kWarps, most = per_sm[dev] * sms[dev];
    if (fit != nullptr) *fit = tiles < most ? tiles : most;
    return cudaSuccess;
  }
  epi_bwd_wide_kernel<T><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

// fn(ACT, TOP, P) for the run-time activation, mode and width (the
// standalone mode takes no activation; the top mode, the fused trunk's,
// no width past the tile forward's 512)
template <typename F>
cudaError_t by_mode(int act, int top, int width, F&& fn) {
  auto by_p = [&](auto p_) -> cudaError_t {
    if (!top) return fn(std::integral_constant<int, neddf::kTanhExp>{}, std::false_type{}, p_);
    if constexpr (decltype(p_)::value > neddf::kMaxWidth) {
      return cudaErrorInvalidValue;
    } else {
      return neddf::by_act(act, [&](auto a_) { return fn(a_, std::true_type{}, p_); });
    }
  };
  switch (epi_class(width)) {
    case 1024: return by_p(std::integral_constant<int, 1024>{});
    case 2048: return by_p(std::integral_constant<int, 2048>{});
  }
  return neddf::by_class(width, by_p);
}

}  // namespace

// The backward of one operand type (EpiBwdArgs<bf16> or <float> at `args`):
// with blocks = 0 the block count that fills the card into *fit (args: M
// and C), else the launch over `blocks` blocks. kernels/_build.py compiles
// this file twice more, with -DNEDDF_EPI_BF16 and with -DNEDDF_EPI_F32,
// each object holding one type's 26 instantiations of epi_bwd_kernel (the
// trunk activation or the standalone mode x the 4 width classes, and the
// standalone mode at 1024 and 2048) and its epi_bwd_wide_kernel (the
// standalone mode past 2048), so that they build beside the object of
// the entry points (no define).
extern "C" int neddf_epi_bwd_bf16(int act, int top, const void* args, int blocks, int* fit,
                                  void* stream);
extern "C" int neddf_epi_bwd_f32(int act, int top, const void* args, int blocks, int* fit,
                                 void* stream);

#if defined(NEDDF_EPI_BF16) || defined(NEDDF_EPI_F32)
#ifdef NEDDF_EPI_BF16
using EpiT = __nv_bfloat16;
#define NEDDF_EPI_FN neddf_epi_bwd_bf16
#else
using EpiT = float;
#define NEDDF_EPI_FN neddf_epi_bwd_f32
#endif
extern "C" int NEDDF_EPI_FN(int act, int top, const void* args, int blocks, int* fit,
                            void* stream) {
  const EpiBwdArgs<EpiT>& a = *static_cast<const EpiBwdArgs<EpiT>*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!top && a.C > kMaxEpiWidth) return (int)epi_bwd_wide(a, blocks, fit, s);
  return (int)by_mode(act, top, a.C, [&](auto a_, auto top_, auto p_) -> cudaError_t {
    constexpr int ACT = decltype(a_)::value, P = decltype(p_)::value;
    constexpr bool TOP = decltype(top_)::value;
    int n = 0;  // the call also sets the kernel's shared memory limit on this device
    const cudaError_t err = epi_bwd_blocks<EpiT, ACT, TOP, P>(a.M, &n);
    if (err != cudaSuccess || blocks == 0) {
      if (fit != nullptr) *fit = n;
      return err;
    }
    epi_bwd_kernel<EpiT, ACT, TOP, P>
        <<<blocks, kThreads, epi_bwd_smem<EpiT, ACT, TOP, P>(), s>>>(a);
    return cudaGetLastError();
  });
}
#else

// The forward over M rows of v [M, width] and j [3, M, width] (dtype 1
// bf16 or 0 f32, any width) with the f32 head weights wd, wa
// [width], b2 [2], scal [8]: out [10, M] f32 and t_feat [M, width]; dact
// the density activation's code (as the trunk's: 0 tanhExp, 1 ReLU, 2
// LeakyReLU, 3 Softplus, 4 Sigmoid).
extern "C" int neddf_epilogue_fwd(int dtype, int dact, int width, int M, const void* v,
                                  const void* j, const void* wd, const void* wa,
                                  const void* b2, const void* scal, void* out, void* t_feat,
                                  void* stream) {
  if (M <= 0 || width < 1 || dact < 0 || dact > neddf::kSigmoid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (M + kWarps - 1) / kWarps;
  const float* f_wd = static_cast<const float*>(wd);
  const float* f_wa = static_cast<const float*>(wa);
  const float* f_b2 = static_cast<const float*>(b2);
  const float* f_sc = static_cast<const float*>(scal);
  float* o = static_cast<float*>(out);
  auto launch = [&](auto t_, auto nch_, auto full_) {
    using T = decltype(t_);
    epi_fwd_kernel<T, decltype(nch_)::value, decltype(full_)::value>
        <<<grid, kWarps * 32, 0, s>>>(M, width, dact, static_cast<const T*>(v),
                                      static_cast<const T*>(j), f_wd, f_wa, f_b2, f_sc, o,
                                      static_cast<T*>(t_feat));
  };
  auto shaped = [&](auto t_) {  // NCH chunks of 256 columns; FULL: width = 256 NCH
    using T = decltype(t_);
    using One = std::integral_constant<int, 1>;
    using Two = std::integral_constant<int, 2>;
    if (width > 2 * kChunk) {
      epi_fwd_wide_kernel<T><<<grid, kWarps * 32, 0, s>>>(
          M, width, dact, static_cast<const T*>(v), static_cast<const T*>(j), f_wd, f_wa, f_b2,
          f_sc, o, static_cast<T*>(t_feat));
    } else if (width > kChunk) {
      if (width == 2 * kChunk) launch(t_, Two{}, std::true_type{});
      else launch(t_, Two{}, std::false_type{});
    } else {
      if (width == kChunk) launch(t_, One{}, std::true_type{});
      else launch(t_, One{}, std::false_type{});
    }
  };
  if (dtype == 1) shaped(__nv_bfloat16{}); else shaped(float{});
  return (int)cudaGetLastError();
}

// The backward's block count for M rows of the given width (the rows of
// its partials): dtype 1 bf16 or 0 f32; top 0 the standalone mode, 1 the
// top mode with the trunk activation act (0 tanhExp, 1 ReLU, 2 LeakyReLU,
// 3 Softplus, 4 Sigmoid).
extern "C" int neddf_epilogue_bwd_blocks(int dtype, int act, int top, int width, int M,
                                         int* blocks) {
  if (M <= 0 || blocks == nullptr || width < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_epi_bwd_bf16 : neddf_epi_bwd_f32;
  auto count = [&](auto t_) {
    EpiBwdArgs<decltype(t_)> a{};
    a.M = M;
    a.C = width;
    return fn(act, top, &a, 0, blocks, nullptr);
  };
  return dtype == 1 ? count(__nv_bfloat16{}) : count(float{});
}

// The epilogue's backward over M rows of the streams v [M, C] and j [3, M,
// C] (C = width, any, the top mode up to 512; dtype 1 bf16 or 0 f32) with
// the f32 head
// weights wd, wa [C], b2 [2], scal [8], the density activation's code dact
// and the cotangents g_out [10, M] f32 (rows 0, 1, 2, 9 read) and g_tfeat
// [M, C]. top 0: dv into out_v [M, C], dj into out_t [3, M, C]; g_col and
// z unused. top 1: also g_col [M, C] (the colour trunk's cotangent of
// v_feat) and the top layer's stash z [4, M, C] (only its value plane read
// under act 1 and 2), the stacked cotangent gs into out_v (plane 0) and
// out_t (planes 1-3). `blocks` blocks (any count;
// neddf_epilogue_bwd_blocks gives the one that fills the card) each write
// one f32 partial row of parts [blocks, w], w = 2 C + 2 (+ C at the top),
// and red [w] = their sum in block order: dwd, dwa, db2 (and the top db).
extern "C" int neddf_epilogue_bwd(int dtype, int act, int dact, int top, int width, int M,
                                  int blocks, const void* v, const void* j, const void* wd,
                                  const void* wa, const void* b2, const void* scal,
                                  const void* g_out, const void* g_tfeat, const void* g_col,
                                  const void* z, void* out_v, void* out_t, void* parts,
                                  void* red, void* stream) {
  if (M <= 0 || blocks <= 0 || width < 1 || dact < 0 || dact > neddf::kSigmoid ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (top && (g_col == nullptr || z == nullptr)) return (int)cudaErrorInvalidValue;
  const int w = 2 * width + 2 + (top ? width : 0);
  auto launch = [&](auto t_) {
    using T = decltype(t_);
    const size_t plane = (size_t)M * width;
    const T* pv = static_cast<const T*>(v);
    const T* pj = static_cast<const T*>(j);
    const T* pz = static_cast<const T*>(z);
    EpiBwdArgs<T> a{};
    a.plane[0] = pv;
    for (int k = 0; k < 3; ++k) a.plane[1 + k] = pj + k * plane;
    a.plane[kPlaneGt] = static_cast<const T*>(g_tfeat);
    if (top) {
      a.plane[kPlaneGc] = static_cast<const T*>(g_col);
      for (int k = 0; k < 4; ++k) a.plane[kPlaneZ + k] = pz + k * plane;
    }
    a.out_v = static_cast<T*>(out_v);
    a.out_t = static_cast<T*>(out_t);
    a.wd = static_cast<const float*>(wd);
    a.wa = static_cast<const float*>(wa);
    a.b2 = static_cast<const float*>(b2);
    a.scal = static_cast<const float*>(scal);
    a.g_out = static_cast<const float*>(g_out);
    a.parts = static_cast<float*>(parts);
    a.M = M;
    a.C = width;
    a.dact = dact;
    return (dtype == 1 ? neddf_epi_bwd_bf16 : neddf_epi_bwd_f32)(act, top, &a, blocks, nullptr,
                                                                 stream);
  };
  const int err = dtype == 1 ? launch(__nv_bfloat16{}) : launch(float{});
  if (err != (int)cudaSuccess) return err;
  return neddf_sum_splits(w, blocks, parts, red, stream);
}

#endif
