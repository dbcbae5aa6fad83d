// Dual-MLP backward (the dual chain rule in reverse) for sm_90a.
//
// Replaces the Pallas backward neddf_tpu/kernels/dual_mlp.py::
// _run_backward (kernel body _bwd_kernel:728, stashed variant). The
// Python walk (kernels/dual_mlp.py::dual_mlp_seg_bwd_route) goes through
// the layers in reverse with S = K+1 stacked streams [S, M, C]:
//
// * neddf_dual_bwd_gstack, once per call that starts from the output
//   cotangent (gv, gj), which no product produces (a call given the top
//   layer's stacked cotangent, the NeDDF trunk's from neddf_epilogue.cu's
//   top mode, launches none): from g and the stash z (type T) the
//   stacked cotangent of the pre-activation,
//       G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a   (the f'' coupling)
//       G_a = g_a f'(z_v),
//   rounded to T (the Pallas _mm casts it before both products), and one
//   f32 partial of db = sum_rows G_v per block of 64 rows;
// * per layer l > 0, two products on the tensor cores (neddf_gemm_tc,
//   streams = S): dW_l = h_in^T G_l with the layer input h_in =
//   (f(z_v), f'(z_v) z_a) of the stash z_{l-1} formed as the prologue, as
//   each stage lands in shared memory; and g_{l-1} = G_l W_l^T with
//   G_{l-1}, rounded to T, and its db partials as the epilogue, which
//   reads the stash z_{l-1} and writes no f32 g. The coupling needs all S
//   streams of a point in one tile, and the planes are stream-major, so
//   these two products take their rows grouped by point: a 128-row output
//   tile (nt) holds the S streams of 128/S points (32 for the K=3 trunk,
//   64 for the K=1 colour trunk), a reduction stage of BK rows (tn: 64
//   bf16, 32 f32) the S streams of BK/S points; the planes in device
//   memory keep their layout, only the copies' and the epilogue's
//   addresses change (TcOperand::plane). A ragged last group masks the
//   points past M in every stream;
// * layer 0 (input segments, no activation) and a post-skip layer's seg0
//   rows (dx of seg0 is raw) take plain products; neddf_sum_rows sums
//   the db partials in a fixed order over the whole card (groups of rows,
//   then the groups); neddf_sum_splits the dW split partials.
// The same products serve the backwards of mlp_bwd.cu and sdf_mlp.cu,
// which give neddf_gemm_tc an activation whose elementwise work it folds
// in, as the prologue of a tn product (dW = f(z_{l-1})^T G: f applied to
// the stash as its stages land in shared memory) or as the epilogue of an
// nt / nn product of one split (the tile goes through shared memory, is
// combined with the stash and up to one side plane, and leaves as the
// next layer's cotangent in the operand type, with one db partial per
// 128-row tile). So no backward moves a plane through device memory
// between its products but the top layer's cotangent.
// Determinism. The Pallas kernel accumulates dW/db across its sequential
// TPU grid; blocks here run concurrently, so every cross-block reduction
// writes per-block (or per-split) f32 partials that a second pass sums
// in a fixed order. No float atomics: two runs give bitwise-equal dW.
//
// What bounds it on the H100: the two products per layer are
// 2 * S*M * C * fan_in FLOPs each (about 0.1 TFLOP per trunk layer at
// the training batch). They run on the tensor cores (tc_gemm_kernel): a
// 128x128 output tile per block of 8 warps, each warp 64x32 as 4x4 mma
// tiles with f32 accumulators in registers; both operands stream through
// a ring of 3 shared-memory stages of 128 bytes per row (64 bf16 or 32
// f32) filled by cp.async, so the copy of stage k+2 overlaps the
// products of stage k. bf16 operands: mma.sync m16n8k16, fragments by
// ldmatrix (.trans for an operand whose M or N side is contiguous), rows
// padded by 16 bytes against bank conflicts. f32 operands (NeuS, and the
// f32 reference steps): the 3xTF32 split of tc_ops.cuh, three mma.sync
// m16n8k8 tf32 per f32 multiply-add, each fragment split into hi/lo as
// it is read from shared memory; a K-contiguous tile gives its
// fragments by the same ldmatrix byte addresses as bf16, an M- or
// N-contiguous one (dW = in^T G, the NeuS sweep's pbar = qbar W) by
// element loads whose lanes fall on distinct banks. The f32 bound is
// then 3 TF32 FLOPs per FLOP at 495 TFLOP/s (165 TFLOP/s of f32 work),
// or the bytes. A plain dx (nt) writes 4 bytes of f32 per output
// against 2*K FLOPs: about 130 FLOP per byte, below the 295 at which the
// bf16 tensor cores, and not device memory, are the limit, so its tile
// leaves through shared memory in coalesced streaming stores; with the
// epilogue it writes 2 bytes of bf16 and reads S * 2 bytes of stash per
// point and column instead. dW reduces over S*M rows in fixed-order split
// partials. The folded work is elementwise and bound by device memory:
// the epilogue's stash reads are prefetched into L2 at the block's start
// (the product runs meanwhile), under f'' = 0 (ReLU, LeakyReLU) only the
// value stream's; the prologue costs the product no extra pass over
// shared memory (each thread transforms the S rows of the point it
// copied itself). The epilogue and the prologue cost the product no
// registers: the epilogue is a call of its own after the accumulators
// are in shared memory, the stream count of the grouped products is a
// template argument, and the f32 nt product with an epilogue and the f32
// tn product with the dual prologue keep their mma depths in a loop
// (unrolled, ptxas spilled 4 and 20 bytes).
#include "mlp_tile.cuh"
#include "tc_ops.cuh"

namespace {

using neddf::grid_1d;
using neddf::load_n;
using neddf::store_n;
using neddf::vec_load;
using neddf::vec_store;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

constexpr int kMaxStreams = 4;

// the top layer's stacked cotangent from g = (gv [M, C], gj [K, M, C])
// in G (T, or f32: the per-layer route's cotangents, summed over the
// ranks' column shards in f32); the layers below get theirs from the dx
// product's epilogue, or on the per-layer route from this kernel again
template <typename T, typename G, int ACT>
__global__ void gstack_kernel(int S, int C, int M, int rows_per_block,
                              const G* __restrict__ gv, const G* __restrict__ gj,
                              const T* __restrict__ z, T* __restrict__ gs,
                              float* __restrict__ db_part) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  const size_t plane = (size_t)M * C;
  float db = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t i = (size_t)m * C + c;
    float f, d1, d2;
    neddf::act_fn3<ACT>(ld(z, i), f, d1, d2);
    float coupling = 0.f;
    float gt[kMaxStreams];
    for (int a = 1; a < S; ++a) {
      gt[a] = ld(gj, (a - 1) * plane + i);
      if constexpr (!neddf::kZeroDeriv2<ACT>)
        coupling = fmaf(gt[a], ld(z, a * plane + i), coupling);
    }
    const float g0 = neddf::dual_gv(ld(gv, i), d1, d2, coupling);
    db += g0;
    st(gs, i, g0);
    for (int a = 1; a < S; ++a) st(gs, a * plane + i, gt[a] * d1);
  }
  db_part[(size_t)blockIdx.x * C + c] = db;
}

// ---- the products on the tensor cores: bf16 operands by mma.sync
// m16n8k16, f32 operands by the 3xTF32 split (tc_ops.cuh: mma_3xtf32)
using bf16 = __nv_bfloat16;

constexpr int kTcBM = 128;  // output rows per block
constexpr int kTcBN = 128;  // output columns per block
constexpr int kTcStages = 3;
constexpr int kTcThreads = 256;

// the shared tiles of operand type T. A stage is 128 bytes deep (64 bf16
// or 32 f32) and one mma 32 bytes (k16 bf16, k8 tf32), so the byte
// addresses of the ldmatrix fragments are the same for both types.
// Tiles are [rows][BK] when K is the operand's contiguous side (rows
// padded by 16 bytes: ldmatrix without bank conflicts) and [BK][128] when
// M (or N) is (padded by 8 elements: conflict-free for ldmatrix .trans in
// bf16, and for the element loads of f32, whose lanes (k t, m g) then
// fall on banks 8t + g).
template <typename T>
struct TcShape {
  static constexpr int BK = 128 / (int)sizeof(T);   // depth of one stage
  static constexpr int KSTEP = 32 / (int)sizeof(T);  // depth of one mma
  static constexpr int PK = BK + 16 / (int)sizeof(T);
  static constexpr int PMN = kTcBM + 8;
  static constexpr int OP = kTcBM * PK;  // elements of one operand's stage
  static_assert(BK * PMN <= OP, "stage size");
};
constexpr int kTcSmem = 2 * kTcStages * TcShape<bf16>::OP * (int)sizeof(bf16);
static_assert(kTcSmem == 2 * kTcStages * TcShape<float>::OP * (int)sizeof(float), "stages");

// one operand: element (outer o, inner i) at p[o * ld + i], the inner
// side contiguous, copied `vec` elements at a time; in the products with
// grouped rows (EPI kProDual / kEpiDual) stream a of outer row o is at
// p[a * plane + o * ld + i]
template <typename T>
struct TcOperand {
  const T* p;
  long long ld;
  long long plane;
  int vec;
};

// one copy of V elements from src (valid of them, zeros past) to s
template <typename T, int V>
__device__ __forceinline__ void tc_copy(T* s, const T* src, int valid) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES < 4) {
    *s = valid > 0 ? *src : neddf::from_f32<T>(0.f);
  } else {
    neddf::cp_async<BYTES>(neddf::smem_u32(s), src, (int)sizeof(T) * valid);
  }
}

// the OUTER x INNER tile at (o0, i0) into shared s (row pitch P), zeros
// past (olim, ilim); copies of V elements (cp.async from 4 bytes up)
template <typename T, int OUTER, int INNER, int P, int V>
__device__ __forceinline__ void tc_copy_tile(T* s, const TcOperand<T>& op, int o0, int olim,
                                             int i0, int ilim, int tid) {
  constexpr int CPR = INNER / V;
#pragma unroll 1
  for (int idx = tid; idx < OUTER * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int go = o0 + r, gi = i0 + c;
    const int valid = go < olim ? max(0, min(V, ilim - gi)) : 0;
    tc_copy<T, V>(s + r * P + c, valid > 0 ? op.p + (size_t)go * op.ld + gi : op.p, valid);
  }
}

// the same tile with its OUTER rows grouped by point: S = 2^SL streams of
// R = OUTER / S rows, tile row a * R + r holding row o0 + r of stream a
// (zeros past olim in every stream). One thread copies the same columns
// of one point in all S streams, so that it can transform them together
// once its own copies have landed (tc_dual_tile). S is a template
// argument: its shifts and trip counts cost the product no registers (a
// run-time S spilled 24 bytes of the f32 tn product at 128 registers)
template <typename T, int OUTER, int INNER, int P, int V, int SL>
__device__ __forceinline__ void tc_copy_grouped(T* s, const TcOperand<T>& op, int o0, int olim,
                                                int i0, int ilim, int tid) {
  constexpr int CPR = INNER / V;
  constexpr int R = OUTER >> SL;
#pragma unroll 1
  for (int idx = tid; idx < R * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    const int c = (idx - r * CPR) * V;
    const int go = o0 + r, gi = i0 + c;
    const int valid = go < olim ? max(0, min(V, ilim - gi)) : 0;
    const T* src = valid > 0 ? op.p + (size_t)go * op.ld + gi : op.p;
    const long long step = valid > 0 ? op.plane : 0;
#pragma unroll
    for (int a = 0; a < (1 << SL); ++a)
      tc_copy<T, V>(s + (a * R + r) * P + c, src + a * step, valid);
  }
}

template <typename T, int OUTER, int INNER, int P, int SL, int V>
__device__ __forceinline__ void tc_copy_by(T* s, const TcOperand<T>& op, int o0, int olim,
                                           int i0, int ilim, int tid) {
  if constexpr (SL > 0) {
    tc_copy_grouped<T, OUTER, INNER, P, V, SL>(s, op, o0, olim, i0, ilim, tid);
  } else {
    tc_copy_tile<T, OUTER, INNER, P, V>(s, op, o0, olim, i0, ilim, tid);
  }
}

// the tile at the operand's copy width; SL > 0: grouped by point
template <typename T, int OUTER, int INNER, int P, int SL = 0>
__device__ __forceinline__ void tc_load_tile(T* s, const TcOperand<T>& op, int o0, int olim,
                                             int i0, int ilim, int tid) {
  constexpr int E = (int)sizeof(T);
  switch (op.vec * E) {
    case 16: tc_copy_by<T, OUTER, INNER, P, SL, 16 / E>(s, op, o0, olim, i0, ilim, tid); break;
    case 8: tc_copy_by<T, OUTER, INNER, P, SL, 8 / E>(s, op, o0, olim, i0, ilim, tid); break;
    case 4: tc_copy_by<T, OUTER, INNER, P, SL, 4 / E>(s, op, o0, olim, i0, ilim, tid); break;
    default: tc_copy_by<T, OUTER, INNER, P, SL, 1>(s, op, o0, olim, i0, ilim, tid);
  }
}

// the stage at k0 of an A in two K segments that straddles k_split: columns
// k < k_split from A, k_split <= k < ke from A2 (at k - k_split), zeros past
// ke and past olim, by element loads (the segments' columns meet off any
// vector boundary)
template <typename T, int OUTER, int INNER, int P>
__device__ __forceinline__ void tc_load_straddle(T* s, const TcOperand<T>& a,
                                                 const TcOperand<T>& a2, int o0, int olim,
                                                 int k0, int k_split, int ke, int tid) {
#pragma unroll 1
  for (int idx = tid; idx < OUTER * INNER; idx += kTcThreads) {
    const int r = idx / INNER;
    const int c = idx - r * INNER;
    const int go = o0 + r, k = k0 + c;
    T v = neddf::from_f32<T>(0.f);
    if (go < olim && k < ke)
      v = k < k_split ? a.p[(size_t)go * a.ld + k] : a2.p[(size_t)go * a2.ld + (k - k_split)];
    s[r * P + c] = v;
  }
}

template <int ACT>
__device__ __forceinline__ float act_f(float x) {
  float f, df;
  neddf::act_fn<ACT>(x, f, df);
  return f;
}

// f(x) in place over the elements of a tile that this thread copied with
// tc_copy_tile<T, OUTER, INNER, P, V> (the same walk): after its own
// cp.async group has landed they are visible to it, so no barrier is
// needed. Zero-filled elements become f(0) (log 2 for Softplus, 1/2 for
// Sigmoid): they lie past the reduction's end, where the other operand's
// stage is zero-filled too, or past the output's rows, which are not
// stored, so they add nothing
template <typename T, int ACT, int OUTER, int INNER, int P, int V>
__device__ __forceinline__ void tc_act_tile(T* s, int tid) {
  constexpr int CPR = INNER / V;
#pragma unroll 1
  for (int idx = tid; idx < OUTER * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    T* e = s + r * P + (idx - r * CPR) * V;
    float x[V];
    vec_load<V>(e, x);
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = act_f<ACT>(x[j]);
    vec_store<V>(e, x);
  }
}

// the dual layer input in place over the elements of a grouped tile that
// this thread copied with tc_copy_grouped (the same walk): the value row
// z_v becomes f(z_v) and each tangent row z_a becomes f'(z_v) z_a, all
// rounded to T as the plain version's input is; z_v is overwritten only
// after f'(z_v) is in registers. A zero-filled point's value row becomes
// f(0) and its tangent rows 0; its G rows are zero-filled too.
// f32 takes its 4-element copies in pairs (H): four f' of tanhExp live
// beside the accumulators spilled 20 bytes of the f32 tn product; under
// Softplus (log1p and the logistic per element) one at a time, two
// spilled 20 bytes
template <typename T, int ACT, int OUTER, int INNER, int P, int V, int SL>
__device__ __forceinline__ void tc_dual_tile(T* s, int tid) {
  constexpr int CPR = INNER / V;
  constexpr int R = OUTER >> SL;
  constexpr int H = sizeof(T) == 4 && V > 2 ? (ACT == neddf::kSoftplus ? 1 : 2) : V;
#pragma unroll 1
  for (int idx = tid; idx < R * CPR; idx += kTcThreads) {
    const int r = idx / CPR;
    T* e0 = s + r * P + (idx - r * CPR) * V;
#pragma unroll
    for (int h = 0; h < V; h += H) {
      T* e = e0 + h;
      float x[H], d1[H];
      vec_load<H>(e, x);
#pragma unroll
      for (int j = 0; j < H; ++j) neddf::act_fn<ACT>(x[j], x[j], d1[j]);
      vec_store<H>(e, x);
#pragma unroll
      for (int a = 1; a < (1 << SL); ++a) {
        T* t = e + a * R * P;
        vec_load<H>(t, x);
#pragma unroll
        for (int j = 0; j < H; ++j) x[j] *= d1[j];
        vec_store<H>(t, x);
      }
    }
  }
}

// the prologue's transform (tc_act_tile, or tc_dual_tile when grouped)
template <typename T, int ACT, int OUTER, int INNER, int P, int SL, int V>
__device__ __forceinline__ void tc_act_by(T* s, int tid) {
  if constexpr (SL > 0) {
    tc_dual_tile<T, ACT, OUTER, INNER, P, V, SL>(s, tid);
  } else {
    tc_act_tile<T, ACT, OUTER, INNER, P, V>(s, tid);
  }
}

// ... at the copy width vec
template <typename T, int ACT, int OUTER, int INNER, int P, int SL>
__device__ __forceinline__ void tc_act_load(T* s, int vec, int tid) {
  constexpr int E = (int)sizeof(T);
  switch (vec * E) {
    case 16: tc_act_by<T, ACT, OUTER, INNER, P, SL, 16 / E>(s, tid); break;
    case 8: tc_act_by<T, ACT, OUTER, INNER, P, SL, 8 / E>(s, tid); break;
    case 4: tc_act_by<T, ACT, OUTER, INNER, P, SL, 4 / E>(s, tid); break;
    default: tc_act_by<T, ACT, OUTER, INNER, P, SL, 1>(s, tid);
  }
}

// what a product does besides the sum (template parameter EPI)
constexpr int kEpiNone = 0;  // f32 partials out
constexpr int kProAct = 1;   // tn: operand A is f(A) (dW = f(z_{l-1})^T G)
constexpr int kEpiAct = 2;   // nt / nn, one split: the elementwise epilogue below
// the dual backward's, over rows grouped by point:
constexpr int kProDual = 3;  // tn: A is the dual layer input of the stash (tc_dual_tile)
constexpr int kEpiDual = 4;  // nt, one split: the stacked cotangent (tc_epilogue_dual)
// (with the template argument SL: 2^SL streams)

// the epilogue's side planes; columns [0, n_act) take the activation's
// epilogue, [n_act, N) leave raw (f32) to `raw` [M, N - n_act]. mode
// kModeDact: v = acc f'(z) (+ side), out = T(v), out2 = acc (the raw
// product), db: per-tile column sums of v; kModeAdjoint (tanhExp,
// Softplus and Sigmoid: ReLU and LeakyReLU have f'' = 0):
// out = acc f'(z), out2 = acc side f''(z), or with no side acc f''(z) in
// column 0 and 0 elsewhere (the top of the sweep's adjoint)
constexpr int kModeDact = 1;
constexpr int kModeAdjoint = 2;
template <typename T>
struct TcEpi {
  const T* z;          // [M, n_act] the stash
  const float* side;   // [M, n_act] or null
  T* out;              // [M, n_act] or null
  float* out2;         // [M, n_act] or null
  float* raw;          // [M, N - n_act] or null when N == n_act
  float* db;           // [ceil(M / kTcBM), n_act] or null
  int n_act;
  int mode;
};

// the epilogue of a finished 128 x 128 tile (kEpiAct), once the kernel has
// put its accumulators in shared memory (the free ring; a call of its own,
// so that its registers do not add to the product's): each thread takes 4
// columns of 16 rows in coalesced 16-byte pieces (element by element where
// n_act is not a multiple of 4, a group then straddling n_act), reads the
// side planes there, writes the outputs and sums its columns; the 8 warps'
// column sums meet in shared memory and are added in warp order (one db
// partial per tile and column, the same on every run). FULL: n_act % 4
// == 0 (the kernel picks the variant), every group all 4 columns or none,
// by vectors as at the widths that are multiples of 4
template <typename T, int ACT, bool FULL>
__device__ __noinline__ void tc_epilogue(int M, int N, const TcEpi<T>& epi) {
  // the fields in registers once (read through the reference after every
  // store, they would be loaded again: the stores might alias them)
  const T* __restrict__ zp = epi.z;
  const float* __restrict__ side = epi.side;
  T* __restrict__ out = epi.out;
  float* __restrict__ out2 = epi.out2;
  float* __restrict__ raw = epi.raw;
  float* __restrict__ db = epi.db;
  const int n_act = epi.n_act;
  const bool adjoint = !neddf::kZeroDeriv2<ACT> && epi.mode == kModeAdjoint;
  constexpr int kOP = kTcBN + 4;  // padded row of the staged f32 tile
  constexpr int kWarps = kTcThreads / 32;
  constexpr int kU = 4;  // rows per pass: their loads are in flight together
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const float* so = reinterpret_cast<const float*>(tc_smem);
  float* red = reinterpret_cast<float*>(tc_smem) + kTcBM * kOP;  // [8 warps][kTcBN]
  const int c = (tid & 31) * 4;  // this thread's 4 columns of the tile
  const int gc = n0 + c;
  const bool act = gc < n_act;  // the first of them is activated
  const int n_in = FULL ? 4 : min(4, n_act - gc);  // activated columns of the group
  const int n_raw = N - n_act;
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int r0 = tid >> 5; r0 < kTcBM; r0 += kU * kWarps) {
    float zv[kU][4], sv[kU][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int gr = m0 + r0 + u * kWarps;
#pragma unroll
      for (int j = 0; j < 4; ++j) zv[u][j] = sv[u][j] = 0.f;
      if (act && gr < M) {
        const size_t i = (size_t)gr * n_act + gc;
        load_n<4>(zp + i, FULL, n_in, zv[u]);
        if (side != nullptr) load_n<4>(side + i, FULL, n_in, sv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u * kWarps;
      const int gr = m0 + r;
      if (gr >= M || gc >= N) continue;
      const float4 a4 = *reinterpret_cast<const float4*>(so + r * kOP + c);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      if (!act) {  // past the activated columns: the raw product
        float* p = raw + (size_t)gr * n_raw + (gc - n_act);
        for (int j = 0; j < 4 && gc + j < N; ++j) p[j] = av[j];
        continue;
      }
      if constexpr (!FULL) {  // a group straddling n_act: its columns past it raw
        for (int j = n_in; j < 4 && gc + j < N; ++j)
          raw[(size_t)gr * n_raw + (gc + j - n_act)] = av[j];
      }
      float v[4], w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f, d1, d2 = 0.f;
        if constexpr (neddf::kZeroDeriv2<ACT>) {
          neddf::act_fn<ACT>(zv[u][j], f, d1);
        } else {
          neddf::act_fn3<ACT>(zv[u][j], f, d1, d2);
        }
        if (adjoint) {
          v[j] = av[j] * d1;
          w[j] = av[j] * (side != nullptr ? sv[u][j] : (gc + j == 0 ? 1.f : 0.f)) * d2;
        } else {
          v[j] = av[j] * d1 + sv[u][j];
          w[j] = av[j];
          dsum[j] += v[j];
        }
      }
      const size_t i = (size_t)gr * n_act + gc;
      if (out != nullptr) store_n<4>(out + i, FULL, n_in, v);
      if (out2 != nullptr) store_n<4>(out2 + i, FULL, n_in, w);
    }
  }
  if (db == nullptr) return;
  *reinterpret_cast<float4*>(red + (tid >> 5) * kTcBN + c) =
      make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
  __syncthreads();
  if (tid < kTcBN && n0 + tid < n_act) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kTcBN + tid];
    db[(size_t)blockIdx.y * n_act + n0 + tid] = s;
  }
}

// the epilogue of a finished 128 x 128 tile whose rows are grouped by
// point (kEpiDual: tile row a * P + r is point p0 + r of stream a, P =
// 128 / S), once the kernel has put its accumulators in shared memory (a
// call of its own, as tc_epilogue). With g the product (g_{l-1} = G_l W^T)
// and z the stash z_{l-1} [S, M, N]:
//     G_v = g_v f'(z_v) + f''(z_v) sum_a g_a z_a,   G_a = g_a f'(z_v),
// rounded to T into out [S, M, N]. Each thread takes 4 columns of a point
// per pass (kU points, their S stash rows loaded together; only z_v's
// where f'' = 0; element by element where N is not a multiple of 4),
// reads the point's S rows of g from the staged tile and sums G_v over
// its points; the 8 warps' sums are added in warp order (one db partial
// per tile and column, the same on every run). FULL: N % 4 == 0, as in
// tc_epilogue
template <typename T, int ACT, int SL, bool FULL>
__device__ __noinline__ void tc_epilogue_dual(int M, int N, const TcEpi<T>& epi) {
  const T* __restrict__ zp = epi.z;
  T* __restrict__ out = epi.out;
  float* __restrict__ db = epi.db;
  constexpr bool kCouple = !neddf::kZeroDeriv2<ACT>;
  constexpr int kOP = kTcBN + 4;  // padded row of the staged f32 tile
  constexpr int kWarps = kTcThreads / 32;
  constexpr int kU = 2;  // points per pass: their loads are in flight together
  constexpr int S = 1 << SL, P = kTcBM >> SL;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * P, n0 = blockIdx.x * kTcBN;
  const size_t plane = (size_t)M * N;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const float* so = reinterpret_cast<const float*>(tc_smem);
  float* red = reinterpret_cast<float*>(tc_smem) + kTcBM * kOP;  // [8 warps][kTcBN]
  const int c = (tid & 31) * 4;  // this thread's 4 columns of the tile
  const int gc = n0 + c;
  const int n_in = FULL ? 4 : min(4, N - gc);
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int r0 = tid >> 5; r0 < P; r0 += kU * kWarps) {
    float zv[kU][kMaxStreams][4];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pt = p0 + r0 + u * kWarps;
      const bool live = r0 + u * kWarps < P && pt < M && gc < N;
      const size_t i = (size_t)pt * N + gc;
#pragma unroll
      for (int a = 0; a < kMaxStreams; ++a) {
#pragma unroll
        for (int j = 0; j < 4; ++j) zv[u][a][j] = 0.f;
        if (live && a < S && (a == 0 || kCouple))
          load_n<4>(zp + a * plane + i, FULL, n_in, zv[u][a]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u * kWarps;
      const int pt = p0 + r;
      if (r >= P || pt >= M || gc >= N) continue;
      const size_t i = (size_t)pt * N + gc;
      float d1[4], d2[4], coupling[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f;
        neddf::act_fn3<ACT>(zv[u][0][j], f, d1[j], d2[j]);
      }
#pragma unroll
      for (int a = 1; a < kMaxStreams; ++a) {
        if (a >= S) break;
        const float4 g4 = *reinterpret_cast<const float4*>(so + (a * P + r) * kOP + c);
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
        float ga[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kCouple) coupling[j] = fmaf(g[j], zv[u][a][j], coupling[j]);
          ga[j] = g[j] * d1[j];
        }
        store_n<4>(out + a * plane + i, FULL, n_in, ga);
      }
      const float4 g4 = *reinterpret_cast<const float4*>(so + r * kOP + c);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = kCouple ? g[j] * d1[j] + d2[j] * coupling[j] : g[j] * d1[j];
        dsum[j] += v[j];
      }
      store_n<4>(out + i, FULL, n_in, v);
    }
  }
  *reinterpret_cast<float4*>(red + (tid >> 5) * kTcBN + c) =
      make_float4(dsum[0], dsum[1], dsum[2], dsum[3]);
  __syncthreads();
  if (tid < kTcBN && n0 + tid < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * kTcBN + tid];
    db[(size_t)blockIdx.y * N + n0 + tid] = s;
  }
}

// out[z][m][n] = sum over k in split z of A(m, k) B(k, n) (f32). A_K: A is
// [M, K] with K contiguous (else [K, M], M contiguous); B_K: B is [N, K]
// with K contiguous (else [K, N], N contiguous). With A_K, A may come in
// two K segments: columns k >= k_split from A2 (a stage that straddles
// k_split by element loads), so [qbar | cg] W runs as one product. EPI kProAct (tn)
// applies f (ACT) to A as its stages land; kEpiAct (one split) hands the
// finished tile to the epilogue (TcEpi) instead of writing it. kProDual
// (tn) and kEpiDual (nt) do the same for the dual backward over rows
// grouped by point, S = 2^SL streams of M (nt) or K (tn) points each:
// an output tile holds the S streams of 128 / S points (nt), a stage of
// the reduction the S streams of BK / S points (tn, k_chunk a multiple
// of BK / S), so the epilogue and the prologue see every stream of a
// point in one tile.
template <typename T, bool A_K, bool B_K, int ACT, int EPI, int SL>
__global__ void __launch_bounds__(kTcThreads, 2)
    tc_gemm_kernel(int M, int N, int K, int k_chunk, const TcOperand<T> A,
                   const TcOperand<T> A2, int k_split, const TcOperand<T> B,
                   float* __restrict__ out, const __grid_constant__ TcEpi<T> epi) {
  using Sh = TcShape<T>;
  constexpr int BK = Sh::BK, PK = Sh::PK, PMN = Sh::PMN, OP = Sh::OP;
  constexpr bool kF32 = std::is_same_v<T, float>;
  // A in two K segments: the nn epilogue of the sweep adjoint (a stage
  // that straddles k_split by element loads)
  constexpr bool kTwoK = EPI == kEpiAct && A_K && !B_K;
  constexpr bool kEpi = EPI == kEpiAct || EPI == kEpiDual;
  // rows grouped by point: the output rows (nt) or the reduction (tn)
  constexpr bool kGroupM = EPI == kEpiDual;
  constexpr bool kGroupK = EPI == kProDual;
  static_assert((kGroupM || kGroupK) == (SL > 0), "streams only for the dual products");
  // the f32 nt product with an epilogue and the f32 tn product with the
  // dual prologue keep their mma depths in a loop (unrolled, ptxas spilled
  // 4 and 20 bytes of them at 128 registers)
  constexpr bool kRollK = kF32 && ((kEpi && B_K) || kGroupK);
  extern __shared__ __align__(128) unsigned char tc_smem[];
  T* sA = reinterpret_cast<T*>(tc_smem);
  T* sB = sA + kTcStages * OP;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps of 64 rows x 32 columns
  const int wn = (warp & 3) * 32;
  // first output row (nt grouped: first point), and the reduction's
  // advance per stage (tn grouped: points)
  const int m0 = blockIdx.y * (kTcBM >> (kGroupM ? SL : 0)), n0 = blockIdx.x * kTcBN;
  constexpr int kstep = BK >> (kGroupK ? SL : 0);
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + kstep - 1) / kstep : 0;

  auto load = [&](int t) {
    const int k0 = kb + t * kstep;
    T* a = sA + (t % kTcStages) * OP;
    T* b = sB + (t % kTcStages) * OP;
    if constexpr (kTwoK) {
      if (k0 >= k_split) {
        tc_load_tile<T, kTcBM, BK, PK>(a, A2, m0, M, k0 - k_split, ke - k_split, tid);
      } else if (k0 + BK <= k_split) {
        tc_load_tile<T, kTcBM, BK, PK>(a, A, m0, M, k0, min(ke, k_split), tid);
      } else {
        tc_load_straddle<T, kTcBM, BK, PK>(a, A, A2, m0, M, k0, k_split, ke, tid);
      }
    } else if constexpr (A_K) {
      tc_load_tile<T, kTcBM, BK, PK, SL>(a, A, m0, M, k0, ke, tid);
    } else {
      tc_load_tile<T, BK, kTcBM, PMN, SL>(a, A, k0, ke, m0, M, tid);
    }
    if constexpr (B_K) {
      tc_load_tile<T, kTcBN, BK, PK>(b, B, n0, N, k0, ke, tid);
    } else {
      // grouped by point along K in the dual prologue's tn only
      tc_load_tile<T, BK, kTcBN, PMN, kGroupK ? SL : 0>(b, B, k0, ke, n0, N, tid);
    }
  };

  if constexpr (EPI == kEpiAct || EPI == kEpiDual) {
    // the epilogue's side planes of this tile on their way to L2 while the
    // product runs: its loads then wait on L2, not on device memory (the
    // dual epilogue's: the stash rows of its points, all S streams where
    // f'' couples them, else the value stream's)
    constexpr int kLines = kTcBN * (int)sizeof(T) / 128;  // 128-byte lines per row
    constexpr int pts = kTcBM >> SL;  // rows (points) per stream
    const int rows = kGroupM && neddf::kZeroDeriv2<ACT> ? pts : kTcBM;
    for (int i = tid; i < rows * kLines; i += kTcThreads) {
      const int r = i / kLines;
      const int gc = n0 + (i % kLines) * (128 / (int)sizeof(T));
      const int gr = m0 + r % pts;
      if (gr >= M || gc >= epi.n_act) continue;
      const size_t at = (size_t)gr * epi.n_act + gc;
      if constexpr (kGroupM) {  // tile row r: stream r / pts
        neddf::prefetch_l2(epi.z + (size_t)(r / pts) * M * epi.n_act + at);
      } else {
        neddf::prefetch_l2(epi.z + at);
        if (kF32 && epi.side != nullptr) neddf::prefetch_l2(epi.side + at);
      }
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s);
    neddf::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    neddf::cp_async_wait<kTcStages - 2>();
    if constexpr (EPI == kProAct || kGroupK) {
      tc_act_load<T, ACT, BK, kTcBM, PMN, SL>(sA + (t % kTcStages) * OP, A.vec, tid);
    }
    __syncthreads();  // stage t has landed; stage t-1 is free for refill
    if (t + kTcStages - 1 < nk) load(t + kTcStages - 1);
    neddf::cp_async_commit();
    const T* a = sA + (t % kTcStages) * OP;
    const T* b = sB + (t % kTcStages) * OP;
    // zeros past it: skip their mma (grouped, the zeros of a ragged stage
    // lie in every stream's group)
    const int k_left = kGroupK ? BK : ke - (kb + t * BK);
    // one mma depth: the warp's B fragments first, then one A fragment at
    // a time (fewer live registers than all of A first)
    auto step = [&](int kk) {
      // bfr[nj]: b0, b1 of column tile 2nj, then of 2nj+1
      uint32_t bfr[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn + nj * 16;
        if constexpr (B_K) {
          neddf::ldsm_x4(bfr[nj], neddf::smem_u32(b + (n + (lane & 7) + (lane >> 4) * 8) * PK +
                                                  kk) + ((lane >> 3) & 1) * 16);
        } else if constexpr (!kF32) {
          neddf::ldsm_x4_t(bfr[nj], neddf::smem_u32(
              b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * PMN + n + (lane >> 4) * 8));
        } else {
          const T* p = b + (kk + tq) * PMN + n + g;  // (k t, n g)
          bfr[nj][0] = __float_as_uint(p[0]);
          bfr[nj][1] = __float_as_uint(p[4 * PMN]);
          bfr[nj][2] = __float_as_uint(p[8]);
          bfr[nj][3] = __float_as_uint(p[4 * PMN + 8]);
        }
      }
      uint32_t blo[2][4];
      if constexpr (kF32) {
        neddf::split_tf32(bfr[0], blo[0]);
        neddf::split_tf32(bfr[1], blo[1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm + mi * 16;
        uint32_t af[4];
        if constexpr (A_K) {
          neddf::ldsm_x4(af, neddf::smem_u32(a + (m + (lane & 7) + ((lane >> 3) & 1) * 8) * PK +
                                             kk) + (lane >> 4) * 16);
        } else if constexpr (!kF32) {
          neddf::ldsm_x4_t(af, neddf::smem_u32(
              a + (kk + (lane & 7) + (lane >> 4) * 8) * PMN + m + ((lane >> 3) & 1) * 8));
        } else {
          const T* p = a + (kk + tq) * PMN + m + g;  // (row g, k t)
          af[0] = __float_as_uint(p[0]);
          af[1] = __float_as_uint(p[8]);
          af[2] = __float_as_uint(p[4 * PMN]);
          af[3] = __float_as_uint(p[4 * PMN + 8]);
        }
        if constexpr (kF32) {
          uint32_t alo[4];
          neddf::split_tf32(af, alo);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            neddf::mma_3xtf32(acc[mi][2 * nj], af, alo, bfr[nj][0], bfr[nj][1], blo[nj][0],
                              blo[nj][1]);
            neddf::mma_3xtf32(acc[mi][2 * nj + 1], af, alo, bfr[nj][2], bfr[nj][3],
                              blo[nj][2], blo[nj][3]);
          }
        } else {
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            neddf::mma_bf16_16816(acc[mi][2 * nj], af, bfr[nj][0], bfr[nj][1]);
            neddf::mma_bf16_16816(acc[mi][2 * nj + 1], af, bfr[nj][2], bfr[nj][3]);
          }
        }
      }
    };
    if constexpr (kRollK) {
#pragma unroll 1
      for (int kk = 0; kk < BK && kk < k_left; kk += Sh::KSTEP) step(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += Sh::KSTEP) {
        if (kk >= k_left) break;
        step(kk);
      }
    }
  }
  neddf::cp_async_wait<0>();

  if constexpr (kEpi) {
    constexpr int kOP = kTcBN + 4;  // padded row of the staged f32 tile
    static_assert(kTcBM * kOP * (int)sizeof(float) + 8 * kTcBN * (int)sizeof(float) <= kTcSmem,
                  "staged tile and column sums");
    // this thread's first element of the staged tile, from threadIdx again
    // (nothing of the product's own indexing is kept live for it)
    const int t = threadIdx.x;
    float* so = reinterpret_cast<float*>(tc_smem) + ((t >> 7) * 64 + ((t & 31) >> 2)) * kOP +
                ((t >> 5) & 3) * 32 + 2 * (t & 3);
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(so + (mi * 16 + 8 * hh) * kOP + ni * 8) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
    __syncthreads();
    if constexpr (kGroupM) {
      if ((N & 3) == 0) tc_epilogue_dual<T, ACT, SL, true>(M, N, epi);
      else tc_epilogue_dual<T, ACT, SL, false>(M, N, epi);
    } else {
      if ((epi.n_act & 3) == 0) tc_epilogue<T, ACT, true>(M, N, epi);
      else tc_epilogue<T, ACT, false>(M, N, epi);
    }
    return;
  }
  float* o = out + (size_t)blockIdx.z * M * N;
  if constexpr (A_K && B_K) {
    // dx (nt, N of a whole tile or more): its f32 output is most of the
    // bytes, so the tile goes through the free ring in shared memory and
    // out in coalesced 16-byte rows, streaming (nothing reads it again
    // here); the other layouts keep their partials in L2 for the split sum
    if (N >= kTcBN && (N & 3) == 0) {
      constexpr int kOP = kTcBN + 4;  // padded row of the staged f32 tile
      static_assert(kTcBM * kOP * (int)sizeof(float) <= kTcSmem, "staged tile");
      float* so = reinterpret_cast<float*>(tc_smem);
      __syncthreads();  // every warp is done with the ring
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(so + (wm + mi * 16 + g + 8 * hh) * kOP + wn + ni * 8 +
                                       2 * tq) =
                make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      __syncthreads();
      for (int idx = tid; idx < kTcBM * (kTcBN / 4); idx += kTcThreads) {
        const int r = idx / (kTcBN / 4);
        const int c = (idx - r * (kTcBN / 4)) * 4;
        if (m0 + r >= M || n0 + c >= N) continue;
        __stcs(reinterpret_cast<float4*>(o + (size_t)(m0 + r) * N + n0 + c),
               *reinterpret_cast<const float4*>(so + r * kOP + c));
      }
      return;
    }
  }
  const bool pairs = (N & 1) == 0;  // then (r*N + c) is even: 8-byte stores
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + wm + mi * 16 + g + 8 * hh;
        const int c = n0 + wn + ni * 8 + 2 * tq;
        if (r >= M || c >= N) continue;
        float* p = o + (size_t)r * N + c;
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
        } else {
          p[0] = acc[mi][ni][2 * hh];
          if (c + 1 < N) p[1] = acc[mi][ni][2 * hh + 1];
        }
      }
}

template <typename T, bool A_K, bool B_K, int ACT, int EPI, int SL = 0>
cudaError_t launch_tc_gemm(dim3 grid, cudaStream_t s, int M, int N, int K, int k_chunk,
                           const TcOperand<T>& a, const TcOperand<T>& a2, int k_split,
                           const TcOperand<T>& b, float* out, const TcEpi<T>& epi) {
  auto kernel = tc_gemm_kernel<T, A_K, B_K, ACT, EPI, SL>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, kTcSmem, s>>>(M, N, K, k_chunk, a, a2, k_split, b, out, epi);
  return cudaGetLastError();
}

template <typename T, bool A_K, bool B_K, int EPI, int SL = 0>
cudaError_t launch_by_act(int act, dim3 grid, cudaStream_t s, int M, int N, int K, int k_chunk,
                          const TcOperand<T>& a, const TcOperand<T>& a2, int k_split,
                          const TcOperand<T>& b, float* out, const TcEpi<T>& epi) {
  return neddf::by_act(act, [&](auto a_) {
    return launch_tc_gemm<T, A_K, B_K, decltype(a_)::value, EPI, SL>(
        grid, s, M, N, K, k_chunk, a, a2, k_split, b, out, epi);
  });
}

// the dual products (EPI kProDual / kEpiDual, A in one segment) by the
// stream count 2^sl
template <typename T, bool A_K, bool B_K, int EPI>
cudaError_t launch_dual(int act, int sl, dim3 grid, cudaStream_t s, int M, int N, int K,
                        int k_chunk, const TcOperand<T>& a, const TcOperand<T>& b, float* out,
                        const TcEpi<T>& epi) {
  if (sl == 1)
    return launch_by_act<T, A_K, B_K, EPI, 1>(act, grid, s, M, N, K, k_chunk, a, a, K, b, out,
                                              epi);
  return launch_by_act<T, A_K, B_K, EPI, 2>(act, grid, s, M, N, K, k_chunk, a, a, K, b, out,
                                            epi);
}

// the products; act < 0: no activation (f32 partials out); with act,
// layout 1 (tn) takes the prologue and layouts 0 / 2 the epilogue `epi`;
// streams > 1: the dual backward's products over rows grouped by point
template <typename T>
cudaError_t gemm_tc(int layout, int act, int streams, int M, int N, int K, const void* A,
                    long long lda, int vec_a, const void* A2, long long lda2, int vec_a2,
                    int k_split, const void* B, long long ldb, int vec_b, int splits, void* out,
                    const TcEpi<T>& epi, cudaStream_t s) {
  constexpr int E = (int)sizeof(T);
  constexpr int BK = TcShape<T>::BK;
  auto misaligned = [](const void* ptr, long long ld, int vec) {
    return (vec != 1 && vec != 2 && vec != 4 && vec * E != 16) || ld < 1 || ld % vec != 0 ||
           reinterpret_cast<uintptr_t>(ptr) % (E * vec) != 0;
  };
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (misaligned(A, lda, vec_a) || misaligned(B, ldb, vec_b)) return cudaErrorInvalidValue;
  if (A2 != nullptr &&
      (layout == 1 || misaligned(A2, lda2, vec_a2) || k_split <= 0 || k_split >= K ||
       splits != 1))
    return cudaErrorInvalidValue;
  if (A2 == nullptr) k_split = K;
  // S = streams = 2^sl planes [S, points, ld] of each grouped operand: the
  // output rows of nt (M points), the reduction of tn (K points)
  const int sl = streams == 1 ? 0 : streams == 2 ? 1 : streams == 4 ? 2 : -1;
  if (sl < 0 || (sl > 0 && (act < 0 || A2 != nullptr || layout == 2)))
    return cudaErrorInvalidValue;
  const int kstep = layout == 1 ? BK >> sl : BK;
  int k_chunk = (K + splits - 1) / splits;
  k_chunk = (k_chunk + kstep - 1) / kstep * kstep;
  const int mstep = layout == 0 ? kTcBM >> sl : kTcBM;
  const dim3 grid((N + kTcBN - 1) / kTcBN, (M + mstep - 1) / mstep, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const long long points = layout == 1 ? K : M;
  const TcOperand<T> a{static_cast<const T*>(A), lda, points * lda, vec_a};
  const TcOperand<T> a2{static_cast<const T*>(A2), lda2, 0, vec_a2};
  const TcOperand<T> b{static_cast<const T*>(B), ldb, points * ldb, vec_b};
  float* o = static_cast<float*>(out);
  if (sl > 0) {
    if (layout == 1)
      return launch_dual<T, false, false, kProDual>(act, sl, grid, s, M, N, K, k_chunk, a, b, o,
                                                    epi);
    // the stacked cotangent: one split, all N columns, no mode or side planes
    if (epi.mode != 0 || splits != 1 || epi.n_act != N || epi.z == nullptr ||
        epi.out == nullptr || epi.db == nullptr || epi.side != nullptr ||
        epi.out2 != nullptr || epi.raw != nullptr || !aligned(epi.z) || !aligned(epi.out))
      return cudaErrorInvalidValue;
    return launch_dual<T, true, true, kEpiDual>(act, sl, grid, s, M, N, K, k_chunk, a, b, o,
                                                epi);
  }
  if (act < 0) {
    if (layout == 0)
      return launch_tc_gemm<T, true, true, neddf::kTanhExp, kEpiNone>(
          grid, s, M, N, K, k_chunk, a, a2, k_split, b, o, epi);
    if (layout == 1)
      return launch_tc_gemm<T, false, false, neddf::kTanhExp, kEpiNone>(
          grid, s, M, N, K, k_chunk, a, a2, k_split, b, o, epi);
    return launch_tc_gemm<T, true, false, neddf::kTanhExp, kEpiNone>(
        grid, s, M, N, K, k_chunk, a, a2, k_split, b, o, epi);
  }
  if (layout == 1)
    return launch_by_act<T, false, false, kProAct>(act, grid, s, M, N, K, k_chunk, a, a2,
                                                   k_split, b, o, epi);
  // the epilogue sees the finished sum: one split, and 16-byte-aligned
  // side planes
  const bool adjoint = epi.mode == kModeAdjoint;
  if (splits != 1 || epi.z == nullptr || epi.n_act <= 0 || epi.n_act > N ||
      (epi.mode != kModeDact && !adjoint) || (adjoint && neddf::zero_deriv2(act)) ||
      (adjoint && epi.db != nullptr) || (epi.n_act < N) != (epi.raw != nullptr) ||
      !aligned(epi.z) || !aligned(epi.side) || !aligned(epi.out) || !aligned(epi.out2))
    return cudaErrorInvalidValue;
  if (layout == 0)
    return launch_by_act<T, true, true, kEpiAct>(act, grid, s, M, N, K, k_chunk, a, a2, k_split,
                                                 b, o, epi);
  if constexpr (std::is_same_v<T, float>) {  // nn: the f32 sweep adjoint only
    return launch_by_act<T, true, false, kEpiAct>(act, grid, s, M, N, K, k_chunk, a, a2,
                                                  k_split, b, o, epi);
  }
  return cudaErrorInvalidValue;
}

__global__ void sum_splits_kernel(long long n, int splits,
                                  const float* __restrict__ parts,
                                  float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += parts[z * n + i];
    out[i] = s;
  }
}

// the first level of the db sum: block (column group x, row group y) adds
// its rows of 32 columns, warp w taking rows w, w + 8, ... in order, and
// the 8 warps' sums in warp order; group_sums [gridDim.y, C]
__global__ void sum_rows_kernel(int R, int C, int rows_per_group,
                                const float* __restrict__ parts,
                                float* __restrict__ group_sums) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rows_per_group;
  const int r1 = min(R, r0 + rows_per_group);
  float s = 0.f;
  if (c < C)
    for (int r = r0 + warp; r < r1; r += 8) s += parts[(size_t)r * C + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][lane];
    group_sums[(size_t)blockIdx.y * C + c] = t;
  }
}

}  // namespace

// The products of one operand type (gemm_tc<T>, the arguments of
// neddf_gemm_tc below without dtype): kernels/_build.py compiles this file
// twice more, with -DNEDDF_GEMM_BF16 and with -DNEDDF_GEMM_F32, each object
// holding one type's instantiations, so that they build beside the object
// of the entry points (no define).
extern "C" int neddf_gemm_tc_bf16(int layout, int act, int mode, int streams, int M, int N, int K,
                                  const void* A, long long lda, int vec_a, const void* A2,
                                  long long lda2, int vec_a2, int k_split, const void* B,
                                  long long ldb, int vec_b, int splits, void* out,
                                  const void* z, const void* side, int n_act, void* out_t,
                                  void* out2, void* raw, void* db, void* stream);
extern "C" int neddf_gemm_tc_f32(int layout, int act, int mode, int streams, int M, int N, int K,
                                  const void* A, long long lda, int vec_a, const void* A2,
                                  long long lda2, int vec_a2, int k_split, const void* B,
                                  long long ldb, int vec_b, int splits, void* out,
                                  const void* z, const void* side, int n_act, void* out_t,
                                  void* out2, void* raw, void* db, void* stream);

#if defined(NEDDF_GEMM_BF16) || defined(NEDDF_GEMM_F32)
#ifdef NEDDF_GEMM_BF16
using GemmT = bf16;
#define NEDDF_GEMM_FN neddf_gemm_tc_bf16
#else
using GemmT = float;
#define NEDDF_GEMM_FN neddf_gemm_tc_f32
#endif
extern "C" int NEDDF_GEMM_FN(int layout, int act, int mode, int streams, int M, int N, int K,
                                  const void* A, long long lda, int vec_a, const void* A2,
                                  long long lda2, int vec_a2, int k_split, const void* B,
                                  long long ldb, int vec_b, int splits, void* out,
                                  const void* z, const void* side, int n_act, void* out_t,
                                  void* out2, void* raw, void* db, void* stream) {
  const TcEpi<GemmT> e{static_cast<const GemmT*>(z), static_cast<const float*>(side),
                       static_cast<GemmT*>(out_t), static_cast<float*>(out2),
                       static_cast<float*>(raw), static_cast<float*>(db), n_act, mode};
  return (int)gemm_tc<GemmT>(layout, act, streams, M, N, K, A, lda, vec_a, A2, lda2, vec_a2,
                             k_split, B, ldb, vec_b, splits, out, e,
                             static_cast<cudaStream_t>(stream));
}
#else

// The top layer's stacked cotangent (gstack_kernel): gv [M, width], gj
// [n_tan, M, width] (dtype 1 bf16 or 0 f32, or f32 where g_f32) and the
// stash z [n_tan + 1, M, width] (dtype), into gs (same shape and type as
// z) and the f32 db partials [ceil(M / rows_per_block), width].
extern "C" int neddf_dual_bwd_gstack(int dtype, int g_f32, int act, int n_tan, int width,
                                     int M, int rows_per_block, const void* gv,
                                     const void* gj, const void* z, void* gs,
                                     void* db_part, void* stream) {
  if (n_tan < 1 || n_tan + 1 > kMaxStreams || M <= 0 || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((M + rows_per_block - 1) / rows_per_block, (width + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dbp = static_cast<float*>(db_part);
  return (int)neddf::by_act(act, [&](auto a_) {
    constexpr int ACT = decltype(a_)::value;
    if (dtype == 1 && g_f32)
      gstack_kernel<bf16, float, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const float*>(gv),
          static_cast<const float*>(gj), static_cast<const bf16*>(z), static_cast<bf16*>(gs),
          dbp);
    else if (dtype == 1)
      gstack_kernel<bf16, bf16, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const bf16*>(gv),
          static_cast<const bf16*>(gj), static_cast<const bf16*>(z), static_cast<bf16*>(gs),
          dbp);
    else
      gstack_kernel<float, float, ACT><<<grid, block, 0, s>>>(
          n_tan + 1, width, M, rows_per_block, static_cast<const float*>(gv),
          static_cast<const float*>(gj), static_cast<const float*>(z), static_cast<float*>(gs),
          dbp);
    return cudaGetLastError();
  });
}

// The products on the tensor cores, out[z] = A B over split z of K (f32
// partials [splits, M, N]): dtype 1 bf16 operands (mma m16n8k16), 0 f32
// operands (3xTF32). layout 0 (nt): A [M, K] and B [N, K], K contiguous in
// both; 1 (tn): A [K, M] and B [K, N]; 2 (nn): A [M, K] and B [K, N].
// lda / ldb: elements between rows; vec_a / vec_b: elements per copy (8,
// 4, 2 or 1 bf16; 4, 2 or 1 f32), which the row stride and the pointer
// must allow. Any other layout, or a misaligned vector width, is refused.
// act < 0: the product alone (mode, A2 and the epilogue's planes null).
// act >= 0 (0 tanhExp, 1 ReLU, 2 LeakyReLU, 3 Softplus, 4 Sigmoid) folds
// the activation in.
// layout 1 (tn): the prologue, out = f(A) B as f32 partials (dW =
// f(z_{l-1})^T G; f(A) rounded to the operand type, as the layer's input
// was). layouts 0 (nt) and 2 (nn, f32 only), one split, out null: the
// epilogue over columns [0, n_act) with the stash z [M, n_act] (operand
// type) and the optional f32 side plane; mode 1: out_t = T(acc f'(z) +
// side), out2 = acc, db = per-128-row-tile column sums of acc f'(z) + side
// ([ceil(M / 128), n_act]); mode 2 (f'' != 0): out_t = acc f'(z), out2 =
// acc side f''(z) (no side: column 0 only); columns [n_act, N) go raw to
// `raw` [M, N - n_act]. Null outputs are not written. A2 (nt / nn): the
// columns k >= k_split of A come from A2 [M, K - k_split] (row stride
// lda2, copy width vec_a2).
// streams 2 or 4 (S; 1 otherwise): the dual backward's two products, act
// >= 0, over S planes [S, points, ld] of each grouped operand. tn (dW =
// h_in^T G over K points, split chunks a multiple of BK / S points): A is
// the stash z_{l-1} [S, K, M], its prologue h_v = f(z_v), h_a = f'(z_v)
// z_a; nt (M points, one split, n_act = N, out null, mode 0): out_t [S, M,
// N] = T(G_{l-1}) (G_v = acc_v f'(z_v) + f''(z_v) sum_a acc_a z_a, G_a =
// acc_a f'(z_v)) with z [S, M, N], db = per-tile column sums of G_v
// ([ceil(M / (128 / S)), N]).
extern "C" int neddf_gemm_tc(int dtype, int layout, int act, int mode, int streams, int M,
                             int N, int K, const void* A, long long lda, int vec_a,
                             const void* A2, long long lda2, int vec_a2, int k_split,
                             const void* B, long long ldb, int vec_b, int splits, void* out,
                             const void* z, const void* side, int n_act, void* out_t,
                             void* out2, void* raw, void* db, void* stream) {
  if (dtype < 0 || dtype > 1 || layout < 0 || layout > 2 || M <= 0 || N <= 0 || K <= 0 ||
      splits < 1 || splits > 65535 || (act < 0 || layout == 1) != (out != nullptr) ||
      (act < 0 && (A2 != nullptr || z != nullptr)))
    return (int)cudaErrorInvalidValue;
  auto fn = dtype == 1 ? neddf_gemm_tc_bf16 : neddf_gemm_tc_f32;
  return fn(layout, act, mode, streams, M, N, K, A, lda, vec_a, A2, lda2, vec_a2, k_split, B,
            ldb, vec_b, splits, out, z, side, n_act, out_t, out2, raw, db, stream);
}

// out [C] = the sum over the R rows of parts [R, C] in a fixed order: the
// rows in groups of rows_per_group (sum_rows_kernel, columns x groups
// spread over the card) into scratch [ceil(R / rows_per_group), C], then
// the groups in order (sum_splits_kernel). Two runs give the same bits.
extern "C" int neddf_sum_rows(int R, int C, int rows_per_group, const void* parts,
                              void* scratch, void* out, void* stream) {
  if (R <= 0 || C <= 0 || rows_per_group <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (R + rows_per_group - 1) / rows_per_group;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  sum_rows_kernel<<<dim3((C + 31) / 32, groups), 256, 0, s>>>(
      R, C, rows_per_group, static_cast<const float*>(parts), sc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_splits_kernel<<<grid_1d((size_t)C, 256), 256, 0, s>>>(C, groups, sc,
                                                            static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int neddf_sum_splits(long long n, int splits, const void* parts,
                                void* out, void* stream) {
  if (n <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sum_splits_kernel<<<grid_1d((size_t)n, 256), 256, 0, s>>>(
      n, splits, static_cast<const float*>(parts), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

#endif
