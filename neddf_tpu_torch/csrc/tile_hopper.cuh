// The fused row-tile forward on Hopper (sm_90a): every layer of a trunk
// chained in shared memory on wgmma, the weights streamed by TMA. Built
// into csrc/tile_fwd.cu's objects, one per operand type and width class
// (kernels/_build.py); the entry points are dual_mlp_fwd.cu's
// neddf_dual_mlp_fwd, mlp_fwd.cu's neddf_mlp_seg_fwd and, through the
// latter, sdf_mlp.cu's trunk (neddf::tile_fwd picks the object).
//
// Replaces the row tile of the Pallas forwards neddf_tpu/kernels/
// dual_mlp.py::_run_forward:635 (pallas_call :688), mlp.py::_run_forward
// :192 (:232) and the trunk of sdf_mlp.py::_run_forward:257 (:288): S =
// K+1 streams (the values and K tangent planes) of M points through L <=
// 12 layers,
//     z_v = x_v W + b,   z_a = x_a W,   h_v = f(z_v),   h_a = f'(z_v) z_a,
// every layer's z optionally stashed ([S, M, N_l], rounded to T, the bias
// on the value rows), the last layer's h to v_out [M, N_l] and j_out [K,
// M, N_l]. Layer 0 reads up to four input segments side by side (their
// weight rows are one matrix); a post-skip layer reads [seg0, h]
// (kSplitSegFirst, NeDDF) or [h, seg0] (kSplitHiddenFirst, NeRF, NeuS);
// every layer is N = TileArgs::width wide but the last, which may be
// narrower (TileArgs::last_width: NeuS's 3-wide colour output).
//
// The design (the plan below; kernels/dual_mlp.py::tile_fwd_plan holds
// the same numbers, and the launcher refuses a plan that differs):
// * Persistent: one block per SM walks groups of row tiles. A tile is 64
//   stacked rows, the S streams of 64 / S points; a block holds one or two
//   of them (TilePlan::consumers), each owned by one warpgroup, and a
//   producer warpgroup, one warp of which works (setmaxnreg gives the
//   other registers to the consumers).
// * The weights: the producer walks every layer's W as one schedule of
//   items (layer, N chunk, input piece, k-block) and keeps a ring of
//   stages filled against mbarriers. bf16: W [fan_in, N_l] is N-contiguous,
//   so a stage is TMA boxes of [64 k rows][64 n] under the 128-byte swizzle
//   (MN-major), which wgmma reads through its transpose bit; a layer whose
//   rows are not whole 16-byte vectors (N_l = 3, 45, 100) is copied into
//   the same layout by the producer warp's own loads. f32: one pre-pass
//   launch (tile_wt_prep) writes every layer's W^T [N][kp] as tf32 hi and
//   lo planes (K-major, as TF32 wgmma takes B), each input piece from a
//   k-block of its own; a stage is the two planes' [NC n][32 k] boxes by
//   one 3-D tensor map. Both warpgroups of a block read every stage, so a
//   pass over W serves 128 stacked rows: per row tile of 64 rows and layer
//   the block reads C * fan_in * sizeof(T) / 2 bytes of W from L2 (32 KB
//   at 256 x 256 bf16).
// * h is the A operand: a tile's activations stay in shared memory as
//   k-blocks of [64 rows][128 bytes] under the 128-byte swizzle (K-major),
//   the layout wgmma reads (bf16: A from shared memory; f32: A's fragments
//   read by the thread and split into tf32 hi and lo, the 3xTF32 step of
//   hopper.cuh). The layer-0 input (each segment from a k-block of its
//   own) and, for a post-skip layer, a copy of segment 0 are staged there
//   by the warpgroup itself, zero past each piece: a piece's k-blocks may
//   read the next piece's weight rows, which then meet zeros.
// * N chunks: wgmma m64n128 (m64n64 at the class 64) with two accumulator
//   sets, the running sum and each k-block's partial (summed from zero,
//   added with a rounded f32 add: the tensor core's accumulation
//   truncates); a layer wider than one chunk writes its output into a
//   second buffer while the next chunk still reads the first (f32 at the
//   class 512, where the two do not fit, parks it in device memory and
//   copies it back).
// * The epilogue runs in the consumer warpgroup, beside the other
//   warpgroup's products: a turn barrier passes the tensor cores from one
//   warpgroup to the other after each chunk's products (ping-pong), on
//   the chunks whose k-blocks fit the ring (a longer one, layer 0's wide
//   input or a post-skip layer, would wait for stages that only the
//   other warpgroup's reads free, and runs without turns). Rows are
//   ordered so that a thread's two accumulator rows (r, r + 8) are the
//   value and the first tangent of one point (S = 2, 4); under S = 4 the
//   two warps of a pair hold a point's four streams, each takes f and f'
//   for half the columns (the odd warp from z_v, which the even one
//   publishes) and they trade f' through shared memory. The bias loads go
//   out together; the stash and the last layer's outputs leave through
//   the output region (bf16 by stmatrix) in 16-byte rows, a warp's stores
//   whole lines.
//
// What bounds it on the H100: 2 S M fan_in N FLOPs per layer on the
// tensor cores (bf16 989 TFLOP/s; f32 by three TF32 products, 165) against
// the stash's 2 or 4 bytes per stacked row and column and layer (the K=3
// trunk's bound is its stash's bytes).
#pragma once

#include <cuda.h>

#include <mutex>

#include "hopper.cuh"
#include "mlp_tile.cuh"

namespace neddf::tile {

using namespace neddf::hopper;

// ---------------------------------------------------------------- the plan
constexpr int kRows = 64;            // stacked rows of a warpgroup's tile
constexpr int kKb = kRows * 128;     // bytes of one k-block of a tile (8 KB)
constexpr int kSmemLimit = 232448;   // shared bytes a block may use
constexpr int kMaxStages = 6;
// warpgroups: the consumers (one or two) and the producer's, whose first
// warp loads the weights and whose registers go to the consumers by
// setmaxnreg (ptxas allocates a wgmma kernel's registers by warpgroup: a
// block of three gets 168 a thread at launch)
constexpr int kThreads = 3 * 128;  // the most a block launches
// the producer's and the consumers' registers by operand type: bf16's
// producer also copies the stages of layers off 16-byte rows itself; f32's
// consumers hold the 3xTF32 step's partials and split fragments
template <typename T>
struct Regs {
  static constexpr int PROD = 56, MMA = 224;
};
template <>
struct Regs<float> {
  static constexpr int PROD = 40, MMA = 232;
};
template <typename T>
constexpr bool regs_fit() {
  return 2 * 128 * Regs<T>::MMA + 128 * Regs<T>::PROD <= 65536 / kThreads / 8 * 8 * kThreads;
}
static_assert(regs_fit<__nv_bfloat16>() && regs_fit<float>(), "setmaxnreg budget");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// a layer's input pieces, in the order of W's rows: the source (0 the
// layer-0 input, 1 the copy of segment 0, 2 the hidden state), the width,
// W's first row and the piece's first k-block (in the layer-0 input's
// region, and in W^T of the f32 pre-pass). Layer 0's segments are pieces
// of their own, each from a k-block of its own, so that a segment is
// staged with loads as wide as its own rows allow.
struct Pieces {
  int n, src[kMaxSeg], width[kMaxSeg], wrow[kMaxSeg], kbase[kMaxSeg];
};
constexpr int kSrcX0 = 0, kSrcSeg = 1, kSrcHidden = 2;

__host__ __device__ inline Pieces layer_pieces(const TileArgs& a, int l, int bk) {
  Pieces p{};
  const int w0 = a.seg_w[0], n = a.width;
  if (l == 0) {
    p.n = a.n_seg;
    for (int i = 0, row = 0, kb = 0; i < a.n_seg; ++i) {
      p.src[i] = kSrcX0; p.width[i] = a.seg_w[i]; p.wrow[i] = row; p.kbase[i] = kb;
      row += a.seg_w[i];
      kb += cdiv(a.seg_w[i], bk);
    }
  } else if (a.split[l] == kSplitSegFirst) {
    p.n = 2;
    p.src[0] = kSrcSeg; p.width[0] = w0;
    p.src[1] = kSrcHidden; p.width[1] = n; p.wrow[1] = w0; p.kbase[1] = cdiv(w0, bk);
  } else if (a.split[l] == kSplitHiddenFirst) {
    p.n = 2;
    p.src[0] = kSrcHidden; p.width[0] = n;
    p.src[1] = kSrcSeg; p.width[1] = w0; p.wrow[1] = n; p.kbase[1] = cdiv(n, bk);
  } else {
    p.n = 1;
    p.src[0] = kSrcHidden; p.width[0] = n;
  }
  return p;
}

__host__ __device__ inline int layer_width(const TileArgs& a, int l) {
  return l == a.n_layers - 1 ? a.last_width : a.width;
}

struct TilePlan {
  int nc;           // columns of an N chunk
  int consumers;    // warpgroups (row tiles) of a block
  int stages;       // of the weight ring
  int park;         // a layer's output parks in device memory
  int kb_seg, kb_a, kb_b;  // k-blocks of a warpgroup's regions: seg0's copy, A, B
  int f_bytes;      // z_v for the partner warp (S = 4)
  int wg_bytes, stage_bytes, smem;
  int kp;           // f32: k of the W^T planes
  int points, grid;
  long long park_off, scratch_bytes;
};

// the plan of a call (false: no layout fits the shared memory); S streams,
// class C, operand bytes E, sms of the card
__host__ inline bool tile_plan(const TileArgs& a, int S, int C, int E, int sms, TilePlan& p) {
  p = TilePlan{};
  const int bk = 128 / E, N = a.width;
  p.nc = C == 64 ? 64 : 128;
  const bool dbl = cdiv(N, p.nc) > 1;
  const bool split = has_split(a);
  int kbx = 0;  // the layer-0 input's k-blocks, a segment from a k-block of its own
  for (int i = 0; i < a.n_seg; ++i) kbx += cdiv(a.seg_w[i], bk);
  const int kbh = cdiv(N, bk);
  p.kb_seg = split ? cdiv(a.seg_w[0], bk) : 0;
  p.kb_a = split && a.n_seg == 1 ? kbh : (kbx > kbh ? kbx : kbh);
  p.f_bytes = S == 4 ? (64 * (p.nc + 4) + 1023) / 1024 * 1024 : 0;
  p.stage_bytes = 128 * p.nc * (E == 4 ? 2 : 1);
  auto total = [&](int nw, int st, bool park) {
    const int wg = (p.kb_seg + p.kb_a + (dbl && !park ? kbh : 0)) * kKb + p.f_bytes;
    return nw * wg + st * p.stage_bytes + (2 * st + 2) * 8;
  };
  bool found = false;
  const int tries[3][3] = {{2, 3, 0}, {1, 2, 0}, {1, 2, 1}};  // consumers, least stages, park
  for (int t = 0; t < 3 && !found; ++t) {
    if (tries[t][2] && !dbl) break;
    for (int st = kMaxStages; st >= tries[t][1] && !found; --st)
      if (total(tries[t][0], st, tries[t][2]) <= kSmemLimit) {
        p.consumers = tries[t][0];
        p.stages = st;
        p.park = tries[t][2];
        found = true;
      }
  }
  if (!found) return false;
  p.kb_b = dbl && !p.park ? kbh : 0;
  p.wg_bytes = (p.kb_seg + p.kb_a + p.kb_b) * kKb + p.f_bytes;
  p.smem = total(p.consumers, p.stages, p.park);
  if (E == 4) {
    for (int l = 0; l < a.n_layers; ++l) {
      const Pieces pc = layer_pieces(a, l, bk);
      const int k = (pc.kbase[pc.n - 1] + cdiv(pc.width[pc.n - 1], bk)) * bk;
      if (k > p.kp) p.kp = k;
    }
  }
  p.points = kRows / S;
  const long long tiles = (a.M + p.points - 1) / p.points;
  const long long groups = (tiles + p.consumers - 1) / p.consumers;
  p.grid = (int)(groups < sms ? groups : sms);
  const long long wt = (long long)a.n_layers * 2 * N * p.kp * 4;
  p.park_off = (wt + 255) / 256 * 256;
  p.scratch_bytes = p.park ? p.park_off + (long long)p.grid * kRows * C * E : wt;
  return true;
}

// ------------------------------------------------------------ the kernel
struct alignas(64) TileMaps {
  CUtensorMap w[kMaxLayers];  // bf16: layer l's W by TMA (tma[l]); f32: w[0] the W^T planes
};

struct TileRun {
  TileArgs a;
  TilePlan p;
  int tma[kMaxLayers];  // bf16: layer l's W goes by TMA (else the producer's loads)
};

__device__ __forceinline__ void sts_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_v2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ void sts_v4(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
// a barrier of n threads under id (a warpgroup, or a pair of its warps)
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the byte offset of element (row r, column c) in a K-major swizzled
// region of k-blocks [64 rows][128 bytes]
template <typename T>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int E = (int)sizeof(T), BK = 128 / E;
  const int byte = (c % BK) * E;
  return (c / BK) * kKb + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

// a pair of adjacent values of row r at column c (even) into a region
__device__ __forceinline__ void put2(uint32_t region, int r, int c, float x, float y, float*) {
  sts_v2(region + swz<float>(r, c), x, y);
}
__device__ __forceinline__ void put2(uint32_t region, int r, int c, float x, float y,
                                     __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  sts_b32(region + swz<__nv_bfloat16>(r, c), *reinterpret_cast<const uint32_t*>(&h));
}

// four (x4) or two (x2) 8 x 8 b16 blocks into shared memory: lanes 8k ..
// 8k + 7 give the 16-byte row addresses of block k, register k holds this
// lane's pair (row lane / 4, columns 2 (lane % 4), + 1) of block k, as an
// mma accumulator fragment holds it
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ void stsm_x2(uint32_t addr, uint32_t r0, uint32_t r1) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(addr), "r"(r0),
               "r"(r1)
               : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16: 8 x 8 blocks into a swizzled region, the 8-column groups g0 and g0
// + 1 (of 8 a k-block), each of rows rb_lo.. and rb_hi.. (8-aligned):
// blocks (rb_lo, g0), (rb_hi, g0), (rb_lo, g0 + 1), (rb_hi, g0 + 1)
__device__ __forceinline__ void stsm_blocks4(uint32_t region, int g0, int rb_lo, int rb_hi,
                                             int lane, uint32_t r0, uint32_t r1, uint32_t r2,
                                             uint32_t r3) {
  const int k = lane >> 3;
  const int row = ((k & 1) ? rb_hi : rb_lo) + (lane & 7);
  const int grp = g0 + (k >> 1);
  stsm_x4(region + (grp >> 3) * kKb + row * 128 + (((grp & 7) ^ (lane & 7)) << 4), r0, r1, r2, r3);
}
// blocks (rb, g0), (rb, g0 + 1)
__device__ __forceinline__ void stsm_blocks2(uint32_t region, int g0, int rb, int lane,
                                             uint32_t r0, uint32_t r1) {
  const int row = rb + (lane & 7);
  const int grp = g0 + ((lane >> 3) & 1);
  stsm_x2(region + (grp >> 3) * kKb + row * 128 + (((grp & 7) ^ (lane & 7)) << 4), r0, r1);
}

// a pair (x, y) at columns col, col + 1 of a device row p of n elements
// (16-byte aligned rows of even n: one store), the columns < n only
template <typename T>
__device__ __forceinline__ void store2(T* p, int col, int n, float x, float y) {
  if (col + 1 < n && (n & 1) == 0) {
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float2*>(p + col) = make_float2(x, y);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x, y);
    }
  } else {
    if (col < n) p[col] = from_f32<T>(x);
    if (col + 1 < n) p[col + 1] = from_f32<T>(y);
  }
}

// the point and the stream of row r of a tile: groups of 8 points, each
// group's S streams as blocks of 8 rows, so that a thread's accumulator
// rows r and r + 8 are streams s and s + 1 of one point
template <int S>
__device__ __forceinline__ int row_point(int r) {
  constexpr int SL = S == 4 ? 2 : S == 2 ? 1 : 0;
  return (r >> (3 + SL)) * 8 + (r & 7);
}
template <int S>
__device__ __forceinline__ int row_stream(int r) {
  return (r >> 3) & (S - 1);
}

// the layer-0 input of the tile's 64 rows at points m0..: segment i (of
// the first nseg) into the k-blocks of the swizzled region dst from its
// own first k-block on (Pieces), zeros past it, past M and in the tangent
// rows of a segment without tangents; each 16-byte unit by loads as wide
// as the segment's rows and addresses allow (16, 8 or 4 bytes, else
// elements), all of a unit in flight together. t: the thread of the
// warpgroup
template <typename T, int S>
__device__ __forceinline__ void stage_input(const TileArgs& a, int nseg, uint32_t dst, int m0,
                                            int t) {
  using Elem = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
  constexpr int E = (int)sizeof(T), V = 16 / E, BK = 128 / E;
  int kb0 = 0;
  for (int i = 0; i < nseg; ++i) {
    const int w = a.seg_w[i];
    const int per_row = cdiv(w, BK) * 8;
    const Elem* sv = static_cast<const Elem*>(a.seg_v[i]);
    const Elem* sj = static_cast<const Elem*>(a.seg_j[i]);
    const uintptr_t al = reinterpret_cast<uintptr_t>(sv) | reinterpret_cast<uintptr_t>(sj) |
                         (uintptr_t)(w * E);
    const int vb = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : E;
#pragma unroll 1
    for (int u = t; u < kRows * per_row; u += 128) {
      const int r = u / per_row, cu = u - r * per_row;
      const int c0 = cu * V;
      const int s = row_stream<S>(r);
      const int m = m0 + row_point<S>(r);
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      const Elem* src = m >= a.M || c0 >= w ? nullptr
                        : s == 0             ? sv + (size_t)m * w
                        : sj != nullptr      ? sj + ((size_t)(s - 1) * a.M + m) * w
                                             : nullptr;
      if (src != nullptr) {
        src += c0;
        if (c0 + V <= w && vb == 16) {
          x = __ldg(reinterpret_cast<const uint4*>(src));
        } else if (c0 + V <= w && vb == 8) {
          const uint2 p0 = __ldg(reinterpret_cast<const uint2*>(src));
          const uint2 p1 = __ldg(reinterpret_cast<const uint2*>(src) + 1);
          x = make_uint4(p0.x, p0.y, p1.x, p1.y);
        } else if (c0 + V <= w && vb == 4) {
          const uint32_t* q = reinterpret_cast<const uint32_t*>(src);
          x = make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
        } else {
          Elem e[V];
#pragma unroll
          for (int k = 0; k < V; ++k) e[k] = c0 + k < w ? __ldg(src + k) : Elem(0);
          if constexpr (V == 8) {
            x = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                           e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
          } else {
            x = make_uint4(e[0], e[1], e[2], e[3]);
          }
        }
      }
      sts_v4(dst + (kb0 + (cu >> 3)) * kKb + r * 128 + (((cu & 7) ^ (r & 7)) << 4), x);
    }
    kb0 += cdiv(w, BK);
  }
}

// --------------------------------------------------- wgmma by chunk width
// d (+)= A B over one k16 step, A K-major and B MN-major from shared
// memory: m64n128 (64 registers) or m64n64 (32)
__device__ __forceinline__ void wg_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_bf16_m64n128<0, 1>(d, da, db, scale_d);
}
__device__ __forceinline__ void wg_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (+)= a B over one k8 step, tf32, a from registers, B K-major
__device__ __forceinline__ void wg_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  wgmma_tf32_m64n128(d, a, db, scale_d);
}
__device__ __forceinline__ void wg_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// acc += a b over one k8 step at f32 accuracy (hopper.cuh's wg_3xtf32_k8
// at either chunk width)
template <int NR>
__device__ __forceinline__ void step_3xtf32(float (&acc)[NR], float (&part)[NR],
                                            const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                            uint64_t dh, uint64_t dl) {
  wg_fence();
  wg_tf32(part, al, dh, 0);
  wg_tf32(part, ah, dl, 1);
  wg_tf32(part, ah, dh, 1);
  wg_commit();
  wg_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// row (s, m) of an output of S planes [S, M, n] given as its stream-0
// plane p0 [M, n] and the others p1 [S - 1, M, n] (the stash: p1 = p0 +
// M n; the outputs: v_out and j_out)
template <typename T>
__device__ __forceinline__ T* row_of(T* p0, T* p1, int s, int m, int M, int n) {
  return s == 0 ? p0 + (size_t)m * n : p1 + ((size_t)(s - 1) * M + m) * n;
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// columns [c0, c0 + NC) of a tile's rows in the swizzled region `region`
// to rows (s, m0 + p) of the output planes (p0, p1; row_of), columns < n
// and rows < M only: 16-byte units, consecutive threads along a row (a
// warp's stores whole lines), element by element where n leaves rows off
// 16 bytes. t: the thread of the warpgroup
template <typename T, int S, int NC>
__device__ __forceinline__ void copy_out(uint32_t region, int c0, int n, int m0, int M, T* p0,
                                         T* p1, int t) {
  constexpr int E = (int)sizeof(T), V = 16 / E, BK = 128 / E;
  constexpr int PER_ROW = NC / V;  // units of a row of the chunk (a power of 2)
  const int cols = min(NC, n - c0);
  if (cols <= 0) return;
  const int per_row = (cols + V - 1) / V;
  const bool vec = (n * E) % 16 == 0;
#pragma unroll 1
  for (int u = t; u < kRows * PER_ROW; u += 128) {
    const int r = u / PER_ROW, k = u % PER_ROW;
    if (k >= per_row) continue;
    const int m = m0 + row_point<S>(r);
    if (m >= M) continue;
    const int col = c0 + k * V;
    const int byte = (col % BK) * E;
    const uint4 x = lds_v4(region + (col / BK) * kKb + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4));
    T* d = row_of(p0, p1, row_stream<S>(r), m, M, n) + col;
    if (vec && col + V <= n) {
      *reinterpret_cast<uint4*>(d) = x;
    } else {
      using Elem = std::conditional_t<sizeof(T) == 2, uint16_t, uint32_t>;
      union {
        uint4 v;
        Elem e[V];
      } y;
      y.v = x;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col + e < n) reinterpret_cast<Elem*>(d)[e] = y.e[e];
    }
  }
}

// bf16 layer l's stage for W rows [krow, krow + 64) and columns [n0, n0 +
// NC) by the producer warp's own loads, in the layout TMA gives (boxes of
// [64 rows][64 columns], 128-byte swizzle), zeros past W's rows and
// columns; then one arrive on full
template <int NC>
__device__ __forceinline__ void copy_stage(const uint16_t* w, int rows, int n, int krow,
                                           int n0, uint32_t st, uint32_t full, int lane) {
  constexpr int UNITS = 64 * NC / 8;  // 16-byte units
#pragma unroll 1
  for (int u = lane; u < UNITS; u += 32) {
    const int box = u / 512, rem = u - box * 512;
    const int k = rem >> 3, cu = rem & 7;
    const int row = krow + k;
    union {
      uint4 v;
      uint16_t e[8];
    } x;
    x.v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows) {
      const int c0 = n0 + box * 64 + cu * 8;
      for (int e = 0; e < 8; ++e)
        if (c0 + e < n) x.e[e] = w[(size_t)row * n + c0 + e];
    }
    sts_v4(st + box * kKb + k * 128 + ((cu ^ (k & 7)) << 4), x.v);
  }
  fence_async_smem();
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

template <typename T, int K, int C, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tile_fwd(const __grid_constant__ TileMaps maps, const __grid_constant__ TileRun run) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int S = K + 1;
  constexpr int E = (int)sizeof(T);
  constexpr int BK = 128 / E;
  constexpr int NC = C == 64 ? 64 : 128;
  constexpr int NR = NC / 2;  // accumulator registers of a chunk
  constexpr int FP = NC + 4;  // the z_v exchange's row pitch (f32): 2-way conflicts at most
  const TileArgs& a = run.a;
  const TilePlan& p = run.p;
  const int NW = p.consumers, ST = p.stages;

  extern __shared__ __align__(1024) unsigned char tile_smem[];
  const uint32_t base = smem_u32(tile_smem);
  if (base % kAlign != 0) __trap();
  const uint32_t ring = base + NW * p.wg_bytes;
  const uint32_t bars = ring + ST * p.stage_bytes;  // full[ST], empty[ST], turn[2]
  const uint32_t turn = bars + 16 * ST;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);            // the producer's arrive (+ the bytes)
      mbar_init(bars + 8 * (ST + s), 4 * NW);  // one arrive per consumer warp
    }
    mbar_init(turn, 4);
    mbar_init(turn + 8, 4);
    mbar_init_fence();
  }
  __syncthreads();

  const int L = a.n_layers;
  const int lane = threadIdx.x & 31;
  const int n_groups = (int)(((long long)(a.M + p.points - 1) / p.points + NW - 1) / NW);

  if (threadIdx.x >= NW * 128) {
    // ---- the producer: the weights of every layer, item by item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<T>::PROD) : "memory");
    if (threadIdx.x >= NW * 128 + 32) return;  // its warpgroup's other warps
    int stage = 0;
    uint32_t phase = 0;
    for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
      for (int l = 0; l < L; ++l) {
        const int nl = layer_width(a, l);
        const Pieces pc = layer_pieces(a, l, BK);
        const int rows = pc.wrow[pc.n - 1] + pc.width[pc.n - 1];  // W's rows
        for (int c = 0; c < cdiv(nl, NC); ++c) {
          for (int q = 0; q < pc.n; ++q) {
            for (int kb = 0; kb < cdiv(pc.width[q], BK); ++kb) {
              const uint32_t full = bars + 8 * stage, st = ring + stage * p.stage_bytes;
              mbar_wait(bars + 8 * (ST + stage), phase ^ 1);
              if constexpr (kF32) {
                if (lane == 0) {
                  mbar_expect_tx(full, p.stage_bytes);
                  const int k = (pc.kbase[q] + kb) * BK;
                  tma_load_3d(st, &maps.w[0], full, k, c * NC, 2 * l);
                  tma_load_3d(st + NC * 128, &maps.w[0], full, k, c * NC, 2 * l + 1);
                }
              } else if (run.tma[l]) {
                if (lane == 0) {
                  mbar_expect_tx(full, p.stage_bytes);
#pragma unroll
                  for (int b = 0; b < NC / 64; ++b)
                    tma_load_2d(st + b * kKb, &maps.w[l], full, c * NC + 64 * b,
                                pc.wrow[q] + kb * BK);
                }
              } else {
                copy_stage<NC>(static_cast<const uint16_t*>(a.w[l]), rows, nl,
                               pc.wrow[q] + kb * BK, c * NC, st, full, lane);
              }
              if (++stage == ST) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- a consumer warpgroup: its row tile of every group, layer by layer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<T>::MMA) : "memory");
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int w = t >> 5;  // warp of the warpgroup
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t mine = base + wg * p.wg_bytes;
  const uint32_t seg = mine, reg_a = seg + p.kb_seg * kKb, reg_b = reg_a + p.kb_a * kKb;
  const uint32_t fsc = reg_b + p.kb_b * kKb;  // z_v of S = 4: [16 points][FP] f32
  const bool x_in_seg = p.kb_seg > 0 && a.n_seg == 1;
  const bool dbl = cdiv(a.width, NC) > 1;
  T* park = p.park ? reinterpret_cast<T*>(static_cast<char*>(a.scratch) + p.park_off) +
                         (size_t)blockIdx.x * kRows * C
                   : nullptr;
  const int wg_bar = 1 + wg, pair_bar = 3 + 2 * wg + (w >> 1);
  const int hcols = cdiv(a.width, BK) * BK;  // h's columns in its region
  // the thread's accumulator rows, their streams and points
  const int r_lo = 16 * w + g, r_hi = r_lo + 8;
  const int s_lo = row_stream<S>(r_lo), s_hi = row_stream<S>(r_hi);
  const int p_lo = row_point<S>(r_lo), p_hi = row_point<S>(r_hi);
  int stage = 0;
  uint32_t phase = 0, tphase = wg == 0;

  float acc[NR], part[NR];
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int m0 = (grp * NW + wg) * p.points;
    if (p.kb_seg > 0) stage_input<T, S>(a, 1, seg, m0, t);
    if (!x_in_seg) stage_input<T, S>(a, a.n_seg, reg_a, m0, t);
    fence_async_smem();
    named_bar(wg_bar, 128);
    const int m_lo = m0 + p_lo, m_hi = m0 + p_hi;

    for (int l = 0; l < L; ++l) {
      const int nl = layer_width(a, l);
      const bool last = l == L - 1;
      const Pieces pc = layer_pieces(a, l, BK);
      // the hidden state this layer reads, and where its output goes
      // (two buffers: layer l writes B when l is even, A when odd)
      const bool two = dbl && !p.park;
      const uint32_t h_in = two && (l & 1) ? reg_b : reg_a;
      const uint32_t h_out = two && (l & 1) == 0 ? reg_b : reg_a;
      const float* bias = a.b[l];
      T* zs = static_cast<T*>(a.stash[l]);
      // the turn passes only over a chunk whose items fit the ring: the
      // stages a chunk waits for are then freed by the other warpgroup's
      // earlier chunks alone (a longer chunk runs without turns)
      int items = 0;
      for (int q = 0; q < pc.n; ++q) items += cdiv(pc.width[q], BK);
      const bool turns = NW == 2 && items <= ST;
      for (int c = 0; c < cdiv(nl, NC); ++c) {
        if (turns) {
          mbar_wait(turn + 8 * wg, tphase);
          tphase ^= 1;
        }
        // ---- the chunk's products: acc = sum over the pieces' k-blocks
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = 0.f;
        for (int q = 0; q < pc.n; ++q) {
          const uint32_t src = pc.src[q] == kSrcHidden ? h_in
                               : pc.src[q] == kSrcSeg    ? seg
                               : (x_in_seg ? seg : reg_a) + pc.kbase[q] * kKb;
          for (int kb = 0; kb < cdiv(pc.width[q], BK); ++kb) {
            mbar_wait(bars + 8 * stage, phase);
            const uint32_t st = ring + stage * p.stage_bytes;
            const uint32_t at = src + kb * kKb;
            if constexpr (kF32) {
              const uint64_t dh = wg_desc(st), dl = wg_desc(st + NC * 128);
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                uint32_t ah[4], al[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int k = kk * 8 + tq + 4 * (i >> 1);
                  const int r = r_lo + 8 * (i & 1);
                  split_tf32(lds_u32(at + r * 128 + (((k >> 2) ^ g) << 4) + ((k & 3) << 2)),
                             ah[i], al[i]);
                }
                step_3xtf32(acc, part, ah, al, dh + 2 * kk, dl + 2 * kk);
              }
            } else {
              const uint64_t da = wg_desc(at), db = wg_desc_mn(st, kKb);
              wg_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) wg_bf16(part, da + 2 * kk, db + 128 * kk, kk > 0);
              wg_commit();
              wg_wait<0>();
              fence_regs(part);
#pragma unroll
              for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(bars + 8 * (ST + stage));
            if (++stage == ST) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        if (turns) {
          __syncwarp();
          if (lane == 0) mbar_arrive(turn + 8 * (1 - wg));
        }

        // ---- the chunk's epilogue, beside the other warpgroup's products
        const bool in_lo = m_lo < a.M, in_hi = m_hi < a.M;
        // z: the bias on the value rows (a loop of loads and adds alone,
        // so that its loads are in flight together)
        if (s_lo == 0 || s_hi == 0) {
#pragma unroll
          for (int j = 0; j < NR / 4; ++j) {
            const int col = c * NC + 8 * j + 2 * tq;
            const float b0 = col < nl ? __ldg(bias + col) : 0.f;
            const float b1 = col + 1 < nl ? __ldg(bias + col + 1) : 0.f;
            if (s_lo == 0) {
              acc[4 * j] += b0;
              acc[4 * j + 1] += b1;
            }
            if (s_hi == 0) {
              acc[4 * j + 2] += b0;
              acc[4 * j + 3] += b1;
            }
          }
        }
        // S = 4: a pair of warps holds the 4 streams of 16 points, the even
        // warp the value and first tangent, the odd one the others; each
        // takes f and f' for half the columns (the odd one from z_v, its
        // half's value outputs straight into the region) and they trade f'
        const bool own = S < 4 || (w & 1) == 0;  // the warp holds its points' value rows
        constexpr int H = S == 4 ? NR / 8 : NR / 4;  // the j the warp's own pass takes
        const uint32_t xrow = fsc + (p_lo & 15) * FP * 4 + 8 * tq;  // this thread's f32 pairs
        if constexpr (S == 4) {
          if (own) {
#pragma unroll
            for (int j = H; j < NR / 4; ++j) sts_v2(xrow + 32 * j, acc[4 * j], acc[4 * j + 1]);
          }
          if (zs == nullptr || p.park) named_bar(pair_bar, 64);  // else the stash's barriers
        }
        // a pair of each accumulator row into the output region (the
        // columns it holds) or, parked, into device memory
        auto put_row = [&](int r, int j, float x0, float x1, bool zero_past) {
          const int col = c * NC + 8 * j + 2 * tq;
          if (col >= hcols) return;
          if (zero_past) {
            x0 = col < nl ? x0 : 0.f;
            x1 = col + 1 < nl ? x1 : 0.f;
          }
          put2(h_out, r, col, x0, x1, static_cast<T*>(nullptr));
        };
        if (zs != nullptr) {
          if (p.park) {
#pragma unroll
            for (int j = 0; j < NR / 4; ++j) {
              const int col = c * NC + 8 * j + 2 * tq;
              if (in_lo) store2(row_of(zs, zs + (size_t)a.M * nl, s_lo, m_lo, a.M, nl), col, nl,
                                acc[4 * j], acc[4 * j + 1]);
              if (in_hi) store2(row_of(zs, zs + (size_t)a.M * nl, s_hi, m_hi, a.M, nl), col, nl,
                                acc[4 * j + 2], acc[4 * j + 3]);
            }
          } else {
            // the stash through the output region: 16-byte rows out
            if constexpr (kF32) {
#pragma unroll
              for (int j = 0; j < NR / 4; ++j) {
                put_row(r_lo, j, acc[4 * j], acc[4 * j + 1], false);
                put_row(r_hi, j, acc[4 * j + 2], acc[4 * j + 3], false);
              }
            } else {
#pragma unroll
              for (int j = 0; j < NR / 4; j += 2)
                if (c * NC + 8 * j < hcols)
                  stsm_blocks4(h_out, c * NC / 8 + j, 16 * w, 16 * w + 8, lane,
                               pack_bf16(acc[4 * j], acc[4 * j + 1]),
                               pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                               pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                               pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
            }
            named_bar(wg_bar, 128);
            copy_out<T, S, NC>(h_out, c * NC, nl, m0, a.M, zs, zs + (size_t)a.M * nl, t);
            named_bar(wg_bar, 128);  // read before h takes the region
          }
        }
        // f(z_v), f'(z_v) z_a: the warp's own pass
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          float f0, d0, f1, d1;
          if (own) {
            if (j >= H) continue;
            act_fn<ACT>(acc[4 * j], f0, d0);
            act_fn<ACT>(acc[4 * j + 1], f1, d1);
            acc[4 * j] = f0;
            acc[4 * j + 1] = f1;
            if constexpr (S == 1) {
              float f2, d2, f3, d3;
              act_fn<ACT>(acc[4 * j + 2], f2, d2);
              act_fn<ACT>(acc[4 * j + 3], f3, d3);
              acc[4 * j + 2] = f2;
              acc[4 * j + 3] = f3;
            } else {
              acc[4 * j + 2] *= d0;
              acc[4 * j + 3] *= d1;
              if constexpr (S == 4) sts_v2(xrow + 32 * j, d0, d1);
            }
          } else if (j >= H) {
            const float2 zv = *reinterpret_cast<const float2*>(tile_smem + (xrow - base) + 32 * j);
            act_fn<ACT>(zv.x, f0, d0);
            act_fn<ACT>(zv.y, f1, d1);
            acc[4 * j] *= d0;
            acc[4 * j + 1] *= d1;
            acc[4 * j + 2] *= d0;
            acc[4 * j + 3] *= d1;
            sts_v2(xrow + 32 * j, d0, d1);
            if (p.park) {
              if (!last) {
                const int col = c * NC + 8 * j + 2 * tq;
                store2(park + (size_t)(r_lo - 16) * C, col, C, col < nl ? f0 : 0.f,
                       col + 1 < nl ? f1 : 0.f);
              } else if (in_lo) {
                store2(static_cast<T*>(a.v_out) + (size_t)m_lo * nl, c * NC + 8 * j + 2 * tq, nl,
                       f0, f1);
              }
            } else if constexpr (kF32) {
              put_row(r_lo - 16, j, f0, f1, true);  // the partner's value row
            } else {
              const int col = c * NC + 8 * j + 2 * tq;  // kept for the partner's value row
              part[2 * j] = col < nl ? f0 : 0.f;
              part[2 * j + 1] = col + 1 < nl ? f1 : 0.f;
            }
          }
        }
        if constexpr (S == 4) {
          // the partner's half of f'(z_v)
          named_bar(pair_bar, 64);
#pragma unroll
          for (int j = 0; j < NR / 4; ++j) {
            if ((own && j < H) || (!own && j >= H)) continue;
            const float2 d = *reinterpret_cast<const float2*>(tile_smem + (xrow - base) + 32 * j);
            if (!own) {
              acc[4 * j] *= d.x;
              acc[4 * j + 1] *= d.y;
            }
            acc[4 * j + 2] *= d.x;
            acc[4 * j + 3] *= d.y;
          }
        }
        // (S = 4: the even warp's value row past H is the odd warp's)
        auto value_done = [&](int j) { return S == 4 && own && j >= H; };
        if (p.park) {
#pragma unroll
          for (int j = 0; j < NR / 4; ++j) {
            const int col = c * NC + 8 * j + 2 * tq;
            if (last) {
              T* v = static_cast<T*>(a.v_out);
              T* jo = static_cast<T*>(a.j_out);
              if (in_lo && !value_done(j))
                store2(row_of(v, jo, s_lo, m_lo, a.M, nl), col, nl, acc[4 * j], acc[4 * j + 1]);
              if (in_hi)
                store2(row_of(v, jo, s_hi, m_hi, a.M, nl), col, nl, acc[4 * j + 2], acc[4 * j + 3]);
            } else {
              if (!value_done(j))
                store2(park + (size_t)r_lo * C, col, C, col < nl ? acc[4 * j] : 0.f,
                       col + 1 < nl ? acc[4 * j + 1] : 0.f);
              store2(park + (size_t)r_hi * C, col, C, col < nl ? acc[4 * j + 2] : 0.f,
                     col + 1 < nl ? acc[4 * j + 3] : 0.f);
            }
          }
        } else {
          if constexpr (kF32) {
#pragma unroll
            for (int j = 0; j < NR / 4; ++j) {
              if (!value_done(j)) put_row(r_lo, j, acc[4 * j], acc[4 * j + 1], true);
              put_row(r_hi, j, acc[4 * j + 2], acc[4 * j + 3], true);
            }
          } else {
            // zero past N, then 8 x 8 blocks by stmatrix
#pragma unroll
            for (int j = 0; j < NR / 4; ++j) {
              const int col = c * NC + 8 * j + 2 * tq;
              if (col >= nl) acc[4 * j] = acc[4 * j + 2] = 0.f;
              if (col + 1 >= nl) acc[4 * j + 1] = acc[4 * j + 3] = 0.f;
            }
#pragma unroll
            for (int j = 0; j < NR / 4; j += 2) {
              if (c * NC + 8 * j >= hcols) continue;
              const uint32_t h0 = pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
              const uint32_t h1 = pack_bf16(acc[4 * j + 6], acc[4 * j + 7]);
              if (value_done(j)) {
                stsm_blocks2(h_out, c * NC / 8 + j, 16 * w + 8, lane, h0, h1);
              } else {
                stsm_blocks4(h_out, c * NC / 8 + j, 16 * w, 16 * w + 8, lane,
                             pack_bf16(acc[4 * j], acc[4 * j + 1]), h0,
                             pack_bf16(acc[4 * j + 4], acc[4 * j + 5]), h1);
              }
              if (S == 4 && !own && j >= H)  // the partner's value row, kept above
                stsm_blocks2(h_out, c * NC / 8 + j, 16 * (w - 1), lane,
                             pack_bf16(part[2 * j], part[2 * j + 1]),
                             pack_bf16(part[2 * j + 2], part[2 * j + 3]));
            }
          }
          if (last) {
            named_bar(wg_bar, 128);
            copy_out<T, S, NC>(h_out, c * NC, nl, m0, a.M, static_cast<T*>(a.v_out),
                               static_cast<T*>(a.j_out), t);
          }
        }
        fence_async_smem();
        named_bar(wg_bar, 128);  // the chunk's h is complete (and fsc read)
      }
      if (p.park && !last) {
        // the parked output back into A (every product of the layer is done)
        const int per_row = cdiv(a.width, BK) * 8;
        constexpr int V = 16 / E;
#pragma unroll 1
        for (int u = t; u < kRows * per_row; u += 128) {
          const int r = u / per_row, cu = u - r * per_row;
          const uint4 v = *reinterpret_cast<const uint4*>(park + (size_t)r * C + cu * V);
          sts_v4(reg_a + (cu >> 3) * kKb + r * 128 + (((cu & 7) ^ (r & 7)) << 4), v);
        }
        fence_async_smem();
        named_bar(wg_bar, 128);
      }
    }
  }
}

// every layer's W^T [N][kp] (k contiguous) as tf32 hi and lo planes of the
// buffer [L][2][N][kp]: row n of layer l from W_l's column n, each input
// piece at its k-block (zeros between the pieces, past them and past N_l).
// 32 x 32 tiles through shared memory; grid (kp / 32, N / 32, L). A
// template of the class C only so that each object (tile_fwd.cu, one per
// class) holds its own.
struct PrepArgs {
  const float* w[kMaxLayers];
  int nl[kMaxLayers];
  Pieces pc[kMaxLayers];
  int N, kp;
  float* out;
};

template <int C>
__global__ void tile_wt_prep(const __grid_constant__ PrepArgs a) {
  __shared__ float tile[32][33];
  const int l = blockIdx.z;
  const int kb = blockIdx.x * 32, nb = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const Pieces& pc = a.pc[l];
  const int nl = a.nl[l];
  for (int r = ty; r < 32; r += 8) {
    const int kp = kb + r, n = nb + tx;
    float v = 0.f;
    for (int q = 0; q < pc.n; ++q) {
      const int k = kp - pc.kbase[q] * 32;
      if (k >= 0 && k < pc.width[q] && n < nl) v = a.w[l][(size_t)(pc.wrow[q] + k) * nl + n];
    }
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int n = nb + r, kp = kb + tx;
    if (n >= a.N) continue;
    const float v = tile[tx][r];
    const float h = __uint_as_float(tf32_rna(v));
    const size_t i = ((size_t)(2 * l) * a.N + n) * a.kp + kp;
    a.out[i] = h;
    a.out[i + (size_t)a.N * a.kp] = __uint_as_float(tf32_rna(v - h));
  }
}

// ------------------------------------------------------------ host side
// bf16 W maps by (address, columns, rows): an encoding is a function of
// them alone, and a step launches the same weights' maps again and again
// (encoding a trunk's eight per call doubled the launcher's host time)
struct MapCache {
  static constexpr int kSize = 64;
  struct Entry {
    const void* p;
    int cols, rows;
    CUtensorMap map;
  } e[kSize];
  int next = 0;
};

inline int w_map(const void* w, int cols, int rows, CUtensorMap* out) {
  static MapCache cache{};
  static std::mutex lock;
  const std::lock_guard<std::mutex> hold(lock);
  for (const auto& x : cache.e)
    if (x.p == w && x.cols == cols && x.rows == rows) {
      *out = x.map;
      return 0;
    }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  if (int r = encode<__nv_bfloat16>(out, w, 2, dims, strides, box)) return r;
  auto& slot = cache.e[cache.next];
  cache.next = (cache.next + 1) % MapCache::kSize;
  slot.p = w;
  slot.cols = cols;
  slot.rows = rows;
  slot.map = *out;
  return 0;
}

// the plan's numbers as the launcher passes them (kernels/dual_mlp.py::
// tile_fwd_plan's "ints")
constexpr int kPlanInts = 8;
inline void plan_ints(const TilePlan& p, int (&v)[kPlanInts]) {
  const int x[kPlanInts] = {kRows, p.consumers, p.stages, p.smem, p.park, p.kp, p.grid,
                            (int)p.scratch_bytes};
  for (int i = 0; i < kPlanInts; ++i) v[i] = x[i];
}

template <typename T, int K, int C, int ACT>
cudaError_t launch_tile(const TileArgs& a, const int* plan, cudaStream_t stream) {
  constexpr int E = (int)sizeof(T);
  constexpr bool kF32 = std::is_same_v<T, float>;
  if (a.M <= 0) return cudaSuccess;
  if (width_class(a.width) != C || a.last_width < 1 || a.last_width > a.width || plan == nullptr)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  TileRun run{};
  run.a = a;
  if (!tile_plan(a, K + 1, C, E, sms, run.p)) return cudaErrorInvalidValue;
  int mine[kPlanInts];
  plan_ints(run.p, mine);
  for (int i = 0; i < kPlanInts; ++i)
    if (mine[i] != plan[i]) return cudaErrorInvalidValue;  // the plan differs
  if (run.p.scratch_bytes > 0 && a.scratch == nullptr) return cudaErrorInvalidValue;
  constexpr int NC = C == 64 ? 64 : 128;
  TileMaps maps{};
  if constexpr (kF32) {
    PrepArgs pa{};
    for (int l = 0; l < a.n_layers; ++l) {
      pa.w[l] = static_cast<const float*>(a.w[l]);
      pa.nl[l] = layer_width(a, l);
      pa.pc[l] = layer_pieces(a, l, 32);
    }
    pa.N = a.width;
    pa.kp = run.p.kp;
    pa.out = static_cast<float*>(a.scratch);
    tile_wt_prep<C><<<dim3(run.p.kp / 32, cdiv(a.width, 32), a.n_layers), dim3(32, 8), 0,
                      stream>>>(pa);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[3] = {(cuuint64_t)run.p.kp, (cuuint64_t)a.width,
                                (cuuint64_t)(2 * a.n_layers)};
    const cuuint64_t strides[2] = {(cuuint64_t)run.p.kp * 4,
                                   (cuuint64_t)run.p.kp * 4 * a.width};
    const cuuint32_t box[3] = {32, (cuuint32_t)NC, 1};
    if (int r = encode<float>(&maps.w[0], a.scratch, 3, dims, strides, box))
      return (cudaError_t)r;
  } else {
    for (int l = 0; l < a.n_layers; ++l) {
      const int nl = layer_width(a, l);
      run.tma[l] = (nl * E) % 16 == 0 && reinterpret_cast<uintptr_t>(a.w[l]) % 16 == 0;
      if (!run.tma[l]) continue;
      const Pieces pc = layer_pieces(a, l, 64);
      if (int r = w_map(a.w[l], nl, pc.wrow[pc.n - 1] + pc.width[pc.n - 1], &maps.w[l]))
        return (cudaError_t)r;
    }
  }
  auto kernel = mlp_tile_fwd<T, K, C, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, run.p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<run.p.grid, (run.p.consumers + 1) * 128, run.p.smem, stream>>>(maps, run);
  return cudaGetLastError();
}

}  // namespace neddf::tile
