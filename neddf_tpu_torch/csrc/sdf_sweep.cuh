// The NeuS trunk's reverse sweep of channel 0 on Hopper (sm_90a): the
// second launch of sdf_mlp.cu's forward, after the trunk (tile_hopper.cuh's
// mlp_tile_fwd<float, 0>) has written the stash z_l of every layer. Built
// into csrc/tile_fwd.cu's f32 objects, one per width class C
// (kernels/_build.py); the entry point is sdf_mlp.cu's neddf_sdf_sweep.
//
// Replaces the sweep of the Pallas forward neddf_tpu/kernels/sdf_mlp.py::
// _trunk_and_sweep:69 (its sweep :89-104) under _run_forward:257
// (pallas_call :288): starting from p_{L-1} = onehot0 f'(z_{L-1}),
//     q_l = p_l W_l^T   (over all of W_l's fan_in rows),
//     p_{l-1} = q_l[hidden] f'(z_{l-1}),
//     gE += q_l[e rows]  (layer 0, whose rows are all e rows, and each
//                         post-skip layer [h, e], whose e rows follow its N
//                         hidden rows: kSplitHiddenFirst),
// in f32 by the 3xTF32 split (tc_ops.cuh), each k-block's partial summed
// from zero and added with a rounded f32 add (the tensor core's f32
// accumulation truncates).
//
// What bounds it on the H100: the operations. At width 256, E = 36 and
// 265,216 rows (a NeuS step's two passes) the sweep does 7 x 256 x 256 +
// 2 x 36 x 256 multiply-adds a row, 253 GFLOP: 1.53 ms at 165 TFLOP/s of
// f32 work (three TF32 products each, 495 TFLOP/s at 700 W), against 0.57
// ms for the stash's 1.9 GB read once at 3.35 TB/s.
//
// The design (the plan below; kernels/sdf_mlp.py::sweep_plan holds the
// same numbers, and the launcher refuses a plan that differs):
// * Persistent, as the tile forward: one block per SM walks groups of row
//   tiles of 64 rows; a block holds one or two tiles (SweepPlan::
//   consumers), each owned by a consumer warpgroup, and a producer
//   warpgroup: warp 0 streams W by TMA, warp 1 the stash, warps 2-3 split
//   W's stages into tf32 hi and lo planes.
// * B needs no transpose: B(k, n) = W[n][k], and W's rows [fan_in][N] are
//   already K-major, as TF32 wgmma takes B. A stage is a TMA box of W's f32
//   rows [NC n][32 k] under the 128-byte swizzle; the splitter warps turn
//   it in place into the hi plane and write the lo plane beside it (the
//   same layout), then arrive on the stage's `ready` barrier, which the
//   products wait for. So W is read from L2 as one f32 plane, 4 bytes per
//   element, rather than as the two planes of a pre-pass (8 bytes): at the
//   class 256 one consumer reads it once per 64-row tile, 1864 rows x 256
//   x 4 bytes a tile at E = 36 (TMA reads no row past W's fan_in), 7.9 GB
//   at 265,216 rows against the 15.8 GB of two planes (kernels/
//   sdf_mlp.py::sweep_plan's w_l2_bytes); at the classes 64 and 128 two
//   consumers read every stage, 128 rows a pass.
// * p is the A operand: a tile's p stays in shared memory as k-blocks of
//   [64 rows][128 bytes] under the 128-byte swizzle; the thread reads its
//   fragments of a whole k-block (32 columns) and splits them, and the
//   k-block's twelve products run back to back (one wait a k-block, not
//   one a k8 step: 10% of the sweep, measured). Two regions of
//   p alternate by layer (A and B: layer l reads one and writes the
//   other), so a layer's output chunks never overwrite what its later
//   chunks read.
// * gE rides on the products: the e rows of W at layer 0 and at each
//   post-skip layer are extra N columns of that layer's product (chunks
//   of 64 columns, m64n64, where E <= 64; else of NC; rows past E are
//   TMA's zero fill), computed first, while p_l is whole, and their sums
//   go straight to the tile's rows of ge_out (the first such layer
//   writes, the others add in the same thread): gE's running sum takes
//   no shared memory, so E is not capped by it.
// * The stash read overlaps the products: warp 1 brings z_{l-1}'s row tile
//   by TMA (boxes [64 rows][32 columns], the region's own swizzle) into
//   the region that layer l writes, as soon as layer l+1 is done with it,
//   so that it lands while layer l's first products run; the epilogue
//   p_{l-1} = q f'(z) reads z from the very bytes it overwrites, after the
//   chunk's last k-block.
// * At the class 512 two regions of 128 KB do not fit: the layer's output
//   parks in device memory (the plan's scratch) and is copied back, and z
//   comes one chunk at a time into a 32 KB region of its own.
// Shared memory at the full width of a class: 64, two tiles of 2 x 16 KB
// and 6 stages of 16 KB (160 KB); 128, two tiles of 2 x 32 KB and 3
// stages of 32 KB (224 KB); 256, one tile of 2 x 64 KB and 3 stages (224
// KB); 512, one tile of 128 KB, the z region of 32 KB and 2 stages (224
// KB). None depends on E.
#pragma once

#include "tile_hopper.cuh"

namespace neddf::sweep {

using namespace neddf::hopper;
using namespace neddf::tile;

// the barriers of a block: full[ST], ready[ST], empty[ST], then zfull and
// zfree, 4 chunks for each of 2 consumers
constexpr int kZSlots = 4;

struct SweepPlan {
  int nc, ne;        // columns of a hidden chunk and of an e chunk
  int consumers, stages, park;
  int kb;            // k-blocks of p: its columns rounded up to 32
  int region_bytes;  // one region of p
  int wg_bytes, stage_bytes, smem;
  int grid;
  long long scratch_bytes;
};

__host__ __device__ constexpr int sweep_barriers(int stages) {
  return (3 * stages + 2 * 2 * kZSlots) * 8;
}

// the plan of a sweep (false: no layout fits the shared memory): M rows, E,
// N, class C, sms of the card
__host__ inline bool sweep_plan(int M, int E, int N, int C, int sms, SweepPlan& p) {
  p = SweepPlan{};
  p.nc = C == 64 ? 64 : 128;
  p.ne = p.nc == 128 && E <= 64 ? 64 : p.nc;
  p.kb = cdiv(N, 32);
  p.region_bytes = p.kb * kKb;
  p.stage_bytes = 2 * p.nc * 128;
  auto total = [&](int nw, int st, bool park) {
    const int wg = park ? p.region_bytes + p.nc / 32 * kKb : 2 * p.region_bytes;
    return nw * wg + st * p.stage_bytes + sweep_barriers(st);
  };
  bool found = false;
  const int tries[3][3] = {{2, 3, 0}, {1, 2, 0}, {1, 2, 1}};  // consumers, least stages, park
  for (int t = 0; t < 3 && !found; ++t)
    for (int st = kMaxStages; st >= tries[t][1] && !found; --st)
      if (total(tries[t][0], st, tries[t][2]) <= kSmemLimit) {
        p.consumers = tries[t][0];
        p.stages = st;
        p.park = tries[t][2];
        found = true;
      }
  if (!found) return false;
  p.wg_bytes = p.park ? p.region_bytes + p.nc / 32 * kKb : 2 * p.region_bytes;
  p.smem = total(p.consumers, p.stages, p.park);
  const long long tiles = cdiv(M, kRows);
  const long long groups = (tiles + p.consumers - 1) / p.consumers;
  p.grid = (int)(groups < sms ? groups : sms);
  p.scratch_bytes = p.park ? (long long)p.grid * kRows * C * 4 : 0;
  return true;
}

// the plan's numbers as the launcher passes them (kernels/sdf_mlp.py::
// sweep_plan's "ints")
constexpr int kSweepInts = 8;
inline void sweep_ints(const SweepPlan& p, int (&v)[kSweepInts]) {
  const int x[kSweepInts] = {kRows, p.consumers, p.stages, p.smem, p.park, p.grid,
                             (int)p.scratch_bytes, p.ne};
  for (int i = 0; i < kSweepInts; ++i) v[i] = x[i];
}

struct alignas(64) SweepMaps {
  CUtensorMap w[kMaxLayers];  // W_l's f32 rows, boxes [NC rows][32 columns]
  CUtensorMap z[kMaxLayers];  // the stash z_l, boxes [64 rows][32 columns]
};

struct SweepRun {
  SweepArgs a;
  SweepPlan p;
};

__device__ __forceinline__ float2 lds_v2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// layer l's chunks of output columns: its e chunks first (layer 0 and a
// post-skip layer), then its hidden chunks (l > 0); chunk i's first row of
// W (its first output column)
struct Chunks {
  int ne, nh;  // e chunks, hidden chunks
  __device__ __forceinline__ int row0(const SweepRun& r, int l, int i, int nc) const {
    return i < ne ? (l == 0 ? 0 : r.a.N) + i * r.p.ne : (i - ne) * nc;
  }
};
// W_l's rows (its fan-in)
__device__ __forceinline__ int w_rows(const SweepRun& r, int l) {
  return l == 0 ? r.a.E : r.a.N + (r.a.split[l] ? r.a.E : 0);
}
__device__ __forceinline__ Chunks layer_chunks(const SweepRun& r, int l, int nc) {
  const bool has_e = l == 0 || r.a.split[l] != 0;
  return Chunks{has_e ? cdiv(r.a.E, r.p.ne) : 0, l > 0 ? cdiv(r.a.N, nc) : 0};
}

// one chunk's products over the ring's next kb k-blocks: acc = p W^T for
// the warpgroup's 64 rows (region `in`) against the stage's first 2 NR
// columns (NR 64: m64n128, 32: m64n64) at f32 accuracy by the 3xTF32
// split: per k-block, A's fragments of its four k8 steps split into tf32
// hi and lo as they are read, the twelve products lo_a hi_b, hi_a lo_b,
// hi_a hi_b summed from zero in `part` by the tensor cores, then added to
// acc with a rounded f32 add (the tensor core's accumulation truncates);
// a stage is waited for on `ready` (split) and released by one arrive per
// consumer warp on `empty`
template <int NR>
__device__ __forceinline__ void chunk_products(float (&acc)[NR], float (&part)[NR], uint32_t in,
                                               int kb, uint32_t ring, int stage_bytes,
                                               int plane, uint32_t ready, uint32_t empty,
                                               int ST, int& stage, uint32_t& phase, int r_lo,
                                               int g, int tq, int lane) {
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  for (int k = 0; k < kb; ++k) {
    const uint32_t at = in + k * kKb;
    uint32_t ah[4][4], al[4][4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = kk * 8 + tq + 4 * (i >> 1);
        const int r = r_lo + 8 * (i & 1);
        split_tf32(lds_u32(at + r * 128 + (((c >> 2) ^ g) << 4) + ((c & 3) << 2)), ah[kk][i],
                   al[kk][i]);
      }
    mbar_wait(ready + 8 * stage, phase);
    const uint32_t st = ring + stage * stage_bytes;
    const uint64_t dh = wg_desc(st), dl = wg_desc(st + plane);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wg_tf32(part, al[kk], dh + 2 * kk, kk > 0);
      wg_tf32(part, ah[kk], dl + 2 * kk, 1);
      wg_tf32(part, ah[kk], dh + 2 * kk, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == ST) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// an e chunk's sums into the tile's rows of gE (columns c0.. < E): written
// by the first layer that has e rows, added by the others, each element by
// the thread that holds it every time
template <int NR>
__device__ __forceinline__ void ge_out(const float (&acc)[NR], const SweepArgs& a, int m0,
                                       int r_lo, int c0, int tq, bool first) {
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    const int col = c0 + 8 * j + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + r_lo + 8 * hh;
      if (m >= a.M) continue;
      float* d = a.ge + (size_t)m * a.E + col;
      if (col < a.E) d[0] = first ? acc[4 * j + 2 * hh] : __fadd_rn(d[0], acc[4 * j + 2 * hh]);
      if (col + 1 < a.E)
        d[1] = first ? acc[4 * j + 2 * hh + 1] : __fadd_rn(d[1], acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int C, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    sdf_sweep_kernel(const __grid_constant__ SweepMaps maps, const __grid_constant__ SweepRun run) {
  constexpr int NC = C == 64 ? 64 : 128;
  constexpr int NR = NC / 2;  // accumulator registers of a hidden chunk
  constexpr int ZB = NC / 32;  // k-blocks of a chunk
  const SweepArgs& a = run.a;
  const SweepPlan& p = run.p;
  const int NW = p.consumers, ST = p.stages;

  extern __shared__ __align__(1024) unsigned char sweep_smem[];
  const uint32_t base = smem_u32(sweep_smem);
  if (base % kAlign != 0) __trap();
  const uint32_t ring = base + NW * p.wg_bytes;
  const uint32_t bars = ring + ST * p.stage_bytes;
  const uint32_t full = bars, ready = bars + 8 * ST, empty = bars + 16 * ST;
  const uint32_t zfull = bars + 24 * ST, zfree = zfull + 8 * 2 * kZSlots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);           // the producer's arrive (+ the bytes)
      mbar_init(ready + 8 * s, 2);          // one arrive per splitter warp
      mbar_init(empty + 8 * s, 4 * NW);     // one arrive per consumer warp
    }
    for (int i = 0; i < 2 * kZSlots; ++i) {
      mbar_init(zfull + 8 * i, 1);          // warp 1's arrive (+ the bytes)
      mbar_init(zfree + 8 * i, 4);          // one arrive per warp of the consumer
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int L = a.L, kb = p.kb;
  const int lane = threadIdx.x & 31;
  const int n_groups = (int)(((long long)cdiv(a.M, kRows) + NW - 1) / NW);
  const int nh = cdiv(a.N, NC);

  if (threadIdx.x >= NW * 128) {
    // ---- the producer's warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs<float>::PROD) : "memory");
    const int pw = (threadIdx.x - NW * 128) >> 5;
    if (pw == 0) {
      // W's stages, every layer's chunks in the order the consumers take them
      if (lane != 0) return;
      int stage = 0;
      uint32_t phase = 0;
      for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x)
        for (int l = L - 1; l >= 0; --l) {
          const Chunks ch = layer_chunks(run, l, NC);
          for (int i = 0; i < ch.ne + ch.nh; ++i) {
            const int row0 = ch.row0(run, l, i, NC);
            for (int k = 0; k < kb; ++k) {
              mbar_wait(empty + 8 * stage, phase ^ 1);
              mbar_expect_tx(full + 8 * stage, NC * 128);
              tma_load_2d(ring + stage * p.stage_bytes, &maps.w[l], full + 8 * stage, k * 32,
                          row0);
              if (++stage == ST) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
    } else if (pw == 1) {
      // z_{l-1}'s row tile, chunk by chunk, into the region layer l writes
      // (parked: the z region), once the consumer has freed it
      if (lane != 0) return;
      uint32_t zph = 0;  // the parity bit of each (consumer, slot)
      for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x)
        for (int l = L - 1; l >= 1; --l)
          for (int c = 0; c < nh; ++c)
            for (int w = 0; w < NW; ++w) {
              const int slot = w * kZSlots + (p.park ? 0 : c);
              mbar_wait(zfree + 8 * slot, ((zph >> slot) & 1) ^ 1);
              zph ^= 1u << slot;
              const int boxes = min(ZB, kb - c * ZB);
              const uint32_t mine = base + w * p.wg_bytes;
              const uint32_t dst = p.park ? mine + p.region_bytes
                                          : mine + (((L - 1 - l) & 1) ? 0 : p.region_bytes) +
                                                c * ZB * kKb;
              mbar_expect_tx(zfull + 8 * slot, boxes * kKb);
              for (int b = 0; b < boxes; ++b)
                tma_load_2d(dst + b * kKb, &maps.z[l - 1], zfull + 8 * slot, (c * ZB + b) * 32,
                            (grp * NW + w) * kRows);
            }
    } else {
      // warps 2-3: each landed stage of W into its tf32 hi plane (in place)
      // and lo plane (beside it), then `ready`: the rows that lie in W (the
      // others are TMA's zeros in hi and stale in lo, and meet only output
      // columns past N or E, which no epilogue keeps)
      const int t = threadIdx.x - NW * 128 - 64;
      int stage = 0;
      uint32_t phase = 0;
      for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x)
        for (int l = L - 1; l >= 0; --l) {
          const Chunks ch = layer_chunks(run, l, NC);
          for (int i = 0; i < (ch.ne + ch.nh) * kb; ++i) {
            const int units = 8 * min(NC, w_rows(run, l) - ch.row0(run, l, i / kb, NC));
            mbar_wait(full + 8 * stage, phase);
            const uint32_t st = ring + stage * p.stage_bytes;
#pragma unroll 4
            for (int u = t; u < units; u += 64) {
              const uint4 v = lds_v4(st + u * 16);
              uint4 hi, lo;
              split_tf32(v.x, hi.x, lo.x);
              split_tf32(v.y, hi.y, lo.y);
              split_tf32(v.z, hi.z, lo.z);
              split_tf32(v.w, hi.w, lo.w);
              sts_v4(st + u * 16, hi);
              sts_v4(st + NC * 128 + u * 16, lo);
            }
            fence_async_smem();
            __syncwarp();
            if (lane == 0) mbar_arrive(ready + 8 * stage);
            if (++stage == ST) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
    }
    return;
  }

  // ---- a consumer warpgroup: its row tile of every group, layer by layer
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs<float>::MMA) : "memory");
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int w = t >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r_lo = 16 * w + g;
  const uint32_t reg_a = base + wg * p.wg_bytes;
  const uint32_t reg_b = reg_a + p.region_bytes;  // parked: the z region
  const int hcols = kb * 32;
  const int N = a.N;
  float* park =
      p.park ? static_cast<float*>(a.scratch) + (size_t)blockIdx.x * kRows * C : nullptr;
  int first_e = 0;  // the first layer of the sweep with e rows
  for (int l = L - 1; l > 0 && first_e == 0; --l)
    if (a.split[l]) first_e = l;
  // this warp's arrive on zfree[slot]: its reads of the region are done
  auto release = [&](int slot) {
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(zfree + 8 * (wg * kZSlots + slot));
  };
  int stage = 0;
  uint32_t phase = 0, zph = 0;

  float acc[NR], part[NR];
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int m0 = (grp * NW + wg) * kRows;
    // p_{L-1} = onehot0 f'(z_{L-1}) into A: the warp's own 16 rows (a warp
    // reads and writes only its own rows of p until the next group)
    for (int u = lane; u < 16 * kb * 8; u += 32) {
      const int r = 16 * w + u / (kb * 8), cu = u % (kb * 8);
      const int m = m0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (cu == 0 && m < a.M) x.x = __float_as_uint(dact<ACT>(a.z[L - 1][(size_t)m * a.ld]));
      sts_v4(reg_a + (cu >> 3) * kKb + r * 128 + (((cu & 7) ^ (r & 7)) << 4), x);
    }
    __syncwarp();

    for (int l = L - 1; l >= 0; --l) {
      const uint32_t in = p.park || ((L - 1 - l) & 1) == 0 ? reg_a : reg_b;
      const uint32_t out = p.park ? reg_b : (in == reg_a ? reg_b : reg_a);
      const Chunks ch = layer_chunks(run, l, NC);
      // ---- the e chunks: gE's columns, while p_l is whole
      for (int i = 0; i < ch.ne; ++i) {
        const int c0 = i * p.ne;
        if constexpr (NC == 128) {
          if (p.ne == 64) {
            float ea[32], ep[32];
            chunk_products<32>(ea, ep, in, kb, ring, p.stage_bytes, NC * 128, ready, empty, ST,
                               stage, phase, r_lo, g, tq, lane);
            ge_out<32>(ea, a, m0, r_lo, c0, tq, l == first_e);
            continue;
          }
        }
        chunk_products<NR>(acc, part, in, kb, ring, p.stage_bytes, NC * 128, ready, empty, ST,
                           stage, phase, r_lo, g, tq, lane);
        ge_out<NR>(acc, a, m0, r_lo, c0, tq, l == first_e);
      }
      // ---- the hidden chunks: p_{l-1} = q f'(z_{l-1})
      for (int c = 0; c < ch.nh; ++c) {
        chunk_products<NR>(acc, part, in, kb, ring, p.stage_bytes, NC * 128, ready, empty, ST,
                           stage, phase, r_lo, g, tq, lane);
        const int slot = p.park ? 0 : c;
        mbar_wait(zfull + 8 * (wg * kZSlots + slot), (zph >> slot) & 1);
        zph ^= 1u << slot;
#pragma unroll
        for (int j = 0; j < NR / 4; ++j) {
          const int col = c * NC + 8 * j + 2 * tq;
          if (col >= hcols) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r_lo + 8 * hh;
            const uint32_t at = out + swz<float>(r, p.park ? col - c * NC : col);
            const float2 z = lds_v2(at);
            const float x = col < N ? acc[4 * j + 2 * hh] * dact<ACT>(z.x) : 0.f;
            const float y = col + 1 < N ? acc[4 * j + 2 * hh + 1] * dact<ACT>(z.y) : 0.f;
            if (p.park) {
              *reinterpret_cast<float2*>(park + (size_t)r * C + col) = make_float2(x, y);
            } else {
              sts_v2(at, x, y);
            }
          }
        }
        if (p.park) release(0);  // the z region is read
      }
      // `in` is read for the last time and every z of this layer waited
      // for: it takes z_{l-2} next (a consumer arrives on a slot only after
      // its last phase was waited for, so its arrivals never run a phase
      // ahead of the producer's waits)
      if (!p.park && l >= 2)
        for (int s = 0; s < nh; ++s) release(s);
      if (p.park && l > 0) {
        // the parked output back into A (every product of the layer is done)
        named_bar(1 + wg, 128);
#pragma unroll 1
        for (int u = t; u < kRows * kb * 8; u += 128) {
          const int r = u / (kb * 8), cu = u - r * (kb * 8);
          const uint4 v = *reinterpret_cast<const uint4*>(park + (size_t)r * C + cu * 4);
          sts_v4(reg_a + (cu >> 3) * kKb + r * 128 + (((cu & 7) ^ (r & 7)) << 4), v);
        }
        named_bar(1 + wg, 128);
      }
      __syncwarp();
    }
    // every read of this group's regions is done: B takes the next group's
    // z_{L-2}
    if (!p.park)
      for (int s = 0; s < nh; ++s) release(s);
  }
}

template <int C, int ACT>
cudaError_t launch_sweep(const SweepArgs& a, const int* plan, cudaStream_t stream) {
  constexpr int NC = C == 64 ? 64 : 128;
  if (a.M <= 0) return cudaSuccess;
  if (width_class(a.N) != C || a.E < 1 || a.L < 2 || a.L > kMaxLayers || a.ld < a.N ||
      a.ld % 4 != 0 || a.ge == nullptr || plan == nullptr)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  SweepRun run{};
  run.a = a;
  if (!sweep_plan(a.M, a.E, a.N, C, sms, run.p)) return cudaErrorInvalidValue;
  int mine[kSweepInts];
  sweep_ints(run.p, mine);
  for (int i = 0; i < kSweepInts; ++i)
    if (mine[i] != plan[i]) return cudaErrorInvalidValue;  // the plan differs
  if (run.p.park && a.scratch == nullptr) return cudaErrorInvalidValue;
  SweepMaps maps{};
  for (int l = 0; l < a.L; ++l) {
    if (a.w[l] == nullptr || a.z[l] == nullptr || (l == 0 && a.split[l] != 0) ||
        (a.split[l] != 0 && a.split[l] != kSplitHiddenFirst) ||
        reinterpret_cast<uintptr_t>(a.w[l]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(a.z[l]) % 16 != 0)
      return cudaErrorInvalidValue;
    const int fan_in = l == 0 ? a.E : a.N + (a.split[l] ? a.E : 0);
    const cuuint64_t wdims[2] = {(cuuint64_t)a.ld, (cuuint64_t)fan_in};
    const cuuint64_t strides[1] = {(cuuint64_t)a.ld * 4};
    const cuuint32_t wbox[2] = {32, (cuuint32_t)NC};
    if (int r = encode<float>(&maps.w[l], a.w[l], 2, wdims, strides, wbox)) return (cudaError_t)r;
    if (l == a.L - 1) continue;
    const cuuint64_t zdims[2] = {(cuuint64_t)a.ld, (cuuint64_t)a.M};
    const cuuint32_t zbox[2] = {32, (cuuint32_t)kRows};
    if (int r = encode<float>(&maps.z[l], a.z[l], 2, zdims, strides, zbox)) return (cudaError_t)r;
  }
  auto kernel = sdf_sweep_kernel<C, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, run.p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<run.p.grid, (run.p.consumers + 1) * 128, run.p.smem, stream>>>(maps, run);
  return cudaGetLastError();
}

}  // namespace neddf::sweep
