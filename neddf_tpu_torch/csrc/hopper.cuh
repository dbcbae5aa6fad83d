// Hopper (sm_90a) machinery shared by the per-layer route's wgmma + TMA
// kernels: layer_fwd.cu (layer_fwd_wide) and route_products.cu (route_nt,
// route_tn).
//
// * mbarriers (init, arrive, expect_tx, wait on a phase's parity) and
//   TMA tile loads (2-D and 3-D boxes completing on an mbarrier).
// * wgmma: m64n128k16 bf16 with both operands from shared memory (K-major,
//   or MN-major through the transpose bits: route_tn's dW), m64n128k8 tf32
//   with A from registers; their descriptors for tiles under the 128-byte
//   swizzle (K-major: 128-byte rows, 8-row groups 1024 bytes apart;
//   MN-major: 128-byte rows of 64 M/N values per K row, 8 K rows 1024
//   bytes apart, the next 64 M/N values `lbo` bytes on); fence, commit,
//   wait, and a register fence that keeps the compiler's code off the
//   accumulators of an in-flight wgmma.
// * The 3xTF32 k8 step (tc_ops.cuh's split on wgmma): lo_a hi_b +
//   hi_a lo_b + hi_a hi_b summed from zero in a partial, waited for, and
//   added to the running sum with a rounded f32 add (the tensor core's
//   accumulation truncates; partials over a whole 32-deep k-block moved a
//   tensor-parallel NeRF step's gradient 2.1e-6 from the fused route).
// * The persistent 128 x 128 tile ring of K-major operands (`Wide<T>`):
//   its stage shapes, warp roles and setmaxnreg budgets; one tile's
//   products over the ring (`kmajor_tile`) and its hand-over to the
//   epilogue's warps through shared memory (`hand_over`).
// * Host side: cuTensorMapEncodeTiled through the runtime's driver entry
//   point (no link against libcuda), 128-byte swizzled tensor maps, the
//   current device's SM count.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_ops.cuh"

namespace neddf::hopper {

// ------------------------------------------------------------ the tile ring
constexpr int kTileRows = 128;    // rows of an output tile
constexpr int kTileCols = 128;    // its columns
constexpr int kAlign = 1024;      // the 128-byte swizzle's period
constexpr int kHandPitch = kTileCols + 4;  // f32 per row of the handed-over tile
constexpr int kHandBytes = kTileRows * kHandPitch * 4;

// the persistent K-major product by operand type: the ring's stages of a
// 128-byte k-block (64 bf16, 32 f32) of A's 128 rows and of B's 128
// columns (f32: hi and lo), 16 KB each, and its warps: 0-7 the products
// (warpgroups 0 and 1), 8 the producer (one thread), the epilogue the
// others from EPI_FIRST on. f32 (REG_SPLIT): warpgroup 3 is the epilogue,
// and setmaxnreg gives the products (64 sums, 64 partials, 32 fragments)
// the registers the producer's warpgroup and the epilogue do not need.
// bf16: the 64 sums fit the 96 registers of a block of five warpgroups,
// so no warp gives any up and warps 9-11 join the epilogue too (11 warps).
template <typename T>
struct Wide;
template <>
struct Wide<__nv_bfloat16> {
  static constexpr int BK = 64, STAGES = 4, STAGE = 2 * 16384;
  static constexpr int THREADS = 5 * 128, EPI_FIRST = 9 * 32;
  static constexpr bool REG_SPLIT = false;
  static constexpr int PROD_REGS = 0, MMA_REGS = 0, EPI_REGS = 0;
};
template <>
struct Wide<float> {
  static constexpr int BK = 32, STAGES = 3, STAGE = 3 * 16384;
  static constexpr int THREADS = 4 * 128, EPI_FIRST = 3 * 128;
  static constexpr bool REG_SPLIT = true;
  static constexpr int PROD_REGS = 40, MMA_REGS = 184, EPI_REGS = 104;
};

// a setmaxnreg budget (G's THREADS, EPI_FIRST, REG_SPLIT and the three
// counts) fits the registers a block of G::THREADS is launched with
template <typename G>
constexpr bool regs_fit() {
  constexpr int launch = 65536 / G::THREADS / 8 * 8;
  return !G::REG_SPLIT ||
         (256 * G::MMA_REGS + 128 * G::PROD_REGS + (G::THREADS - G::EPI_FIRST) * G::EPI_REGS <=
              launch * G::THREADS &&
          G::PROD_REGS <= launch && G::EPI_REGS <= launch && G::MMA_REGS >= launch);
}
static_assert(regs_fit<Wide<__nv_bfloat16>>() && regs_fit<Wide<float>>(), "setmaxnreg budget");

// the ring, the handed-over tile and the barriers: full[ST], empty[ST],
// hand_full, hand_empty
template <typename T>
constexpr int wide_smem() {
  return Wide<T>::STAGES * Wide<T>::STAGE + kHandBytes + (2 * Wide<T>::STAGES + 2) * 8;
}

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// the mbarriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's shared-memory writes visible to the async proxy (wgmma
// reading a tile that threads wrote)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// the descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: 8-row groups 1024 bytes apart; the start address advances by
// 32 bytes per k16 (bf16) or k8 (tf32) step inside the swizzled row
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// the descriptor of an MN-major 16-bit tile under the 128-byte swizzle, as
// TMA lands boxes of [K rows][64 M/N values]: a K row's 64 values in one
// 128-byte row, 8 K rows 1024 bytes apart (the stride offset), the next 64
// M/N values `lbo` bytes on (the leading offset: the next box); the start
// address advances by 2048 bytes (16 K rows) per k16 step
__device__ __forceinline__ uint64_t wg_desc_mn(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the registers of an in-flight wgmma are not touched by code the
// compiler moves across the wait (an empty asm that redefines them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d += A B over one k16 step: m64n128k16, A and B from shared memory,
// each K-major (0) or MN-major (1: the transpose bit)
template <int TRANS_A = 0, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_bf16_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// d += a B over one k8 step: m64n128k8 tf32, a from registers, B from
// shared memory (K-major: TF32 wgmma takes no other)
__device__ __forceinline__ void wgmma_tf32_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// acc += a b over one k8 step at f32 accuracy: a's hi and lo fragments,
// b's hi and lo tiles (descriptors dh, dl); the three products summed from
// zero in part, then added with a rounded add (tc_ops.cuh)
__device__ __forceinline__ void wg_3xtf32_k8(float (&acc)[64], float (&part)[64],
                                             const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                             uint64_t dh, uint64_t dl) {
  wg_fence();
  wgmma_tf32_m64n128(part, al, dh, 0);
  wgmma_tf32_m64n128(part, ah, dl, 1);
  wgmma_tf32_m64n128(part, ah, dh, 1);
  wg_commit();
  wg_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// one output tile's products over the ring's next nk k-blocks of K-major
// operands (stage and phase carried from tile to tile; the ring's shape G,
// Wide<T> or one with other STAGES): warpgroup wg's 64
// rows (A at wg * 8192 of a stage) against the tile's 128 columns (B at
// 16384; f32: B's lo plane at 32768), the f32 sum in acc; a stage is
// released by one arrive per consumer warp once its products are done.
// bars: full[ST] then empty[ST]. r0 is the thread's row g of the tile
// (g + 8 too), tq its column pair. bf16: m64n128k16 from shared memory,
// one k-block's group in flight while the previous stage is released;
// f32: A's fragments split into tf32 hi and lo as they are read, each k8
// step by wg_3xtf32_k8
template <typename T, typename G = Wide<T>>
__device__ __forceinline__ void kmajor_tile(float (&acc)[64], uint32_t base, uint32_t bars,
                                            int nk, int& stage, uint32_t& phase, int wg, int r0,
                                            int g, int tq, int lane) {
  constexpr int ST = G::STAGES;
  if constexpr (!std::is_same_v<T, float>) {
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t st = base + stage * G::STAGE;
      const uint64_t da = wg_desc(st + wg * 8192), db = wg_desc(st + 16384);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_bf16_m64n128(acc, da + 2 * kk, db + 2 * kk, (kb | kk) != 0);
      wg_commit();
      wg_wait<1>();  // the previous k-block's products are done: release its stage
      if (kb > 0 && lane == 0) mbar_arrive(bars + 8 * (ST + prev));
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (ST + prev));
  } else {
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t st = base + stage * G::STAGE;
      // A's fragments (a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of each
      // k8 step) from the swizzled rows, split into tf32 hi and lo
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = kk * 8 + tq + 4 * (i >> 1);
          const uint32_t at =
              st + (r0 + 8 * (i & 1)) * 128 + (((k >> 2) ^ g) << 4) + ((k & 3) << 2);
          split_tf32(lds_u32(at), ah[kk][i], al[kk][i]);
        }
      const uint64_t dh = wg_desc(st + 16384), dl = wg_desc(st + 32768);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wg_3xtf32_k8(acc, part, ah[kk], al[kk], dh + 2 * kk, dl + 2 * kk);
      if (lane == 0) mbar_arrive(bars + 8 * (ST + stage));
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// a finished tile into the hand-over tile h [kTileRows][kHandPitch] f32
// once the epilogue has read the previous one (hand_empty, parity flipped
// per tile in hphase), then one arrive per warp on hand_full: thread
// (g, tq) holds columns 8 j + 2 tq (+1) of rows r0 and r0 + 8
__device__ __forceinline__ void hand_over(const float (&acc)[64], float* h, uint32_t hand_full,
                                          uint32_t hand_empty, uint32_t& hphase, int r0, int tq,
                                          int lane) {
  mbar_wait(hand_empty, hphase ^ 1);
  hphase ^= 1;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(h + (r0 + 8 * hh) * kHandPitch + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  __syncwarp();
  if (lane == 0) mbar_arrive(hand_full);
}

// --------------------------------------------------------------- host side
// cuTensorMapEncodeTiled through the runtime's driver entry point (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a failure of the tensor maps' encoding, returned as kEncodeError + its CUresult
constexpr int kEncodeError = 20000;

// a tensor map of T (bf16 or f32) under the 128-byte swizzle, zero fill
// past its bounds: `rank` dims (innermost first), the byte strides of the
// outer ones, the box
template <typename T>
int encode(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        std::is_same_v<T, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        (cuuint32_t)rank, const_cast<void*>(p), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// the current device's SMs (cached per device: every launch asks)
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 0;
  return sms[dev];
}

}  // namespace neddf::hopper
