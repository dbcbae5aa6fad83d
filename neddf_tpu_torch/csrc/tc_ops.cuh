// Tensor-core and asynchronous-copy primitives for sm_90a, shared by the
// bf16 product of the backwards (dual_mlp_bwd.cu: tc_gemm_kernel) and the
// bf16 row-tile forward (mlp_tile.cuh: tile_forward_tc).
//
// * mma_bf16_16816: one warp-wide mma.sync m16n8k16, bf16 operands, f32
//   accumulators in place. Fragment layout (g = lane / 4, t = lane % 4):
//   A a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols +8), a3
//   (row g+8, cols +8); B b0 (k 2t, 2t+1 of column g), b1 (k +8); C c0, c1
//   (row g, cols 2t, 2t+1), c2, c3 (row g+8). The products are exact; the
//   f32 accumulation is not rounded to nearest: in the bf16 tile forward
//   about twice as many pre-activations round to the other bf16 neighbour
//   as with an FMA sum, most of them toward zero (tc_accuracy.py).
//   Summing each mma from zero and adding it with a rounded f32 add
//   removes most of that, but needs registers the tile body lacks.
// * ldsm_x4 / ldsm_x4_t: ldmatrix of four 8x8 b16 matrices from shared
//   memory; lanes 8i..8i+7 give the row addresses of matrix i, register i
//   receives it (.trans: transposed), which builds A and B fragments from
//   tiles stored with either dimension contiguous.
// * cp_async<BYTES>: a 4-, 8- or 16-byte copy from device to shared memory
//   that bypasses the registers; only the first `src_bytes` are read, the
//   rest of the destination is zero-filled (the ragged edge of a tile).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace neddf {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace neddf
