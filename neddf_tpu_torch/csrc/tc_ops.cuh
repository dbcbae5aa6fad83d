// Tensor-core and asynchronous-copy primitives for sm_90a, shared by the
// shallow nt product (dual_mlp_bwd.cu: tc_gemm_kernel), the NeuS sweep
// (sdf_sweep.cuh) and the wgmma kernels' tf32 split (hopper.cuh), in bf16
// and in f32.
//
// * mma_bf16_16816: one warp-wide mma.sync m16n8k16, bf16 operands, f32
//   accumulators in place. Fragment layout (g = lane / 4, t = lane % 4):
//   A a0 (row g, cols 2t, 2t+1), a1 (row g+8), a2 (row g, cols +8), a3
//   (row g+8, cols +8); B b0 (k 2t, 2t+1 of column g), b1 (k +8); C c0, c1
//   (row g, cols 2t, 2t+1), c2, c3 (row g+8). The products are exact; the
//   f32 accumulation is not rounded to nearest (the tile forward on
//   wgmma, tile_hopper.cuh, sums each k-block from zero and adds it with
//   a rounded f32 add).
// * mma_3xtf32: f32 operands on the tensor cores at f32 accuracy. Each
//   operand value is split as x = hi + lo with hi = tf32(x) and lo =
//   tf32(x - hi) (split_tf32: cvt.rna, round to nearest with ties away
//   from zero to 10 mantissa bits; x - hi is exact in f32), and a b is
//   taken as lo_a hi_b + hi_a lo_b + hi_a hi_b by three mma.sync m16n8k8
//   tf32, the two small terms first. The
//   dropped lo_a lo_b and the rounding of lo leave about 2^-21 of |a b|
//   per term, the order of an f32 FMA sum's own rounding over K = 256.
//   The mma does not round its f32 accumulation to nearest but toward
//   zero, so a running sum kept in its accumulators drifts toward zero
//   in proportion to the number of mma it went through: over the 2048-
//   to 4144-row splits of a NeuS dW that was 2.5e-5 of the result
//   (tc_accuracy.py --f32), and it moved an aux-head gradient norm of
//   the f32 NeDDF step by 1.4e-3 against the JAX package. So the three
//   products of one k8 step are summed from zero, where the truncation
//   is relative to that step's small partial, and added to the running
//   sum by a rounded f32 add (__fadd_rn), as an FMA sum would round.
//   Three TF32 mma per f32 multiply-add: at the H100's 495 TFLOP/s dense
//   TF32 that is 165 TFLOP/s of f32 work, against 67 on the FMA units.
//   Fragment layout of m16n8k8 tf32 (g = lane / 4, t = lane % 4): A a0
//   (row g, col t), a1 (row g+8), a2 (row g, col t+4), a3 (row g+8, col
//   t+4); B b0 (k t of column g), b1 (k t+4); C as above. An ldmatrix of
//   b16 matrices (below) reads 32-bit elements as pairs, so the same
//   byte addresses that build bf16 fragments of a K-contiguous tile
//   build tf32 ones; an M- or N-contiguous tile (no 32-bit .trans) is
//   read element by element.
// * ldsm_x4: ldmatrix of four 8x8 b16 matrices from shared memory; lanes
//   8i..8i+7 give the row addresses of matrix i, register i receives it.
// * lds_u32: one 32-bit load from a shared-memory address (a 32-bit
//   address, not a generic pointer, keeps a register free beside the
//   accumulators).
// * prefetch_l2: a line of device memory on its way to L2 (the products'
//   epilogue asks for its side planes so while the product runs).
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

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x (an f32 bit pattern) = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// a fragment of N f32 bit patterns split in place into hi (x) and lo
template <int N>
__device__ __forceinline__ void split_tf32(uint32_t (&x)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], x[i], lo[i]);
}

// d += a b at f32 accuracy: lo_a hi_b, hi_a lo_b, then hi_a hi_b, summed
// from zero and added to d with a rounded f32 add
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(t, al, bh0, bh1);
  mma_tf32_1688(t, ah, bl0, bl1);
  mma_tf32_1688(t, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], t[i]);
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr));
  return r;
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

// a 128-byte line of device memory into L2, nothing waited for
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace neddf
