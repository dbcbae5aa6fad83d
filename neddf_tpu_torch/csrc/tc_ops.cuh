// Shared-memory, tf32 and asynchronous-copy primitives for sm_90a, shared
// by the wgmma kernels (hopper.cuh, tile_hopper.cuh, the NeuS sweep in
// sdf_sweep.cuh, layer_fwd.cu, route_products.cu) and the epilogue
// backward (neddf_epilogue.cu).
//
// * split_tf32: the 3xTF32 split of an f32 operand, x = hi + lo with hi =
//   tf32(x) and lo = tf32(x - hi) (cvt.rna: round to nearest with ties
//   away from zero to 10 mantissa bits; x - hi is exact in f32). A product
//   a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b on the tensor cores
//   (hopper.cuh's wg_3xtf32_k8), the two small terms first; the dropped
//   lo_a lo_b and the rounding of lo leave about 2^-21 of |a b| per term,
//   the order of an f32 FMA sum's own rounding over K = 256. The tensor
//   core does not round its f32 accumulation to nearest but toward zero,
//   so a running sum kept in its accumulators drifts toward zero in
//   proportion to the number of products it went through (2.5e-5 of a
//   NeuS dW over its 2048- to 4144-row splits, tc_accuracy.py --f32): the
//   products of a step are summed from zero and added to the running sum
//   by a rounded f32 add (__fadd_rn), as an FMA sum would round. Three
//   TF32 products per f32 multiply-add: at the H100's 495 TFLOP/s dense
//   TF32 that is 165 TFLOP/s of f32 work, against 67 on the FMA units.
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
