// Dual-MLP trunk forward (NeDDF distance trunk) for sm_90a.
//
// Replaces the Pallas forward neddf_tpu/kernels/dual_mlp.py::_run_forward
// (kernel body _fwd_kernel, public dual_mlp_seg) in its trunk
// configuration: K=3 tangent planes, one input segment with tangents,
// and a post-skip layer that consumes [seg0, h]; the activation is tanhExp
// (the shipped NeDDF), ReLU, LeakyReLU, Softplus or Sigmoid, and the
// width any up to 512, on the width class's instantiation of the tile
// forward (tile_hopper.cuh, built per class by tile_fwd.cu). The value v
// [M, C0] and planes j [K, M, C0] go through every layer inside the
// shared memory of a persistent block (tile_hopper.cuh); only the last
// layer's v [M, C] and j [K, M, C] reach device memory.
//
// K is a template parameter: the colour trunk's K=1 training
// configuration (four segments 60/24/3/256, tangents on the first and
// the last, no post-skip layer) is the K=1 instantiation of the same
// tile kernel. Under a differentiated call the kernel also writes each
// layer's pre-activation stack (the Pallas forward's stash,
// dual_mlp.py:570-580) for csrc/dual_mlp_bwd.cu.
//
// What bounds it on the H100, and the design (tile_hopper.cuh): in bf16
// the layers' products run on wgmma with the weights streamed by TMA, so
// the training trunk with its stash, which writes 2*C bytes per stacked
// row and layer (about 1.6 GB per step for the fine trunk), is held by
// those stash bytes and the epilogue's activations rather than by the
// products; the eval trunk (no stash) by the products and the epilogue.
// In f32 the products run by the 3xTF32 split, bound by 165 TFLOP/s of
// f32 work. `plan` is the launch plan (kernels/dual_mlp.py::
// tile_fwd_plan's ints), `scratch` its device scratch.
#include "mlp_tile.cuh"

using neddf::TileArgs;

extern "C" int neddf_dual_mlp_fwd(int dtype, int act, int n_tan, int width, int M,
                                  int n_seg, const void* const* seg_v,
                                  const void* const* seg_j, const int* seg_w,
                                  int n_layers, const void* const* w,
                                  const void* const* b, const int* split,
                                  void* const* stash, void* v_out, void* j_out,
                                  const int* plan, void* scratch, void* stream) {
  if (n_seg < 1 || n_seg > neddf::kMaxSeg || n_layers < 1 ||
      n_layers > neddf::kMaxLayers)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  for (int s = 0; s < n_seg; ++s) {
    a.seg_v[s] = seg_v[s];
    a.seg_j[s] = seg_j[s];
    a.seg_w[s] = seg_w[s];
  }
  a.n_seg = n_seg;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = w[l];
    a.b[l] = static_cast<const float*>(b[l]);
    a.split[l] = split[l];
    a.stash[l] = stash != nullptr ? stash[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.M = M;
  a.width = width;
  a.last_width = width;
  a.v_out = v_out;
  a.j_out = j_out;
  a.scratch = scratch;
  if (n_tan != 3 && n_tan != 1) return (int)cudaErrorInvalidValue;
  return neddf::tile_fwd(dtype, n_tan, act, a, plan, static_cast<cudaStream_t>(stream));
}

extern "C" const char* neddf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
