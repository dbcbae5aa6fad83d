// Value-only multi-segment MLP forward (mlp_seg) for sm_90a.
//
// Replaces the Pallas forward neddf_tpu/kernels/mlp.py::_run_forward
// (kernel body _fwd_kernel, public mlp_seg): layer 0 reads the segments
// as split weight rows of one [sum(seg_w), C] matrix, staged side by side
// in shared memory, and the whole trunk runs inside one block per row
// tile (mlp_tile.cuh with K=0). Its configurations:
//
// * the NeDDF eval colour trunk: segments PE(pos), PE(dir), normal, trunk
//   features (60/24/3/256), tanhExp, no post-skip layer;
// * the NeRF trunk: one segment PE(pos) (60), ReLU, 8 layers, the layer
//   after the skip consuming [h, seg0] (the Pallas _layer_pre split
//   order, mlp_tile.cuh's kSplitHiddenFirst);
// * the NeuS colour trunk: segments pos, PE(dir), grad sdf, features
//   (3/24/3/256), ReLU, 8 layers of 256 and a last layer of 3 columns
//   (last_width: its weight [fan_in, 3], its output and stash [M, 3]);
// * the NeuS SDF trunk: one segment PE(pos) (36), ReLU, 8 layers, [h, e]
//   after layer 4, always with its stash, which sdf_mlp.cu's sweep reads
//   (kernels/sdf_mlp.py launches the two in turn).
//
// Every layer is `width` wide (any width up to 512, on the instantiation
// of its width class, tile_fwd.cu) but the last, `last_width` (1 up to
// width) wide, and any of the five activations. Under a differentiated
// call (stash != null) every layer's pre-activation [M, N_l] is written
// rounded to T for the backward (mlp_bwd.cu), as the Pallas forward's
// stash variant does. Bound and design: see tile_hopper.cuh (wgmma fed by
// TMA: bf16, f32 by the 3xTF32 split); `plan` is the launch plan
// (kernels/dual_mlp.py::tile_fwd_plan's ints), `scratch` its device
// scratch.
#include "mlp_tile.cuh"

using neddf::TileArgs;

extern "C" int neddf_mlp_seg_fwd(int dtype, int act, int width, int last_width, int M, int n_seg,
                                 const void* const* seg_v, const int* seg_w,
                                 int n_layers, const void* const* w,
                                 const void* const* b, const int* split,
                                 void* const* stash, void* out, const int* plan,
                                 void* scratch, void* stream) {
  if (n_seg < 1 || n_seg > neddf::kMaxSeg || n_layers < 1 ||
      n_layers > neddf::kMaxLayers || neddf::width_class(width) == 0)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  for (int s = 0; s < n_seg; ++s) {
    a.seg_v[s] = seg_v[s];
    a.seg_j[s] = nullptr;
    a.seg_w[s] = seg_w[s];
  }
  a.n_seg = n_seg;
  for (int l = 0; l < n_layers; ++l) {
    if (split[l] != 0 && split[l] != neddf::kSplitHiddenFirst)
      return (int)cudaErrorInvalidValue;
    a.w[l] = w[l];
    a.b[l] = static_cast<const float*>(b[l]);
    a.split[l] = split[l];
    a.stash[l] = stash != nullptr ? stash[l] : nullptr;
  }
  a.n_layers = n_layers;
  a.M = M;
  a.width = width;
  a.last_width = last_width;
  a.v_out = out;
  a.j_out = nullptr;
  a.scratch = scratch;
  return neddf::tile_fwd(dtype, 0, act, a, plan, static_cast<cudaStream_t>(stream));
}
