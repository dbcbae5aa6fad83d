// Value-only multi-segment MLP forward (NeDDF eval colour trunk) for
// sm_90a.
//
// Replaces the Pallas forward neddf_tpu/kernels/mlp.py::_run_forward
// (kernel body _fwd_kernel, public mlp_seg) for layouts without a
// post-skip layer: layer 0 reads the segments (PE(pos), PE(dir), normal,
// trunk features: widths 60/24/3/256) as split weight rows of one
// [343, C] matrix, staged side by side in shared memory, and the whole
// trunk runs inside one block per row tile (mlp_tile.cuh with K=0).
// NeRF's post-skip order [h, seg0] is not implemented here; the Python
// wrapper refuses it. Bound and design: see mlp_tile.cuh.
#include "mlp_tile.cuh"

using neddf::TileArgs;

extern "C" int neddf_mlp_seg_fwd(int dtype, int width, int M, int n_seg,
                                 const void* const* seg_v, const int* seg_w,
                                 int n_layers, const void* const* w,
                                 const void* const* b, void* out,
                                 void* stream) {
  if (n_seg < 1 || n_seg > neddf::kMaxSeg || n_layers < 1 ||
      n_layers > neddf::kMaxLayers)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  for (int s = 0; s < n_seg; ++s) {
    a.seg_v[s] = seg_v[s];
    a.seg_j[s] = nullptr;
    a.seg_w[s] = seg_w[s];
  }
  a.n_seg = n_seg;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = w[l];
    a.b[l] = static_cast<const float*>(b[l]);
    a.split[l] = 0;
  }
  a.n_layers = n_layers;
  a.M = M;
  a.v_out = out;
  a.j_out = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (width == 256) {
    return (int)(dtype == 1
                     ? neddf::launch_mlp_tile<__nv_bfloat16, 0, 256>(a, st)
                     : neddf::launch_mlp_tile<float, 0, 256>(a, st));
  }
  return (int)cudaErrorInvalidValue;
}
