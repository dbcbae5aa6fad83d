// SDF trunk with its channel-0 gradient (the NeuS trunk) for sm_90a.
//
// Replaces the Pallas kernels of neddf_tpu/kernels/sdf_mlp.py:
//
// * forward, _run_forward / _fwd_kernel (_trunk_and_sweep:69), as two
//   launches: the trunk h = f(z_l), z_l = in_l W_l + b_l is mlp_fwd.cu's
//   f32 row tile (tile_hopper.cuh's mlp_tile_fwd, K=0; the post-skip
//   layer reads [h, e], kSplitHiddenFirst), writing the stash z_l [M, C]
//   and h [M, C]; then sdf_sweep.cuh's sdf_sweep_kernel (wgmma fed by TMA,
//   persistent) runs the reverse sweep of channel 0:
//       p_{L-1} = onehot0 * f'(z_{L-1});  q_l = p_l W_l^T;
//       p_{l-1} = q_l[hidden] * f'(z_{l-1});  gE += q_l[e rows]
//   (the e rows of layer 0 and of every post-skip layer). p lives in
//   shared memory, gE in the tile's rows of the output; z_{l-1} is read
//   back from the stash by TMA while layer l's products run (a layer's
//   stash is M x 256 x 4 bytes, 271 MB at the NeuS step's 265,216 rows:
//   it comes from device memory, not from L2). Two kernels rather than
//   one: the trunk's regions and the sweep's in one block's shared memory
//   do not fit. Out: h, gE [M, E], the stash.
// * backward, _run_backward / _bwd_kernel:176-242, is run by the Python
//   wrapper (kernels/sdf_mlp.py::sdf_mlp_bwd_route) as products of
//   neddf_fold_nt / neddf_fold_tn (route_products.cu, f32: 3xTF32) whose epilogues and
//   prologues do the elementwise work, so no [M, C] plane makes a round
//   trip through device memory for it:
//     replay: p_{L-1} = onehot0 f'(z_{L-1}) (neddf_sdf_top); q_l = p_l
//       W_l[hidden]^T with the epilogue p_{l-1} = q_l f'(z_{l-1});
//     ascending adjoint of the sweep: qbar_0 = cg; pbar_l = [qbar_l | cg]
//       W_l (one product over both K segments) with the epilogue
//       qbar_{l+1} = pbar_l f'(z_l), and where f'' != 0 (tanhExp,
//       Softplus, Sigmoid) zs_l = pbar_l q_{l+1} f''(z_l); dW_l +=
//       qbar_l^T p_l;
//     descending trunk backward: zbar_{L-1} = ch f'(z_{L-1}) + zs_{L-1}
//       (mlp_bwd.cu's gpre); hbar = zbar_l W_l^T over all of W's rows
//       with the epilogue zbar_{l-1} = hbar f'(z_{l-1}) + zs_{l-1} and its
//       db partials, ebar from the e rows' columns; dW_l += f(z_{l-1})^T
//       zbar_l (the activation as the prologue of the product).
//   Under ReLU and LeakyReLU f'' = 0: q is not kept after the replay and
//   zs is neither written nor read; tanhExp, Softplus and Sigmoid keep
//   them. The db partials are summed by neddf_sum_rows, the
//   dW splits by neddf_sum_splits (fixed orders: bitwise reproducible).
//
// Numerics: f32 throughout (NeuS runs its trunk in f32); sums in f32; the
// products by the 3xTF32 split (tc_ops.cuh), about 2^-21 of each product.
//
// What bounds it on the H100: the forward does 2 * M * C * fan_in FLOPs
// per layer for the trunk and as many for the sweep, the backward five
// times the trunk's products; on the tensor cores at three TF32 mma per
// f32 multiply-add they are bound by 165 TFLOP/s of f32 work (495 TF32
// at 700 W), not by the bytes (a few hundred bytes per row per layer).
// The sweep's design is in sdf_sweep.cuh. sdf_top_kernel is bound by
// device memory.
#include "mlp_tile.cuh"

namespace {

// the top of the replayed sweep: p = onehot0 * f'(z), channel 0 only;
// on a column shard of the top layer (the per-layer route under tensor
// parallelism) channel 0 lies in one rank's shard, at its column `col0`,
// and every other rank's p is zero (col0 = -1)
template <int ACT>
__global__ void sdf_top_kernel(size_t n, int C, int col0, const float* __restrict__ z,
                               float* __restrict__ p) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    p[i] = (int)(i % C) == col0 ? neddf::dact<ACT>(z[i]) : 0.f;
}

int grid_1d(size_t n) { return neddf::grid_1d(n, 256); }

}  // namespace

// gE [M, E] of the trunk whose per-layer pre-activations mlp_seg's
// forward (mlp_fwd.cu, f32, [h, e] post-skip layers) wrote: every layer
// `width` wide, the weights w [fan_in_l, ld] and the stash z [M, ld] with
// rows ld elements apart (width rounded up to a multiple of 4, zeros past
// it: the caller's padded copies where width is not); launched by the plan
// `plan` (kernels/sdf_mlp.py::sweep_plan's ints; its scratch, or null),
// the sweep of the width class (tile_fwd.cu's f32 objects)
extern "C" int neddf_sdf_sweep(int act, int M, int e_dim, int width, int n_layers,
                               const void* const* w, const int* split, const void* const* z,
                               long long ld, void* ge_out, const int* plan, void* scratch,
                               void* stream) {
  if (M <= 0 || e_dim < 1 || n_layers < 2 || n_layers > neddf::kMaxLayers || z == nullptr ||
      w == nullptr || split == nullptr || neddf::width_class(width) == 0)
    return (int)cudaErrorInvalidValue;
  neddf::SweepArgs a = {};
  a.M = M;
  a.E = e_dim;
  a.N = width;
  a.L = n_layers;
  a.ld = ld;
  for (int l = 0; l < n_layers; ++l) {
    a.w[l] = static_cast<const float*>(w[l]);
    a.split[l] = split[l];
    a.z[l] = static_cast<const float*>(z[l]);
  }
  a.ge = static_cast<float*>(ge_out);
  a.scratch = scratch;
  switch (neddf::width_class(width)) {
    case 64: return neddf::neddf_sdf_sweep_64(act, &a, plan, stream);
    case 128: return neddf::neddf_sdf_sweep_128(act, &a, plan, stream);
    case 256: return neddf::neddf_sdf_sweep_256(act, &a, plan, stream);
  }
  return neddf::neddf_sdf_sweep_512(act, &a, plan, stream);
}

// p [M, width] = onehot0 * f'(z): the top of the replayed sweep (the
// backward's; the per-layer route's forward sweep too), channel 0 at
// column col0 of z's columns, or nowhere (col0 = -1: a column shard
// without it)
extern "C" int neddf_sdf_top(int act, long long n, int width, int col0, const void* z, void* p,
                             void* stream) {
  if (n <= 0 || width <= 0 || col0 < -1 || col0 >= width) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zf = static_cast<const float*>(z);
  float* pf = static_cast<float*>(p);
  return (int)neddf::by_act(act, [&](auto a_) {
    sdf_top_kernel<decltype(a_)::value><<<grid_1d(n), 256, 0, s>>>(n, width, col0, zf,
                                                                    pf);
    return cudaGetLastError();
  });
}
