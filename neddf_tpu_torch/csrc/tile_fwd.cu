// The row-tile forward (tile_hopper.cuh) of one operand type and width class,
// and for f32 the NeuS sweep (sdf_sweep.cuh) of that class: every
// activation, and K = 3, 1 and 0 tangent planes. kernels/_build.py
// compiles this file once per (type, class), with -DNEDDF_TILE_F32=0|1
// and -DNEDDF_TILE_C=64|128|256|512, each its own nvcc process, so that
// the 120 tile instantiations (and 20 sweeps) build side by side; the
// entry points neddf_dual_mlp_fwd (dual_mlp_fwd.cu), neddf_mlp_seg_fwd
// (mlp_fwd.cu) and neddf_sdf_sweep (sdf_mlp.cu) pick the object by width
// (neddf::tile_fwd).
#include "tile_hopper.cuh"

#if !defined(NEDDF_TILE_C) || !defined(NEDDF_TILE_F32)
#error "build with -DNEDDF_TILE_C=<64|128|256|512> -DNEDDF_TILE_F32=<0|1> (kernels/_build.py)"
#endif

#define NEDDF_CAT3_(a, b, c) a##b##_##c
#define NEDDF_CAT3(a, b, c) NEDDF_CAT3_(a, b, c)
#define NEDDF_CAT2_(a, b) a##b
#define NEDDF_CAT2(a, b) NEDDF_CAT2_(a, b)

#if NEDDF_TILE_F32
#include "sdf_sweep.cuh"
using TileT = float;
#define NEDDF_TILE_FN NEDDF_CAT3(neddf_tile_fwd_, f32, NEDDF_TILE_C)
#else
using TileT = __nv_bfloat16;
#define NEDDF_TILE_FN NEDDF_CAT3(neddf_tile_fwd_, bf16, NEDDF_TILE_C)
#endif

extern "C" int NEDDF_TILE_FN(int n_tan, int act, const neddf::TileArgs* a, const int* plan,
                             void* stream) {
  constexpr int C = NEDDF_TILE_C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)neddf::by_act(act, [&](auto a_) {
    constexpr int ACT = decltype(a_)::value;
    switch (n_tan) {
      case 3: return neddf::tile::launch_tile<TileT, 3, C, ACT>(*a, plan, st);
      case 1: return neddf::tile::launch_tile<TileT, 1, C, ACT>(*a, plan, st);
      case 0: return neddf::tile::launch_tile<TileT, 0, C, ACT>(*a, plan, st);
    }
    return cudaErrorInvalidValue;
  });
}

#if NEDDF_TILE_F32
extern "C" int NEDDF_CAT2(neddf_sdf_sweep_, NEDDF_TILE_C)(int act, const neddf::SweepArgs* a,
                                                      const int* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)neddf::by_act(act, [&](auto a_) {
    return neddf::sweep::launch_sweep<NEDDF_TILE_C, decltype(a_)::value>(*a, plan, st);
  });
}
#endif
