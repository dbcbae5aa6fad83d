#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: build, check and drive its kernels.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --phase 24   # the build and phase 24 alone
    python3 chip_smoke.py --phase 25   # the build and phase 25 alone
    python3 chip_smoke.py --phase 26   # the build and phase 26 alone

Phases (any failure stops the script with a non-zero exit code):

1. versions of torch, CUDA and nvcc, and the card's name and power limit;
2. build the CUDA kernels from ``neddf_tpu_torch/csrc`` (timed); in the
   built library's SASS every tensor-core kernel (the per-layer route's
   layer forward, the backward products, the row-tile forward and the
   NeuS sweep, ``TC_FUNCTIONS``) has HGMMA (warpgroup wgmma)
   instructions and no other tensor-core ones, on TF32 operands in the
   f32 instantiations (the 3xTF32 split) and not in the bf16 ones; no
   mma.sync HMMA is left anywhere in the library; ptxas reports no spills
   in them nor in the FMA kernels of ``SPILL_FUNCTIONS`` (the epilogue
   backward, the narrow layer forward, the shallow nt);
3. each kernel against its plain PyTorch version at the eval render's
   shapes (M = 1024 rays x 194 fine samples, and a ragged M), in f32 and
   bf16, with the median CUDA-event times of both;
4. the eval render of ``pretrained/machine_neddf`` (epoch 1000) through
   ``neddf_tpu_torch.scripts.run_eval``: test camera 0 at downsampling 8
   (>= 29.3 dB, SSIM >= 0.96 against the point-sampled ground truth) and
   at full resolution (within 0.2 dB of the JAX package's 29.79 dB), with
   the launch counts of both kernels over that run, every tile forward on
   the tensor-core body and no call of a plain version; then a patch of rays rendered with the kernels and with the
   plain versions agrees, with f32 and with bf16 trunks;
5. one more full-resolution render of cam 0 under ``torch.profiler``:
   the device's busy share and the kernels by device time, also written
   to ``chiprun_out/chip_smoke/profile.txt``;
6. the training path's kernel routes against their plain versions at the
   train step's shapes (M = 512 rays x 194 fine samples, and the coarse
   pass's 512 x 65 plus a ragged 7), in f32 and bf16, with times: the
   trunk forward with its stash, the K=1 colour forward, the dual-MLP
   backward (trunk and colour configurations: one top-layer ``gstack``
   per call, every layer below through the products with the stacked
   cotangent and the layer input folded in, no ``dual_act``) and the
   epilogue forward and backward, the backward in both modes: standalone
   (dv, dj) and the main path's top mode (the K=3 trunk's top-layer
   stacked cotangent gs, bitwise equal to the standalone mode, torch's
   add and ``gstack``), timed beside those three steps (the epilogue's
   routes by their kernels' device time, ``DEVICE_TIMED``); two backward
   runs must give bitwise-equal dW / db; then
   the trunk and the colour trunk with ReLU and LeakyReLU (ragged rows,
   both precisions), each forward layer held to the plain layer over the
   kernel's own stash (f' is a step at 0 there), and the epilogue
   backward's top mode on the K=3 trunk's outputs;
6b. the tensor-core product of the backwards alone, bf16 at the fine
   trunk's shapes (dx and dW over 4 x 99,328 rows, layer 0's fan-in 60,
   NeRF's 3-wide last layer, a ragged row count) and f32 (3xTF32) at the
   NeuS backward's (dx and dW over 265,216 rows, the 36-wide PE side,
   the colour trunk's 3-wide last layer, a ragged row count), against
   its plain version, with the times of both, of ``torch.matmul`` on the
   same operands (f32: TF32 off) and the bound, and TFLOP/s; then the
   products with an activation folded in (route_nt's epilogue:
   ``nt_act``, ``nn_adjoint``, ``nt_gstack``; route_tn's prologue:
   ``tn_act``, ``tn_dual_act``) at the shipped steps' shapes, timed the
   same way, and over a grid of the five activations, bf16 and f32, S =
   2 and 4, a ragged row count, the raw seg0 columns and the sweep
   adjoint's two K segments, dW and db bitwise over two runs
   (``phase_fold_products``);
7. one train step of ``pretrained/machine_neddf`` at full width (its
   ``.hydra`` config on ``data/machine``, params of epoch 1000, iteration
   100,000, camera 0, ``MACHINE_BATCH`` rays from ``machine_step_draws``):
   in f32 through the kernels, its loss dict and every parameter's
   gradient norm against the JAX package's numbers on the CPU
   (``JAX_STEP``); in bf16 through the kernels and the plain versions,
   against each other (the aux head's two gradient norms, which jump
   with any rounding at this checkpoint, only on the same step from
   seeded parameters, where every number is compared again);
8. the main path, ``python -m neddf_tpu_torch.scripts.run
   trainer.epoch_max=2 hydra.run.dir=chiprun_out/chip_smoke/train`` on
   the default config (bunny_smoke, bf16, 300 steps of 512 rays), driven
   in this process through that module's ``main``: every loss finite,
   train PSNR of the last 50 steps above the first 50, every kernel of
   the path launched, every product and tile forward on the tensor cores
   and no plain version called, the dual backward's launches as
   ``expected_folding`` reckons them (per step 2 ``gstack``, the colour
   trunk's), the epilogue backward's top mode once per pass and its
   standalone mode never; ms/step and rays/s;
   then the first 100 steps again through the plain versions
   (``network.fused=off``), which must track the kernel run; and a
   ``torch.profiler`` table of a few more steps in ``profile_train.txt``;
9. the NeRF and NeuS routes against their plain versions, with times:
   ``mlp_seg`` with the ``[h, seg0]`` post-skip layer, ReLU and its stash
   at the NeRF step's shapes (1024 rays x 194 fine and 65 coarse samples,
   bf16 and f32) and with the 3-wide last layer at the NeuS colour
   trunk's (1024 x 259 rows, f32), its backward, and ``sdf_mlp`` forward
   and backward at the NeuS step's rows and a ragged M, ReLU and tanhExp,
   with the count of ReLU rows whose gE took the other side of f'(0)
   beside the FMA kernels' (before the tensor cores); the sweep alone
   (``sdf_sweep_kernel``, the NeuS step's rows, ReLU) over the fused
   call's stash against the plain sweep, timed beside #7's trunk alone
   and its bound (operations); LeakyReLU on both ``mlp_seg`` precisions and on
   ``sdf_mlp``; two backward runs must give bitwise-equal dW / db; the
   parallel db sum at the NeuS fine pass;
10. one full-width f32 train step of each family (``FAMILY_OVERRIDES``)
   from the seeded parameters of ``family_params``, against the JAX
   package's numbers on the CPU (``FAMILY_STEP``, made by
   ``tools/family_step_reference.py``), with ``optimize_camera``: the
   camera's pose-delta gradient too;
11. a 300-step run of each configuration through ``scripts/run.py``
   (NeRF: separate coarse network, point samples, bf16; NeuS: f32):
   every loss finite, train PSNR of the last 50 steps at least 3 dB above
   the first 50, every new kernel launched, every product and tile
   forward on the tensor cores (NeRF: bf16 mma; NeuS: f32 by the 3xTF32
   split) and no plain version called;
   ms/step, rays/s and the device's busy share over five traced steps
   (``profile_train_{nerf,neus}.txt``);
11b. NeDDF, NeRF and NeuS with LeakyReLU, and NeDDF at width 128, at
   ``fused="auto"`` through their kernels (finite, every kernel
   launched), and an activation the kernels do not take (GELU, which
   neither the fused kernels nor the per-layer route have; widths over
   512 and deeper trunks take that route) raising NotImplementedError on
   the card;
12. ``run_eval`` of each run dir at downsampling 8, through the kernels
   and through the plain versions: PSNR within 0.05 dB;
14. resume: phase 8's run is run A; run B, the same command as a
   subprocess, is killed by pid (``training/watchdog.py::_kill_child``)
   as soon as its epoch-0 checkpoint is on disk (its bytes must equal
   A's) and continued in this process by ``scripts.run --resume``; the
   whole training state (params, Adam moments and counts, camera deltas
   and their optimizer, iteration, the generator) and the losses of
   epochs 1-2 must equal A's bitwise (else a second uninterrupted run A'
   sets the spread B may show); 14b: one epoch of ``python -m
   neddf_tpu_torch.scripts.run --watchdog`` with ``optimize_camera``,
   ``grad_accum=2``, ``debug_nans`` and ``async_checkpoint`` (a
   subprocess, started with run B) ends with exit code 0 and a full-state
   checkpoint;
15. the camera path: (a) phase 7's f32 step with ``optimize_camera``,
   camera 0's pose-delta gradient against the JAX package's
   (``JAX_STEP["camera_grad"]``); (b) one step of each family at 512
   rays through the kernels and through the plain versions, the camera
   gradients against each other, the routes counted, one
   ``RowSparseAdam`` step moving that row only; (c) one epoch of the
   default config with ``trainer.optimize_camera=true``: ms/step, device
   ms/step and launches per step beside the default run's; (d) the device
   ms per step of the products that form input cotangents the default
   step throws away;
16. ``grad_accum`` 2 and 4 against 1 on one default-config step (bf16 and
   f32, then with ``optimize_camera``), and one epoch at grad_accum=2;
17. ``export_pth`` of phase 8's run dir loaded back bitwise, an
   ``async_checkpoint`` save equal in bytes to a synchronous one, the
   logger's scalar names under ``log/``, ``debug_nans`` raising on a NaN
   weight, a ``profile_trace_start=2`` trace under ``log/profile/``, and
   the host syncs of one step under ``torch.cuda.set_sync_debug_mode``
   (``camera_pose`` must make none);
18. geometry extraction and the culled eval render, at full width on a
   copy of ``pretrained/machine_neddf``, each path with every count at 0
   just before it and read just after (no plain version called): (a)
   ``python -m neddf_tpu_torch.scripts.fields_visualizer`` at 64^3
   (voxel cache, the distance mesh at 0.0275, five slices) through #1 and
   #3; the 64^3 volume through the plain versions (mesh vertex and
   triangle counts within 1%); the 16^3 f32 volume against the JAX
   package's (``tools/geometry_reference.npz``, within 1e-4 of max |v|);
   ``voxelize`` and the host's marching tetrahedra timed at 64^3 and
   256^3; (b) ``trainer.enable_ray_cull`` (the grid through the training
   forward: #1 with its stash, #5, #1'): build time, occupied shares; (c)
   ``run_eval --ray-cull`` of cam 0 at full resolution, then the dense and
   culled renders of one call (active pixels bitwise equal, culled pixels
   the empty composite, PSNR within 0.05 dB, one host sync more), and
   ``render_image(occupancy=...)`` with an all-occupied grid at full
   budgets (against the dense render, >= 40 dB) and the run's grid at
   budgets 16/64 (s/image, PSNR); (d) ``fields_visualizer --field auto``
   on phase 11's NeRF and NeuS runs (#3 / #7 launched; a mesh with a
   triangle, at the family's default level or, where the short run's
   field does not reach it, at the cached volume's mid-range);
19. the forward-facing path (BASELINE config #5: an LLFF capture of the
   machine scene, ``dataset.recenter=true render.ndc=true
   render.sampling_type=point loss=nerf_loss``, NeDDF and NeRF), each
   path with every count at 0 just before it and read just after:
   (a) a 9-image 64x64 capture by the port's generator, its decoded
   pixels against the JAX package's (``tools/llff_reference.npz``: at
   most 1 level on at most 0.1% of the pixels), and ``LLFFDataset`` on
   the reference's files against the JAX package's, ``recenter`` false
   and true (within 1e-6); the 24-image 400x400 capture, made by the
   port's generator in a subprocess started at the beginning; (b) one
   full-width f32 step of NeDDF-NDC and NeRF-NDC through the kernels
   from the seeded parameters, against the JAX package's numbers (within
   1e-3, or 5x their spread under a 1e-7 camera shift or a one-f32-step
   move of each ray's final transmittance, which the mask loss's 1 / (1 -
   T) amplifies on NeRF's nearly transparent coarse rays); (c) 15 epochs of
   the 21 train frames of each through ``scripts/run.py`` (bf16; 512 /
   1024 rays): every loss finite, train PSNR of the last 50 steps at
   least 3 dB above the first 50, every kernel of the path launched on
   the tensor cores and no plain version called; ms/step, rays/s and the
   busy share over five traced steps (``profile_train_llff_*.txt``);
   (d) ``run_eval`` of the 3 held-out views at full resolution, the
   plain versions on the same draws within 0.05 dB of PSNR per view;
   s/image; (e) ``fields_visualizer`` on the NeDDF-NDC run dir (#1 and
   #3 launched; slices and a finite volume); (f) ``run_eval --ray-cull``,
   ``render_rays_accel`` and ``build_occupancy`` refuse the NDC run;
20. data parallelism (``neddf_tpu_torch/parallel``), each path with
   every count at 0 just before it and read just after: (b) an NCCL
   process group of world size 1 here: ``make_sharded_grads`` on the
   default step (512 rays, bf16, seeded parameters) and
   ``make_sharded_render`` of ``pretrained/machine_neddf`` cam 0 at
   downsampling 8, bitwise equal to the single-process step and render;
   (a) two ranks in processes of their own, both on the one card, in a
   gloo group: the library-level sharded step against the single-process
   step on the same draws (f32: every loss and gradient norm within
   1e-5; bf16: phase 7's step bars), each rank's launches one single
   step's (2 each of #1, #1', #5, #6 in top mode, 4 of #2) on the tensor
   cores with no plain version called, ms per step (two ranks sharing one
   card: not a data-parallel speed), and the sharded eval render's
   launches per rank, its gathered image equal on both ranks and within
   1e-3 of (b)'s single-process render; (c) ``scripts/run.py trainer.mesh.data=2`` raises
   "needs 2 devices" before the run dir is made, and ``data: auto`` is
   the single-process path (phase 8 checks its run made no world);
21. every kernel against its plain version on the same inputs beside the
   shipped width and activations (GRID_CASES: widths 45, 64, 96, 128,
   200, 256 and 512 under Softplus, Sigmoid and tanhExp, 96, 200 and 512
   under ReLU and LeakyReLU, the density under another activation each
   time), f32 and bf16 (sdf_mlp f32), at 33,287 rows: phases 6/9's bars,
   dW/db bitwise over two runs, the tangent stash read exactly where f''
   is not zero; under ReLU and LeakyReLU the forwards layer by layer over
   the kernel's own stash, and a direct disagreement only where a
   pre-activation lies across the kink (logged); 21b: each of paths (a)
   and (b) at its own networks and rows (the passes of its step, (a)'s
   eval colour at 198,656 rows), timed beside the bounds;
22. the full-width f32 step of WIDE_OVERRIDES' paths, (a) NeDDF at every
   width 512 with Softplus and a LeakyReLU density and (b) NeuS at width
   128 with Softplus, from the seeded parameters against the JAX
   package's numbers (WIDE_STEP; within 1e-3 or 5x their spread), and
   their camera gradients;
23. a 300-step run of each path through ``scripts/run.py`` (phase 11's
   gates: every loss finite, train PSNR up >= 3 dB, every kernel
   launched on its tensor-core route, the folded launches as
   ``expected_folding`` counts them, no plain call; ms/step, rays/s, the
   busy share, peak memory) and ``run_eval`` of its run dir through the
   kernels and the plain versions within 0.05 dB;
24. the per-layer route (tensor parallelism's column shards and widths
   over 512), each path with every count at 0 just before it and read
   just after: (a) each new kernel mode against its plain version at the
   fine pass's 99,328 rows and width 1024, f32 and bf16 (the layer
   forward of the K=3 trunk, its post-skip layer's two K segments, the
   K=1 colour layer 0, the value-only eval colour layer 0; ``gstack`` from
   f32 cotangents; the epilogue forward and standalone backward at 1024;
   the K=3 trunk's whole walk forward and backward), with CUDA-event ms,
   plain ms, ``torch.addmm`` on the same operands and the bound; (b)
   NeDDF with both trunks 1024 wide on the card: its f32 step from the
   seeded parameters against the JAX package (``tools/tp_step_reference.json``,
   phase 10's bars), a 200-step run through ``scripts/run.py`` (bf16, 512
   rays: train PSNR up >= 3 dB, every launch on the route, none of the
   fused route's, no plain call; ms/step, busy share, peak memory) and
   ``run_eval`` kernels vs plain within 0.05 dB; (c) two gloo ranks of
   data 1 x model 2 on the one card, the default width and 1024: the TP
   step against one rank's on the same draws (f32 within 1e-5, bf16 the
   step bars), each rank's launches, and ``machine_neddf`` cam 0 at
   downsampling 8 over the two ranks' shards within 0.05 dB of the whole
   render;
25. NeRF's and NeuS's per-layer route (their tensor parallelism and
   widths over 512), each path with every count at 0 just before it and
   read just after: (a) each new mode against its plain version at width
   1024, f32 and bf16, ReLU, at NeRF's 198,656 and NeuS's 265,216 rows
   (the layer forward of a post-skip layer reading [h | embed], hidden
   first; NeuS colour's whole 3-wide last layer; ``gpre`` on the f32 sum
   after the reduce-scatter, NeuS's with zs added; the sweep's top at a
   column shard), with CUDA-event ms, plain ms, ``torch.addmm`` and the
   bound; NeRF's trunk walk and NeuS's sdf walk (the sweep per layer)
   forward and backward at 65,536 rows, each layer and the backward held
   over the kernel's own stash; (b) NeRF-1024 (bf16) and NeuS-1024 (f32)
   on the card: each f32 step from the seeded parameters against the JAX
   package (``tools/tp_family_step_reference.json``, phase 10's bars), a
   short run (NeRF 200 steps of 1024 rays, PSNR up >= 3 dB; NeuS 200
   steps of 256 rays, >= 1 dB; every launch on the route, none of the fused route's, no tile
   forward, no plain call; ms/step, busy share, peak memory) and
   ``run_eval`` kernels vs plain within 0.05 dB; (c) NeRF and NeuS at
   width 256 over two gloo ranks of data 1 x model 2 on the one card: the
   TP step against one rank's on the same draws (f32 within 1e-6, NeRF's
   bf16 the step bars; NeuS under tanhExp, where the shards' sums cannot
   take ReLU's kink the other way), each rank's launches, no plain call;
26. trunks of any depth and widths over 2048, each path with every count
   at 0 just before it and read just after: (a) the epilogue forward (#5)
   and its standalone backward (#6; past 2048 its column-chunked kernel
   ``epi_bwd_wide_kernel``) at widths 2056, 3072 and 4096 over 99,328
   rows, f32 and bf16, against their plain versions (f32 1e-4, bf16 2^-5
   of the largest), dwd, dwa and db2 bitwise over two runs, timed beside
   their bounds; (b) each configuration of ``DEEP_OVERRIDES`` (NeDDF's
   11- and 9-layer trunks, NeRF's 16-layer trunks, NeuS's 16- and
   13-layer trunks, each with several post-skip layers, at the shipped
   width 256) through the per-layer route on the card: its f32 step from
   the seeded parameters against the JAX package
   (``tools/deep_step_reference.json``, phase 10's bars), a 100-step run
   through ``scripts/run.py`` (every loss finite, the mean loss of the
   last 20 steps below the first 20's, every launch on the route's
   tensor-core products, none of the fused route's, no plain call;
   ms/step over steps 50-99, the busy share, peak memory) and
   NeDDF-deep's ``run_eval`` kernels vs plain within 0.05 dB; (c) NeDDF
   with both trunks 4096 wide: 20 bf16 steps of 128 rays (finite, on the
   route; ms/step, peak memory), its f32 step through the kernels against
   the plain versions at 32 rays (phase 10's 1e-3), and two gloo ranks of
   data 1 x model 2 (shards of 2048) against one rank in f32 (1e-5; run
   beside phase 14b's subprocess with 24c and 25c); (d) NeDDF with both
   trunks 512 wide in f32 at ``embed_pos_rank`` 11, whose fused plans do
   not fit a block's shared memory: the per-layer route, its f32 step
   through the kernels against the plain versions (phase 10's 1e-3) and
   20 finite steps;
13. (printed last) one JSON line of per-kernel results (with each route's
   bound; the parallel db sum among them; ``launches_geometry``,
   ``launches_llff`` and ``launches_dp``: each kernel's launches on the
   phase-18 and phase-19 paths, and per rank per sharded step and in the
   sharded eval render of phase 20a; phases 21-23's kernels at paths
   (a) and (b)), the card line, and the final
   ``{"ok": true, "device": {...}}`` line.

Each dataset split is decoded once in this process (``cache_datasets``).
Phases 24c, 25c and 26c's ranks run while phase 14b's ``--watchdog``
subprocess ends
(the card would wait for it otherwise; their ranks' step times, no TP
speed in any case, share the card with it). Every log line ends with the
seconds since the start. Outputs go to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import atexit
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RUN = REPO / "pretrained" / "machine_neddf"
EPOCH = 1000
OUT = REPO / "chiprun_out" / "chip_smoke"
M_FULL = 1024 * 194  # rows of one fine pass at the eval chunk of 1024 rays
M_RAGGED = 1000 * 65 + 7  # not a multiple of any row tile
# downsampling-8 bar from tests/training/test_pretrained_artifact.py
PSNR_DS8_MIN, SSIM_DS8_MIN = 29.3, 0.96
# full resolution: the JAX package's own render of test cam 0 on the CPU
# (`python -m neddf_tpu.scripts.run_eval pretrained/machine_neddf --epoch
# 1000 --cameras 0 --device cpu`) scores 29.79 dB. BASELINE.md's 30.16 dB
# for the same view was taken on a TPU, and the JAX package does not
# reproduce it off the TPU.
PSNR_FULL_REF, PSNR_FULL_TOL = 29.79, 0.2
PSNR_FULL_TPU = 30.16
# kernel vs plain, max |diff| / max |plain|: f32 sums run in another order
# (~1e-6 relative per layer); bf16 rounds every layer's activations, and a
# value next to a rounding boundary may round the other way and carry
# one bf16 step (2^-8 relative) on through the later layers
REL_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}

# phase 6: rows of the train step's fine and coarse passes (512 rays)
M_TRAIN = 512 * 194
M_TRAIN_RAGGED = 512 * 65 + 7
# the dual-MLP backward sums dW over ~4 x 10^5 stacked rows in another
# order than torch's matmul (f32); in bf16 both round the stacked
# cotangent, where a flip moves one bf16 step (2^-8) of one row
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}

# the full-width train step of pretrained/machine_neddf (phase 7)
MACHINE_CAMERA = 0
MACHINE_ITERATION = 100_000  # epoch 1000 x 100 train views (the checkpoint holds params only)
MACHINE_BATCH = 64  # rays; the JAX reference below runs on a CPU and must fit its memory


def machine_step_draws(width: int, height: int, n_strat: int, n_pdf: int, seed: int = 0,
                       batch: int = MACHINE_BATCH):
    """Pixel columns/rows and sample uniforms of the phase-7 and phase-10
    steps (numpy), shared with tools/train_step_reference.py and
    tools/family_step_reference.py."""
    import numpy as np

    rng = np.random.default_rng(seed)
    us = rng.integers(0, width - 1, batch)
    vs = rng.integers(0, height - 1, batch)
    u_strat = rng.random((batch, n_strat), dtype=np.float32)
    u_pdf = rng.random((batch, n_pdf), dtype=np.float32)
    return us, vs, u_strat, u_pdf


# phases 9-12: the NeRF and NeuS configurations, as
# ``scripts/run.py`` overrides of config/config.yaml
FAMILY_OVERRIDES = {
    "nerf": ["network=nerf", "render=nerf_render", "loss=nerf_loss", "trainer=nerf_trainer"],
    "neus": ["network=neus", "loss=nerf_loss", "trainer.batch_size=1024"],
}
FAMILY_CAMERA = 0
FAMILY_DRAW_SEED = 1
# rays of the phase-10 step; its JAX reference runs on a CPU. The early
# layers' gradient norms of the 8-layer ReLU trunk are small sums that a
# few ReLU-mask flips between two f32 summation orders move; their share
# falls as 1/sqrt(rays)
FAMILY_BATCH = 256
# an se3 camera delta of ~1e-7 (the f32 rounding by which two
# implementations' rays differ): the reference tool records how far each
# number of the step moves under it (FAMILY_STEP[...]["spread"])
FAMILY_SHIFT = (1e-7, -1e-7, 1e-7, 1e-7, 1e-7, -1e-7)
# the bar of a number that moves more than JAX_STEP_TOL / SPREAD_FACTOR
# under that shift: SPREAD_FACTOR times its spread (the port's rays on the
# card differ from the JAX package's on the CPU by rounding of that size
# at every step of the ray and sample arithmetic, not by one shift)
SPREAD_FACTOR = 5.0
# a seed at which neither NeRF network starts dead (a ReLU density head
# that is negative at every sample passes no gradient at all)
FAMILY_PARAM_SEED = 2
# phases 21-23: the configurations beside the shipped widths and
# activations, as scripts/run.py overrides: (a) NeDDF wide and smooth
# (every width 512, Softplus, a LeakyReLU density; bf16, the default
# batch), (b) NeuS narrow (width 128, Softplus, as NeuS's own paper; f32)
WIDE_OVERRIDES = {
    "neddf_wide": ["network.ddf_layer_width=512", "network.col_layer_width=512",
                   "network.activation_type=Softplus",
                   "network.density_activation_type=LeakyReLU"],
    "neus_narrow": ["network=neus", "loss=nerf_loss", "trainer.batch_size=1024",
                    "network.sdf_layer_width=128", "network.col_layer_width=128",
                    "network.activation_type=Softplus"],
}
# rays of their f32 step against the JAX package (phase 22), whose 512-wide
# reference runs on a CPU
WIDE_BATCH = 64
# phase 24: NeDDF with both trunks 1024 wide (the per-layer route at model
# = 1; the rest as shipped: tanhExp, a ReLU density, bf16, 512 rays), its
# f32 step's rays against the JAX package (tools/family_step_reference.py
# --tp writes TP_STEP_REF)
TP_OVERRIDES = {"neddf_1024": ["network.ddf_layer_width=1024", "network.col_layer_width=1024"]}
TP_BATCH = 32
TP_STEP_REF = REPO / "tools" / "tp_step_reference.json"
# phase 25: NeRF and NeuS past 512 (the per-layer route of mlp_seg and
# sdf_mlp at model = 1; the rest as shipped: NeRF bf16, NeuS f32, ReLU),
# their f32 steps' rays against the JAX package
# (tools/family_step_reference.py --tp-families writes TP_FAMILY_STEP_REF)
TP_FAMILY_OVERRIDES = {
    "nerf_1024": [*FAMILY_OVERRIDES["nerf"], "network.layer_width=1024"],
    "neus_1024": [*FAMILY_OVERRIDES["neus"], "network.sdf_layer_width=1024",
                  "network.col_layer_width=1024"],
}
TP_FAMILY_BATCH = 32
TP_FAMILY_STEP_REF = REPO / "tools" / "tp_family_step_reference.json"
# phase 26: trunks deeper than the fused kernels hold, at the shipped
# widths (256), which take the per-layer route on one card: NeDDF's K=3
# trunk of 11 layers (post-skip layers 5 and 9) and colour trunk of 9,
# NeRF's 16-layer trunks, NeuS's 16-layer sdf trunk and 13-layer colour
# trunk (each with three post-skip layers); their f32 steps' rays against
# the JAX package (tools/family_step_reference.py --deep writes
# DEEP_STEP_REF)
DEEP_OVERRIDES = {
    "neddf_deep": ["network.ddf_layer_count=12", "network.col_layer_count=10",
                   "network.skips=[4,8]"],
    "nerf_deep": [*FAMILY_OVERRIDES["nerf"], "network.layer_count=16", "network.skips=[4,8,12]"],
    "neus_deep": [*FAMILY_OVERRIDES["neus"], "network.sdf_layer_count=16",
                  "network.col_layer_count=12", "network.skips=[4,8,12]"],
}
DEEP_BATCH = 256
DEEP_STEP_REF = REPO / "tools" / "deep_step_reference.json"


def family_params(shapes: dict, seed: int = FAMILY_PARAM_SEED) -> dict:
    """Seeded parameters (numpy f32) by the port's parameter name, drawn
    like PyTorch's ``nn.Linear`` default (w and b uniform in
    +-1/sqrt(fan_in)) in sorted name order; NeuS's ``variance`` is its
    init value 0.3. Shared with tools/family_step_reference.py."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        if name.endswith("variance"):
            out[name] = np.array(0.3, np.float32)
            continue
        bound = 1.0 / math.sqrt(shapes[name[:-1] + "w"][0])
        out[name] = rng.uniform(-bound, bound, size=shapes[name]).astype(np.float32)
    return out


# phase 19: the forward-facing path (BASELINE config #5) on an LLFF capture
# of the machine scene, NDC rays, as scripts/run.py overrides
LLFF_SMALL = {"n_images": 9, "image_size": 64}  # the capture held against the JAX one
LLFF_CAPTURE = {"n_images": 24, "image_size": 400}  # tools/llff_experiment.py's defaults
LLFF_OVERRIDES = {
    "neddf": ["dataset=llff", "dataset.factor=1", "dataset.recenter=true", "loss=nerf_loss",
              "render.ndc=true", "render.sampling_type=point"],
    "nerf": ["network=nerf", "render=nerf_render", "trainer=nerf_trainer", "dataset=llff",
             "dataset.factor=1", "dataset.recenter=true", "loss=nerf_loss", "render.ndc=true",
             "render.sampling_type=point"],
}
# the phase-19 f32 steps (rays, draws, camera); their JAX reference runs on a CPU
LLFF_BATCH = 128
LLFF_DRAW_SEED = 3
LLFF_CAMERA = 0
# decoded images, LLFFDataset's cameras and the f32 steps of the JAX package,
# made on a CPU by tools/llff_step_reference.py
LLFF_REF = REPO / "tools" / "llff_reference.npz"


def llff_ndc_near(capture) -> float:
    """The NDC near plane of a capture: 0.9 of its smallest bound, scaled as
    LLFFDataset scales it (the mean bound at 4.0), as
    tools/llff_experiment.py sets it."""
    import numpy as np

    bounds = np.load(Path(capture) / "poses_bounds.npy")[:, 15:17]
    return 0.9 * float(bounds.min()) * 4.0 / float(np.mean(bounds))


def llff_overrides(family: str, capture) -> list:
    """A family's phase-19 overrides on ``capture``."""
    return [*LLFF_OVERRIDES[family], f"dataset.dataset_dir={capture}",
            f"render.ndc_near={llff_ndc_near(capture)!r}"]


# The JAX package's numbers for the phase-7 step, made once on a CPU with
#   JAX_PLATFORMS=cpu python tools/train_step_reference.py
# (f32, network.fused=off, the draws of machine_step_draws); camera_grad
# and its spread are phase 15a's.
JAX_STEP = {
    "loss": 0.0013547728303819895,
    "mse": 0.0005737842293456197,
    "losses": {
        "color": 0.0005737842293456197,
        "color_coarse": 7.981894304975867e-05,
        "fields_penalty": 7.665929297218099e-05,
        "fields_penalty_coarse": 7.61266055633314e-05,
        "mask": 0.0004969338187947869,
        "mask_coarse": 5.144995520822704e-05
    },
    "grad_norms": {
        "network_fine.layer_aux_out.b": 3.109811950707808e-05,
        "network_fine.layer_aux_out.w": 0.00024105430929921567,
        "network_fine.layer_col_out.b": 0.008281280286610126,
        "network_fine.layer_col_out.w": 0.025889361277222633,
        "network_fine.layer_ddf_out.b": 0.0012196124298498034,
        "network_fine.layer_ddf_out.w": 0.009699746966362,
        "network_fine.layers_col.0.b": 0.0004561395035125315,
        "network_fine.layers_col.0.w": 0.004541456233710051,
        "network_fine.layers_col.1.b": 0.0004439109761733562,
        "network_fine.layers_col.1.w": 0.003714937251061201,
        "network_fine.layers_col.2.b": 0.001061740331351757,
        "network_fine.layers_col.2.w": 0.006420883350074291,
        "network_fine.layers_ddf.0.b": 0.0023002305533736944,
        "network_fine.layers_ddf.0.w": 0.008921636268496513,
        "network_fine.layers_ddf.1.b": 0.000841807690449059,
        "network_fine.layers_ddf.1.w": 0.0018240285571664572,
        "network_fine.layers_ddf.2.b": 0.0004552037862595171,
        "network_fine.layers_ddf.2.w": 0.002026146976277232,
        "network_fine.layers_ddf.3.b": 0.00030857636011205614,
        "network_fine.layers_ddf.3.w": 0.0026695425622165203,
        "network_fine.layers_ddf.4.b": 0.00028954644221812487,
        "network_fine.layers_ddf.4.w": 0.0035387391690164804,
        "network_fine.layers_ddf.5.b": 0.0004389507230371237,
        "network_fine.layers_ddf.5.w": 0.005519998259842396,
        "network_fine.layers_ddf.6.b": 0.0005343801458366215,
        "network_fine.layers_ddf.6.w": 0.0055043878965079784
    },
    "camera_grad": [
        0.017266057431697845,
        -0.0013490300625562668,
        0.0023521985858678818,
        0.03997461497783661,
        0.04528425633907318,
        -0.0573374480009079
    ],
    "camera_grad_spread": 1.6634530456345573e-05
}
# f32 port on the card vs the JAX package on a CPU: sums in another
# order, amplified by 1/D in the density and moving the inverse-CDF
# samples continuously: 1e-3 relative on each loss term and gradient norm
JAX_STEP_TOL = 1e-3
# bf16 step, kernels vs plain versions: a flipped bf16 rounding (2^-8)
# moves a fine sample and the losses with it; each loss term within 2%,
# each gradient norm within 5%
BF16_STEP_TOL = {"loss": 0.02, "grad_norm": 0.05}
# At the epoch-1000 checkpoint these two norms jump with any change of
# rounding: the plain version's own move by 6.0% and 8.1% under a 1e-7
# camera shift (tc_accuracy.py). Phase 7 holds them to the bar on the step
# from seeded parameters instead, where every number is well conditioned.
BF16_JUMPY_NORMS = ("network_fine.layer_aux_out.w", "network_fine.layer_aux_out.b")


_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the log with the seconds since the script started."""
    print(f"{msg}  [t {time.perf_counter() - _START:.0f} s]", flush=True)


def fail(msg: str) -> "None":
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# phase 2: the kernels that must run on the tensor cores (by the mangled
# names in the library) and how many instantiations each has, all on
# wgmma (HGMMA; no mma.sync HMMA anywhere in the library)
TC_FUNCTIONS = {# the per-layer route's wide layer forward: bf16 and f32 x the 5
                # activations
                "layer_fwd_wide": 10,
                # the backward products on wgmma: dx (route_nt) and dW (route_tn),
                # bf16 and f32 x plain (1), with the activation's epilogue /
                # prologue (the 5 activations) and the dual products over rows
                # grouped by point (the 5 activations x S = 2, 4): 16 each
                "route_nt": 32, "route_tn": 32,
                # the row-tile forward on wgmma (tile_hopper.cuh): bf16 and f32 x
                # K=3, K=1, K=0 x the 5 activations x the width classes 64, 128,
                # 256, 512
                "mlp_tile_fwd": 120,
                # the NeuS sweep (sdf_sweep.cuh): f32 x the 5 activations x the 4
                # classes
                "sdf_sweep_kernel": 20}



# the elementwise passes of the backwards that the products' epilogues and
# prologues took over: their entry points are gone
REMOVED_PASSES = ("neddf_sdf_sweep_p", "neddf_sdf_adjoint", "neddf_sdf_zbar", "neddf_sdf_act",
                  "neddf_mlp_act", "neddf_dual_act")


# phase 2: other kernels whose instantiations ptxas must build without
# spills: the epilogue backward (bf16 and f32 x the standalone mode and the
# top mode's 5 activations x the width classes 64, 128, 256, 512, and the
# standalone mode at the per-layer route's classes 1024 and 2048), two
# blocks of 256 threads per SM (128 registers each), and its column-chunked
# standalone kernel past 2048 (bf16 and f32); the narrow layer forward
SPILL_FUNCTIONS = {"epi_bwd_kernel": 52, "epi_bwd_wide_kernel": 2,
                   # the per-layer route's narrow layer forward: bf16 and f32 x
                   # the 5 activations x S = 1, 2, 4 x the column classes 4, 32
                   "layer_fwd_narrow": 60,
                   # the shallow nt (an nt of a depth under 8, on the FMA units):
                   # bf16 and f32 operands
                   "shallow_nt_kernel": 2}


def _is_tc_function(name: str) -> bool:
    return any(key in name for key in TC_FUNCTIONS)


def ptxas_spills(build_dir: Path, keys) -> dict:
    """Spilled bytes (stores + loads) of every function whose mangled name
    holds one of ``keys``, from ptxas's ``-v`` lines in the build log."""
    spills, name = {}, None
    for line in (build_dir / "build.log").read_text().splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif "spill stores" in line and name is not None and any(k in name for k in keys):
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills[name] = nums[1] + nums[2]  # stack frame, spill stores, spill loads
    return spills


def check_spill_functions(build_dir: Path) -> dict:
    """Phase 2: every instantiation of ``SPILL_FUNCTIONS`` built, none
    spilling."""
    spills = ptxas_spills(build_dir, SPILL_FUNCTIONS)
    for key, count in SPILL_FUNCTIONS.items():
        found = [n for n in spills if key in n]
        if len(found) != count:
            fail(f"ptxas: {len(found)} instantiations of {key}, expected {count}")
    if max(spills.values()) > 0:
        fail(f"ptxas: spills in {spills}")
    return spills


def check_tensor_core_build(build_dir: Path) -> dict:
    """Phase 2's checks of the built library: ``cuobjdump -sass`` counts
    the HGMMA instructions of every tensor-core function (the products,
    the tile forwards and the NeuS sweep: wgmma alone, no mma.sync HMMA
    in them or anywhere in the library), the f32 ones on TF32 operands
    (3xTF32) and the bf16 ones not; ptxas's ``-v`` lines in the build log
    show their spills; fails on a count of 0, a missing instantiation or
    a spill."""
    from neddf_tpu_torch.kernels import _build

    # the SASS of the library's objects, one cuobjdump per object, all at
    # once, each into a file of its own (the library is their link; one
    # cuobjdump over it took ~50 s)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    objs = sorted(build_dir.glob("*.o")) or [build_dir / _build._LIB_NAME]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"{k}.sass" for k in range(len(objs))]
        procs = []
        for obj, path in zip(objs, outs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen([str(cuobjdump), "-sass", str(obj)], stdout=f))
        failed = [str(obj) for obj, proc in zip(objs, procs) if proc.wait()]
        if failed:
            fail(f"cuobjdump -sass failed on {failed}")
        sass = "".join(path.read_text() for path in outs)
    # no mma.sync left in the library: HMMA only as part of HGMMA
    mma_sync = sum(1 for line in sass.splitlines() if "HMMA" in line and "HGMMA" not in line)
    if mma_sync:
        fail(f"SASS: {mma_sync} mma.sync (HMMA) instructions in the library")
    hgmma, tf32, name = {}, {}, None
    for line in sass.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            name = text.split(":", 1)[1].strip()
            if _is_tc_function(name):
                hgmma[name] = tf32[name] = 0
        elif name in hgmma and "HGMMA" in text:
            hgmma[name] += 1
            tf32[name] += "TF32" in text
    spills = ptxas_spills(build_dir, TC_FUNCTIONS)
    for key, count in TC_FUNCTIONS.items():
        found = [n for n in hgmma if key in n]
        if len(found) != count:
            fail(f"SASS: {len(found)} tensor-core instantiations of {key}, expected {count}")
    if min(hgmma.values()) < 1:
        fail(f"SASS: a tensor-core function without HGMMA: {hgmma}")
    for fn in hgmma:
        is_f32 = "nv_bfloat16" not in fn
        if is_f32 != (tf32[fn] > 0) or (is_f32 and tf32[fn] != hgmma[fn]):
            fail(f"SASS: {fn}: {tf32[fn]} of {hgmma[fn]} HGMMA on TF32 operands")
    if set(spills) != set(hgmma) or max(spills.values()) > 0:
        fail(f"ptxas: spills in the tensor-core functions (or missing -v lines): {spills}")
    return {"hgmma": hgmma, "tf32_hgmma": tf32, "spill_bytes": spills}


def time_pair(torch, fn_kernel, fn_plain, reps: int = 5, inner: int = 1):
    """Median CUDA-event ms of kernel and plain, measured in turns
    (plain, kernel, kernel, plain) after one warm-up of each; with
    ``inner`` > 1 each reading is the mean of that many launches back to
    back (the device's time, without the host's between launches)."""
    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

    fn_plain()
    fn_kernel()
    k, p = [], []
    for _ in range(reps):
        p.append(once(fn_plain))
        k.append(once(fn_kernel))
        k.append(once(fn_kernel))
        p.append(once(fn_plain))
    return statistics.median(k), statistics.median(p)


def kernel_key(name: str) -> str:
    """A profiler kernel name without its namespaces and argument list;
    the product keeps its template arguments (operand type, layout, what
    it folds in)."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
    head = head.replace("neddf::", "").replace("__nv_bfloat16", "bf16").strip()
    return head if head.startswith("shallow_nt_kernel") else head.split("<")[0]


def profile_calls(torch, fn, calls: int = 20) -> tuple:
    """({kernel: {"launches", "ms"}} per call of ``fn``, device ms per call
    in all), by torch.profiler over ``calls`` calls after one warm-up (a
    short launch back to back with others is timed by the host's launch
    rate under CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0:
            continue
        r = out.setdefault(kernel_key(ev.key), {"launches": 0, "ms": 0.0})
        r["launches"] += ev.count / calls
        r["ms"] += ev.self_device_time_total / 1e3 / calls
    return out, sum(r["ms"] for r in out.values())


def rel_err(torch, got, ref):
    diff = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    return diff.max().item(), diff.max().item() / max(scale, 1e-30)


def profile_render(torch, trainer, eval_dir: Path, card: str, untraced_s: float) -> None:
    """Trace one full-resolution render (device activity only, which keeps
    the tracing cost on the host low); write device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from neddf_tpu_torch.utils.profiling import device_time_table

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.render_test(eval_dir, 0, 1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    busy, table = device_time_table(prof, 30)
    lines = [f"card: {card}",
             f"traced wall {wall:.3f} s, untraced wall {untraced_s:.3f} s, device busy "
             f"{busy:.3f} s: busy share {busy / wall:.3f} traced, "
             f"{busy / untraced_s:.3f} of the untraced wall", *table]
    (OUT / "profile.txt").write_text("\n".join(lines) + "\n")
    for line in lines[:8]:
        log(f"[5] {line}")


# phase 8: the main path's run and its checks
TRAIN_EPOCHS = 2  # trainer.epoch_max: epochs 0..2 of 100 steps
# dB, train PSNR of the last 50 steps over the first 50; the card shows
# +5.26 dB (20.90 -> 26.15 dB on NVIDIA H100 80GB HBM3, 700 W)
PSNR_GAIN_MIN = 3.0
# plain versions vs kernels over the first 100 steps (bf16, the same
# seed and draws): a flipped bf16 rounding moves samples, so the runs
# drift apart slowly; mean relative loss gap and the gap of the mean
# train PSNR over steps 50-99 (the card shows 0.0030 and 0.002 dB)
TRACK_LOSS_REL, TRACK_PSNR_DB = 0.02, 0.2


def check_close(name: str, got: float, ref: float, tol: float, floor: float = 0.0) -> float:
    rel = abs(got - ref) / max(abs(ref), floor, 1e-30)
    if not rel <= tol:
        fail(f"{name}: {got!r} vs {ref!r}, relative {rel:.3g} > {tol}")
    return rel


# phase 6: routes of one or two short launches, whose CUDA-event time per
# call is mostly the host's (its wrapper's torch and ctypes calls): timed
# by the device time of their kernels (torch.profiler), the event times
# kept beside it
DEVICE_TIMED = ("neddf_epilogue", "neddf_epilogue_bwd", "neddf_epilogue_gstack")
# the density activation of the shipped NeDDF config (phases 3 and 6)
DENSITY = "ReLU"


def phase_train_kernels(torch, sd, card: str) -> dict:
    """Phase 6: the training path's kernel routes against their plain
    versions at the train step's shapes; returns results per route."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import neddf_epilogue as epi
    from neddf_tpu_torch.ops.dual import pe_dual_directional_mip, pe_dual_planes_mip
    from neddf_tpu_torch.ops.pe import pe_grad_scale, positional_encoding_mip

    dev = torch.device("cuda", 0)
    n_ddf = sum(1 for k in sd if k.startswith("network_fine.layers_ddf.") and k.endswith(".w"))
    n_col = sum(1 for k in sd if k.startswith("network_fine.layers_col.") and k.endswith(".w"))
    ddf_w = [sd[f"network_fine.layers_ddf.{i}.w"].to(dev) for i in range(n_ddf)]
    ddf_b = [sd[f"network_fine.layers_ddf.{i}.b"].to(dev) for i in range(n_ddf)]
    col_w = [sd[f"network_fine.layers_col.{i}.w"].to(dev) for i in range(n_col)]
    col_b = [sd[f"network_fine.layers_col.{i}.b"].to(dev) for i in range(n_col)]
    wd = sd["network_fine.layer_ddf_out.w"][:, 0].to(dev).contiguous()
    wa = sd["network_fine.layer_aux_out.w"][:, 0].to(dev).contiguous()
    b2 = torch.cat([sd["network_fine.layer_ddf_out.b"], sd["network_fine.layer_aux_out.b"]]).to(dev)
    # d_near, aux_grad_scale, distance_range_max and the shipped penalty weights
    scal = torch.tensor([0.001, 1.1, 2.0, 0.05, 1.0, 1.0, 1.0, 0.0], device=dev)
    layout = tuple(li == 5 for li in range(n_ddf))
    c_layout = (False,) * n_col
    has_j = (True, False, False, True)
    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}

    def dual_counts():
        folded = dm.folded_launches()
        return (dm.PASS_LAUNCHES["gstack"], dm.PASS_LAUNCHES["dual_act"],
                folded["epilogue"], folded["prologue"])

    def check_dual_counts(what, before, n_layers):
        # the top layer's gstack alone; below it the stacked cotangent and
        # the layer input come folded into the products (no dual_act)
        got = tuple(a - b for a, b in zip(dual_counts(), before))
        if got != (1, 0, n_layers - 1, n_layers - 1):
            fail(f"{what}: gstack, dual_act, epilogue and prologue launches {got}, expected "
                 f"(1, 0, {n_layers - 1}, {n_layers - 1})")

    def check_top_mode(route, m, dtype_name, args, tol):
        # the epilogue backward's top mode (the K=3 trunk's top layer folded
        # in) against its plain version; its gs bitwise equal to the
        # standalone mode, torch's add and the top gstack; two runs bitwise
        v, j, wd_, wa_, b2_, scal_, g_o, g_t, g_c, z, act, dens = args
        before = epi.neddf_epilogue_gstack.launches
        tk = epi.neddf_epilogue_gstack(*args)
        tp = epi.neddf_epilogue_gstack_plain(*args)
        torch.cuda.synchronize()
        if epi.neddf_epilogue_gstack.launches != before + 1:
            fail(f"{route} {dtype_name} M={m}: the top mode's kernel did not launch once")
        r = check(route, m, dtype_name, list(zip(tk, tp)), tol)
        dv, dj = epi.neddf_epilogue_bwd(v, j, wd_, wa_, b2_, scal_, g_o, g_t, dens)[:2]
        gs = dm.DualProducts(v.dtype, dev).gstack(dv + g_c, dj, z, act)[0]
        r["gs_bitwise_vs_composition"] = torch.equal(tk[0], gs)
        if not r["gs_bitwise_vs_composition"]:
            fail(f"{route} {dtype_name} M={m}: gs differs from the standalone mode + add + "
                 f"gstack in {int((tk[0] != gs).sum())} elements")
        again = epi.neddf_epilogue_gstack(*args)
        if not all(torch.equal(a, b) for a, b in zip(tk, again)):
            fail(f"{route} {dtype_name} M={m}: two runs differ")
        del tk, tp, dv, dj, gs, again

    def check(route, m, dtype_name, pairs, tol):
        worst_abs, worst_rel = 0.0, 0.0
        for got, ref in pairs:
            if not torch.isfinite(got.float()).all():
                fail(f"{route} {dtype_name} M={m}: non-finite output")
            a, r = rel_err(torch, got, ref)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        if worst_rel > tol:
            fail(f"{route} {dtype_name} M={m}: rel err {worst_rel:.3g} > {tol}")
        results.setdefault(route, {})[f"{m}/{dtype_name}"] = {
            "max_abs_err": worst_abs, "rel_err": worst_rel}
        return results[route][f"{m}/{dtype_name}"]

    for m in (M_TRAIN, M_TRAIN_RAGGED):
        pos = torch.rand((m, 3), generator=gen, device=dev) * 2.0 - 1.0
        var = torch.rand((m, 3), generator=gen, device=dev) * 1e-5
        dirs = torch.randn((m, 3), generator=gen, device=dev)
        dirs = dirs / dirs.norm(dim=1, keepdim=True)
        emb_v, emb_j = pe_dual_planes_mip(pos, 10, var=var, chan_scale=pe_grad_scale(10, dev))
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tol, btol = REL_TOL[dtype_name], BWD_REL_TOL[dtype_name]
            w = [x.to(dtype).contiguous() for x in ddf_w]
            cw = [x.to(dtype).contiguous() for x in col_w]
            v0, j0 = emb_v.to(dtype).contiguous(), emb_j.to(dtype).contiguous()
            # trunk forward with its stash
            tk = dm.dual_mlp_trunk(v0, j0, w, ddf_b, layout, stash=True)
            tp = dm.dual_mlp_seg_plain([v0], [j0], w, ddf_b, layout, "tanhExp", (True,), 3,
                                       stash=True)
            torch.cuda.synchronize()
            check("dual_mlp_trunk_stash", m, dtype_name,
                  [(tk[0], tp[0]), (tk[1], tp[1])] + list(zip(tk[2], tp[2])), tol)
            v_feat, j_feat, t_pres = tp
            del tk
            # epilogue forward and backward on the trunk's streams
            ek = epi.neddf_epilogue(v_feat, j_feat, wd, wa, b2, scal, DENSITY)
            ep = epi.neddf_epilogue_plain(v_feat, j_feat, wd, wa, b2, scal, DENSITY)
            check("neddf_epilogue", m, dtype_name, [(ek[0], ep[0]), (ek[1], ep[1])], tol)
            g_out = torch.randn((10, m), generator=gen, device=dev)
            g_tf = (torch.randn((m, 256), generator=gen, device=dev) * 0.1).to(dtype)
            ebargs = (v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf, DENSITY)
            ebk = epi.neddf_epilogue_bwd(*ebargs)
            ebp = epi.neddf_epilogue_bwd_plain(*ebargs)
            check("neddf_epilogue_bwd", m, dtype_name, list(zip(ebk, ebp)), btol)
            again = epi.neddf_epilogue_bwd(*ebargs)
            if not all(torch.equal(a, b) for a, b in zip(ebk, again)):
                fail(f"neddf_epilogue_bwd {dtype_name} M={m}: two runs differ")
            # the main path's mode: with the colour trunk's cotangent of
            # v_feat and the trunk's top-layer stash
            g_col = (torch.randn((m, 256), generator=gen, device=dev) * 0.01).to(dtype)
            top_args = (v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf, g_col, t_pres[-1],
                        "tanhExp", DENSITY)
            check_top_mode("neddf_epilogue_gstack", m, dtype_name, top_args, btol)
            # the K=1 colour forward on [PE dual(pos) along grad D, PE(dir), n, features]
            t_dir = ep[0][6:9].T.contiguous()
            ep_v, ep_t = pe_dual_directional_mip(pos, 10, t_dir, var=var)
            segs = [ep_v.to(dtype).contiguous(), positional_encoding_mip(dirs, 4).to(dtype),
                    ep[0][3:6].T.to(dtype).contiguous(), v_feat]
            js = [ep_t.to(dtype)[None].contiguous(), ep[1][None].contiguous()]
            ck = dm.dual_mlp_seg(segs, js, cw, col_b, c_layout, "tanhExp", has_j, 1, stash=True)
            cp = dm.dual_mlp_seg_plain(segs, js, cw, col_b, c_layout, "tanhExp", has_j, 1,
                                       stash=True)
            check("dual_mlp_color_k1", m, dtype_name,
                  [(ck[0], cp[0]), (ck[1], cp[1])] + list(zip(ck[2], cp[2])), tol)
            # the dual-MLP backward, trunk and colour configurations
            bwd_args = {}
            for cfg, vs_, js_, ws_, lay, hj, k, pres in (
                    ("trunk", [v0], [j0], w, layout, (True,), 3, t_pres),
                    ("color", segs, js, cw, c_layout, has_j, 1, cp[2])):
                gv = (torch.randn((m, 256), generator=gen, device=dev) * 0.01).to(dtype)
                gj = (torch.randn((k, m, 256), generator=gen, device=dev) * 0.01).to(dtype)
                args = (vs_, js_, ws_, lay, "tanhExp", hj, pres, gv, gj)
                before = dual_counts()
                bk = dm.dual_mlp_seg_bwd(*args)
                check_dual_counts(f"dual_mlp_seg_bwd {cfg} {dtype_name} M={m}", before, len(ws_))
                bp = dm.dual_mlp_seg_bwd_plain(*args)
                torch.cuda.synchronize()
                check(f"dual_mlp_seg_bwd_{cfg}", m, dtype_name,
                      list(zip(sum(bk, []), sum(bp, []))), btol)
                again = dm.dual_mlp_seg_bwd(*args)
                if not all(torch.equal(a, b) for a, b in zip(bk[2] + bk[3], again[2] + again[3])):
                    fail(f"dual_mlp_seg_bwd {cfg} {dtype_name} M={m}: dW/db differ between runs")
                bwd_args[cfg] = args
                del bk, bp, again
            if m == M_TRAIN:
                timings = {
                    "neddf_epilogue": (
                        lambda: epi.neddf_epilogue(v_feat, j_feat, wd, wa, b2, scal, DENSITY),
                        lambda: epi.neddf_epilogue_plain(v_feat, j_feat, wd, wa, b2, scal,
                                                         DENSITY)),
                    "neddf_epilogue_bwd": (
                        lambda: epi.neddf_epilogue_bwd(v_feat, j_feat, wd, wa, b2, scal,
                                                       g_out, g_tf, DENSITY),
                        lambda: epi.neddf_epilogue_bwd_plain(v_feat, j_feat, wd, wa, b2, scal,
                                                             g_out, g_tf, DENSITY)),
                    "neddf_epilogue_gstack": (
                        lambda: epi.neddf_epilogue_gstack(*top_args),
                        lambda: epi.neddf_epilogue_gstack_plain(*top_args)),
                    "dual_mlp_color_k1": (
                        lambda: dm.dual_mlp_seg(segs, js, cw, col_b, c_layout, "tanhExp",
                                                has_j, 1, stash=True),
                        lambda: dm.dual_mlp_seg_plain(segs, js, cw, col_b, c_layout, "tanhExp",
                                                      has_j, 1, stash=True)),
                    "dual_mlp_trunk_stash": (
                        lambda: dm.dual_mlp_trunk(v0, j0, w, ddf_b, layout, stash=True),
                        lambda: dm.dual_mlp_seg_plain([v0], [j0], w, ddf_b, layout, "tanhExp",
                                                      (True,), 3, stash=True)),
                    "dual_mlp_seg_bwd_trunk": (
                        lambda: dm.dual_mlp_seg_bwd(*bwd_args["trunk"]),
                        lambda: dm.dual_mlp_seg_bwd_plain(*bwd_args["trunk"])),
                    "dual_mlp_seg_bwd_color": (
                        lambda: dm.dual_mlp_seg_bwd(*bwd_args["color"]),
                        lambda: dm.dual_mlp_seg_bwd_plain(*bwd_args["color"])),
                }
                for route, (fk, fp) in timings.items():
                    ms, plain_ms = time_pair(torch, fk, fp, reps=3)
                    r = results[route][f"{m}/{dtype_name}"]
                    r.update(ms=ms, plain_ms=plain_ms)
                    if route in DEVICE_TIMED:
                        r.update(event_ms=ms, event_plain_ms=plain_ms,
                                 ms=profile_calls(torch, fk, calls=10)[1],
                                 plain_ms=profile_calls(torch, fp, calls=3)[1])
                # the three steps the top mode replaces, on the same inputs:
                # the standalone mode, the add, the top layer's gstack
                k = dm.DualProducts(dtype, dev)

                def composed():
                    dv, dj = epi.neddf_epilogue_bwd(v_feat, j_feat, wd, wa, b2, scal, g_out,
                                                    g_tf, DENSITY)[:2]
                    return k.gstack(dv + g_col, dj, t_pres[-1], "tanhExp")

                results["neddf_epilogue_gstack"][f"{m}/{dtype_name}"].update(
                    composed_ms=profile_calls(torch, composed, calls=10)[1],
                    composed_event_ms=time_pair(torch, composed, composed, reps=3)[0])
            for route in results:
                if f"{m}/{dtype_name}" in results[route]:
                    log(f"[6] {route} M={m} {dtype_name}: "
                        f"{json.dumps(results[route][f'{m}/{dtype_name}'])} | card: {card}")
            del tp, v_feat, j_feat, t_pres, ek, ep, ebk, ebp, ck, cp, bwd_args, top_args
            torch.cuda.empty_cache()

    # ReLU and LeakyReLU (f'' = 0: no coupling term in the backward) on the
    # K=3 trunk and the K=1 colour trunk, inputs from their own seed. f' is
    # a step at 0, so a tangent whose z lies within a rounding of 0 may
    # take the other side in the kernel than in the plain pass: each layer
    # is held to the plain layer over the kernel's own stash of the layer
    # below (its input), and the backwards run on the plain stash
    gen.manual_seed(5)
    m = M_TRAIN_RAGGED

    def replay(*args):
        return dual_replay(torch, *args)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0

    for act in ("ReLU", "LeakyReLU"):
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tol, btol = REL_TOL[dtype_name], BWD_REL_TOL[dtype_name]
            w = [x.to(dtype).contiguous() for x in ddf_w]
            cw = [x.to(dtype).contiguous() for x in col_w]
            v0 = uniform(m, 60).to(dtype)
            j0 = (uniform(3, m, 60) * 0.1).to(dtype)
            segs = [uniform(m, 60).to(dtype), uniform(m, 24).to(dtype),
                    uniform(m, 3).to(dtype), uniform(m, 256).to(dtype)]
            js = [(uniform(1, m, 60) * 0.1).to(dtype), (uniform(1, m, 256) * 0.1).to(dtype)]
            for cfg, args in (("trunk", ([v0], [j0], w, ddf_b, layout, act, (True,), 3)),
                              ("color", (segs, js, cw, col_b, c_layout, act, has_j, 1))):
                if cfg == "trunk":
                    fk = dm.dual_mlp_trunk(v0, j0, w, ddf_b, layout, act, stash=True)
                else:
                    fk = dm.dual_mlp_seg(*args, stash=True)
                fp = dm.dual_mlp_seg_plain(*args, stash=True)
                torch.cuda.synchronize()
                route = f"dual_mlp_{cfg}_{act}"
                r = check(route, m, dtype_name,
                          list(zip([fk[0], fk[1], *fk[2]], replay(*args, fk[2]))), tol)
                r["tangent_sides_off_plain"] = sum(
                    int(((a[:1] > 0) != (b[:1] > 0)).sum().item()) for a, b in zip(fk[2], fp[2]))
                vs_, js_, ws_, _, lay, _, hj, k = args
                gv = (uniform(m, 256) * 0.01).to(dtype)
                gj = (uniform(k, m, 256) * 0.01).to(dtype)
                bargs = (vs_, js_, ws_, lay, act, hj, fp[2], gv, gj)
                before = dual_counts()
                bk = dm.dual_mlp_seg_bwd(*bargs)
                check_dual_counts(f"{route}_bwd {dtype_name}", before, len(ws_))
                bp = dm.dual_mlp_seg_bwd_plain(*bargs)
                torch.cuda.synchronize()
                check(f"{route}_bwd", m, dtype_name, list(zip(sum(bk, []), sum(bp, []))), btol)
                again = dm.dual_mlp_seg_bwd(*bargs)
                if not all(torch.equal(a, b) for a, b in zip(bk[2] + bk[3], again[2] + again[3])):
                    fail(f"{route}_bwd {dtype_name} M={m}: dW/db differ between runs")
                names = [route, f"{route}_bwd"]
                if cfg == "trunk":  # the epilogue backward's top mode on this trunk
                    top_args = (fp[0], fp[1], wd, wa, b2, scal, uniform(10, m),
                                (uniform(m, 256) * 0.1).to(dtype), gv, fp[2][-1], act,
                                DENSITY)
                    names.append(f"neddf_epilogue_gstack_{act}")
                    check_top_mode(names[-1], m, dtype_name, top_args, btol)
                    del top_args
                for name in names:
                    log(f"[6] {name} M={m} {dtype_name}: "
                        f"{json.dumps(results[name][f'{m}/{dtype_name}'])} | card: {card}")
                del fk, fp, bk, bp, again
            torch.cuda.empty_cache()
    return results


# phase 6b: the products of the backwards alone. bf16 operands multiply
# exactly in f32, so the kernel differs from its plain version (f32
# torch.matmul of the same operands, TF32 off) only in the order of the
# f32 sums, within and across the split partials; f32 operands (3xTF32)
# also by the dropped lo*lo term and the rounding of lo, ~2^-21 of each
# product
PRODUCT_REL_TOL = 1e-4


def product_cases(torch, gen, dev):
    """(name, layout, a, b) at the shapes the main paths give the product.
    bf16: the fine trunk's dx and dW (4 streams x 99,328 rows, C = 256),
    layer 0's narrow side (fan-in 60), NeRF's 3-wide last layer (K = 3 in
    nt, N = 3 in tn) and a ragged row count. f32 (the NeuS backward, one
    network over both passes' 265,216 rows): the trunk's dx and dW, the
    PE side (E = 36: dW of layer 0, the post-skip layer's e rows), the
    colour trunk's 3-wide last layer and a ragged row count (the sweep
    adjoint's nn, with its epilogue, is a folded mode:
    ``phase_fold_products``). The per-layer route's products at
    width 1024 (route_nt, route_tn: the K=3 trunk's 4 x 99,328 rows in
    bf16, NeuS's 265,216 in f32) and a tensor-parallel shard of 512."""
    def bf(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.1).bfloat16()

    def f32(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.1

    r, rr, rn = 4 * M_TRAIN, 4 * M_TRAIN_RAGGED, M_NERF_FINE
    rs, rsr, e = M_NEUS, M_NEUS - 1001, SDF_FANS[0]
    return [
        ("nt fine trunk dx", "nt", bf(r, 256), bf(256, 256)),
        ("tn fine trunk dW", "tn", bf(r, 256), bf(r, 256)),
        ("nt layer 0 dx (N=60)", "nt", bf(r, 256), bf(60, 256)),
        ("tn layer 0 dW (m=60)", "tn", bf(r, 60), bf(r, 256)),
        ("nt NeRF last layer dx (K=3)", "nt", bf(rn, 3), bf(256, 3)),
        ("tn NeRF last layer dW (N=3)", "tn", bf(rn, 256), bf(rn, 3)),
        (f"nt ragged ({rr} rows)", "nt", bf(rr, 256), bf(256, 256)),
        (f"tn ragged ({rr} rows)", "tn", bf(rr, 256), bf(rr, 256)),
        ("f32 nt NeuS trunk dx", "nt", f32(rs, 256), f32(256, 256)),
        ("f32 tn NeuS trunk dW", "tn", f32(rs, 256), f32(rs, 256)),
        (f"f32 tn NeuS layer 0 dW (m={e})", "tn", f32(rs, e), f32(rs, 256)),
        (f"f32 nt NeuS e rows dx (N={e})", "nt", f32(rs, 256), f32(e, 256)),
        ("f32 nt NeuS colour last layer dx (K=3)", "nt", f32(rs, 3), f32(256, 3)),
        ("f32 nt NeuS-1024 colour last layer dx (K=3)", "nt", f32(M_NEUS_1024, 3),
         f32(1024, 3)),
        ("f32 tn NeuS colour last layer dW (N=3)", "tn", f32(rs, 256), f32(rs, 3)),
        (f"f32 tn ragged ({rsr} rows)", "tn", f32(rsr, 256), f32(rsr, 256)),
        ("nt route dx 1024", "nt", bf(r, 1024), bf(1024, 1024)),
        ("tn route dW 1024", "tn", bf(r, 1024), bf(r, 1024)),
        ("nt route dx shard 512", "nt", bf(r, 512), bf(1024, 512)),
        ("tn route dW shard 512", "tn", bf(r, 1024), bf(r, 512)),
        ("f32 nt route dx 1024", "nt", f32(rs, 1024), f32(1024, 1024)),
        ("f32 tn route dW 1024", "tn", f32(rs, 1024), f32(rs, 1024)),
    ]


def product_call(layout, a, b):
    """The strided call ``(m, n, k, a, sam, sak, b, sbk, sbn)`` of one case
    and the PyTorch call that computes the same product (the yardstick)."""
    import torch

    if layout == "nt":  # a [R, k] times b [n, k]^T
        (m, k), n = a.shape, b.shape[0]
        return (m, n, k, a, k, 1, b, 1, k), lambda: torch.matmul(a, b.T)
    (k, m), n = a.shape, b.shape[1]  # tn: a [R, m]^T times b [R, n], over R rows
    return (m, n, k, a, 1, m, b, n, 1), lambda: torch.matmul(a.T, b)


def product_kernel(dm) -> tuple:
    """The plain product kernels' launch counts so far: (route_nt,
    route_tn, shallow_nt)."""
    return (dm.ROUTE_PRODUCT_LAUNCHES["nt"], dm.ROUTE_PRODUCT_LAUNCHES["tn"],
            sum(dm.SHALLOW_LAUNCHES.values()))


def host_ms(torch, fn, calls: int = 20) -> float:
    """The host's ms per call of ``fn`` (launches queued, not waited for)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    out = 1000.0 * (time.perf_counter() - start) / calls
    torch.cuda.synchronize()
    return out


def phase_products(torch, card: str) -> dict:
    """Phase 6b: the plain products of the backwards (``Products``: the nt
    and tn on ``route_nt`` / ``route_tn``, the 3-wide layers' K = 3 dx on
    ``shallow_nt``, bound by its f32 output's bytes) against their plain
    version, with
    the times of both, of ``torch.matmul`` on the same operands (the
    yardstick, bf16 out for bf16 operands, f32 with TF32 off for f32 ones;
    the port never calls it) and the bound, TFLOP/s and the host's ms per
    call, per shape; which kernel took it."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    results = {}
    for name, layout, a, b in product_cases(torch, gen, dev):
        prod = dm.Products(a.dtype, dev)
        call, library = product_call(layout, a, b)
        m, n, k = call[:3]

        def kernel():
            return getattr(prod, layout)(a, b)

        def plain():
            return dm.products_plain(*call)

        before = product_kernel(dm)
        got, ref = kernel(), plain()
        ran = [new - old for new, old in zip(product_kernel(dm), before)]
        if sorted(ran) != [0, 0, 1]:
            fail(f"product {name}: launches (route_nt, route_tn, shallow_nt) {ran}")
        kernel_name = ("route_nt", "route_tn", "shallow_nt")[ran.index(1)]
        torch.cuda.synchronize()
        if got.shape != (m, n) or not torch.isfinite(got).all():
            fail(f"product {name}: shape {tuple(got.shape)} or non-finite output")
        err, rel = rel_err(torch, got, ref)
        if rel > PRODUCT_REL_TOL:
            fail(f"product {name}: rel err {rel:.3g} > {PRODUCT_REL_TOL}")
        if not torch.equal(got, kernel()):
            fail(f"product {name}: two runs differ")
        ms, plain_ms = time_pair(torch, kernel, plain, reps=3, inner=10)
        library_ms, _ = time_pair(torch, library, library, reps=3, inner=10)
        flops = 2.0 * m * n * k
        f32 = a.dtype == torch.float32
        t = a.element_size()
        r = {"layout": layout, "dtype": str(a.dtype).replace("torch.", ""), "m": m, "n": n,
             "k": k, "kernel": kernel_name, "max_abs_err": err, "rel_err": rel, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms, "tflops": flops / ms / 1e9,
             "host_ms": host_ms(torch, kernel),
             # (shallow_nt's operations run on the FMA units, in f32)
             **bound(flops, t * (m * k + k * n) + 4 * m * n,
                     "float32" if kernel_name == "shallow_nt" else "tf32x3" if f32
                     else "bfloat16")}
        if f32 and kernel_name != "shallow_nt":
            r["fma_bound_ms"] = bound(flops, 0, "float32")["bound_ms"]
        results[name] = r
        log(f"[6b] product {name} ({kernel_name}): {r['tflops']:.1f} TFLOP/s, {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, torch.matmul {r['dtype']} {library_ms:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}), host {r['host_ms']:.4f} ms a call, rel "
            f"err {rel:.2e} | card: {card}")
        del got, ref
    torch.cuda.empty_cache()
    return results


# phase 6b: the products with an activation folded in (csrc/
# route_products.cu: route_nt with the epilogue, route_tn with the
# prologue) at the shipped steps' shapes, timed, and over a grid of the
# five activations at a ragged row count (against every tile: 128, 64 and
# 32 points); bars: their f32 outputs (dW, db, the raw and the kept
# product) PRODUCT_REL_TOL, their T outputs GRID_TOL (phase 21's)
FOLD_GRID_ROWS = 33_287
FOLD_ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")


def fold_shipped_cases(torch, gen, dev) -> list:
    """(name, mode, dtype name, kernel call, plain call, torch.matmul of
    the bare product, flops, bytes) at the shapes of the shipped steps:
    NeDDF's K=3 trunk (S = 4) and K=1 colour trunk (S = 2) over 99,328
    points, tanhExp, bf16; NeRF's trunk over 198,656 rows (ReLU, bf16:
    a hidden layer, the post-skip layer's 60 raw seg0 columns, dW); NeuS
    over 265,216 rows (ReLU, f32: the sdf trunk's descending nt with the
    side plane, 36 raw columns and db, the sweep's replay, the adjoint's
    [qbar | cg] W, dW)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    cases = []
    pts, c = M_TRAIN, 256
    for s_, tag in ((4, "K=3 trunk"), (2, "K=1 colour")):
        gs, z = rnd(s_, pts, c, scale=0.1), rnd(s_, pts, c)
        w = rnd(c, c, scale=1 / 16)
        k, kp = dm.DualProducts(torch.bfloat16, dev), dm.DualProductsPlain(torch.bfloat16)
        rows = s_ * pts
        cases.append((f"nt_gstack {tag} (S={s_}, {pts} points, bf16, tanhExp)", "nt_gstack",
                      "bfloat16", lambda k=k, gs=gs, w=w, z=z: k.nt_gstack(gs, w, z, "tanhExp"),
                      lambda kp=kp, gs=gs, w=w, z=z: kp.nt_gstack(gs, w, z, "tanhExp"),
                      lambda gs=gs, w=w, rows=rows: torch.matmul(gs.view(rows, c), w.T),
                      2.0 * rows * c * c, 2 * (3 * rows * c + c * c) + 4 * c))
        cases.append((f"tn_dual_act {tag} (S={s_}, {pts} points, bf16, tanhExp)",
                      "tn_dual_act", "bfloat16",
                      lambda k=k, gs=gs, z=z: k.tn_dual_act(z, gs, "tanhExp"),
                      lambda kp=kp, gs=gs, z=z: kp.tn_dual_act(z, gs, "tanhExp"),
                      lambda gs=gs, z=z, rows=rows: torch.matmul(z.view(rows, c).T,
                                                                 gs.view(rows, c)),
                      2.0 * rows * c * c, 2 * 2 * rows * c + 4 * c * c))
    r = M_NERF_FINE
    k, kp = dm.Products(torch.bfloat16, dev), dm.ProductsPlain(torch.bfloat16)
    g, z = rnd(r, c, scale=0.1), rnd(r, c)
    for n in (c, c + 60):
        w = rnd(n, c, scale=1 / 16)
        cases.append((f"nt_act NeRF {'post-skip, 60 raw' if n > c else 'hidden'} ({r} rows, "
                      f"bf16, ReLU, db)", "nt_act", "bfloat16",
                      lambda k=k, g=g, w=w, z=z: k.nt_act(g, w, z, "ReLU", n_act=c, db=True),
                      lambda kp=kp, g=g, w=w, z=z: kp.nt_act(g, w, z, "ReLU", n_act=c, db=True),
                      lambda g=g, w=w: torch.matmul(g, w.T), 2.0 * r * c * n,
                      2 * (r * c + n * c + r * c + r * c) + 4 * r * (n - c) + 4 * c))
    cases.append((f"tn_act NeRF ({r} rows, bf16, ReLU)", "tn_act", "bfloat16",
                  lambda k=k, g=g, z=z: k.tn_act(z, g, "ReLU"),
                  lambda kp=kp, g=g, z=z: kp.tn_act(z, g, "ReLU"),
                  lambda g=g, z=z: torch.matmul(z.T, g), 2.0 * r * c * c,
                  2 * 2 * r * c + 4 * c * c))
    r, e = M_NEUS, SDF_FANS[0]
    k, kp = dm.Products(torch.float32, dev), dm.ProductsPlain(torch.float32)
    f32 = torch.float32
    g, z, side = rnd(r, c, dtype=f32, scale=0.1), rnd(r, c, dtype=f32), rnd(r, c, dtype=f32)
    cg = rnd(r, e, dtype=f32)
    w_skip = rnd(c + e, c, dtype=f32, scale=1 / 16)
    w = w_skip[:c]
    cases += [
        (f"nt_act NeuS sdf trunk (post-skip, side plane, {e} raw, db; {r} rows, f32, ReLU)",
         "nt_act", "float32",
         lambda: k.nt_act(g, w_skip, z, "ReLU", add=side, n_act=c, db=True),
         lambda: kp.nt_act(g, w_skip, z, "ReLU", add=side, n_act=c, db=True),
         lambda: torch.matmul(g, w_skip.T), 2.0 * r * c * (c + e),
         4 * (r * c + (c + e) * c + 3 * r * c + r * e + c)),
        (f"nt_act NeuS sweep replay ({r} rows, f32, ReLU)", "nt_act", "float32",
         lambda: k.nt_act(g, w, z, "ReLU"), lambda: kp.nt_act(g, w, z, "ReLU"),
         lambda: torch.matmul(g, w.T), 2.0 * r * c * c, 4 * (3 * r * c + c * c)),
        (f"nn_adjoint NeuS [qbar | cg] W ({c} + {e}; {r} rows, f32, ReLU)", "nn_adjoint",
         "float32", lambda: k.nn_adjoint(g, w_skip, z, "ReLU", a2=cg),
         lambda: kp.nn_adjoint(g, w_skip, z, "ReLU", a2=cg),
         lambda: torch.matmul(torch.cat([g, cg], dim=1), w_skip), 2.0 * r * (c + e) * c,
         4 * (r * (c + e) + (c + e) * c + 2 * r * c)),
        (f"tn_act NeuS ({r} rows, f32, ReLU)", "tn_act", "float32",
         lambda: k.tn_act(z, g, "ReLU"), lambda: kp.tn_act(z, g, "ReLU"),
         lambda: torch.matmul(z.T, g), 2.0 * r * c * c, 4 * (2 * r * c + c * c)),
    ]
    return cases


def _fold_outputs(out) -> list:
    """A folded product's outputs as a list (None where not asked for)."""
    return list(out) if isinstance(out, tuple) else [out]


def fold_grid(torch, dev, dtype) -> dict:
    """Each folded mode against its plain version at FOLD_GRID_ROWS rows
    under the five activations: nt_act (the side plane, 36 raw columns and
    db; the kept product), tn_act, nt_gstack and tn_dual_act at S = 2 and
    4, and in f32 nn_adjoint over [qbar | cg] (with q; the top where f''
    is not zero) and over cg alone; dW and db bitwise equal over two
    runs. Returns the worst max abs and rel errors by mode."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.ops.activations import SECOND_DERIVATIVE_ZERO

    gen = torch.Generator(device=dev).manual_seed(19)
    name = str(dtype).replace("torch.", "")
    f32 = torch.float32

    def rnd(*shape, t=dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(t)

    r, c, e = FOLD_GRID_ROWS, 256, 36
    k, kp = dm.DualProducts(dtype, dev), dm.DualProductsPlain(dtype)
    g, z, side = rnd(r, c, scale=0.1), rnd(r, c), rnd(r, c, t=f32, scale=0.1)
    w_skip = rnd(c + e, c, scale=1 / 16)
    worst = {}

    def hold(mode, act, got, ref, exact):
        for i, (a, b) in enumerate(zip(_fold_outputs(got), _fold_outputs(ref))):
            if (a is None) != (b is None):
                fail(f"[6b] {mode} {name} {act}: output {i} missing")
            if a is None:
                continue
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail(f"[6b] {mode} {name} {act}: output {i} shape {tuple(a.shape)} or "
                     f"non-finite")
            err, rel = rel_err(torch, a, b)
            bar = PRODUCT_REL_TOL if a.dtype == f32 else GRID_TOL[name]
            if rel > bar:
                fail(f"[6b] {mode} {name} {act}: output {i} rel err {rel:.3g} > {bar}")
            old = worst.get(mode, (0.0, 0.0))
            worst[mode] = (max(old[0], err), max(old[1], rel))
        for i in exact:  # dW and db: the same bits on a second run
            if not torch.equal(_fold_outputs(got)[i], _fold_outputs(exact[i]())[i]):
                fail(f"[6b] {mode} {name} {act}: output {i} differs over two runs")

    for act in FOLD_ACTS:
        call = lambda: k.nt_act(g, w_skip, z, act, add=side, n_act=c, db=True)  # noqa: E731
        hold("nt_act", act, call(), kp.nt_act(g, w_skip, z, act, add=side, n_act=c, db=True),
             {3: call})
        hold("nt_act", act, k.nt_act(g, w_skip[:c], z, act, keep=True),
             kp.nt_act(g, w_skip[:c], z, act, keep=True), {})
        call = lambda: k.tn_act(z, g, act)  # noqa: E731
        hold("tn_act", act, call(), kp.tn_act(z, g, act), {0: call})
        for s_ in (2, 4):
            pts = r // s_
            gs, zs = rnd(s_, pts, c, scale=0.1), rnd(s_, pts, c)
            w = w_skip[:c]
            call = lambda: k.nt_gstack(gs, w, zs, act)  # noqa: E731
            hold(f"nt_gstack S={s_}", act, call(), kp.nt_gstack(gs, w, zs, act), {1: call})
            call = lambda: k.tn_dual_act(zs, gs, act)  # noqa: E731
            hold(f"tn_dual_act S={s_}", act, call(), kp.tn_dual_act(zs, gs, act), {0: call})
        if dtype == f32:
            cg, q = rnd(r, e), rnd(r, c)
            hold("nn_adjoint [qbar | cg]", act, k.nn_adjoint(g, w_skip, z, act, a2=cg, q=q),
                 kp.nn_adjoint(g, w_skip, z, act, a2=cg, q=q), {})
            hold("nn_adjoint cg", act, k.nn_adjoint(cg, w_skip[c:], z, act, q=q),
                 kp.nn_adjoint(cg, w_skip[c:], z, act, q=q), {})
            if act not in SECOND_DERIVATIVE_ZERO:
                hold("nn_adjoint top", act, k.nn_adjoint(g, w_skip, z, act, a2=cg, top=True),
                     kp.nn_adjoint(g, w_skip, z, act, a2=cg, top=True), {})
    torch.cuda.synchronize()
    return {mode: {"max_abs_err": v[0], "rel_err": v[1]} for mode, v in worst.items()}


def phase_fold_products(torch, card: str) -> dict:
    """Phase 6b, the folded modes: each mode at the shipped steps' shapes
    against its plain version, timed (kernel, plain, torch.matmul of the
    bare product: the yardstick, which the port never calls), with its
    bound and TFLOP/s; one launch of its own kernel a call and none of
    shallow_nt; then the grid of ``fold_grid``."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {"shipped": {}, "grid": {}}
    for name, mode, dtype_name, kernel, plain, library, flops, nbytes in fold_shipped_cases(
            torch, gen, dev):
        before = dict(dm.FOLD_LAUNCHES), sum(dm.SHALLOW_LAUNCHES.values())
        got = _fold_outputs(kernel())
        ran = {m: dm.FOLD_LAUNCHES[m] - before[0][m] for m in dm.FOLD_LAUNCHES}
        shallow = sum(dm.SHALLOW_LAUNCHES.values()) - before[1]
        if ran != {m: int(m == mode) for m in ran} or shallow:
            fail(f"[6b] {name}: launches {ran}, shallow_nt {shallow}; one {mode} expected")
        ref = _fold_outputs(plain())
        torch.cuda.synchronize()
        errs = [rel_err(torch, a, b) for a, b in zip(got, ref) if a is not None]
        bar = max(PRODUCT_REL_TOL if a.dtype == torch.float32 else GRID_TOL[dtype_name]
                  for a in got if a is not None)
        if any(rel > bar for _, rel in errs):
            fail(f"[6b] {name}: rel errs {errs} over {bar}")
        del got, ref
        ms, plain_ms = time_pair(torch, kernel, plain, reps=3, inner=10)
        library_ms, _ = time_pair(torch, library, library, reps=3, inner=10)
        r = {"mode": mode, "dtype": dtype_name, "max_abs_err": max(e for e, _ in errs),
             "rel_err": max(rel for _, rel in errs), "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "tflops": flops / ms / 1e9,
             "host_ms": host_ms(torch, kernel),
             **bound(flops, nbytes, "tf32x3" if dtype_name == "float32" else "bfloat16")}
        out["shipped"][name] = r
        log(f"[6b] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, torch.matmul of the bare "
            f"product {library_ms:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']}), "
            f"{r['tflops']:.1f} TFLOP/s, host {r['host_ms']:.4f} ms a call, rel err "
            f"{r['rel_err']:.2e} | card: {card}")
    torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        out["grid"][name] = fold_grid(torch, dev, dtype)
        log(f"[6b] folded modes {name} at {FOLD_GRID_ROWS} rows, the 5 activations, S = 2 and "
            f"4, raw and kept columns, two K segments: dW and db bitwise over two runs; worst "
            f"errs {json.dumps(out['grid'][name])}")
    torch.cuda.empty_cache()
    return out


def _pass_counters(dm) -> list:
    """The elementwise passes' launch counters of the three kernel modules."""
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    return [mlp.PASS_LAUNCHES, sk.PASS_LAUNCHES, dm.PASS_LAUNCHES]


def route_counts(dm) -> dict:
    """Launches of shallow_nt ("products") and of the tile forward by
    operand type: "tc" (bf16) and "tf32x3" (f32 by the 3xTF32 split); of
    the NeuS sweep ("sweep");
    of the products with an activation folded in, by end ("folded") and
    by mode ("fold"); of the elementwise passes."""
    passes = {}
    for counter in _pass_counters(dm):
        passes.update(counter)
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    return {"products": dict(dm.SHALLOW_LAUNCHES), "folded": dm.folded_launches(),
            "sweep": sk.SWEEP_LAUNCHES["sweep"],
            "tile_forward": dict(dm.TILE_LAUNCHES), "passes": passes,
            "layer_forward_kernels": dict(dm.LAYER_FWD_LAUNCHES),
            "layer_forward_wide_streams": dict(dm.LAYER_FWD_WIDE_STREAMS),
            "layer_forward_host_s": dm.LAYER_FWD_HOST["s"],
            "route_products": dict(dm.ROUTE_PRODUCT_LAUNCHES),
            "route_products_host_s": dm.ROUTE_PRODUCT_HOST["s"],
            "fold": dict(dm.FOLD_LAUNCHES)}


def reset_route_counts(dm) -> None:
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    dm.SHALLOW_LAUNCHES.update(tc=0, tf32x3=0)
    sk.SWEEP_LAUNCHES["sweep"] = 0
    dm.TILE_LAUNCHES.update(tc=0, tf32x3=0)
    dm.ROUTE_LAUNCHES.update(fwd=0, fwd_value=0)
    dm.LAYER_FWD_LAUNCHES.update(narrow=0, wide=0)
    dm.LAYER_FWD_WIDE_STREAMS.update(s1=0, s2=0, s4=0)
    dm.LAYER_FWD_HOST["s"] = 0.0
    dm.ROUTE_PRODUCT_LAUNCHES.update(nt=0, tn=0)
    dm.ROUTE_PRODUCT_HOST["s"] = 0.0
    dm.FOLD_LAUNCHES.update({mode: 0 for mode in dm.FOLD_LAUNCHES})
    for counter in _pass_counters(dm):
        counter.update({k: 0 for k in counter})


def check_routes(what: str, counts: dict, route: str, backward: bool = True) -> None:
    """A run in one compute dtype: every tile forward and every launch of
    shallow_nt (an nt of a depth under ROUTE_NT_MIN_K) on its route ("tc"
    for bf16, "tf32x3" for f32), none on the other, the
    tile forward launched; a backward's products with an activation
    folded in launched (route_nt / route_tn on wgmma; their launchers
    refuse an operand of another type than the run's)."""
    other = {"tc": "tf32x3", "tf32x3": "tc"}[route]
    if counts["tile_forward"][other] or counts["tile_forward"][route] < 1:
        fail(f"{what}: tile forward routes {counts['tile_forward']}, expected {route} only")
    if backward and counts["products"][other]:
        fail(f"{what}: shallow_nt routes {counts['products']}, expected {route} only")
    if backward and sum(counts["fold"].values()) < 1:
        fail(f"{what}: folded products {counts['fold']} (route_nt / route_tn expected)")


def machine_trainer(torch, optimize_camera: bool = False):
    """The trainer of pretrained/machine_neddf on its train split (f32,
    kernels), epoch-1000 params, at the phase-7 iteration."""
    from neddf_tpu_torch import config as config_lib

    cfg = config_lib.load_snapshot(RUN)
    cfg["dataset"]["dataset_dir"] = str(REPO / cfg["dataset"]["dataset_dir"])
    cfg["network"]["compute_dtype"] = "float32"
    cfg["trainer"].update(device="cuda", optimize_camera=optimize_camera)
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.load_pretrained_model(RUN / "models" / f"model_{EPOCH:05}.ckpt")
    trainer.iteration = MACHINE_ITERATION
    return trainer


def machine_step(torch, trainer, batch: int = MACHINE_BATCH, seed: int = 0) -> dict:
    """Phase 7's step on the shared draws (``batch`` rays from ``seed``):
    loss dict and gradient norms."""
    render = trainer.neural_render
    draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                               render.sample_coarse + 1, render.sample_fine + 1, seed=seed,
                               batch=batch)
    us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
    loss, loss_dict, mse = trainer.step_grads(MACHINE_CAMERA, us.long(), vs.long(),
                                              u_strat, u_pdf)
    return {"loss": loss.item(), "mse": mse.item(),
            "losses": {k: v.item() for k, v in loss_dict.items()},
            "grad_norms": {n: p.grad.norm().item() for n, p in render.named_parameters()}}


def phase_machine_step(torch, card: str) -> dict:
    trainer = machine_trainer(torch)
    net = trainer.neural_render.network_fine
    got = machine_step(torch, trainer)
    worst = 0.0
    for k in ("loss", "mse"):
        worst = max(worst, check_close(k, got[k], JAX_STEP[k], JAX_STEP_TOL))
    for k, ref in JAX_STEP["losses"].items():
        worst = max(worst, check_close(f"loss {k}", got["losses"][k], ref, JAX_STEP_TOL))
    for k, ref in JAX_STEP["grad_norms"].items():
        worst = max(worst, check_close(f"grad norm {k}", got["grad_norms"][k], ref, JAX_STEP_TOL))
    log(f"[7] f32 step vs the JAX package: loss {got['loss']:.8g} (JAX {JAX_STEP['loss']:.8g}), "
        f"worst relative gap {worst:.3g} over {2 + len(JAX_STEP['losses'])} losses and "
        f"{len(JAX_STEP['grad_norms'])} gradient norms (bar {JAX_STEP_TOL}) | card: {card}")
    net.compute_dtype = torch.bfloat16
    fused = net.fused
    kern = machine_step(torch, trainer)
    net.fused = "off"
    plain = machine_step(torch, trainer)
    worst_loss, worst_grad = bf16_step_gaps(kern, plain, skip=BF16_JUMPY_NORMS)
    jumpy = {k: abs(kern["grad_norms"][k] / plain["grad_norms"][k] - 1) for k in BF16_JUMPY_NORMS}
    log(f"[7] bf16 step, kernels vs plain versions: loss {kern['loss']:.8g} vs "
        f"{plain['loss']:.8g}; worst relative gap {worst_loss:.3g} (losses, bar "
        f"{BF16_STEP_TOL['loss']}), {worst_grad:.3g} (gradient norms, bar "
        f"{BF16_STEP_TOL['grad_norm']}); not held here: {json.dumps(jumpy)}")
    # the same step from seeded parameters: every number, those two too
    render = trainer.neural_render
    shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
    render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
    net.fused = fused
    seeded_kern = machine_step(torch, trainer)
    net.fused = "off"
    seeded_plain = machine_step(torch, trainer)
    seeded_loss, seeded_grad = bf16_step_gaps(seeded_kern, seeded_plain)
    log(f"[7] bf16 step from seeded parameters, kernels vs plain versions: worst relative "
        f"gap {seeded_loss:.3g} (losses), {seeded_grad:.3g} (all gradient norms)")
    del trainer
    torch.cuda.empty_cache()
    return {"f32": got, "bf16_kernels": kern, "bf16_plain": plain, "jax": JAX_STEP,
            "worst_rel_vs_jax": worst, "bf16_jumpy_gaps": jumpy, "bf16_seeded_kernels": seeded_kern,
            "bf16_seeded_plain": seeded_plain}


def bf16_step_gaps(kern: dict, plain: dict, skip=()) -> tuple:
    """Each loss within BF16_STEP_TOL["loss"] and each gradient norm (but
    those in ``skip``) within BF16_STEP_TOL["grad_norm"] of the plain
    step's; returns the worst relative gaps."""
    worst_loss = max(check_close(f"bf16 loss {k}", kern["losses"][k], plain["losses"][k],
                                 BF16_STEP_TOL["loss"]) for k in plain["losses"])
    worst_grad = max(check_close(f"bf16 grad norm {k}", kern["grad_norms"][k],
                                 plain["grad_norms"][k], BF16_STEP_TOL["grad_norm"])
                     for k in plain["grad_norms"] if k not in skip)
    return worst_loss, worst_grad


def run_main_path(torch, run_dir: Path, extra=()):
    """``python -m neddf_tpu_torch.scripts.run`` in this process."""
    import os

    from neddf_tpu_torch.scripts import run as run_script

    if run_dir.exists():
        shutil.rmtree(run_dir)
    cwd = os.getcwd()
    try:
        trainer = run_script.main([f"trainer.epoch_max={TRAIN_EPOCHS}",
                                   f"hydra.run.dir={run_dir}", *extra])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    return trainer


def profile_train(torch, trainer, card: str, name: str = "profile_train.txt",
                  what: str = "512 rays, bf16", tag: str = "8", steps: int = 5) -> dict:
    """Device time by kernel over a few more train steps, into
    ``OUT/name``; returns the device's busy share of the traced wall, the
    device ms per step and the kernel launches per step (counted over the
    traced steps)."""
    from torch.profiler import ProfilerActivity, profile

    from neddf_tpu_torch.utils.profiling import device_time_table

    for cam in range(2):
        trainer.run_train_step(cam)
    trainer.flush_logs()
    torch.cuda.synchronize()
    kernels, _ = path_counters()
    before = {k: fn.launches for k, fn in kernels.items()}
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for cam in range(steps):
            trainer.run_train_step(cam)
        trainer.flush_logs()
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {k: (fn.launches - before[k]) / steps for k, fn in kernels.items()
                if fn.launches > before[k]}
    busy, table = device_time_table(prof)
    lines = [f"card: {card}",
             f"{steps} train steps ({what}): traced wall {wall:.3f} s, device busy "
             f"{busy:.3f} s, busy share {busy / wall:.3f} of the traced wall", *table]
    (OUT / name).write_text("\n".join(lines) + "\n")
    for line in lines[:12]:
        log(f"[{tag}] {line}")
    return {"busy_share": busy / wall, "device_ms_per_step": 1000.0 * busy / steps,
            "launches_per_step": launches}


def mean(xs):
    return sum(xs) / len(xs)


def phase_train_run(torch, card: str) -> dict:
    """Phase 8: the main path (the default config's training run)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import neddf_epilogue as epi

    kernels = {"dual_mlp_trunk": dm.dual_mlp_trunk, "mlp_seg": mlp.mlp_seg,
               "dual_mlp_seg": dm.dual_mlp_seg, "dual_mlp_seg_bwd": dm.dual_mlp_seg_bwd,
               "neddf_epilogue": epi.neddf_epilogue,
               "neddf_epilogue_gstack": epi.neddf_epilogue_gstack}
    plains = [dm.dual_mlp_trunk_plain, dm.dual_mlp_seg_plain, dm.dual_mlp_seg_bwd_plain,
              mlp.mlp_seg_plain, epi.neddf_epilogue_plain, epi.neddf_epilogue_bwd_plain,
              epi.neddf_epilogue_gstack_plain, dm.route_product_plain]
    # the epilogue backward's standalone mode: off the main path, which runs
    # its top mode
    standalone = epi.neddf_epilogue_bwd
    for fn in (*kernels.values(), standalone):
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    reset_route_counts(dm)
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    trainer = run_main_path(torch, OUT / "train")
    wall = time.perf_counter() - start
    if trainer.world is not None:
        fail(f"[8] data: auto on one card made a world of {trainer.world} ranks")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: fn.launches for k, fn in kernels.items()}
    routes = route_counts(dm)
    plain_calls = sum(fn.calls for fn in plains)
    log(f"[8] main path run: {trainer.iteration} steps in {wall:.1f} s (load, hooks and "
        f"checkpoint included), peak device memory {peak_gib:.2f} GiB; launches "
        f"{launches}, the epilogue backward's standalone mode {standalone.launches}; routes "
        f"{routes}; plain calls {plain_calls}")
    if min(launches.values()) < 1 or plain_calls:
        fail("the main path did not run through every kernel alone")
    # per pass one K=3 and one K=1 dual backward; the K=3 one starts from
    # the epilogue backward's top mode
    if launches["neddf_epilogue_gstack"] * 2 != launches["dual_mlp_seg_bwd"] or (
            standalone.launches):
        fail(f"the main path's epilogue backward: top mode {launches['neddf_epilogue_gstack']}"
             f", standalone {standalone.launches}, expected one top mode per pair of dual "
             f"backwards ({launches['dual_mlp_seg_bwd']}) and no standalone")
    launches["neddf_epilogue_bwd"] = standalone.launches
    check_routes("main path", routes, "tc")
    net = trainer.neural_render.network_fine
    dual_layers = (len(net.layers_ddf), len(net.layers_col))
    expected = expected_folding("neddf", launches, dual_layers)
    folding = {"passes": routes["passes"], "folded": routes["folded"]}
    steps = trainer.iteration
    log(f"[8] main path: elementwise launches {routes['passes']} and products with an "
        f"activation folded in {routes['folded']} (expected {expected}; per step: gstack "
        f"{expected['passes']['gstack'] / steps:g} (the colour trunk's; the K=3 trunk's top "
        f"layer in the epilogue backward, {launches['neddf_epilogue_gstack'] / steps:g}), "
        f"epilogues {expected['folded']['epilogue'] / steps:g}, prologues "
        f"{expected['folded']['prologue'] / steps:g}, dual_act 0)")
    if folding != expected:
        fail(f"the main path's elementwise launches {folding}, expected {expected}")
    hist = trainer.history
    if len(hist) != 100 * (TRAIN_EPOCHS + 1):
        fail(f"{len(hist)} logged steps")
    if not all(math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
               for r in hist):
        fail("a non-finite loss in the main path run")
    first, last = mean([r["psnr"] for r in hist[:50]]), mean([r["psnr"] for r in hist[-50:]])
    log(f"[8] train PSNR: first 50 steps {first:.3f} dB, last 50 {last:.3f} dB "
        f"(gain bar {PSNR_GAIN_MIN} dB); loss {mean([r['loss'] for r in hist[:50]]):.5f} -> "
        f"{mean([r['loss'] for r in hist[-50:]]):.5f}")
    if not last - first >= PSNR_GAIN_MIN:
        fail("train PSNR did not rise")
    # steady steps: epoch 1 has no hook inside it
    steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
    ms_step = 1000.0 * mean(steady)
    rays_s = trainer.batch_size / mean(steady)
    render = trainer.neural_render
    samples = 2 * (render.sample_coarse + 1) + render.sample_fine + 1
    log(f"[8] {ms_step:.2f} ms/step, {rays_s:.0f} rays/s (steps 100-199, bf16, "
        f"{trainer.batch_size} rays x {samples} samples) | card: {card}")
    # run A of phase 14: its state and losses before any step beyond the run
    run_a = {"state": trainer.checkpoint_state(), "losses": [r["loss"] for r in hist[100:300]]}
    prof = profile_train(torch, trainer, card)
    kernel_hist = [dict(r) for r in hist[:100]]
    del trainer
    torch.cuda.empty_cache()

    start = time.perf_counter()
    plain_trainer = run_main_path(torch, OUT / "train_plain",
                                  ["network.fused=off", "trainer.epoch_max=0"])
    plain_wall = time.perf_counter() - start
    ph = plain_trainer.history
    gaps = [abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(kernel_hist, ph)]
    psnr_gap = abs(mean([r["psnr"] for r in kernel_hist[50:]])
                   - mean([r["psnr"] for r in ph[50:100]]))
    plain_steady = 1000.0 * mean([r["seconds"] for r in ph[10:100]])
    log(f"[8] plain versions, first 100 steps ({plain_wall:.1f} s, {plain_steady:.2f} ms/step "
        f"steps 10-99): mean relative loss gap {mean(gaps):.4f} (bar {TRACK_LOSS_REL}), max "
        f"{max(gaps):.4f}; PSNR gap steps 50-99 {psnr_gap:.3f} dB (bar {TRACK_PSNR_DB})")
    if len(ph) != 100 or not mean(gaps) <= TRACK_LOSS_REL or not psnr_gap <= TRACK_PSNR_DB:
        fail("the plain versions do not track the kernel run")
    return {"launches": launches, "routes": routes, "plain_calls": plain_calls,
            "folding_expected": expected, "ms_per_step": ms_step, "peak_memory_gib": peak_gib,
            "rays_per_s": rays_s, "psnr_first50": first, "psnr_last50": last,
            "wall_s": wall, "plain_ms_per_step": plain_steady,
            "track_mean_loss_gap": mean(gaps), "track_max_loss_gap": max(gaps),
            "track_psnr_gap_db": psnr_gap, "ms_10_99": 1000.0 * mean(
                [r["seconds"] for r in kernel_hist[10:100]]), **prof,
            "loss_curve": [r["loss"] for r in hist], "psnr_curve": [r["psnr"] for r in hist],
            "plain_loss_curve": [r["loss"] for r in ph]}, run_a


# The JAX package's numbers for the phase-10 steps, made once on a CPU with
#   JAX_PLATFORMS=cpu python tools/family_step_reference.py
# (f32, network.fused=off, the parameters of family_params and the draws of
# machine_step_draws(seed=FAMILY_DRAW_SEED, batch=FAMILY_BATCH)); held at
# JAX_STEP_TOL like phase 7's step. camera_grad is the pose-delta gradient
# of FAMILY_CAMERA, camera_grad_spread its spread under a shift of the
# translation part of FAMILY_SHIFT.
FAMILY_STEP = {
 "nerf": {
  "loss": 0.07272379100322723,
  "mse": 0.012628795579075813,
  "losses": {
   "color": 0.012628795579075813,
   "color_coarse": 0.0012153348652645946,
   "mask": 0.04297208786010742,
   "mask_coarse": 0.015907572582364082
  },
  "grad_norms": {
   "network_coarse.layers.0.b": 0.00021642321371473372,
   "network_coarse.layers.0.w": 0.0010082325898110867,
   "network_coarse.layers.1.b": 0.0005932954954914749,
   "network_coarse.layers.1.w": 0.002336723729968071,
   "network_coarse.layers.2.b": 0.001566355931572616,
   "network_coarse.layers.2.w": 0.0028038532473146915,
   "network_coarse.layers.3.b": 0.00404606806114316,
   "network_coarse.layers.3.w": 0.003762252861633897,
   "network_coarse.layers.4.b": 0.009944715537130833,
   "network_coarse.layers.4.w": 0.005273424554616213,
   "network_coarse.layers.5.b": 0.027658987790346146,
   "network_coarse.layers.5.w": 0.0997622013092041,
   "network_coarse.layers.6.b": 0.07830952852964401,
   "network_coarse.layers.6.w": 0.1373198926448822,
   "network_coarse.layers.7.b": 0.2326049953699112,
   "network_coarse.layers.7.w": 0.19407057762145996,
   "network_coarse.outL_color.0.b": 2.1401106664598046e-07,
   "network_coarse.outL_color.0.w": 7.135423061299662e-07,
   "network_coarse.outL_color.1.b": 5.675591410181369e-07,
   "network_coarse.outL_color.1.w": 5.048278808317264e-07,
   "network_coarse.outL_density.b": 0.653171718120575,
   "network_coarse.outL_density.w": 0.3662753403186798,
   "network_fine.layers.0.b": 0.00012371683260425925,
   "network_fine.layers.0.w": 0.0002496445085853338,
   "network_fine.layers.1.b": 0.0004579228116199374,
   "network_fine.layers.1.w": 0.0014011700404807925,
   "network_fine.layers.2.b": 0.0013850490795448422,
   "network_fine.layers.2.w": 0.002093283925205469,
   "network_fine.layers.3.b": 0.003804202890023589,
   "network_fine.layers.3.w": 0.0028712935745716095,
   "network_fine.layers.4.b": 0.010396725498139858,
   "network_fine.layers.4.w": 0.005758058745414019,
   "network_fine.layers.5.b": 0.03289446607232094,
   "network_fine.layers.5.w": 0.058088887482881546,
   "network_fine.layers.6.b": 0.1043478399515152,
   "network_fine.layers.6.w": 0.1296025663614273,
   "network_fine.layers.7.b": 0.3238949775695801,
   "network_fine.layers.7.w": 0.21931642293930054,
   "network_fine.outL_color.0.b": 0.0010659921681508422,
   "network_fine.outL_color.0.w": 0.0034757673274725676,
   "network_fine.outL_color.1.b": 0.0030849208123981953,
   "network_fine.outL_color.1.w": 0.0029864166863262653,
   "network_fine.outL_density.b": 0.9229459166526794,
   "network_fine.outL_density.w": 0.4799703061580658
  },
  "camera_grad": [
   0.4601384997367859,
   0.8499272465705872,
   -0.33512601256370544,
   -0.2180701345205307,
   -0.20166951417922974,
   0.08122581243515015
  ],
  "camera_grad_spread": 0.011343553958920886,
  "spread": {
   "loss": 1.946557369860858e-06,
   "mse": 0.0,
   "loss color": 0.0,
   "loss color_coarse": 0.0,
   "loss mask": 1.7338186176056103e-07,
   "loss mask_coarse": 8.547696085611851e-06,
   "network_coarse.layers.0.b": 0.002354481327605532,
   "network_coarse.layers.0.w": 0.0025505008167976267,
   "network_coarse.layers.1.b": 0.0018201192044650608,
   "network_coarse.layers.1.w": 0.0019492530603362724,
   "network_coarse.layers.2.b": 0.0017789808095863995,
   "network_coarse.layers.2.w": 0.0019741816828424893,
   "network_coarse.layers.3.b": 0.0017828565641197095,
   "network_coarse.layers.3.w": 0.002085185657581374,
   "network_coarse.layers.4.b": 0.0016797999860836104,
   "network_coarse.layers.4.w": 0.0018618770670168897,
   "network_coarse.layers.5.b": 0.0018027778537259586,
   "network_coarse.layers.5.w": 0.0023477474290985656,
   "network_coarse.layers.6.b": 0.0015643364029225176,
   "network_coarse.layers.6.w": 0.0021178720534862257,
   "network_coarse.layers.7.b": 0.0015549790110184866,
   "network_coarse.layers.7.w": 0.0019127207794680777,
   "network_coarse.outL_color.0.b": 3.5525299657562676e-05,
   "network_coarse.outL_color.0.w": 3.640631003406499e-05,
   "network_coarse.outL_color.1.b": 3.5254270423890534e-05,
   "network_coarse.outL_color.1.w": 3.6482271305139745e-05,
   "network_coarse.outL_density.b": 0.0015523247319887761,
   "network_coarse.outL_density.w": 0.0017443221451696198,
   "network_fine.layers.0.b": 6.598636799268292e-05,
   "network_fine.layers.0.w": 4.3135005572576396e-05,
   "network_fine.layers.1.b": 2.1418436939672717e-05,
   "network_fine.layers.1.w": 1.6783041550739745e-05,
   "network_fine.layers.2.b": 2.4290856190482674e-05,
   "network_fine.layers.2.w": 2.280162828095966e-05,
   "network_fine.layers.3.b": 9.914971772626195e-06,
   "network_fine.layers.3.w": 1.1190297331065433e-05,
   "network_fine.layers.4.b": 1.3884660039473641e-05,
   "network_fine.layers.4.w": 1.3667237698414528e-05,
   "network_fine.layers.5.b": 7.92748300942204e-06,
   "network_fine.layers.5.w": 8.72179693129988e-06,
   "network_fine.layers.6.b": 8.425363772221005e-06,
   "network_fine.layers.6.w": 8.393234776827911e-06,
   "network_fine.layers.7.b": 4.6006150838342484e-07,
   "network_fine.layers.7.w": 7.473802961745816e-07,
   "network_fine.outL_color.0.b": 7.644589492642793e-07,
   "network_fine.outL_color.0.w": 8.708288220492786e-07,
   "network_fine.outL_color.1.b": 7.547378289845591e-07,
   "network_fine.outL_color.1.w": 8.575953556377773e-07,
   "network_fine.outL_density.b": 1.097874688970486e-06,
   "network_fine.outL_density.w": 9.934722046036135e-07
  }
 },
 "neus": {
  "loss": 0.1333521604537964,
  "mse": 0.010037576779723167,
  "losses": {
   "color": 0.010037576779723167,
   "color_coarse": 0.001003757701255381,
   "mask": 0.11119160801172256,
   "mask_coarse": 0.011119218543171883
  },
  "grad_norms": {
   "network_fine.layers_col.0.b": 1.4293711501522921e-05,
   "network_fine.layers_col.0.w": 5.983127630315721e-05,
   "network_fine.layers_col.1.b": 3.3315962355118245e-05,
   "network_fine.layers_col.1.w": 6.0413352912291884e-05,
   "network_fine.layers_col.2.b": 8.135303505696356e-05,
   "network_fine.layers_col.2.w": 6.901117012603208e-05,
   "network_fine.layers_col.3.b": 0.00018257762712892145,
   "network_fine.layers_col.3.w": 0.00010134344483958557,
   "network_fine.layers_col.4.b": 0.00047696492401883006,
   "network_fine.layers_col.4.w": 0.000212166050914675,
   "network_fine.layers_col.5.b": 0.0012070550583302975,
   "network_fine.layers_col.5.w": 0.00046837012632749975,
   "network_fine.layers_col.6.b": 0.002770537044852972,
   "network_fine.layers_col.6.w": 0.0012408980401232839,
   "network_fine.layers_col.7.b": 0.006318370811641216,
   "network_fine.layers_col.7.w": 0.0028957442846149206,
   "network_fine.layers_col.8.b": 0.015432468615472317,
   "network_fine.layers_col.8.w": 0.007265223655849695,
   "network_fine.layers_sdf.0.b": 1.431039891031105e-06,
   "network_fine.layers_sdf.0.w": 2.705468432395719e-06,
   "network_fine.layers_sdf.1.b": 4.774637545779115e-06,
   "network_fine.layers_sdf.1.w": 1.5842215361772105e-05,
   "network_fine.layers_sdf.2.b": 1.371204143651994e-05,
   "network_fine.layers_sdf.2.w": 2.2354157408699393e-05,
   "network_fine.layers_sdf.3.b": 4.277220432413742e-05,
   "network_fine.layers_sdf.3.w": 3.292840119684115e-05,
   "network_fine.layers_sdf.4.b": 0.0001238036493305117,
   "network_fine.layers_sdf.4.w": 6.208521517692134e-05,
   "network_fine.layers_sdf.5.b": 0.0003064531774725765,
   "network_fine.layers_sdf.5.w": 0.0005115928361192346,
   "network_fine.layers_sdf.6.b": 0.0009686918347142637,
   "network_fine.layers_sdf.6.w": 0.0010849080281332135,
   "network_fine.layers_sdf.7.b": 0.0028427974320948124,
   "network_fine.layers_sdf.7.w": 0.00179282168392092,
   "network_fine.variance": 0.39704278111457825
  },
  "camera_grad": [
   -1.0675847079255618e-05,
   -1.7052901966962963e-05,
   -1.4216392628441099e-05,
   3.857745832647197e-05,
   2.5587623895262368e-05,
   -1.710197284410242e-05
  ],
  "camera_grad_spread": 0.00019583158328965078,
  "spread": {
   "loss": 0.0,
   "mse": 0.0,
   "loss color": 0.0,
   "loss color_coarse": 0.0,
   "loss mask": 0.0,
   "loss mask_coarse": 8.375791617005202e-08,
   "network_fine.layers_col.0.b": 1.4634672134349853e-06,
   "network_fine.layers_col.0.w": 2.1889427260703564e-06,
   "network_fine.layers_col.1.b": 1.0373645611369165e-05,
   "network_fine.layers_col.1.w": 1.0056426791380811e-05,
   "network_fine.layers_col.2.b": 2.77254174821815e-06,
   "network_fine.layers_col.2.w": 3.900968947970879e-06,
   "network_fine.layers_col.3.b": 4.144536237951853e-06,
   "network_fine.layers_col.3.w": 4.3794980047078884e-06,
   "network_fine.layers_col.4.b": 9.152820990957623e-07,
   "network_fine.layers_col.4.w": 8.916360423979796e-07,
   "network_fine.layers_col.5.b": 1.928914858083947e-07,
   "network_fine.layers_col.5.w": 2.485541141143007e-07,
   "network_fine.layers_col.6.b": 1.6807618153773908e-07,
   "network_fine.layers_col.6.w": 9.381538052503402e-08,
   "network_fine.layers_col.7.b": 0.0,
   "network_fine.layers_col.7.w": 8.040442137480786e-08,
   "network_fine.layers_col.8.b": 6.034825651171266e-08,
   "network_fine.layers_col.8.w": 6.409455639164056e-08,
   "network_fine.layers_sdf.0.b": 3.4955146191954596e-06,
   "network_fine.layers_sdf.0.w": 3.02552128050818e-06,
   "network_fine.layers_sdf.1.b": 3.6192065194481398e-06,
   "network_fine.layers_sdf.1.w": 3.4445739349090346e-06,
   "network_fine.layers_sdf.2.b": 1.5255480547968902e-06,
   "network_fine.layers_sdf.2.w": 1.8715425286069344e-06,
   "network_fine.layers_sdf.3.b": 1.1907663891557245e-06,
   "network_fine.layers_sdf.3.w": 8.838519150308961e-07,
   "network_fine.layers_sdf.4.b": 2.1157249849019515e-06,
   "network_fine.layers_sdf.4.w": 1.9922823668830168e-06,
   "network_fine.layers_sdf.5.b": 1.2346088203683105e-06,
   "network_fine.layers_sdf.5.w": 1.2515505004040233e-06,
   "network_fine.layers_sdf.6.b": 1.2017787045895147e-07,
   "network_fine.layers_sdf.6.w": 1.07304323323378e-07,
   "network_fine.layers_sdf.7.b": 1.638038933236973e-07,
   "network_fine.layers_sdf.7.w": 1.948023992642703e-07,
   "network_fine.variance": 0.0
  }
 }
}


# The JAX package's numbers for phase 22's f32 steps of WIDE_OVERRIDES'
# configurations, made once on a CPU with
#   JAX_PLATFORMS=cpu python tools/family_step_reference.py --wide
# (as FAMILY_STEP, at WIDE_BATCH rays; NeDDF through the jnp path, which
# applies the LeakyReLU density)
WIDE_STEP = {
 "neddf_wide": {
  "loss": 0.23134423792362213,
  "mse": 0.05949636548757553,
  "losses": {
   "color": 0.05949636548757553,
   "color_coarse": 0.005950195714831352,
   "fields_penalty": 8.412722601880418e-11,
   "fields_penalty_coarse": 4.654878218990355e-11,
   "mask": 0.15080969035625458,
   "mask_coarse": 0.015087983570992947
  },
  "grad_norms": {
   "network_fine.layer_aux_out.b": 0.00020029701408930123,
   "network_fine.layer_aux_out.w": 0.003409690922126174,
   "network_fine.layer_col_out.b": 0.2832021713256836,
   "network_fine.layer_col_out.w": 4.850977897644043,
   "network_fine.layer_ddf_out.b": 0.11326532810926437,
   "network_fine.layer_ddf_out.w": 1.9267598390579224,
   "network_fine.layers_col.0.b": 0.008046722039580345,
   "network_fine.layers_col.0.w": 0.13952766358852386,
   "network_fine.layers_col.1.b": 0.02596273459494114,
   "network_fine.layers_col.1.w": 0.4387803077697754,
   "network_fine.layers_col.2.b": 0.08423485606908798,
   "network_fine.layers_col.2.w": 1.4204460382461548,
   "network_fine.layers_ddf.0.b": 2.148986459360458e-05,
   "network_fine.layers_ddf.0.w": 5.677546141669154e-05,
   "network_fine.layers_ddf.1.b": 7.824889326002449e-05,
   "network_fine.layers_ddf.1.w": 0.0012682644883170724,
   "network_fine.layers_ddf.2.b": 0.00025704342988319695,
   "network_fine.layers_ddf.2.w": 0.004395011346787214,
   "network_fine.layers_ddf.3.b": 0.0008447680156677961,
   "network_fine.layers_ddf.3.w": 0.014108833856880665,
   "network_fine.layers_ddf.4.b": 0.0028703073039650917,
   "network_fine.layers_ddf.4.w": 0.048938311636447906,
   "network_fine.layers_ddf.5.b": 0.01018065307289362,
   "network_fine.layers_ddf.5.w": 0.1759079247713089,
   "network_fine.layers_ddf.6.b": 0.03383360803127289,
   "network_fine.layers_ddf.6.w": 0.5693358182907104
  },
  "camera_grad": [
   -0.00023399153724312782,
   -0.0011139470152556896,
   0.0017227660864591599,
   -0.0016927288379520178,
   -0.0005670891841873527,
   0.00030422143754549325
  ],
  "camera_grad_spread": 4.093406404323774e-05,
  "spread": {
   "loss": 0.0,
   "mse": 6.261374569577459e-08,
   "loss color": 6.261374569577459e-08,
   "loss color_coarse": 7.825982700821759e-08,
   "loss fields_penalty": 6.598476362319368e-07,
   "loss fields_penalty_coarse": 5.962685662193137e-07,
   "loss mask": 0.0,
   "loss mask_coarse": 0.0,
   "network_fine.layer_aux_out.b": 3.6325841637057475e-07,
   "network_fine.layer_aux_out.w": 1.3656994077849372e-07,
   "network_fine.layer_col_out.b": 0.0,
   "network_fine.layer_col_out.w": 0.0,
   "network_fine.layer_ddf_out.b": 1.3155977599316942e-07,
   "network_fine.layer_ddf_out.w": 6.187034166596908e-08,
   "network_fine.layers_col.0.b": 0.0,
   "network_fine.layers_col.0.w": 0.0,
   "network_fine.layers_col.1.b": 0.0,
   "network_fine.layers_col.1.w": 6.792082930789218e-08,
   "network_fine.layers_col.2.b": 0.0,
   "network_fine.layers_col.2.w": 0.0,
   "network_fine.layers_ddf.0.b": 8.464406072094055e-08,
   "network_fine.layers_ddf.0.w": 1.2815320972529077e-07,
   "network_fine.layers_ddf.1.b": 9.2984799031024e-08,
   "network_fine.layers_ddf.1.w": 0.0,
   "network_fine.layers_ddf.2.b": 0.0,
   "network_fine.layers_ddf.2.w": 0.0,
   "network_fine.layers_ddf.3.b": 6.890372248226487e-08,
   "network_fine.layers_ddf.3.w": 6.600989026185794e-08,
   "network_fine.layers_ddf.4.b": 8.111697424600961e-08,
   "network_fine.layers_ddf.4.w": 0.0,
   "network_fine.layers_ddf.5.b": 0.0,
   "network_fine.layers_ddf.5.w": 8.47100050393982e-08,
   "network_fine.layers_ddf.6.b": 1.1010620844866959e-07,
   "network_fine.layers_ddf.6.w": 2.093830841500146e-07
  }
 },
 "neus_narrow": {
  "loss": 0.6810174584388733,
  "mse": 0.5364684462547302,
  "losses": {
   "color": 0.5364684462547302,
   "color_coarse": 0.05364613980054855,
   "mask": 0.0826389417052269,
   "mask_coarse": 0.008263940922915936
  },
  "grad_norms": {
   "network_fine.layers_col.0.b": 2.8697835659841076e-05,
   "network_fine.layers_col.0.w": 0.0002634006959851831,
   "network_fine.layers_col.1.b": 0.00010348289652029052,
   "network_fine.layers_col.1.w": 0.0008665270870551467,
   "network_fine.layers_col.2.b": 0.0003708428412210196,
   "network_fine.layers_col.2.w": 0.0031567788682878017,
   "network_fine.layers_col.3.b": 0.0012662640074267983,
   "network_fine.layers_col.3.w": 0.010746045969426632,
   "network_fine.layers_col.4.b": 0.004650182090699673,
   "network_fine.layers_col.4.w": 0.03823718801140785,
   "network_fine.layers_col.5.b": 0.015021787025034428,
   "network_fine.layers_col.5.w": 0.13568758964538574,
   "network_fine.layers_col.6.b": 0.04786713048815727,
   "network_fine.layers_col.6.w": 0.4112149775028229,
   "network_fine.layers_col.7.b": 0.16818945109844208,
   "network_fine.layers_col.7.w": 1.4186631441116333,
   "network_fine.layers_col.8.b": 0.502193808555603,
   "network_fine.layers_col.8.w": 4.3011040687561035,
   "network_fine.layers_sdf.0.b": 2.599104118417017e-05,
   "network_fine.layers_sdf.0.w": 3.016938535438385e-05,
   "network_fine.layers_sdf.1.b": 9.10623639356345e-05,
   "network_fine.layers_sdf.1.w": 0.000744129647500813,
   "network_fine.layers_sdf.2.b": 0.00029663502937182784,
   "network_fine.layers_sdf.2.w": 0.002536261221393943,
   "network_fine.layers_sdf.3.b": 0.000993994646705687,
   "network_fine.layers_sdf.3.w": 0.00847052875906229,
   "network_fine.layers_sdf.4.b": 0.003587874351069331,
   "network_fine.layers_sdf.4.w": 0.030355989933013916,
   "network_fine.layers_sdf.5.b": 0.015085466206073761,
   "network_fine.layers_sdf.5.w": 0.12780289351940155,
   "network_fine.layers_sdf.6.b": 0.05204950273036957,
   "network_fine.layers_sdf.6.w": 0.4228188395500183,
   "network_fine.layers_sdf.7.b": 0.17350399494171143,
   "network_fine.layers_sdf.7.w": 1.4957069158554077,
   "network_fine.variance": 0.6689904928207397
  },
  "camera_grad": [
   0.0003189236740581691,
   -0.001171101932413876,
   -0.0004876636667177081,
   -0.000820403452962637,
   0.0005429856246337295,
   -0.0002500278933439404
  ],
  "camera_grad_spread": 1.0143427116401733e-06,
  "spread": {
   "loss": 0.0,
   "mse": 0.0,
   "loss color": 0.0,
   "loss color_coarse": 6.944190788586472e-08,
   "loss mask": 0.0,
   "loss mask_coarse": 0.0,
   "network_fine.layers_col.0.b": 0.0,
   "network_fine.layers_col.0.w": 1.104926103094688e-07,
   "network_fine.layers_col.1.b": 0.0,
   "network_fine.layers_col.1.w": 6.717350419048472e-08,
   "network_fine.layers_col.2.b": 7.848022725990289e-08,
   "network_fine.layers_col.2.w": 0.0,
   "network_fine.layers_col.3.b": 9.193605847133319e-08,
   "network_fine.layers_col.3.w": 0.0,
   "network_fine.layers_col.4.b": 0.0,
   "network_fine.layers_col.4.w": 0.0,
   "network_fine.layers_col.5.b": 0.0,
   "network_fine.layers_col.5.w": 0.0,
   "network_fine.layers_col.6.b": 0.0,
   "network_fine.layers_col.6.w": 0.0,
   "network_fine.layers_col.7.b": 0.0,
   "network_fine.layers_col.7.w": 0.0,
   "network_fine.layers_col.8.b": 1.1868852972684785e-07,
   "network_fine.layers_col.8.w": 0.0,
   "network_fine.layers_sdf.0.b": 0.0,
   "network_fine.layers_sdf.0.w": 0.0,
   "network_fine.layers_sdf.1.b": 0.0,
   "network_fine.layers_sdf.1.w": 0.0,
   "network_fine.layers_sdf.2.b": 0.0,
   "network_fine.layers_sdf.2.w": 0.0,
   "network_fine.layers_sdf.3.b": 0.0,
   "network_fine.layers_sdf.3.w": 0.0,
   "network_fine.layers_sdf.4.b": 0.0,
   "network_fine.layers_sdf.4.w": 6.136005293654487e-08,
   "network_fine.layers_sdf.5.b": 0.0,
   "network_fine.layers_sdf.5.w": 1.1659486560517924e-07,
   "network_fine.layers_sdf.6.b": 7.15720631906883e-08,
   "network_fine.layers_sdf.6.w": 7.048484977493482e-08,
   "network_fine.layers_sdf.7.b": 0.0,
   "network_fine.layers_sdf.7.w": 0.0,
   "network_fine.variance": 1.781928006901051e-07
  }
 }
}


# ---- bounds (H100 SXM datasheet peaks, 700 W)
# tensor-core bf16; f32 off them (FMA); f32 by the 3xTF32 split: three
# TF32 operations (495 TFLOP/s dense) per f32 one
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
MEM_RATE = 3.35e12  # bytes/s of HBM3


def bound(flops: float, nbytes: float, dtype_name: str) -> dict:
    """Least time the card could take: operations over the peak rate of
    their type or bytes (inputs read once, outputs written once) over the
    memory rate, whichever is larger."""
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype_name]
    mem_ms = 1e3 * nbytes / MEM_RATE
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "flops": flops, "bytes": nbytes}


def mlp_work(m, fan_ins, outs, dtype_name, in_width, streams=1, stash=False):
    """(flops, bytes) of an MLP forward over ``streams`` stacked streams
    of M rows: products 2 M S fan_in C per layer; bytes of the inputs,
    the weights (T) and biases (f32), the output and the stash."""
    t = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * m * streams * sum(f * o for f, o in zip(fan_ins, outs))
    weights = sum(f * o * t + 4 * o for f, o in zip(fan_ins, outs))
    acts = m * streams * (in_width + outs[-1] + (sum(outs) if stash else 0)) * t
    return flops, weights + acts


def mlp_bwd_work(m, fan_ins, outs, dtype_name, in_width, streams=1):
    """(flops, bytes) of the backward from the stash: dx and dW products
    per layer; bytes of the stash, g, the inputs, dx, the weights and the
    f32 dW/db."""
    t = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * 2.0 * m * streams * sum(f * o for f, o in zip(fan_ins, outs))
    params = sum(f * o * (t + 4) + 4 * o for f, o in zip(fan_ins, outs))
    acts = m * streams * (sum(outs) + outs[-1] + 2 * in_width) * t
    return flops, params + acts


def slice12_bounds(n_ddf: int, n_col: int) -> dict:
    """Bounds of the earlier slices' routes at the shapes phases 3 and 6
    time them (bf16)."""
    bf = "bfloat16"
    ddf_fans = [60] + [316 if li == 5 else 256 for li in range(1, n_ddf)]
    out = {}
    f, b = mlp_work(M_TRAIN, ddf_fans, [256] * n_ddf, bf, 60, streams=4, stash=True)
    out["dual_mlp_trunk_stash"] = bound(f, b, bf)
    col_fans = [343] + [256] * (n_col - 1)
    f, b = mlp_work(M_FULL, col_fans, [256] * n_col, bf, 343)
    out["mlp_seg_eval"] = bound(f, b, bf)
    # K=1 colour: layer 0's tangent stream reads only the segments with tangents
    f, b = mlp_work(M_TRAIN, col_fans, [256] * n_col, bf, 343, streams=2, stash=True)
    f -= 2.0 * M_TRAIN * (343 - 316) * 256
    out["dual_mlp_color_k1"] = bound(f, b, bf)
    f, b = mlp_bwd_work(M_TRAIN, ddf_fans, [256] * n_ddf, bf, 60, streams=4)
    out["dual_mlp_seg_bwd_trunk"] = bound(f, b, bf)
    # epilogue: 8 head dots of 256 per row; the 4 streams in, 10 rows and t_feat out
    out["neddf_epilogue"] = bound(2.0 * 8 * 256 * M_TRAIN,
                                  M_TRAIN * (4 * 256 * 2 + 10 * 4 + 256 * 2), bf)
    out["neddf_epilogue_bwd"] = bound(4.0 * 8 * 256 * M_TRAIN,
                                      M_TRAIN * (4 * 256 * 2 * 2 + 10 * 4 + 256 * 2), bf)
    # its top mode: the 4 streams, g_tfeat, g_col and the stash's 4 planes
    # (1 where f'' = 0) in, gs's 4 planes out, 4 g_out values per row; the
    # dots again, dwd/dwa and the stacked cotangent
    for name, z_planes in (("neddf_epilogue_gstack", 4), ("neddf_epilogue_gstack_f2zero", 1)):
        planes = 4 + 2 + z_planes + 4
        out[name] = bound((4.0 * 8 + 16.0) * 256 * M_TRAIN,
                          M_TRAIN * (planes * 256 * 2 + 4 * 4), bf)
    return out


# ---- phases 9-12: the NeRF and NeuS configurations
M_NERF_FINE = 1024 * 194  # rows of a NeRF fine pass (1024 rays)
M_NERF_COARSE = 1024 * 65
M_NEUS = 1024 * (65 + 194)  # rows of a NeuS step (both passes, one network)
M_NEUS_1024 = 256 * (65 + 194)  # NeuS-1024's step (256 rays)
M_SDF_RAGGED = 20_011  # not a multiple of the 128-row tile
NERF_FANS = [60] + [316 if li == 5 else 256 for li in range(1, 8)]
NEUS_COL_FANS = [286] + [256] * 8
NEUS_COL_OUTS = [256] * 8 + [3]
SDF_FANS = [36] + [292 if li == 5 else 256 for li in range(1, 8)]
SDF_LAYOUT = tuple(li == 5 for li in range(8))
# phase 9's count of ReLU rows whose gE took the other side of f'(0) from
# the all-plain pass, with the FMA kernels that came before the tensor
# cores on the same inputs (measured by `python3 tc_accuracy.py --f32
# --tree <that tree>`, NVIDIA H100 80GB HBM3, 700 W)
FMA_ROWS_OFF_PLAIN_GE = {f"ReLU/{M_NEUS}": 0, f"ReLU/{M_SDF_RAGGED}": 0}
# the NeuS fine pass's rows (1024 rays x 194 samples), whose db the
# epilogues leave as one partial per 128-row tile, and the device time
# the parallel db sum may take there (its byte bound is ~0.5 us)
M_DB_ROWS = 1024 * 194
DB_SUM_MS_MAX = 0.015


def f32_bound(flops: float, nbytes: float) -> dict:
    """The bound of an f32 route on the 3xTF32 split, with the FMA units'
    bound beside it (``fma_bound_ms``)."""
    return {**bound(flops, nbytes, "tf32x3"),
            "fma_bound_ms": bound(flops, nbytes, "float32")["bound_ms"]}


def sdf_inputs(torch, dev, act: str, m: int):
    """Phase 9's inputs of the NeuS trunk, seeded by the case: e = PE(6)
    of uniform points, weights and biases uniform in +-1/sqrt(fan_in), and
    the cotangents ch [M, 256] and cg [M, E] of h and gE."""
    from neddf_tpu_torch.ops.pe import positional_encoding_mip

    gen = torch.Generator(device=dev).manual_seed(m + 7 * (act == "ReLU"))

    def uniform(shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0) * scale

    e = positional_encoding_mip(uniform((m, 3)), 6).contiguous()
    ws = [uniform((f, 256), f ** -0.5) for f in SDF_FANS]
    bs = [uniform((256,), f ** -0.5) for f in SDF_FANS]
    return e, ws, bs, uniform((m, 256)) * 0.01, uniform((m, e.shape[1])) * 0.01


def ge_rows_off_plain(fk, fp) -> int:
    """Rows whose gE from the kernel's forward ``fk`` leaves the all-plain
    pass's ``fp`` by more than 1e-4 of its largest magnitude."""
    return int(((fk[1] - fp[1]).abs().amax(dim=1) > 1e-4 * fp[1].abs().max()).sum().item())


def sweep_work(m: int, e_dim: int, layout) -> tuple:
    """(flops, bytes) of the NeuS sweep alone: q_l = p_l W_l^T over every
    row of W_l for l = L-1..1 and layer 0's e rows (2 M N fan_in each);
    the stash read once (z_0..z_{L-2} whole, z_{L-1}'s column 0), gE
    written, the weights read."""
    fans = [e_dim] + [256 + e_dim * s for s in layout[1:]]
    flops = 2.0 * m * 256 * sum(fans[1:]) + 2.0 * m * 256 * e_dim
    nbytes = 4.0 * (m * 256 * (len(fans) - 1) + m + m * e_dim + 256 * sum(fans))
    return flops, nbytes


def sweep_alone(torch, sk, mlp, sdf_grad, e, ws, bs, act: str, fk) -> dict:
    """The sweep (csrc/sdf_sweep.cuh) launched alone over the stash of the
    forward ``fk`` = sdf_mlp(...), against the plain sweep over the same
    stash (``channel0_sweep``), timed (CUDA events, 5 launches back to
    back), beside #7's trunk alone (the same f32 row-tile launch through
    mlp_seg) and the sweep's bound (operations); its gE equals the fused
    call's bit for bit."""
    from neddf_tpu_torch.kernels import _build
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dev, (m, e_dim) = e.device, e.shape
    split = [dm.SPLIT_HIDDEN_FIRST if s else 0 for s in SDF_LAYOUT]
    out, stream = torch.empty_like(fk[1]), _build.stream(dev)

    def sweep():
        sk.sweep_launch(dm._ACT_CODES[act], e_dim, ws, split, fk[2], out, stream)

    def plain():
        return sdf_grad.channel0_sweep(ws, SDF_LAYOUT, act, fk[2], e_dim)

    def trunk():
        return mlp.mlp_seg([e], ws, bs, SDF_LAYOUT, act, stash=True)

    before = sk.SWEEP_LAUNCHES["sweep"]
    sweep()
    torch.cuda.synchronize()
    if sk.SWEEP_LAUNCHES["sweep"] != before + 1 or not torch.equal(out, fk[1]):
        fail("[9] the sweep alone: not one launch, or gE off the fused call's")
    err, rel = rel_err(torch, out, plain())
    if rel > REL_TOL["float32"]:
        fail(f"[9] the sweep alone: rel err {rel:.3g} > {REL_TOL['float32']}")
    ms, plain_ms = time_pair(torch, sweep, plain, reps=3, inner=5)
    trunk_ms, _ = time_pair(torch, trunk, trunk, reps=3, inner=5)
    plan = sk.sweep_plan(256, e_dim, split, m)
    return {"max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "trunk_ms": trunk_ms, "library_ms": None, "w_l2_bytes": plan["w_l2_bytes"] *
            -(-m // 64), "plan": {k: plan[k] for k in ("consumers", "stages", "smem", "grid")},
            **bound(*sweep_work(m, e_dim, SDF_LAYOUT), "tf32x3")}


def phase_family_kernels(torch, card: str) -> dict:
    """Phase 9: the mlp_seg forward with [h, seg0] / 3-wide last layer
    and its backward, and the sdf_mlp forward and backward, against their
    plain versions at the NeRF and NeuS steps' shapes, with times."""
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {}

    def uniform(shape, scale=1.0):
        return (torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0) * scale

    def layers(fans, outs):
        ws = [uniform((f, o), f ** -0.5) for f, o in zip(fans, outs)]
        bs = [uniform((o,), f ** -0.5) for f, o in zip(fans, outs)]
        return ws, bs

    def check(route, key, pairs, tol):
        worst_abs, worst_rel = 0.0, 0.0
        for got, ref in pairs:
            if got.shape != ref.shape or not torch.isfinite(got.float()).all():
                fail(f"{route} {key}: shape {tuple(got.shape)} or non-finite output")
            a, r = rel_err(torch, got, ref)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        if worst_rel > tol:
            fail(f"{route} {key}: rel err {worst_rel:.3g} > {tol}")
        results.setdefault(route, {})[key] = {"max_abs_err": worst_abs, "rel_err": worst_rel}
        return results[route][key]

    def bitwise(route, key, first, again):
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            fail(f"{route} {key}: dW/db differ between two runs")

    def mlp_case(name, m, dtype_name, act):
        dtype = getattr(torch, dtype_name)
        if name == "nerf":
            widths, fans, outs = (60,), NERF_FANS, [256] * 8
            layout = tuple(li == 5 for li in range(8))
        else:
            widths, fans, outs = (3, 24, 3, 256), NEUS_COL_FANS, NEUS_COL_OUTS
            layout = (False,) * 9
        ws, bs = layers(fans, outs)
        ws = [w.to(dtype).contiguous() for w in ws]
        vs = [uniform((m, w)).to(dtype).contiguous() for w in widths]
        g = (uniform((m, outs[-1])) * 0.01).to(dtype)
        key = f"{name}/{m}/{dtype_name}" + ("" if act == "ReLU" else f"/{act}")
        fk = mlp.mlp_seg(vs, ws, bs, layout, act, stash=True)
        fp = mlp.mlp_seg_plain(vs, ws, bs, layout, act, stash=True)
        torch.cuda.synchronize()
        check("mlp_seg", key, [(fk[0], fp[0])] + list(zip(fk[1], fp[1])), REL_TOL[dtype_name])
        args = (vs, ws, layout, act, fp[1], g)
        bk = mlp.mlp_seg_bwd(*args)
        bp = mlp.mlp_seg_bwd_plain(*args)
        torch.cuda.synchronize()
        check("mlp_seg_bwd", key, list(zip(sum(bk, []), sum(bp, []))), BWD_REL_TOL[dtype_name])
        again = mlp.mlp_seg_bwd(*args)
        bitwise("mlp_seg_bwd", key, bk[1] + bk[2], again[1] + again[2])
        if m in (M_NERF_FINE, M_NEUS):
            ms, plain_ms = time_pair(torch, lambda: mlp.mlp_seg(vs, ws, bs, layout, act,
                                                                stash=True),
                                     lambda: mlp.mlp_seg_plain(vs, ws, bs, layout, act,
                                                               stash=True), reps=3)
            work = mlp_work(m, fans, outs, dtype_name, sum(widths), stash=True)
            results["mlp_seg"][key].update(
                ms=ms, plain_ms=plain_ms,
                **(f32_bound(*work) if dtype_name == "float32" else bound(*work, dtype_name)))
            ms, plain_ms = time_pair(torch, lambda: mlp.mlp_seg_bwd(*args),
                                     lambda: mlp.mlp_seg_bwd_plain(*args), reps=3)
            work = mlp_bwd_work(m, fans, outs, dtype_name, sum(widths))
            results["mlp_seg_bwd"][key].update(
                ms=ms, plain_ms=plain_ms,
                **(f32_bound(*work) if dtype_name == "float32" else bound(*work, dtype_name)))
        for route in ("mlp_seg", "mlp_seg_bwd"):
            log(f"[9] {route} {key}: {json.dumps(results[route][key])} | card: {card}")
        del fk, fp, bk, bp, again, args, vs, ws
        torch.cuda.empty_cache()

    # mlp_seg: the NeRF trunk ([h, seg0], ReLU, stash) and the NeuS colour trunk
    relu_cases = [("nerf", m, d) for m in (M_NERF_FINE, M_NERF_COARSE)
                  for d in ("bfloat16", "float32")] + [("neus_color", M_NEUS, "float32")]
    for name, m, dtype_name in relu_cases:
        mlp_case(name, m, dtype_name, "ReLU")

    # the parallel db sum at the NeuS fine pass: the epilogues' 1,552 tile
    # partials (128 rows each) of 256 columns, against the plain sum over
    # rows and torch's own (the library call), device times by the profiler
    from neddf_tpu_torch.kernels import dual_mlp as dm

    parts = uniform((-(-M_DB_ROWS // 128), 256))
    k = dm.Products(torch.float32, dev)
    first, again = k.sum_rows(parts), k.sum_rows(parts)
    ref = parts.double().sum(dim=0)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail("db sum: two runs differ")
    err = (first.double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if rel > REL_TOL["float32"]:
        fail(f"db sum: rel err {rel:.3g} > {REL_TOL['float32']}")
    ms = profile_calls(torch, lambda: k.sum_rows(parts))[1]
    plain_ms = profile_calls(torch, lambda: dm.sum_rows_plain(parts))[1]
    library_ms = profile_calls(torch, lambda: parts.sum(dim=0))[1]
    results["db_sum"] = {"rows": parts.shape[0], "max_abs_err": err, "rel_err": rel, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         **bound(0.0, 4.0 * (parts.numel() + 256), "float32")}
    log(f"[9] db sum of {parts.shape[0]} x 256 partials (the NeuS fine pass): "
        f"{1e3 * ms:.2f} us of device time (plain {1e3 * plain_ms:.2f}, torch.sum "
        f"{1e3 * library_ms:.2f}, bound {1e3 * results['db_sum']['bound_ms']:.2f} us), "
        f"rel err {rel:.2e}, bitwise equal across two runs | card: {card}")
    if ms > DB_SUM_MS_MAX:
        fail(f"db sum: {ms:.4f} ms of device time > {DB_SUM_MS_MAX}")
    del parts, first, again, ref

    # LeakyReLU (slope 0.01, f'(0) = 1) on both precisions of the product's
    # prologue and nt epilogue, inputs from their own seed
    gen.manual_seed(17)
    for name, m, dtype_name in (("nerf", M_NERF_COARSE, "bfloat16"),
                                ("neus_color", M_SDF_RAGGED, "float32")):
        mlp_case(name, m, dtype_name, "LeakyReLU")

    # sdf_mlp: the NeuS SDF trunk with its channel-0 gradient (f32)
    sdf_cases = [(act, m) for act in ("ReLU", "tanhExp") for m in (M_NEUS, M_SDF_RAGGED)]
    for act, m in sdf_cases + [("LeakyReLU", M_SDF_RAGGED)]:
        key = f"{act}/{m}/float32"
        e, ws, bs, ch, cg = sdf_inputs(torch, dev, act, m)
        fk = sk.sdf_mlp(e, ws, bs, SDF_LAYOUT, act, stash=True)
        fp = sdf_grad.sdf_trunk_with_grad(e, ws, bs, SDF_LAYOUT, act, stash=True)
        torch.cuda.synchronize()
        # gE depends on f'(z) (ReLU: a step): where a z lies within an f32
        # rounding of 0 the two passes may take different sides, so the
        # kernel's sweep is held to the plain sweep over its own z, and
        # the rows where it left the all-plain gE are counted
        ge_ref = sdf_grad.channel0_sweep(ws, SDF_LAYOUT, act, fk[2], e.shape[1])
        r = check("sdf_mlp", key, [(fk[0], fp[0]), (fk[1], ge_ref)]
                  + list(zip(fk[2], fp[2])), REL_TOL["float32"])
        r["rows_off_plain_ge"] = ge_rows_off_plain(fk, fp)
        r["rows_off_plain_ge_fma"] = FMA_ROWS_OFF_PLAIN_GE.get(f"{act}/{m}")
        args = (e, ws, SDF_LAYOUT, act, fp[2], ch, cg)
        bk = sk.sdf_mlp_bwd(*args)
        bp = sdf_grad.sdf_trunk_with_grad_vjp(*args)
        torch.cuda.synchronize()
        check("sdf_mlp_bwd", key, [(bk[0], bp[0])] + list(zip(bk[1] + bk[2], bp[1] + bp[2])),
              BWD_REL_TOL["float32"])
        again = sk.sdf_mlp_bwd(*args)
        bitwise("sdf_mlp_bwd", key, bk[1] + bk[2], again[1] + again[2])
        if m == M_NEUS and act == "ReLU":
            e_dim = SDF_FANS[0]
            trunk_flops, _ = mlp_work(m, SDF_FANS, [256] * 8, "float32", e_dim)
            weights = sum(f * 256 * 4 + 4 * 256 for f in SDF_FANS)
            ms, plain_ms = time_pair(
                torch, lambda: sk.sdf_mlp(e, ws, bs, SDF_LAYOUT, act, stash=True),
                lambda: sdf_grad.sdf_trunk_with_grad(e, ws, bs, SDF_LAYOUT, act, stash=True),
                reps=3)
            # trunk + sweep; e in, h, gE and the stash out
            fwd = (2 * trunk_flops, weights + m * 4 * (e_dim + 256 + e_dim + 8 * 256))
            results["sdf_mlp"][key].update(ms=ms, plain_ms=plain_ms,
                                           **f32_bound(*fwd))
            results["sdf_sweep"] = {key: sweep_alone(torch, sk, mlp, sdf_grad, e, ws, bs, act,
                                                     fk)}
            log(f"[9] sdf_sweep {key} (the sweep alone, beside #7's trunk): "
                f"{json.dumps(results['sdf_sweep'][key])} | card: {card}")
            ms, plain_ms = time_pair(torch, lambda: sk.sdf_mlp_bwd(*args),
                                     lambda: sdf_grad.sdf_trunk_with_grad_vjp(*args),
                                     reps=3)
            # the replayed sweep (hidden rows of layers 1..7), then four
            # products per layer; e, the stash, ch, cg in, de and dW/db out
            replay = 2.0 * m * 256 * 256 * 7
            bwd = (4 * trunk_flops + replay,
                   2 * weights + m * 4 * (e_dim + 8 * 256 + 256 + e_dim + e_dim))
            results["sdf_mlp_bwd"][key].update(ms=ms, plain_ms=plain_ms,
                                               **f32_bound(*bwd))
        for route in ("sdf_mlp", "sdf_mlp_bwd"):
            log(f"[9] {route} {key}: {json.dumps(results[route][key])} | card: {card}")
        if act == "ReLU":
            log(f"[9] sdf_mlp {key}: {r['rows_off_plain_ge']} rows whose gE took the other "
                f"side of f'(0) from the all-plain pass (the FMA kernel before the tensor "
                f"cores, same inputs: {r['rows_off_plain_ge_fma']})")
        del fk, fp, bk, bp, again, args, e
        torch.cuda.empty_cache()
    return results


def family_trainer(torch, family: str, extra=()):
    """The trainer of a family's configuration on the card, built from
    config/ as ``scripts/run.py`` composes it."""
    from neddf_tpu_torch import config as config_lib

    known = {**FAMILY_OVERRIDES, **WIDE_OVERRIDES, **TP_OVERRIDES, **TP_FAMILY_OVERRIDES,
             **DEEP_OVERRIDES}
    cfg = config_lib.compose(REPO / "config", overrides=[*known.get(family, []), *extra])
    cfg["dataset"]["dataset_dir"] = str(REPO / cfg["dataset"]["dataset_dir"])
    cfg["trainer"]["device"] = "cuda"
    return config_lib.instantiate(cfg["trainer"], global_config=cfg)


def hold_step(tag: str, got: dict, ref: dict, card: str,
              spread_what: str = "a 1e-7 camera shift") -> tuple:
    """Hold a step's loss, loss dict and gradient norms (``got``) to the
    JAX package's (``ref``): each number within JAX_STEP_TOL, or within
    SPREAD_FACTOR times its own spread (``ref["spread"]``, under
    ``spread_what``) where the function moves more. Returns (worst relative gap of the numbers held to
    JAX_STEP_TOL, {name: wider bar})."""
    pairs = [(k, got[k], ref[k], k) for k in ("loss", "mse")]
    pairs += [(f"loss {k}", got["losses"][k], v, f"loss {k}") for k, v in ref["losses"].items()]
    pairs += [(f"grad norm {k}", got["grad_norms"][k], v, k)
              for k, v in ref["grad_norms"].items()]
    worst, wider = 0.0, {}
    for name, value, want, spread_key in pairs:
        tol = max(JAX_STEP_TOL, SPREAD_FACTOR * ref["spread"][spread_key])
        if tol > JAX_STEP_TOL:
            wider[name] = tol
        rel = check_close(f"{tag} {name}", value, want, tol)
        if tol == JAX_STEP_TOL:
            worst = max(worst, rel)
    log(f"{tag} f32 step vs the JAX package: loss {got['loss']:.8g} (JAX "
        f"{ref['loss']:.8g}), worst relative gap {worst:.3g} over the "
        f"{len(pairs) - len(wider)} of {len(pairs)} numbers held to {JAX_STEP_TOL}; "
        f"{len(wider)} held to {SPREAD_FACTOR:g}x their spread under {spread_what} "
        f"{json.dumps({k: round(v, 5) for k, v in wider.items()})} | card: {card}")
    return worst, wider


# the configurations whose network has a compute_dtype (bf16 by default)
F32_STEP_OVERRIDE = {"nerf": ["network.compute_dtype=float32"],
                     "neddf_wide": ["network.compute_dtype=float32"],
                     "neddf_1024": ["network.compute_dtype=float32"],
                     "nerf_1024": ["network.compute_dtype=float32"],
                     "neddf_deep": ["network.compute_dtype=float32"],
                     "nerf_deep": ["network.compute_dtype=float32"]}


def phase_family_step(torch, card: str, configs=None, refs=None, batch: int = FAMILY_BATCH,
                      tag: str = "10") -> dict:
    """Phase 10: one full-width f32 step of each family from the seeded
    parameters, against the JAX package's numbers on the CPU (``configs``
    and ``refs``: FAMILY_OVERRIDES and FAMILY_STEP by default; phase 22
    passes WIDE_OVERRIDES and WIDE_STEP)."""
    configs = FAMILY_OVERRIDES if configs is None else configs
    refs = FAMILY_STEP if refs is None else refs
    out = {}
    for family in configs:
        extra = F32_STEP_OVERRIDE.get(family, [])
        trainer = family_trainer(torch, family, [*extra, "trainer.optimize_camera=true"])
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=FAMILY_DRAW_SEED, batch=batch)
        us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
        loss, loss_dict, mse = trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(),
                                                  u_strat, u_pdf)
        got = {"loss": loss.item(), "mse": mse.item(),
               "losses": {k: v.item() for k, v in loss_dict.items()},
               "grad_norms": {n: p.grad.norm().item() for n, p in render.named_parameters()}}
        ref = refs[family]
        worst, wider = hold_step(f"[{tag}] {family}", got, ref, card)
        # the pose-delta gradient (optimize_camera): the kernels' input
        # cotangents through the position encoding into the rays
        cam_bar = max(JAX_STEP_TOL, SPREAD_FACTOR * ref["camera_grad_spread"])
        cam_rel = camera_grad_check(torch, f"[{tag}] {family} camera",
                                    trainer.camera_deltas.grad, ref["camera_grad"], cam_bar,
                                    FAMILY_CAMERA)
        log(f"[{tag}] {family} camera {FAMILY_CAMERA}'s pose-delta gradient vs the JAX package: "
            f"relative {cam_rel:.3g} of its norm (bar {cam_bar:.3g}); every other row 0")
        out[family] = {"got": got, "worst_rel_vs_jax": worst, "wider_bars": wider,
                       "camera_grad_rel_vs_jax": cam_rel,
                       "camera_grad": trainer.camera_deltas.grad[FAMILY_CAMERA].tolist()}
        del trainer, render
        torch.cuda.empty_cache()
    return out


FAMILY_RUN_KERNELS = {"nerf": ("mlp_seg", "mlp_seg_bwd"),
                      "neus": ("sdf_mlp", "sdf_mlp_bwd", "mlp_seg", "mlp_seg_bwd")}
# the route of every product and tile forward of each configuration's run:
# NeRF trains in bf16 ("tc"), NeuS in f32 (the 3xTF32 split)
FAMILY_ROUTES = {"nerf": "tc", "neus": "tf32x3"}


def expected_folding(family: str, launches: dict, dual_layers=None, act: str = "ReLU") -> dict:
    """The elementwise launches and the products with an activation folded
    in that a family's run must show, from its backward calls: per
    mlp_seg_bwd of L layers one gpre (the top layer), L - 1 nt epilogues,
    L - 1 tn prologues and L db sums; per sdf_mlp_bwd (8 layers, ReLU) one
    sdf_top and one gpre (the top of the replay and of the trunk), 7 + 7 +
    7 epilogues (replay, adjoint, trunk; the top adjoint is zero under
    ReLU), 7 prologues and 8 db sums; no gstack or dual_act (NeDDF's).
    NeDDF (``dual_layers``: the layers of its K=3 and K=1 trunks), whose
    dual_mlp_seg_bwd calls come in pairs (one per trunk and pass): per
    call of L layers L - 1 nt epilogues (the stacked cotangent of the
    layer below), L - 1 tn prologues (the layer input) and L - 1 db sums
    below the top layer; the colour trunk's top layer one gstack and one
    db sum; the K=3 trunk's top layer none (the epilogue backward's top
    mode forms its stacked cotangent and sums its db); no dual_act. Where
    f'' is not zero (``act`` tanhExp, Softplus, Sigmoid) each sdf_mlp_bwd
    also runs the sweep's top adjoint: one more epilogue."""
    from neddf_tpu_torch.ops.activations import SECOND_DERIVATIVE_ZERO

    if family == "neddf":
        pairs = launches["dual_mlp_seg_bwd"] / 2
        layers = sum(dual_layers)
        return {"passes": {"gpre": 0, "sdf_top": 0, "gstack": pairs, "dual_act": 0,
                           "db_sum": pairs * (layers - 1)},
                "folded": {"prologue": pairs * (layers - 2), "epilogue": pairs * (layers - 2)}}
    col = launches["mlp_seg_bwd"]
    layers = len(NERF_FANS) if family == "nerf" else len(NEUS_COL_FANS)
    sdf = launches.get("sdf_mlp_bwd", 0)
    n_sdf = len(SDF_FANS)
    return {"passes": {"gpre": col + sdf, "sdf_top": sdf, "gstack": 0, "dual_act": 0,
                       "db_sum": col * layers + sdf * n_sdf},
            "folded": {"prologue": col * (layers - 1) + sdf * (n_sdf - 1),
                       "epilogue": col * (layers - 1) + sdf * (3 * (n_sdf - 1) + (
                           act not in SECOND_DERIVATIVE_ZERO))}}


# run_eval at downsampling 8, kernels vs plain versions: PSNR gap (dB)
EVAL_PSNR_GAP_DB = 0.05


def phase_family_runs(torch, card: str, runs=None, tags=("11", "12")) -> dict:
    """Phases 11 and 12: a 300-step run of each configuration through
    ``scripts/run.py``, then a ``run_eval`` render of its run dir through
    the kernels and through the plain versions. ``runs``: {name:
    {overrides, train (the kernels its run launches), eval (those its
    render launches), route, kind (the family, for expected_folding)}},
    NeRF's and NeuS's shipped configurations by default; phase 23 passes
    WIDE_RUNS."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    if runs is None:
        runs = {f: {"overrides": FAMILY_OVERRIDES[f], "train": needed,
                    "eval": tuple(k for k in needed if not k.endswith("_bwd")),
                    "route": FAMILY_ROUTES[f], "kind": f}
                for f, needed in FAMILY_RUN_KERNELS.items()}
    kernels, plains = path_counters()
    t_run, t_eval = tags
    out = {}
    for family, spec in runs.items():
        needed = spec["train"]
        reset_path_counts()
        torch.cuda.reset_peak_memory_stats()
        run_dir = OUT / f"train_{family}"
        start = time.perf_counter()
        trainer = run_main_path(torch, run_dir, [*spec["overrides"],
                                                 f"trainer.epoch_save_model={TRAIN_EPOCHS}"])
        wall = time.perf_counter() - start
        launches = {k: kernels[k].launches for k in needed}
        routes = route_counts(dm)
        plain_calls = sum(fn.calls for fn in plains)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{t_run}] {family} run: {trainer.iteration} steps in {wall:.1f} s (load, hooks and "
            f"checkpoints included), peak device memory {peak_gib:.2f} GiB; launches "
            f"{launches}; routes {routes}; plain calls {plain_calls}")
        if min(launches.values()) < 1 or plain_calls:
            fail(f"the {family} run did not go through every kernel alone")
        check_routes(f"the {family} run", routes, spec["route"])
        net = trainer.neural_render.network_fine
        dual_layers = ((len(net.layers_ddf), len(net.layers_col))
                       if spec["kind"] == "neddf" else None)
        expected = expected_folding(spec["kind"], launches, dual_layers, net.activation_type)
        got = {"passes": routes["passes"], "folded": routes["folded"]}
        log(f"[{t_run}] {family} run: elementwise launches {routes['passes']} and products with "
            f"an activation folded in {routes['folded']} (expected {expected}); no launch of "
            f"{', '.join(REMOVED_PASSES)} (not in the library)")
        if got != expected:
            fail(f"the {family} run's elementwise launches {got}, expected {expected}")
        hist = trainer.history
        if len(hist) != 100 * (TRAIN_EPOCHS + 1):
            fail(f"{family}: {len(hist)} logged steps")
        if not all(math.isfinite(r["loss"]) and all(math.isfinite(v)
                                                    for v in r["losses"].values())
                   for r in hist):
            fail(f"{family}: a non-finite loss")
        first, last = mean([r["psnr"] for r in hist[:50]]), mean([r["psnr"] for r in hist[-50:]])
        log(f"[{t_run}] {family} train PSNR: first 50 steps {first:.3f} dB, last 50 {last:.3f} "
            f"dB (gain bar {PSNR_GAIN_MIN} dB); loss {mean([r['loss'] for r in hist[:50]]):.5f} "
            f"-> {mean([r['loss'] for r in hist[-50:]]):.5f}")
        if not last - first >= PSNR_GAIN_MIN:
            fail(f"{family}: train PSNR did not rise")
        steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
        ms_step = 1000.0 * mean(steady)
        rays_s = trainer.batch_size / mean(steady)
        dtype = str(net.compute_dtype).replace("torch.", "") \
            if hasattr(net, "compute_dtype") else "float32"
        log(f"[{t_run}] {family}: {ms_step:.2f} ms/step, {rays_s:.0f} rays/s (steps 100-199, "
            f"{dtype}, {trainer.batch_size} rays) | card: {card}")
        prof = profile_train(torch, trainer, card, f"profile_train_{family}.txt",
                             f"{trainer.batch_size} rays, {dtype}", t_run)
        del trainer, net
        torch.cuda.empty_cache()

        # phase 12: run_eval of the run dir, kernels then plain versions
        reset_path_counts()
        ev = evaluate(run_dir, TRAIN_EPOCHS, cameras=[0], downsampling=8)
        eval_launches = {k: kernels[k].launches for k in spec["eval"]}
        gt = ev.dataset[0]["rgb_images"].astype("uint8")[::8, ::8]
        psnrs = {}
        for mode in ("kernels", "plain"):
            nets = [ev.neural_render.network_fine]
            if ev.neural_render.use_coarse_network:
                nets.append(ev.neural_render.network_coarse)
            for n in nets:
                n.fused = "auto" if mode == "kernels" else "off"
            ev.generator.manual_seed(ev.seed)
            rgb = ev.render_test(run_dir / f"eval_{mode}", 0, 8)
            psnrs[mode] = peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])
        gap = abs(psnrs["kernels"] - psnrs["plain"])
        log(f"[{t_eval}] {family} run_eval cam 0 at downsampling 8: {psnrs['kernels']:.4f} dB "
            f"through the kernels (launches {eval_launches}), {psnrs['plain']:.4f} dB through "
            f"the plain versions, gap {gap:.4f} dB (bar {EVAL_PSNR_GAP_DB})")
        if min(eval_launches.values()) < 1 or not gap <= EVAL_PSNR_GAP_DB:
            fail(f"{family}: run_eval through the kernels and the plain versions disagree")
        del ev
        torch.cuda.empty_cache()
        out[family] = {"launches": launches, "routes": routes, "plain_calls": plain_calls,
                       "wall_s": wall,
                       "ms_per_step": ms_step, "rays_per_s": rays_s,
                       "busy_share": prof["busy_share"],
                       "device_ms_per_step": prof["device_ms_per_step"],
                       "peak_memory_gib": peak_gib, "psnr_first50": first, "psnr_last50": last,
                       "eval_psnr": psnrs, "eval_launches": eval_launches,
                       "loss_curve": [r["loss"] for r in hist],
                       "psnr_curve": [r["psnr"] for r in hist]}
    return out



# phase 11b: configurations beside the shipped ones, on a small batch of
# points (rays x samples): every field with LeakyReLU, and NeDDF at width
# 128, at fused="auto" launches its kernels, forward and backward, and a
# configuration the kernels do not take (an activation that neither the
# fused kernels nor the per-layer route have; the route takes any width
# and depth) makes them raise on the card (no plain version runs there)
OTHER_BATCH = (64, 32)
OTHER_TAKEN = {"ddf_layer_width": 128}
OTHER_REFUSED = {"activation_type": "GELU"}


def phase_other_configs(torch, card: str) -> dict:
    """Phase 11b: NeDDF, NeRF and NeuS with ``activation_type=LeakyReLU``,
    and NeDDF at ``OTHER_TAKEN``, through their kernels at ``fused="auto"``
    (every output and gradient finite, each kernel of the field launched;
    the gaps to ``fused="off"`` printed, the kernels themselves are held to
    their plain versions in phases 6, 9 and 21), and NeDDF at
    ``OTHER_REFUSED``: NotImplementedError."""
    from neddf_tpu_torch.fields.neddf import NeDDF
    from neddf_tpu_torch.fields.nerf import NeRF
    from neddf_tpu_torch.fields.neus import NeuS
    from neddf_tpu_torch.geometry.rays import Sampling
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    pos = torch.rand(OTHER_BATCH + (3,), generator=gen, device=dev) - 0.5
    dirs = torch.randn(OTHER_BATCH + (3,), generator=gen, device=dev)
    sampling = Sampling(pos, dirs / dirs.norm(dim=-1, keepdim=True), torch.zeros_like(pos))
    from neddf_tpu_torch.kernels import neddf_epilogue as epi

    field_kernels = {NeDDF: (dm.dual_mlp_trunk, dm.dual_mlp_seg, dm.dual_mlp_seg_bwd,
                             epi.neddf_epilogue, epi.neddf_epilogue_gstack),
                     NeRF: (mlp.mlp_seg, mlp.mlp_seg_bwd),
                     NeuS: (sk.sdf_mlp, sk.sdf_mlp_bwd, mlp.mlp_seg, mlp.mlp_seg_bwd)}
    out = {}
    cases = [(field.__name__, field, {"activation_type": "LeakyReLU"}, kernels)
             for field, kernels in field_kernels.items()]
    cases.append((f"NeDDF {OTHER_TAKEN}", NeDDF, OTHER_TAKEN, field_kernels[NeDDF]))
    for label, field, kwargs, kernels in cases:
        torch.manual_seed(0)
        net = field(**kwargs).to(dev)
        runs = {}
        for fused in ("auto", "off"):
            net.fused = fused
            net.zero_grad(set_to_none=True)
            for fn in kernels:
                fn.launches = 0
            res = net(sampling, net.schedule(0), need_aux=True)
            sum(v.float().mean() for v in res.values()).backward()
            torch.cuda.synchronize()
            runs[fused] = ({k: v.detach().float() for k, v in res.items()},
                           {k: p.grad.detach().clone() for k, p in net.named_parameters()
                            if p.grad is not None},
                           {fn.__name__: fn.launches for fn in kernels})
        (ko, kg, launched), (po, pg, _) = runs["auto"], runs["off"]
        finite = all(torch.isfinite(t).all().item() for t in [*ko.values(), *kg.values()])
        gaps = {"outputs": max(rel_err(torch, ko[k], po[k])[1] for k in ko),
                "grads": max(rel_err(torch, kg[k], pg[k])[1] for k in kg)}
        out[label] = {"launches": launched, "finite": finite, "rel_gap_to_off": gaps}
        log(f"[11b] {label} {kwargs} at fused='auto': launches {launched}, finite "
            f"{finite}, largest relative gap to fused='off' {json.dumps(gaps)} | card: {card}")
        if not finite or min(launched.values()) < 1:
            fail(f"phase 11b: {label} {kwargs} did not run through its kernels")
        del net, runs
    net = NeDDF(**OTHER_REFUSED).to(dev)
    try:
        net(sampling, net.schedule(0), need_aux=True)
        fail(f"phase 11b: NeDDF {OTHER_REFUSED} ran on the card; its kernels do not take it")
    except NotImplementedError as err:
        out["refused"] = {"config": OTHER_REFUSED, "error": str(err)}
        log(f"[11b] NeDDF {OTHER_REFUSED} at fused='auto' on the card: NotImplementedError "
            f"({err})")
    del net
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- phases 21-23
# phase 21: each kernel against its plain version beside the shipped width
# and activations, on the same inputs, at ragged rows: the (width,
# activation) cases of GRID_CASES, each through every route (the K=3 trunk
# forward with its stash, the epilogue forward, its top mode, the dual
# backward from it, the K=1 colour trunk forward and backward, mlp_seg
# with a post-skip layer and a 3-wide last layer, forward and backward,
# and sdf_mlp in f32), bf16 and f32. Widths 96 and 200 and the odd 45 run
# on a padded class; the density takes another activation in each case.
GRID_M = 33_287
GRID_CASES = ([(w, a) for w in (64, 96, 128, 200, 512) for a in ("Softplus", "Sigmoid", "tanhExp")]
              + [(w, a) for w in (96, 200, 512) for a in ("ReLU", "LeakyReLU")]
              + [(256, "Softplus"), (256, "Sigmoid"), (45, "Sigmoid")])
GRID_DENSITY = {"Softplus": "LeakyReLU", "Sigmoid": "Softplus", "tanhExp": "Sigmoid",
                "ReLU": "ReLU", "LeakyReLU": "Softplus"}
# phases 6/9's bars: f32 1e-4 (mlp_seg 1e-5), bf16 2^-5
GRID_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
GRID_TRUNK_LAYOUT = tuple(li == 5 for li in range(7))  # NeDDF's trunk: [embed, h] at layer 5
GRID_MLP_LAYOUT = (False, False, True, False, False)  # [h, seg0] at layer 2
GRID_SDF_LAYOUT = tuple(li == 5 for li in range(8))
# Under ReLU and LeakyReLU (f' a step at 0) a pre-activation within a
# rounding of 0 may take the other side of the kink in the kernel than in
# the plain pass (two f32 summation orders), and the tangent planes and
# NeuS's gE carry the step: the forwards are then held as phase 6 holds
# them, each layer against the plain layer over the kernel's own stash of
# the layer below, gE against the plain sweep over the kernel's stash, and
# a direct disagreement over the bar must sit in a row where such a flip
# happened (logged: the layer, |z| of the plain pass there, the error)


def grid_geo(width: int) -> dict:
    """Phase 21's networks at one width: the K=3 trunk (layout, embedding
    width), the K=1 colour trunk (segment widths, layers), mlp_seg
    (segments, fan-ins, outputs, layout), sdf_mlp (layout, embedding)."""
    return {"trunk": (GRID_TRUNK_LAYOUT, 60), "color": ((60, 24, 3, width), 3),
            "mlp": ((60,), [60, width, width + 60, width, width], [width] * 4 + [3],
                    GRID_MLP_LAYOUT),
            "sdf": (GRID_SDF_LAYOUT, 39)}


def path_geo(path: str, width: int) -> dict:
    """The networks of WIDE_OVERRIDES' configurations as the fields build
    them: NeDDF (fields/neddf.py: an 8-layer trunk with [embed, h] at layer
    5 on the 60-wide PE, 4 colour layers on [PE, PE(dir), normal,
    features], the eval colour by mlp_seg over them) and NeuS
    (fields/neus.py: an 8-layer sdf trunk with [h, e] at layer 5 on the
    36-wide PE, 9 colour layers on [pos, PE(dir), gradient, features], the
    last 3 wide)."""
    if path == "neddf_wide":
        segs = (60, 24, 3, width)
        return {"trunk": (tuple(li == 5 for li in range(8)), 60), "color": (segs, 4),
                "mlp": (segs, [sum(segs)] + [width] * 3, [width] * 4, (False,) * 4)}
    segs = (3, 24, 3, width)
    return {"mlp": (segs, [sum(segs)] + [width] * 8, [width] * 8 + [3], (False,) * 9),
            "sdf": (tuple(li == 5 for li in range(8)), 36)}


def dual_replay(torch, vs, js, ws, bs, lay, act, hj, k, pres):
    """Each layer of a dual MLP in f32 over the kernel's own stash of the
    layer below (its input), rounded as the kernel stores it: [v, j, z_0,
    ...] to hold the kernel's outputs and stash against where f' has a
    kink."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    f, df, _ = dm.ACTIVATION_TRIPLES[act]
    dtype = vs[0].dtype
    x0 = torch.cat([dm._stack(v, j, k) for v, j in zip(vs, dm._seg_js(js, hj))],
                   dim=-1).float()
    zs = []
    for li, (wl, bl) in enumerate(zip(ws, bs)):
        h = x0 if li == 0 else dm._dual_act(pres[li - 1].float(), f, df).to(dtype).float()
        if li > 0 and lay[li]:
            h = torch.cat([x0[..., : vs[0].shape[1]], h], dim=-1)
        z = h @ wl.float()
        z[0] += bl
        zs.append(z.to(dtype))
    out = dm._dual_act(pres[-1].float(), f, df).to(dtype)
    return [out[0], out[1:]] + zs


def sdf_replay(torch, e, ws, bs, lay, act, zs):
    """sdf_mlp's trunk layer by layer over the kernel's own stash zs, and
    gE by the plain sweep over it: [h, gE, z_0, ...]."""
    from neddf_tpu_torch.ops import sdf_grad
    from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES

    f = ACTIVATION_TRIPLES[act][0]
    out = []
    for li, (wl, bl) in enumerate(zip(ws, bs)):
        h = e if li == 0 else f(zs[li - 1])
        if li > 0 and lay[li]:
            h = torch.cat([h, e], dim=-1)
        out.append(h @ wl + bl)
    return [f(zs[-1]), sdf_grad.channel0_sweep(ws, lay, act, zs, e.shape[1])] + out


def kink_flips(torch, got, ref, zk, zp) -> dict:
    """Where the largest |got - ref| of a forward output sits, and in that
    row (the value rows of the stashes zk, zp: the kernel's and the plain
    pass's) the first layer whose pre-activation lies on the other side
    of 0, with |z| of the plain pass there; and the flips per layer."""
    d = (got.float() - ref.float()).abs()
    idx = int(d.argmax())
    where = list(torch.unravel_index(torch.tensor(idx), d.shape))
    row = int(where[-2])
    value = [z[0] if z.dim() == 3 else z for z in zk], [z[0] if z.dim() == 3 else z for z in zp]
    out = {"err": float(d.max()), "at": [int(i) for i in where], "flips": [], "first_flip": None}
    for li, (a, b) in enumerate(zip(*value)):
        flip = (a.float() > 0) != (b.float() > 0)
        out["flips"].append(int(flip.sum()))
        in_row = flip[row].nonzero()
        if out["first_flip"] is None and len(in_row):
            c = int(in_row[0])
            scale = float(b.float().abs().max())
            out["first_flip"] = {"layer": li, "col": c, "z_plain": float(b[row, c]),
                                 "z_kernel": float(a[row, c]),
                                 "abs_z_plain_over_layer_max": abs(float(b[row, c])) / scale}
    return out


def grid_case(torch, dev, width: int, act: str, dtype, m: int, timed: bool, geo=None,
              sections=("dual", "color", "mlp", "sdf"), dens=None, seed=None) -> dict:
    """Phase 21 at one (width, activation, dtype, rows): every route of
    ``sections`` against its plain version on the same inputs, over the
    networks of ``geo`` (``grid_geo`` by default); {route: {max_abs_err,
    rel}} (and ms, plain_ms where ``timed``). Fails on a disagreement, a
    non-finite output, dW/db that differ over two runs, or a tangent-stash
    read that is not as f'' says. The tests' cuda cases call it too."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import neddf_epilogue as epi
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad
    from neddf_tpu_torch.ops.activations import SECOND_DERIVATIVE_ZERO

    name = str(dtype).replace("torch.", "")
    tol = GRID_TOL[name]
    dens = dens or GRID_DENSITY[act]
    geo = geo or grid_geo(width)
    kink = act in SECOND_DERIVATIVE_ZERO
    gen = torch.Generator(device=dev).manual_seed(
        width * 7 + len(act) if seed is None else seed)
    tag = f"width {width} {act} {name} M={m}"

    def rnd(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt).contiguous()

    def layers(fans, outs, dt):
        return ([rnd(f, o, scale=1.5 * f ** -0.5, dt=dt) for f, o in zip(fans, outs)],
                [rnd(o, scale=0.1) for o in outs])

    out = {}

    def hold(route, got, ref, bar=tol, direct=None):
        got, ref = list(got), list(ref)
        worst_abs = worst = 0.0
        for g, r in zip(got, ref):
            if not torch.isfinite(g).all():
                fail(f"[21] {route} {tag}: non-finite output")
            err, rel = rel_err(torch, g, r)
            worst_abs, worst = max(worst_abs, err), max(worst, rel)
        if worst > bar:
            fail(f"[21] {route} {tag}: rel err {worst:.3g} > {bar}")
        out[route] = {"max_abs_err": worst_abs, "rel": worst}
        if direct is not None:  # the kink: the kernel against the plain pass itself
            got_d, ref_d, zk, zp = direct
            rel_d = max(rel_err(torch, g, r)[1] for g, r in zip(got_d, ref_d))
            flips = kink_flips(torch, got_d[-1], ref_d[-1], zk, zp)
            out[route].update(direct_rel=rel_d, kink=flips)
            if rel_d > bar and flips["first_flip"] is None:
                fail(f"[21] {route} {tag}: rel err {rel_d:.3g} > {bar} against the plain pass "
                     f"with no pre-activation across the kink in its worst row")
            if rel_d > bar:
                log(f"[21] {route} {tag}: {rel_d:.3g} against the plain pass, a kink flip: "
                    f"{json.dumps(flips)}")

    def timing(route, fk, fp):
        # the epilogue's short launches ten back to back per reading: the
        # device's time without the host's between launches (the profiler,
        # after the smoke's earlier traces, missed some of their events)
        if timed:
            out[route]["ms"], out[route]["plain_ms"] = time_pair(
                torch, fk, fp, reps=3, inner=10 if route in DEVICE_TIMED else 1)

    if "dual" in sections:
        # the K=3 trunk and the epilogue, forward; the top mode; the dual backward
        lay, c0 = geo["trunk"]
        n_l = len(lay)
        fans = [c0] + [width + c0 if s else width for s in lay[1:]]
        w, b = layers(fans, [width] * n_l, dtype)
        v0, j0 = rnd(m, c0, dt=dtype), rnd(3, m, c0, scale=0.5, dt=dtype)
        vk, jk, pk = dm.dual_mlp_trunk(v0, j0, w, b, lay, act, stash=True)
        vp, jp, pp = dm.dual_mlp_seg_plain([v0], [j0], w, b, lay, act, (True,), 3, stash=True)
        if kink:
            hold("dual_mlp_trunk", [vk, jk, *pk],
                 dual_replay(torch, [v0], [j0], w, b, lay, act, (True,), 3, pk),
                 direct=([vk, jk], [vp, jp], pk, pp))
        else:
            hold("dual_mlp_trunk", [vk, jk, *pk], [vp, jp, *pp])
        timing("dual_mlp_trunk", lambda: dm.dual_mlp_trunk(v0, j0, w, b, lay, act, stash=True),
               lambda: dm.dual_mlp_seg_plain([v0], [j0], w, b, lay, act, (True,), 3,
                                             stash=True))
        del vk, jk, pk
        wd, wa = rnd(width, scale=2.0 * width ** -0.5), rnd(width, scale=2.0 * width ** -0.5)
        b2 = torch.tensor([0.3, -0.2], device=dev)
        scal = torch.tensor([0.001, 0.8, 1.5, 0.5, 1.0, 1.0, 1.0, 0.0], device=dev)
        head = (vp, jp, wd, wa, b2, scal)
        hold("neddf_epilogue", epi.neddf_epilogue(*head, dens),
             epi.neddf_epilogue_plain(*head, dens))
        timing("neddf_epilogue", lambda: epi.neddf_epilogue(*head, dens),
               lambda: epi.neddf_epilogue_plain(*head, dens))
        g_out = rnd(10, m)
        g_t, g_col = rnd(m, width, scale=0.1, dt=dtype), rnd(m, width, scale=0.1, dt=dtype)
        top_args = (*head, g_out, g_t, g_col, pp[-1], act, dens)
        top_k = epi.neddf_epilogue_gstack(*top_args)
        top_p = epi.neddf_epilogue_gstack_plain(*top_args)
        hold("neddf_epilogue_gstack", top_k, top_p)
        timing("neddf_epilogue_gstack", lambda: epi.neddf_epilogue_gstack(*top_args),
               lambda: epi.neddf_epilogue_gstack_plain(*top_args))
        nan_z = pp[-1].clone()
        nan_z[1:] = float("nan")
        read = not all(torch.isfinite(t).all().item() for t in epi.neddf_epilogue_gstack(
            *head, g_out, g_t, g_col, nan_z, act, dens))
        if read != (not kink):
            fail(f"[21] neddf_epilogue_gstack {act}: the tangent stash read {read}")
        out["tangent_stash_read"] = read
        bwd_args = ([v0], [j0], w, lay, act, (True,), pp, None, None)
        top = (top_p[0], top_p[4])
        bk = dm.dual_mlp_seg_bwd(*bwd_args, top=top)
        bp = dm.dual_mlp_seg_bwd_plain(*bwd_args, top=top)
        flat = lambda r: [*r[0], *r[1], *r[2], *r[3]]  # noqa: E731
        hold("dual_mlp_seg_bwd", flat(bk), flat(bp))
        if not all(torch.equal(x, y) for x, y in zip(flat(bk)[2:], flat(
                dm.dual_mlp_seg_bwd(*bwd_args, top=top))[2:])):
            fail(f"[21] dual_mlp_seg_bwd {tag}: dW/db not bitwise repeatable")
        timing("dual_mlp_seg_bwd", lambda: dm.dual_mlp_seg_bwd(*bwd_args, top=top),
               lambda: dm.dual_mlp_seg_bwd_plain(*bwd_args, top=top))
        del bk, bp, pp, top_k, top_p, nan_z, head, top_args, bwd_args, top, v0, j0

    if "color" in sections:
        # the K=1 colour trunk: four segments (PE(pos) with its tangent,
        # PE(dir), the normal, the trunk features with theirs)
        widths, n_c = geo["color"]
        has_j = (True, False, False, True)
        cw, cb = layers([sum(widths)] + [width] * (n_c - 1), [width] * n_c, dtype)
        vs = [rnd(m, s, dt=dtype) for s in widths]
        js = [rnd(1, m, s, dt=dtype) for s, h in zip(widths, has_j) if h]
        clay = (False,) * n_c
        ck = dm.dual_mlp_seg(vs, js, cw, cb, clay, act, has_j, 1, stash=True)
        cp = dm.dual_mlp_seg_plain(vs, js, cw, cb, clay, act, has_j, 1, stash=True)
        if kink:
            hold("dual_mlp_seg", [ck[0], ck[1], *ck[2]],
                 dual_replay(torch, vs, js, cw, cb, clay, act, has_j, 1, ck[2]),
                 direct=([ck[0], ck[1]], [cp[0], cp[1]], ck[2], cp[2]))
        else:
            hold("dual_mlp_seg", [ck[0], ck[1], *ck[2]], [cp[0], cp[1], *cp[2]])
        timing("dual_mlp_seg", lambda: dm.dual_mlp_seg(vs, js, cw, cb, clay, act, has_j, 1,
                                                       stash=True),
               lambda: dm.dual_mlp_seg_plain(vs, js, cw, cb, clay, act, has_j, 1, stash=True))
        gv, gj = rnd(m, width, scale=0.1, dt=dtype), rnd(1, m, width, scale=0.1, dt=dtype)
        cargs = (vs, js, cw, clay, act, has_j, cp[2], gv, gj)
        flat = lambda r: [*r[0], *r[1], *r[2], *r[3]]  # noqa: E731
        hold("dual_mlp_seg_bwd_color", flat(dm.dual_mlp_seg_bwd(*cargs)),
             flat(dm.dual_mlp_seg_bwd_plain(*cargs)))
        timing("dual_mlp_seg_bwd_color", lambda: dm.dual_mlp_seg_bwd(*cargs),
               lambda: dm.dual_mlp_seg_bwd_plain(*cargs))
        del ck, cp, cargs, vs, js

    if "mlp" in sections:
        # mlp_seg: its segments, a post-skip layer where the layout has one
        mwidths, mfans, mouts, mlay = geo["mlp"]
        mw, mb = layers(mfans, mouts, dtype)
        segs = [rnd(m, s, dt=dtype) for s in mwidths]
        mk, mpk = mlp.mlp_seg(segs, mw, mb, mlay, act, stash=True)
        mp, mpp = mlp.mlp_seg_plain(segs, mw, mb, mlay, act, stash=True)
        mtol = 1e-5 if name == "float32" else tol
        hold("mlp_seg", [mk, *mpk], [mp, *mpp], mtol)
        timing("mlp_seg", lambda: mlp.mlp_seg(segs, mw, mb, mlay, act, stash=True),
               lambda: mlp.mlp_seg_plain(segs, mw, mb, mlay, act, stash=True))
        g3 = rnd(m, mouts[-1], dt=dtype)
        margs = (segs, mw, mlay, act, mpp, g3)
        mbk = mlp.mlp_seg_bwd(*margs)
        hold("mlp_seg_bwd", [*mbk[0], *mbk[1], *mbk[2]],
             [t for part in mlp.mlp_seg_bwd_plain(*margs) for t in part], tol)
        again = mlp.mlp_seg_bwd(*margs)
        if not all(torch.equal(x, y) for x, y in zip([*mbk[1], *mbk[2]],
                                                     [*again[1], *again[2]])):
            fail(f"[21] mlp_seg_bwd {tag}: dW/db not bitwise repeatable")
        timing("mlp_seg_bwd", lambda: mlp.mlp_seg_bwd(*margs),
               lambda: mlp.mlp_seg_bwd_plain(*margs))
        del mk, mpk, mp, mpp, mbk, again, margs, segs

    if "sdf" in sections and dtype == torch.float32:  # NeuS runs its trunk in f32
        slay, e_dim = geo["sdf"]
        sfans = [e_dim] + [width + e_dim if s else width for s in slay[1:]]
        sw, sb = layers(sfans, [width] * len(sfans), torch.float32)
        e = rnd(m, e_dim)
        hk, gk, pk = sk.sdf_mlp(e, sw, sb, slay, act, stash=True)
        hp, gp, ps = sdf_grad.sdf_trunk_with_grad(e, sw, sb, slay, act, stash=True)
        if kink:
            hold("sdf_mlp", [hk, gk, *pk], sdf_replay(torch, e, sw, sb, slay, act, pk),
                 direct=([hk, gk], [hp, gp], pk, ps))
        else:
            hold("sdf_mlp", [hk, gk, *pk], [hp, gp, *ps])
        timing("sdf_mlp", lambda: sk.sdf_mlp(e, sw, sb, slay, act, stash=True),
               lambda: sdf_grad.sdf_trunk_with_grad(e, sw, sb, slay, act, stash=True))
        ch, cg = rnd(m, width, scale=0.1), rnd(m, e_dim, scale=0.1)
        sargs = (e, sw, slay, act, ps, ch, cg)
        sbk = sk.sdf_mlp_bwd(*sargs)
        de, dws, dbs = sdf_grad.sdf_trunk_with_grad_vjp(*sargs)
        hold("sdf_mlp_bwd", [sbk[0], *sbk[1], *sbk[2]], [de, *dws, *dbs])
        again = sk.sdf_mlp_bwd(*sargs)
        if not all(torch.equal(x, y) for x, y in zip([*sbk[1], *sbk[2]],
                                                     [*again[1], *again[2]])):
            fail(f"[21] sdf_mlp_bwd {tag}: dW/db not bitwise repeatable")
        timing("sdf_mlp_bwd", lambda: sk.sdf_mlp_bwd(*sargs),
               lambda: sdf_grad.sdf_trunk_with_grad_vjp(*sargs))
        del hk, gk, pk, hp, gp, ps, sbk, again, sargs
    return out


def grid_bounds(width: int, m: int, dtype_name: str, geo=None) -> dict:
    """Bounds of phase 21's routes at (width, m, operand type) over the
    networks of ``geo``: the products on the tensor cores (bf16, or f32 by
    the 3xTF32 split) or the bytes; sdf_mlp's in f32 (NeuS runs its trunk
    in f32)."""
    geo = geo or grid_geo(width)
    t = 2 if dtype_name == "bfloat16" else 4
    peak = "bfloat16" if dtype_name == "bfloat16" else "tf32x3"
    out = {}
    if "trunk" in geo:
        lay, c0 = geo["trunk"]
        fans = [c0] + [width + c0 if s else width for s in lay[1:]]
        outs = [width] * len(lay)
        out["dual_mlp_trunk"] = bound(*mlp_work(m, fans, outs, dtype_name, c0, streams=4,
                                                stash=True), peak)
        out["dual_mlp_seg_bwd"] = bound(*mlp_bwd_work(m, fans, outs, dtype_name, c0,
                                                      streams=4), peak)
        out["neddf_epilogue"] = bound(2.0 * 8 * width * m,
                                      m * (4 * width * t + 10 * 4 + width * t), peak)
        out["neddf_epilogue_gstack"] = bound((4.0 * 8 + 16.0) * width * m,
                                             m * ((4 + 2 + 4 + 4) * width * t + 4 * 4), peak)
    if "color" in geo:
        # the K=1 colour trunk: layer 0's tangent stream reads only the segments with tangents
        widths, n_c = geo["color"]
        cfans, couts = [sum(widths)] + [width] * (n_c - 1), [width] * n_c
        f, b = mlp_work(m, cfans, couts, dtype_name, sum(widths), streams=2, stash=True)
        out["dual_mlp_seg"] = bound(f - 2.0 * m * (widths[1] + widths[2]) * width, b, peak)
        out["dual_mlp_seg_bwd_color"] = bound(*mlp_bwd_work(m, cfans, couts, dtype_name,
                                                            sum(widths), streams=2), peak)
    if "mlp" in geo:
        mwidths, mfans, mouts, _ = geo["mlp"]
        out["mlp_seg"] = bound(*mlp_work(m, mfans, mouts, dtype_name, sum(mwidths),
                                         stash=True), peak)
        out["mlp_seg_bwd"] = bound(*mlp_bwd_work(m, mfans, mouts, dtype_name, sum(mwidths)),
                                   peak)
    if "sdf" in geo:
        slay, e_dim = geo["sdf"]
        sfans = [e_dim] + [width + e_dim if s else width for s in slay[1:]]
        # the trunk and the sweep (as many products again); the backward five times the trunk's
        f, b = mlp_work(m, sfans, [width] * len(sfans), "float32", e_dim, stash=True)
        out["sdf_mlp"] = bound(2.0 * f, b, "tf32x3")
        f, b = mlp_bwd_work(m, sfans, [width] * len(sfans), "float32", e_dim)
        out["sdf_mlp_bwd"] = bound(2.5 * f, b, "tf32x3")
    return out


# phase 21b: each path's kernels at the path's own networks and rows (the
# passes of its train step, and path (a)'s eval colour at run_eval's chunk
# of 1,024 rays), timed; the kernels line's path entries come from the
# first (the larger) rows of each
PATH_SHAPES = {
    "neddf_wide": {"width": 512, "act": "Softplus", "density": "LeakyReLU",
                   "dtype": "bfloat16",
                   "runs": ((512 * 194, ("dual", "color")), (512 * 65, ("dual", "color")),
                            (1024 * 194, ("mlp",)))},
    "neus_narrow": {"width": 128, "act": "Softplus", "dtype": "float32",
                    "runs": ((1024 * (65 + 194), ("mlp", "sdf")), (1024 * 65, ("mlp", "sdf")))},
}


def phase_widths_acts(torch, card: str) -> dict:
    """Phase 21: every kernel against its plain version over GRID_CASES, f32
    and bf16 (sdf_mlp f32 only), at GRID_M ragged rows; then (21b) each of
    PATH_SHAPES' paths at its own networks and rows, timed beside the
    bounds."""
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    out = {}
    for width, act in GRID_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            r = grid_case(torch, dev, width, act, dtype, GRID_M, False)
            out[f"{width}/{act}/{name}"] = r
            worst = max(v["rel"] for v in r.values() if isinstance(v, dict))
            log(f"[21] width {width} {act} (density {GRID_DENSITY[act]}) {name}: every route "
                f"within its bar, worst rel {worst:.3g}; tangent stash read "
                f"{r['tangent_stash_read']}")
            torch.cuda.empty_cache()
    out["paths"] = {}
    for path, spec in PATH_SHAPES.items():
        width, act = spec["width"], spec["act"]
        geo = path_geo(path, width)
        dtype = getattr(torch, spec["dtype"])
        for m, sections in spec["runs"]:
            r = grid_case(torch, dev, width, act, dtype, m, True, geo, sections,
                          spec.get("density", "ReLU"), seed=m)
            bounds = grid_bounds(width, m, spec["dtype"], geo)
            for route, v in r.items():
                if isinstance(v, dict) and route in bounds:
                    v.update(bounds[route])
            out["paths"][f"{path}/{m}"] = r
            log(f"[21b] {path} at its own shapes, M={m} ({spec['dtype']}): " + json.dumps(
                {k: [round(v["rel"], 6), round(v["ms"], 4), round(v["plain_ms"], 4),
                     round(v["bound_ms"], 4)] for k, v in r.items()
                 if isinstance(v, dict) and "ms" in v})
                + f" (rel, ms, plain ms, bound ms) | card: {card}")
            torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - start
    log(f"[21] {len(GRID_CASES)} (width, activation) cases x f32 and bf16 through every "
        f"route and the paths' shapes in {out['wall_s']:.1f} s")
    return out


# phase 22: the full-width f32 step of WIDE_OVERRIDES' configurations against
# the JAX package (WIDE_STEP), as phase 10 (phase_family_step)
def phase_wide_step(torch, card: str) -> dict:
    return phase_family_step(torch, card, WIDE_OVERRIDES, WIDE_STEP, WIDE_BATCH, "22")


# phase 23: their 300-step runs through scripts/run.py and run_eval of
# their run dirs, as phases 11 and 12 (phase_family_runs)
WIDE_RUNS = {
    "neddf_wide": {"train": ("dual_mlp_trunk", "dual_mlp_seg", "dual_mlp_seg_bwd",
                             "neddf_epilogue", "neddf_epilogue_gstack"),
                   "eval": ("dual_mlp_trunk", "mlp_seg"), "route": "tc", "kind": "neddf",
                   "tag": "(a)"},
    "neus_narrow": {"train": ("sdf_mlp", "sdf_mlp_bwd", "mlp_seg", "mlp_seg_bwd"),
                    "eval": ("sdf_mlp", "mlp_seg"), "route": "tf32x3", "kind": "neus",
                    "tag": "(b)"},
}


def phase_wide_runs(torch, card: str) -> dict:
    return phase_family_runs(torch, card, {
        name: {**spec, "overrides": WIDE_OVERRIDES[name]} for name, spec in WIDE_RUNS.items()},
        ("23", "23b"))


# the kernels line's "source" and "replaces" of each wrapper's kernel: the
# file that holds its body, and the Pallas call it takes the place of
KERNEL_SOURCES = {
    "dual_mlp_trunk": ("neddf_tpu_torch/csrc/tile_hopper.cuh",
                      "neddf_tpu/kernels/dual_mlp.py:635"),
    "dual_mlp_seg": ("neddf_tpu_torch/csrc/tile_hopper.cuh",
                    "neddf_tpu/kernels/dual_mlp.py:635"),
    "dual_mlp_seg_bwd": ("neddf_tpu_torch/csrc/dual_mlp_bwd.cu",
                         "neddf_tpu/kernels/dual_mlp.py:935"),
    "neddf_epilogue": ("neddf_tpu_torch/csrc/neddf_epilogue.cu",
                       "neddf_tpu/kernels/neddf_epilogue.py:329"),
    "neddf_epilogue_bwd": ("neddf_tpu_torch/csrc/neddf_epilogue.cu",
                           "neddf_tpu/kernels/neddf_epilogue.py:365"),
    "neddf_epilogue_gstack": ("neddf_tpu_torch/csrc/neddf_epilogue.cu",
                              "neddf_tpu/kernels/neddf_epilogue.py:365"),
    "mlp_seg": ("neddf_tpu_torch/csrc/tile_hopper.cuh",
               "neddf_tpu/kernels/mlp.py:192"),
    "mlp_seg_bwd": ("neddf_tpu_torch/csrc/mlp_bwd.cu", "neddf_tpu/kernels/mlp.py:248"),
    "sdf_mlp": ("neddf_tpu_torch/csrc/tile_hopper.cuh",
               "neddf_tpu/kernels/sdf_mlp.py:257"),
    "sdf_mlp_bwd": ("neddf_tpu_torch/csrc/sdf_mlp.cu", "neddf_tpu/kernels/sdf_mlp.py:304"),
}


# ---------------------------------------------------------- phases 14-17
# the kernels that a configuration's training path launches (by the names
# of their wrappers' counters) and the plain versions it must not call
PATH_KERNELS = {"neddf": ("dual_mlp_trunk", "dual_mlp_seg", "dual_mlp_seg_bwd",
                          "neddf_epilogue", "neddf_epilogue_gstack"),
                "nerf": ("mlp_seg", "mlp_seg_bwd"),
                "neus": ("sdf_mlp", "sdf_mlp_bwd", "mlp_seg", "mlp_seg_bwd")}
# rays of the phase-15b and phase-16 steps: the default config's batch
CAMERA_BATCH = 512
# phase 14: run B's first checkpoint must land within this many seconds
RESUME_CHILD_TIMEOUT = 300.0
# phase 16, f32: grad_accum 2 and 4 against 1, relative (the microbatches'
# sums in another order)
ACCUM_F32_TOL = 1e-5


def cache_datasets() -> None:
    """Decode each dataset split once in this process: a later trainer of
    the same split takes the first one's host arrays (phase 8's decode of
    bunny_smoke serves every later phase in this process; phase 14's run
    B, a subprocess, decodes its own). Each trainer copies them to the
    card."""
    from neddf_tpu_torch.data.nerf_synthetic import NeRFSyntheticDataset

    load = NeRFSyntheticDataset.load_data
    cache = {}

    def load_once(self):
        key = (str(self.dataset_dir.resolve()), self.data_split, self.use_mask)
        if key not in cache:
            load(self)
            cache[key] = (self.camera_calib_params, self.camera_params, self.rgb_images,
                          self.mask_images)
        (self.camera_calib_params, self.camera_params, self.rgb_images,
         self.mask_images) = cache[key]

    NeRFSyntheticDataset.load_data = load_once


def path_counters():
    """({wrapper name: kernel wrapper}, [plain versions]) of every family's
    training path."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import neddf_epilogue as epi
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad

    kernels = {"dual_mlp_trunk": dm.dual_mlp_trunk, "mlp_seg": mlp.mlp_seg,
               "dual_mlp_seg": dm.dual_mlp_seg, "dual_mlp_seg_bwd": dm.dual_mlp_seg_bwd,
               "neddf_epilogue": epi.neddf_epilogue,
               "neddf_epilogue_gstack": epi.neddf_epilogue_gstack,
               "mlp_seg_bwd": mlp.mlp_seg_bwd, "sdf_mlp": sk.sdf_mlp,
               "sdf_mlp_bwd": sk.sdf_mlp_bwd,
               # the per-layer route (phase 24): its calls that ran the kernels,
               # and the epilogue's standalone backward it takes
               "dual_mlp_layers": dm.dual_mlp_layers, "mlp_seg_layers": mlp.mlp_seg_layers,
               "neddf_epilogue_bwd": epi.neddf_epilogue_bwd,
               # NeRF's and NeuS's per-layer route (phase 25)
               "sdf_mlp_layers": sk.sdf_mlp_layers}
    plains = [dm.dual_mlp_trunk_plain, dm.dual_mlp_seg_plain, dm.dual_mlp_seg_bwd_plain,
              mlp.mlp_seg_plain, mlp.mlp_seg_bwd_plain, epi.neddf_epilogue_plain,
              epi.neddf_epilogue_bwd_plain, epi.neddf_epilogue_gstack_plain,
              sdf_grad.sdf_trunk_with_grad, sdf_grad.sdf_trunk_with_grad_vjp,
              dm.layer_fwd_plain, dm.route_product_plain]
    return kernels, plains


def reset_path_counts() -> None:
    """Every kernel wrapper's count, every plain version's calls and the
    route counts to 0 (just before a path is driven)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    kernels, plains = path_counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0
    reset_route_counts(dm)


def read_path_counts(what: str, needed) -> dict:
    """The counts just after a path was driven: every kernel of ``needed``
    launched, no plain version called."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    kernels, plains = path_counters()
    launches = {k: fn.launches for k, fn in kernels.items() if fn.launches or k in needed}
    plain_calls = sum(fn.calls for fn in plains)
    if min(launches[k] for k in needed) < 1 or plain_calls:
        fail(f"{what}: launches {launches}, plain calls {plain_calls}; every kernel of "
             f"{needed} must launch and no plain version run")
    return {"launches": launches, "plain_calls": plain_calls, "routes": route_counts(dm)}


def start_run_b(run_dir: Path):
    """Phase 14's run B: the main path's run as a subprocess (a user's
    ``python -m neddf_tpu_torch.scripts.run``), in its own session so that
    the watchdog's ``_kill_child`` kills it by pid."""
    if run_dir.exists():
        shutil.rmtree(run_dir)
    OUT.mkdir(parents=True, exist_ok=True)
    out = open(OUT / "resume_run_b.log", "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "neddf_tpu_torch.scripts.run", f"trainer.epoch_max={TRAIN_EPOCHS}",
         f"hydra.run.dir={run_dir}"],
        cwd=REPO, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return child, out, time.perf_counter()


# phase 14 also runs these options through ``python -m
# neddf_tpu_torch.scripts.run --watchdog`` (one epoch, a subprocess)
WATCHDOG_OVERRIDES = ["trainer.epoch_max=0", "trainer.optimize_camera=true",
                      "trainer.grad_accum=2", "trainer.debug_nans=true",
                      "trainer.async_checkpoint=true"]
WATCHDOG_TIMEOUT = 600.0


def start_watchdog_run(run_dir: Path):
    """One epoch of the default config with ``WATCHDOG_OVERRIDES`` under
    ``--watchdog`` (the supervisor and its child are subprocesses)."""
    if run_dir.exists():
        shutil.rmtree(run_dir)
    out = open(OUT / "watchdog_run.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "neddf_tpu_torch.scripts.run", "--watchdog", "600",
         *WATCHDOG_OVERRIDES, f"hydra.run.dir={run_dir}"],
        cwd=REPO, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, out, time.perf_counter()


def stop_process(proc) -> None:
    """Stop a subprocess this script started: SIGINT first (a supervisor
    then kills its own child), then the watchdog's kill by pid."""
    import os
    import signal

    from neddf_tpu_torch.training.watchdog import _kill_child

    if proc.poll() is not None:
        return
    try:
        os.killpg(proc.pid, signal.SIGINT)
        proc.wait(timeout=30)
    except (ProcessLookupError, subprocess.TimeoutExpired):
        pass
    if proc.poll() is None:
        _kill_child(proc)


def finish_watchdog_run(torch, card: str, run) -> dict:
    """Phase 14b: the ``--watchdog`` run ends with exit code 0, one epoch
    of finite losses, its checkpoint (written by the async checkpointer)
    a full training state with moved camera deltas."""
    import numpy as np

    from neddf_tpu_torch.utils.msgpack import load_msgpack

    proc, out, t0 = run
    try:
        rc = proc.wait(timeout=max(1.0, WATCHDOG_TIMEOUT - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        stop_process(proc)
        fail(f"[14b] the --watchdog run did not end in {WATCHDOG_TIMEOUT} s")
    out.close()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"[14b] the --watchdog run exited with {rc} "
             "(chiprun_out/chip_smoke/watchdog_run.log)")
    run_dir = OUT / "train_watchdog"
    hist = [json.loads(x) for x in (run_dir / "train_log.jsonl").read_text().splitlines()]
    state = load_msgpack(run_dir / "models" / "model_00000.ckpt")
    deltas = np.asarray(state.get("camera_deltas", np.zeros(1)))
    ok = (len(hist) == 100 and all(math.isfinite(r["loss"]) for r in hist)
          and all(k in state for k in ("params", "opt_state", "opt_state_cam", "torch_rng"))
          and int(state["iteration"]) == 100 and np.isfinite(deltas).all()
          and (np.abs(deltas).sum(axis=1) > 0).all())
    log(f"[14b] python -m neddf_tpu_torch.scripts.run --watchdog 600 "
        f"{' '.join(WATCHDOG_OVERRIDES)}: exit {rc} after {wall:.1f} s, {len(hist)} steps "
        f"logged, loss {hist[0]['loss'] if hist else 'n/a'} -> "
        f"{hist[-1]['loss'] if hist else 'n/a'}; its async checkpoint holds the full state, "
        f"every camera row moved | card: {card}")
    if not ok:
        fail("[14b] the --watchdog run (chiprun_out/chip_smoke/watchdog_run.log)")
    return {"exit": rc, "wall_s": wall, "steps": len(hist)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, tree


def state_gaps(a: dict, b: dict) -> dict:
    """{leaf: max |a - b|} over the leaves of two checkpoint states that
    differ."""
    import numpy as np

    bl = dict(_leaves(b))
    gaps = {}
    for name, x in _leaves(a):
        y = bl[name]
        if isinstance(x, np.ndarray):
            if x.shape != y.shape or not np.array_equal(x, y):
                d = np.abs(x.astype(np.float64) - y.astype(np.float64)) if x.shape == y.shape \
                    else np.array([np.inf])
                gaps[name] = float(d.max())
        elif x != y:
            gaps[name] = float("inf")
    return gaps


def phase_resume(torch, card: str, run_b, a_state: dict, a_losses: list) -> dict:
    """Phase 14: run B is killed by pid once its epoch-0 checkpoint is on
    disk, continued in this process with ``scripts.run --resume``, and
    held to run A (phase 8's uninterrupted run): the whole training state
    and the per-step losses of epochs 1-2, bitwise."""
    import os

    from neddf_tpu_torch.scripts import run as run_script
    from neddf_tpu_torch.training.watchdog import _kill_child
    from neddf_tpu_torch.utils.msgpack import packb

    child, child_out, t0 = run_b
    b_dir = OUT / "train_resume"
    ckpt = b_dir / "models" / "model_00000.ckpt"
    while not ckpt.exists():
        if child.poll() is not None:
            child_out.close()
            fail(f"[14] run B exited with {child.returncode} before its first checkpoint "
                 f"(chiprun_out/chip_smoke/resume_run_b.log)")
        if time.perf_counter() - t0 > RESUME_CHILD_TIMEOUT:
            _kill_child(child)
            fail(f"[14] run B wrote no checkpoint in {RESUME_CHILD_TIMEOUT} s")
        time.sleep(0.1)
    waited = time.perf_counter() - t0
    _kill_child(child)
    child_out.close()
    logged = len((b_dir / "train_log.jsonl").read_text().splitlines())
    same_ckpt = ckpt.read_bytes() == (OUT / "train" / "models" / "model_00000.ckpt").read_bytes()
    log(f"[14] run B (a subprocess) wrote models/model_00000.ckpt {waited:.1f} s after its "
        f"start; killed by pid (watchdog._kill_child, exit {child.returncode}) with {logged} "
        f"steps logged; its checkpoint bytes equal run A's epoch-0 checkpoint: {same_ckpt}")
    if not same_ckpt:
        fail("[14] run B's epoch-0 checkpoint differs from run A's")
    reset_path_counts()
    cwd = os.getcwd()
    start = time.perf_counter()
    try:
        trainer = run_script.main(["--resume", str(b_dir)])
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = read_path_counts("[14] the resumed run", PATH_KERNELS["neddf"])
    b_state = trainer.checkpoint_state()
    b_losses = [r["loss"] for r in trainer.history]
    bitwise = packb(b_state) == packb(a_state) and b_losses == a_losses
    gaps = {} if bitwise else state_gaps(a_state, b_state)
    log(f"[14] resumed in process from iteration 100 to {trainer.iteration} ({wall:.1f} s, "
        f"{len(b_losses)} steps; launches {counts['launches']}, plain calls "
        f"{counts['plain_calls']}): params, Adam moments and counts, camera deltas, the "
        f"camera optimizer, iteration and the generator state bitwise equal to run A's: "
        f"{packb(b_state) == packb(a_state)}; the 200 losses of epochs 1-2 equal: "
        f"{b_losses == a_losses} | card: {card}")
    out = {"bitwise": bitwise, "child_wait_s": waited, "steps_logged_at_kill": logged,
           "resume_wall_s": wall, "counts": counts}
    del trainer
    torch.cuda.empty_cache()
    if bitwise:
        return out
    # not deterministic: hold B to A within the spread of a second
    # uninterrupted run A'
    a2 = run_main_path(torch, OUT / "train_a2")
    a2_state = a2.checkpoint_state()
    spread = state_gaps(a_state, a2_state)
    loss_spread = max(abs(x - y) for x, y in zip(a_losses, [r["loss"] for r in a2.history[100:300]]))
    loss_gap = max((abs(x - y) for x, y in zip(a_losses, b_losses)), default=float("inf"))
    out.update(gaps=gaps, spread=spread, loss_gap=loss_gap, loss_spread=loss_spread)
    log(f"[14] not bitwise: B - A per leaf {json.dumps(gaps)}; A' - A {json.dumps(spread)}; "
        f"losses {loss_gap:.3g} vs {loss_spread:.3g}")
    if len(b_losses) != len(a_losses) or loss_gap > loss_spread or any(
            g > spread.get(k, 0.0) for k, g in gaps.items() if k != "torch_rng.state"):
        fail("[14] the resumed run is farther from run A than a second uninterrupted run")
    del a2
    torch.cuda.empty_cache()
    return out


def camera_grad_check(torch, what: str, got, want, bar: float, cam: int) -> float:
    """One camera row's gradient against ``want`` (relative to its norm)
    and every other row exactly zero; returns the relative gap."""
    row = got[cam].double().cpu()
    want = torch.as_tensor(want, dtype=torch.float64)
    rel = ((row - want).norm() / want.norm().clamp_min(1e-30)).item()
    others = torch.cat([got[:cam], got[cam + 1:]]).abs().max().item()
    if not rel <= bar or others != 0.0:
        fail(f"{what}: camera gradient {row.tolist()} vs {want.tolist()}, relative {rel:.3g} "
             f"(bar {bar:.3g}); largest other row {others}")
    return rel


def phase_camera_machine(torch, card: str) -> dict:
    """Phase 15a: phase 7's f32 step with ``optimize_camera``: camera 0's
    pose-delta gradient against the JAX package's."""
    trainer = machine_trainer(torch, optimize_camera=True)
    machine_step(torch, trainer)
    bar = max(JAX_STEP_TOL, SPREAD_FACTOR * JAX_STEP["camera_grad_spread"])
    grad = trainer.camera_deltas.grad
    rel = camera_grad_check(torch, "[15a] machine_neddf f32", grad, JAX_STEP["camera_grad"], bar,
                            MACHINE_CAMERA)
    log(f"[15a] machine_neddf f32 step, camera {MACHINE_CAMERA}'s pose-delta gradient "
        f"{[round(x, 8) for x in grad[MACHINE_CAMERA].tolist()]} vs the JAX package's "
        f"{[round(x, 8) for x in JAX_STEP['camera_grad']]}: relative {rel:.3g} of its norm (bar "
        f"{bar:.3g}); every other row 0 | card: {card}")
    del trainer
    torch.cuda.empty_cache()
    return {"rel_vs_jax": rel, "bar": bar}


def phase_camera_kernels(torch, card: str) -> dict:
    """Phase 15b: one step of each family's shipped configuration at 512
    rays with ``optimize_camera``, through the kernels and through the
    plain versions on the same draws: the camera gradient (the kernels'
    input cotangents through the position encoding into the pose), the
    routes counted; then one camera-optimizer step moves only that row."""
    out = {}
    for family, needed in PATH_KERNELS.items():
        trainer = family_trainer(torch, family, [f"trainer.batch_size={CAMERA_BATCH}",
                                                 "trainer.optimize_camera=true"])
        render = trainer.neural_render
        nets = [render.network_fine] + ([render.network_coarse]
                                        if render.use_coarse_network else [])
        dtype = getattr(nets[0], "compute_dtype", torch.float32)
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=FAMILY_DRAW_SEED, batch=CAMERA_BATCH)
        us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
        reset_path_counts()
        trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(), u_strat, u_pdf)
        torch.cuda.synchronize()
        counts = read_path_counts(f"[15b] {family} kernels", needed)
        check_routes(f"[15b] {family}", counts["routes"],
                     "tc" if dtype == torch.bfloat16 else "tf32x3")
        kern = trainer.camera_deltas.grad.clone()
        for net in nets:
            net.fused = "off"
        trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(), u_strat, u_pdf)
        plain = trainer.camera_deltas.grad.clone()
        for net in nets:
            net.fused = "auto"
        bar = BF16_STEP_TOL["grad_norm"] if dtype == torch.bfloat16 else JAX_STEP_TOL
        rel = camera_grad_check(torch, f"[15b] {family}", kern, plain[FAMILY_CAMERA].cpu(), bar,
                                FAMILY_CAMERA)
        trainer.camera_deltas.grad = kern
        trainer.camera_optimizer.step()
        moved = (trainer.camera_deltas.detach().abs().sum(dim=1) > 0).nonzero().flatten()
        if moved.tolist() != [FAMILY_CAMERA]:
            fail(f"[15b] {family}: the camera optimizer moved rows {moved.tolist()}")
        name = str(dtype).replace("torch.", "")
        log(f"[15b] {family} ({name}, {CAMERA_BATCH} rays): camera {FAMILY_CAMERA}'s gradient "
            f"through the kernels vs the plain versions: relative {rel:.3g} of its norm (bar "
            f"{bar}); kernel launches {counts['launches']}, product routes "
            f"{counts['routes']['products']}, plain calls 0; one RowSparseAdam step moved row "
            f"{FAMILY_CAMERA} only | card: {card}")
        out[family] = {"rel_kernels_vs_plain": rel, "bar": bar, "dtype": name,
                       "kernel_grad": kern[FAMILY_CAMERA].tolist(),
                       "plain_grad": plain[FAMILY_CAMERA].tolist(), **counts}
        del trainer, render, nets
        torch.cuda.empty_cache()
    return out


def one_epoch_run(torch, card: str, name: str, extra, tag: str) -> dict:
    """One epoch of the default config with ``extra`` overrides through
    ``scripts/run.py`` (counts reset just before, read just after), then
    five traced steps: ms/step (steps 10-99), device ms/step and launches
    per step."""
    reset_path_counts()
    trainer = run_main_path(torch, OUT / name, ["trainer.epoch_max=0", *extra])
    counts = read_path_counts(f"[{tag}] {' '.join(extra)}", PATH_KERNELS["neddf"])
    hist = trainer.history
    if len(hist) != 100 or not all(math.isfinite(r["loss"]) for r in hist):
        fail(f"[{tag}] {name}: {len(hist)} steps, or a loss that is not finite")
    ms = 1000.0 * mean([r["seconds"] for r in hist[10:100]])
    prof = profile_train(torch, trainer, card, f"profile_{name}.txt",
                         f"512 rays, bf16, {' '.join(extra)}", tag)
    return {"trainer": trainer, "ms_per_step": ms, **prof, **counts}


def phase_camera_run(torch, card: str, default: dict) -> dict:
    """Phase 15c: one epoch with ``trainer.optimize_camera=true``: each
    camera visited once, its row moved and finite, the others not."""
    run = one_epoch_run(torch, card, "train_camera", ["trainer.optimize_camera=true"], "15c")
    trainer = run.pop("trainer")
    state = trainer.camera_optimizer.state[trainer.camera_deltas]
    visits = state["t"].cpu()
    deltas = trainer.camera_deltas.detach().cpu()
    moved = deltas.abs().sum(dim=1) > 0
    # the five traced steps came after the epoch: their cameras have 2 visits
    if not (torch.isfinite(deltas).all() and torch.equal(moved, visits > 0)
            and visits.min().item() >= 1):
        fail(f"[15c] camera deltas: visits {visits.tolist()}, moved {moved.tolist()}")
    log(f"[15c] optimize_camera, one epoch: {int((visits > 0).sum())} of {len(visits)} rows "
        f"visited and moved (finite), largest |delta| {deltas.abs().max().item():.3g}; "
        f"{run['ms_per_step']:.2f} ms/step (steps 10-99; default run {default['ms_10_99']:.2f}), "
        f"device {run['device_ms_per_step']:.2f} ms/step (default "
        f"{default['device_ms_per_step']:.2f}), launches per step {run['launches_per_step']} "
        f"(default {default['launches_per_step']}) | card: {card}")
    del trainer
    torch.cuda.empty_cache()
    return run


def step_numbers(trainer, draws, camera: bool) -> dict:
    us, vs, u_strat, u_pdf = draws
    loss, loss_dict, mse = trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(), u_strat,
                                              u_pdf)
    norms = {n: p.grad.norm().item() for n, p in trainer.neural_render.named_parameters()}
    if camera:
        norms["camera_deltas"] = trainer.camera_deltas.grad.norm().item()
    return {"loss": loss.item(), "mse": mse.item(),
            "losses": {k: v.item() for k, v in loss_dict.items()}, "grad_norms": norms}


def phase_grad_accum(torch, card: str, default: dict) -> dict:
    """Phase 16: one default-config step with grad_accum 2 and 4 against 1
    on the same draws, in bf16 and f32, without and with
    ``optimize_camera``; then one epoch at grad_accum=2."""
    out = {}
    for camera in (False, True):
        extra = [f"trainer.batch_size={CAMERA_BATCH}"] + (
            ["trainer.optimize_camera=true"] if camera else [])
        trainer = family_trainer(torch, "neddf", extra)
        render = trainer.neural_render
        net = render.network_fine
        draws = [torch.as_tensor(x, device=trainer.device) for x in machine_step_draws(
            trainer.dataset.image_width, trainer.dataset.image_height, render.sample_coarse + 1,
            render.sample_fine + 1, seed=FAMILY_DRAW_SEED, batch=CAMERA_BATCH)]
        for dtype in ((torch.bfloat16, torch.float32) if not camera else (torch.bfloat16,)):
            net.compute_dtype = dtype
            name = str(dtype).replace("torch.", "")
            runs = {}
            for n in (1, 2, 4):
                trainer.grad_accum = n
                reset_path_counts()
                runs[n] = step_numbers(trainer, draws, camera)
                torch.cuda.synchronize()
                counts = read_path_counts(f"[16] grad_accum={n} {name}", PATH_KERNELS["neddf"])
                check_routes(f"[16] grad_accum={n} {name}", counts["routes"],
                             "tc" if dtype == torch.bfloat16 else "tf32x3")
            worst = {}
            for n in (2, 4):
                if dtype == torch.bfloat16:
                    wl, wg = bf16_step_gaps(runs[n], runs[1])
                else:
                    wl = max(check_close(f"[16] f32 accum {n} loss {k}", runs[n]["losses"][k],
                                         v, ACCUM_F32_TOL) for k, v in runs[1]["losses"].items())
                    wg = max(check_close(f"[16] f32 accum {n} grad norm {k}",
                                         runs[n]["grad_norms"][k], v, ACCUM_F32_TOL)
                             for k, v in runs[1]["grad_norms"].items())
                worst[n] = {"loss": wl, "grad_norm": wg}
            key = f"{name}{'+camera' if camera else ''}"
            out[key] = {"worst_rel": worst, "steps": runs}
            log(f"[16] grad_accum 2 and 4 vs 1 ({key}, {CAMERA_BATCH} rays; microbatches of "
                f"256 and 128 rays: rows 256 x 65, 256 x 194, 128 x 65, 128 x 194): worst "
                f"relative gaps {json.dumps(worst)} (bar "
                f"{BF16_STEP_TOL if dtype == torch.bfloat16 else ACCUM_F32_TOL}) | card: {card}")
        del trainer, render, net
        torch.cuda.empty_cache()
    run = one_epoch_run(torch, card, "train_accum2", ["trainer.grad_accum=2"], "16")
    del run["trainer"]
    log(f"[16] grad_accum=2, one epoch: {run['ms_per_step']:.2f} ms/step (steps 10-99; default "
        f"{default['ms_10_99']:.2f}), device {run['device_ms_per_step']:.2f} ms/step (default "
        f"{default['device_ms_per_step']:.2f}), launches per step {run['launches_per_step']} "
        f"(default {default['launches_per_step']}) | card: {card}")
    torch.cuda.empty_cache()
    out["run"] = run
    return out


def phase_rest(torch, card: str) -> dict:
    """Phase 17: ``.pth`` export, an async checkpoint, the logger's
    scalar names, ``debug_nans``, a profiler trace and the step's syncs."""
    import collections
    import contextlib
    import io
    import os
    import traceback
    import warnings

    from neddf_tpu_torch.scripts import export_pth as export_script
    from neddf_tpu_torch.training.checkpoint import (
        load_msgpack_params,
        params_from_jax,
        state_dict_from_pth,
    )

    out = {}
    run_a = OUT / "train"
    # no --device: the snapshot's device must reach the card by default
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        pth = export_script.main([str(run_a)])
    if "on cuda" not in printed.getvalue():
        fail(f"[17] export_pth without --device did not run on the card: {printed.getvalue()!r}")
    trainer = family_trainer(torch, "neddf")
    loaded = state_dict_from_pth(pth, trainer.neural_render)
    want = params_from_jax(load_msgpack_params(run_a / "models" / f"model_{0:05}.ckpt"))
    if set(loaded) != set(want) or not all(torch.equal(loaded[k], want[k]) for k in want):
        fail("[17] the exported .pth does not load back bitwise")
    out["pth"] = str(pth.relative_to(REPO))
    log(f"[17] export_pth with no --device: {printed.getvalue().strip()}; {len(loaded)} "
        f"tensors, loaded back bitwise equal to the checkpoint")

    names = {"loss", "PSNR", "iteration duration", "total duration", "rays per sec",
             "objective/color", "objective/mask", "objective/fields_penalty"}
    events = sorted((run_a / "log").glob("events.out.tfevents*"))
    if events:
        out["log"] = {"tensorboard": [p.name for p in events]}
        log(f"[17] log/: TensorBoard event files {out['log']['tensorboard']}")
    else:
        first = json.loads((run_a / "log" / "train_log.jsonl").read_text().splitlines()[0])
        if not names <= set(first):
            fail(f"[17] log/train_log.jsonl records {sorted(first)} lack {sorted(names)}")
        out["log"] = {"jsonl_keys": sorted(first)}
        log(f"[17] log/train_log.jsonl (no tensorboard here): keys {sorted(first)}")

    cwd = os.getcwd()
    work = OUT / "rest"
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    os.chdir(work)
    try:
        tr_async = family_trainer(torch, "neddf", ["trainer.async_checkpoint=true",
                                                   "trainer.profile_trace_start=2",
                                                   "trainer.profile_trace_steps=2"])
        for cam in range(5):
            tr_async.run_train_step(cam)
            trainer.run_train_step(cam)
        tr_async.flush_logs()
        trainer.flush_logs()
        tr_async.save_checkpoint(work / "async.ckpt")
        tr_async.run_train_step(5)  # training goes on while it writes
        trainer.save_checkpoint(work / "sync.ckpt")
        tr_async.finalize_checkpoints()
        same = (work / "async.ckpt").read_bytes() == (work / "sync.ckpt").read_bytes()
        trace = sorted(p.name for p in (work / "log" / "profile").iterdir())
        log(f"[17] async_checkpoint: bytes equal to the synchronous save: {same}; "
            f"profile_trace_start=2: {trace}")
        if not same or not any(n.startswith("trace_2-3") for n in trace):
            fail("[17] async checkpoint bytes or the profiler trace")
        out.update(async_bytes_equal=same, trace=trace)
        del tr_async

        trainer.run_train_step(1)
        torch.cuda.synchronize()
        syncs = []

        def where(message, category, filename, lineno, file=None, line=None):
            # the warning is raised inside the op's call: the stack names it
            frames = [f for f in traceback.extract_stack() if "neddf_tpu_torch" in f.filename]
            at = frames[-1] if frames else None
            syncs.append(f"{Path(at.filename).relative_to(REPO)}:{at.lineno}" if at
                         else f"{filename}:{lineno}")

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = where
                trainer.camera_pose(3)
                pose_syncs = len(syncs)
                trainer.run_train_step(2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        step_syncs = collections.Counter(syncs[pose_syncs:])
        log(f"[17] torch.cuda.set_sync_debug_mode('warn'): camera_pose {pose_syncs} syncs; one "
            f"default step (log_interval {trainer.log_interval}, no flush) "
            f"{sum(step_syncs.values())} syncs, at {dict(step_syncs)} | card: {card}")
        if pose_syncs:
            fail("[17] camera_pose synchronizes with the host")
        out.update(pose_syncs=pose_syncs, step_syncs=dict(step_syncs))

        tr_nan = family_trainer(torch, "neddf", ["trainer.debug_nans=true"])
        tr_nan.run_train_step(0)
        with torch.no_grad():
            tr_nan.neural_render.network_fine.layers_ddf[2].w[0, 0] = float("nan")
        try:
            tr_nan.run_train_step(1)
            fail("[17] debug_nans: a NaN parameter raised nothing")
        except FloatingPointError as err:
            out["debug_nans"] = str(err)
            log(f"[17] debug_nans with a NaN weight: FloatingPointError({err})")
        if torch.is_anomaly_enabled():
            fail("[17] debug_nans left the anomaly mode on")
        del tr_nan, trainer
    finally:
        os.chdir(cwd)
    torch.cuda.empty_cache()
    return out


# the products whose outputs are layer 0's input cotangents (and the
# skip's seg0 part), by family: (rows per pass, width, calls per pass,
# live under optimize_camera); rows of the NeDDF trunk's stacked planes
# are 4 per point, the colour trunk's 2 (its PE segment) or 1
def _cotangent_products(family: str):
    if family == "neddf":
        for m in (CAMERA_BATCH * 65, CAMERA_BATCH * 194):
            yield ("trunk layer 0 + skip", 4 * m, 60, 2, True)
            yield ("colour PE", 2 * m, 60, 1, True)
            yield ("colour dir", m, 24, 1, True)
            yield ("colour normal (detached)", m, 3, 1, False)
    elif family == "nerf":
        for m in (1024 * 65, 1024 * 194):
            yield ("trunk layer 0", m, 60, 1, True)
    else:
        for m in (1024 * 65, 1024 * 194):
            yield ("sdf layer 0", m, 36, 1, True)
            yield ("colour pos", m, 3, 1, True)
            yield ("colour dir", m, 24, 1, True)


def phase_discarded_cotangents(torch, card: str) -> dict:
    """The device time per step of the products that form input
    cotangents which the default path throws away (the position
    encoding's, the direction's, NeDDF's detached normal): each product at
    its shapes (CUDA events, median of 5 readings of 10 launches) times its
    calls per step."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for family, dtype in (("neddf", torch.bfloat16), ("nerf", torch.bfloat16),
                          ("neus", torch.float32)):
        k = dm.Products(dtype, dev)
        total, live, rows = 0.0, 0.0, []
        for what, m, n, calls, camera_live in _cotangent_products(family):
            a = torch.randn((m, 256), generator=gen, device=dev).to(dtype)
            w = torch.randn((n, 256), generator=gen, device=dev).to(dtype)
            ms = time_one(torch, lambda: k.nt(a, w))
            total += ms * calls
            live += ms * calls if camera_live else 0.0
            rows.append({"what": what, "rows": m, "width": n, "calls": calls, "ms": ms})
            del a, w
        out[family] = {"discarded_ms_per_step": total, "live_under_camera_ms_per_step": live,
                       "products": rows}
        log(f"[15d] {family}: the products of input cotangents the default step discards, "
            f"{total:.4f} device ms per step (under optimize_camera {live:.4f} of it is live): "
            + ", ".join(f"{r['what']} [{r['rows']}, 256] x [{r['width']}, 256]^T x{r['calls']} "
                        f"{r['ms']:.4f} ms" for r in rows) + f" | card: {card}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 18
# geometry extraction and the culled eval render of pretrained/machine_neddf
GEOMETRY_RES = 64  # the visualizer's default lattice
GEOMETRY_RES_LARGE = 256
GEOMETRY_LEVEL = 0.0275  # the distance field's iso level
# kernels vs plain versions (bf16): a vertex or triangle count may move
# where a rounding flips a lattice value across the level
MESH_COUNT_TOL = 0.01
# the JAX package's f32 volumes on the CPU (tools/geometry_reference.py):
# the port's f32 volume through the kernels within this share of max |v|
GEOMETRY_REF = REPO / "tools" / "geometry_reference.npz"
GEOMETRY_REF_TOL = 1e-4
# run_eval --ray-cull against the dense render of the same call: PSNR (dB)
RAY_CULL_PSNR_TOL = 0.05
# occupancy= with budgets of the whole sample axes against the dense render
# (bf16, phase 4's bar for a bf16 render against another)
OCCUPANCY_FULL_PSNR_MIN = 40.0
OCCUPANCY_BUDGETS = (16, 64)
# the fields of the NeDDF paths and the counters that must launch on them
GEOMETRY_EVAL_KERNELS = ("dual_mlp_trunk", "mlp_seg")
GEOMETRY_GRID_KERNELS = ("dual_mlp_trunk", "neddf_epilogue", "dual_mlp_seg")
GEOMETRY_FAMILY_KERNELS = {"nerf": ("mlp_seg",), "neus": ("sdf_mlp", "mlp_seg")}


def count_syncs(torch, fn) -> "collections.Counter":
    """Host syncs of ``fn()`` under ``torch.cuda.set_sync_debug_mode``,
    by the port's line that made each."""
    import collections
    import traceback
    import warnings

    syncs = []

    def where(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack() if "neddf_tpu_torch" in f.filename]
        at = frames[-1] if frames else None
        syncs.append(f"{Path(at.filename).relative_to(REPO)}:{at.lineno}" if at
                     else f"{filename}:{lineno}")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = where
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(syncs)


def timed(torch, fn):
    """(fn(), wall seconds with the device drained before and after)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def image_psnr(color, gt) -> float:
    """PSNR of a rendered colour image [h, w, 3] in [0, 1] against a uint8
    image, as ``render_test`` scores it (uint8 quantisation)."""
    import numpy as np

    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    rgb = np.clip(color * 255, 0, 255).astype(np.uint8)
    return peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])


def phase_geometry(torch, card: str, family_runs) -> dict:
    """Phase 18: geometry extraction and the culled eval render through
    the entry points, at full width on ``pretrained/machine_neddf``
    (a copy under ``OUT``), and the visualizer on ``family_runs``
    ({family: (run dir, epoch)}). Each path is driven with every count at
    0 just before it and read just after."""
    import numpy as np

    from neddf_tpu_torch.fields.base import voxelize
    from neddf_tpu_torch.ops.occupancy import coarsen_grid, make_grid
    from neddf_tpu_torch.scripts import fields_visualizer
    from neddf_tpu_torch.scripts.run_eval import evaluate, load_trainer
    from neddf_tpu_torch.viz import marching_tetrahedra

    out = {"launches": {}}
    run = OUT / "geometry_machine_neddf"
    if run.exists():
        shutil.rmtree(run)
    shutil.copytree(RUN, run)

    # ---- 18a: fields_visualizer (voxel cache, mesh, slices) through the kernels
    reset_path_counts()
    (verts, tris), wall = timed(torch, lambda: fields_visualizer.main(
        [str(run), "--epoch", str(EPOCH), "--resolution", str(GEOMETRY_RES)]))
    counts = read_path_counts("[18a] fields_visualizer", GEOMETRY_EVAL_KERNELS)
    out["launches"]["fields_visualizer"] = ("neddf", counts["launches"])
    check_routes("[18a] fields_visualizer", counts["routes"], "tc", backward=False)
    log(f"[18a] fields_visualizer {RUN.name} --resolution {GEOMETRY_RES}: {wall:.2f} s (load, "
        f"voxelize, marching, export, 5 slices); mesh {verts.shape[0]} vertices, "
        f"{tris.shape[0]} triangles; launches {counts['launches']}, plain calls 0")
    if tris.shape[0] < 1:
        fail("[18a] the distance mesh has no triangle")
    voxel_k = np.load(run / "mesh" / f"voxel_{GEOMETRY_RES}.npy")

    trainer = load_trainer(run, EPOCH)
    net = trainer.neural_render.network_fine
    net.fused = "off"
    voxel_p = voxelize(net, "distance", cube_resolution=GEOMETRY_RES)
    net.fused = "auto"
    v_p, t_p = marching_tetrahedra(voxel_p, GEOMETRY_LEVEL)
    gaps = {"vertices": abs(verts.shape[0] - v_p.shape[0]) / max(v_p.shape[0], 1),
            "triangles": abs(tris.shape[0] - t_p.shape[0]) / max(t_p.shape[0], 1)}
    diff = float(np.abs(voxel_k - voxel_p).max())
    log(f"[18a] {GEOMETRY_RES}^3 bf16 kernels vs plain versions: max |volume diff| {diff:.4g} "
        f"(max |v| {np.abs(voxel_p).max():.4g}); plain mesh {v_p.shape[0]} vertices, "
        f"{t_p.shape[0]} triangles; count gaps {gaps} (bar {MESH_COUNT_TOL})")
    if not np.isfinite(voxel_k).all() or max(gaps.values()) > MESH_COUNT_TOL:
        fail("[18a] the kernels' mesh disagrees with the plain versions'")
    out["kernels_vs_plain"] = {"max_abs_diff": diff, "count_gaps": gaps,
                               "mesh": [int(verts.shape[0]), int(tris.shape[0])],
                               "mesh_plain": [int(v_p.shape[0]), int(t_p.shape[0])]}

    ref = np.load(GEOMETRY_REF)
    net.compute_dtype = torch.float32
    f32 = {}
    for name in ("distance", "density"):
        got = voxelize(net, name, cube_resolution=ref[name].shape[0])
        f32[name] = float(np.abs(got - ref[name]).max() / np.abs(ref[name]).max())
    net.compute_dtype = torch.bfloat16
    log(f"[18a] {ref['distance'].shape[0]}^3 f32 through the kernels vs the JAX package on the "
        f"CPU (tools/geometry_reference.py): max |diff| / max |v| {f32} (distance bar "
        f"{GEOMETRY_REF_TOL})")
    if not f32["distance"] <= GEOMETRY_REF_TOL:
        fail("[18a] the f32 distance volume disagrees with the JAX package's")
    out["f32_vs_jax"] = f32

    times = {}
    for res in (GEOMETRY_RES, GEOMETRY_RES_LARGE):
        volume, secs = timed(torch, lambda: voxelize(net, "distance", cube_resolution=res))
        (v, t), march = timed(torch, lambda: marching_tetrahedra(volume, GEOMETRY_LEVEL))
        times[res] = {"voxelize_s": secs, "points_per_s": res ** 3 / secs, "marching_s": march,
                      "vertices": int(v.shape[0]), "triangles": int(t.shape[0])}
        log(f"[18a] voxelize {res}^3 (bf16, eval route, chunk 65,536): {secs:.3f} s, "
            f"{res ** 3 / secs:.4g} points/s; marching tetrahedra on the host {march:.3f} s "
            f"({v.shape[0]} vertices, {t.shape[0]} triangles) | card: {card}")
        del volume
    out["times"] = times

    # ---- 18b: enable_ray_cull (the grid: 4 EMA-max updates, training route)
    reset_path_counts()
    _, build_s = timed(torch, trainer.enable_ray_cull)
    counts = read_path_counts("[18b] enable_ray_cull", GEOMETRY_GRID_KERNELS)
    out["launches"]["enable_ray_cull"] = ("neddf", counts["launches"])
    grid = trainer.eval_ray_cull
    occupied = (grid.values > grid.threshold).float().mean().item()
    coarse = coarsen_grid(grid, 4).values.mean().item()
    log(f"[18b] enable_ray_cull: {build_s:.3f} s; occupied {occupied:.4f} of the "
        f"{grid.resolution}^3 cells, {coarse:.4f} of the coarsened and dilated "
        f"{grid.resolution // 4}^3; launches {counts['launches']} | card: {card}")
    out["grid"] = {"build_s": build_s, "occupied_share": occupied, "coarse_share": coarse}
    del trainer
    torch.cuda.empty_cache()

    # ---- 18c: run_eval --ray-cull, camera 0 at full resolution
    reset_path_counts()
    trainer, wall = timed(torch, lambda: evaluate(run, EPOCH, cameras=[0], ray_cull=True))
    counts = read_path_counts("[18c] run_eval --ray-cull",
                              GEOMETRY_EVAL_KERNELS + GEOMETRY_GRID_KERNELS)
    out["launches"]["run_eval_ray_cull"] = ("neddf", counts["launches"])
    log(f"[18c] run_eval --ray-cull --cameras 0: {wall:.2f} s (load, grid, render, PNGs); "
        f"launches {counts['launches']}")
    render = trainer.neural_render
    grid = trainer.eval_ray_cull
    h, w = trainer.dataset.image_height, trainer.dataset.image_width
    gt = trainer.dataset[0]["rgb_images"].astype("uint8")
    with torch.no_grad():
        cam_r, cam_t = trainer.camera_pose(0)
    targets = ["color", "depth", "transmittance"]

    def image(ds=1, **kw):
        return render.render_image(
            trainer.calib, cam_r, cam_t, w, h, targets, ds, trainer.chunk,
            generator=torch.Generator(device=cam_r.device).manual_seed(0), **kw)

    dense, dense_s = timed(torch, image)
    culled, culled_s = timed(torch, lambda: image(ray_cull=grid))
    uv = np.stack([np.tile(np.arange(w), h), np.repeat(np.arange(h), w)], axis=1)
    active = render.rays_active(coarsen_grid(grid, 4), trainer.calib, cam_r, cam_t,
                                torch.as_tensor(uv, device=cam_r.device), 128)
    active = active.cpu().numpy().reshape(h, w)
    bitwise = all(np.array_equal(culled[k][active], dense[k][active]) for k in targets)
    empty = bool(np.all(culled["color"][~active] == 0.0)
             and np.all(culled["depth"][~active] == render.max_dist)
             and np.all(culled["transmittance"][~active] == 1.0))
    psnr_dense, psnr_culled = image_psnr(dense["color"], gt), image_psnr(culled["color"], gt)
    share = 1.0 - float(active.mean())
    log(f"[18c] cam 0 {w}x{h}: culled share of rays {share:.4f}; active pixels bitwise equal to "
        f"the dense render of the same call: {bitwise}; culled pixels the empty composite: "
        f"{empty}; PSNR dense {psnr_dense:.4f} dB, culled {psnr_culled:.4f} dB (bar "
        f"{RAY_CULL_PSNR_TOL} dB); {dense_s:.3f} s/image dense, {culled_s:.3f} s/image culled "
        f"| card: {card}")
    if not (bitwise and empty and abs(psnr_culled - psnr_dense) <= RAY_CULL_PSNR_TOL):
        fail("[18c] the culled render disagrees with the dense render")
    # the culled render runs fewer chunks, each with its field's copies of
    # Python values (ops/pe.py), and one sync of its own: the active-ray counts
    syncs_dense = count_syncs(torch, lambda: image(8))
    syncs_culled = count_syncs(torch, lambda: image(8, ray_cull=grid))
    extra = syncs_culled - syncs_dense
    log(f"[18c] host syncs of one render at downsampling 8: dense {dict(syncs_dense)}, culled "
        f"{dict(syncs_culled)}")
    if sum(extra.values()) != 1:
        fail(f"[18c] ray_cull must add one host sync (the active-ray count), added {extra}")

    full = make_grid(16, 6.0, 0.0, cam_r.device)
    budgets_full = (render.sample_coarse + 1, render.sample_fine + 1 + render.sample_coarse + 1)
    reset_path_counts()
    occ_full, occ_full_s = timed(torch, lambda: image(occupancy=full, budget_coarse=budgets_full[0],
                                                      budget_fine=budgets_full[1]))
    counts = read_path_counts("[18c] occupancy= full budgets", GEOMETRY_EVAL_KERNELS)
    out["launches"]["occupancy_full"] = ("neddf", counts["launches"])
    diff = occ_full["color"] - dense["color"]
    full_psnr = -10.0 * math.log10(max(float(np.square(diff).mean()), 1e-20))
    log(f"[18c] occupancy= all-occupied grid, budgets {budgets_full} (the whole sample axes): "
        f"max |color - dense| {np.abs(diff).max():.4g}, {full_psnr:.2f} dB against the dense "
        f"render (bar {OCCUPANCY_FULL_PSNR_MIN}), {occ_full_s:.3f} s/image; launches "
        f"{counts['launches']}")
    reset_path_counts()
    occ, occ_s = timed(torch, lambda: image(occupancy=grid, budget_coarse=OCCUPANCY_BUDGETS[0],
                                            budget_fine=OCCUPANCY_BUDGETS[1]))
    counts = read_path_counts("[18c] occupancy= budgets", GEOMETRY_EVAL_KERNELS)
    out["launches"]["occupancy_budget"] = ("neddf", counts["launches"])
    psnr_occ = image_psnr(occ["color"], gt)
    log(f"[18c] occupancy= the run_eval grid, budgets {OCCUPANCY_BUDGETS}: {occ_s:.3f} s/image, "
        f"PSNR {psnr_occ:.4f} dB (dense {psnr_dense:.4f}); launches {counts['launches']} "
        f"| card: {card}")
    if full_psnr < OCCUPANCY_FULL_PSNR_MIN or not np.isfinite(occ["color"]).all():
        fail("[18c] occupancy= with full budgets disagrees with the dense render")
    out["render"] = {"culled_share": share, "bitwise_active": bitwise, "empty_culled": empty,
                     "psnr_dense": psnr_dense, "psnr_culled": psnr_culled,
                     "dense_s": dense_s, "culled_s": culled_s, "run_eval_s": wall,
                     "syncs_dense": dict(syncs_dense), "syncs_culled": dict(syncs_culled),
                     "occupancy_full_psnr_vs_dense": full_psnr,
                     "occupancy_full_max_abs_diff": float(np.abs(diff).max()),
                     "occupancy_full_s": occ_full_s, "occupancy_budget_s": occ_s,
                     "occupancy_budget_psnr": psnr_occ}
    del trainer, dense, culled, occ_full, occ
    torch.cuda.empty_cache()

    # ---- 18d: the visualizer on the NeRF and NeuS runs (--field auto)
    for family, (run_dir, epoch) in family_runs.items():
        reset_path_counts()
        (v, t), wall = timed(torch, lambda: fields_visualizer.main(
            [str(run_dir), "--epoch", str(epoch), "--resolution", str(GEOMETRY_RES)]))
        counts = read_path_counts(f"[18d] fields_visualizer {family}",
                                  GEOMETRY_FAMILY_KERNELS[family])
        out["launches"][f"fields_visualizer_{family}"] = (family, counts["launches"])
        field = "sdf" if family == "neus" else "density"
        volume = np.load(run_dir / "mesh" / f"voxel_{field}_{GEOMETRY_RES}.npy")
        log(f"[18d] fields_visualizer {family} --field auto ({field}, volume in "
            f"[{volume.min():.4g}, {volume.max():.4g}]): {wall:.2f} s; mesh {v.shape[0]} "
            f"vertices, {t.shape[0]} triangles at the default level; launches "
            f"{counts['launches']} | card: {card}")
        mesh = {"default_level": [int(v.shape[0]), int(t.shape[0])]}
        if t.shape[0] < 1 and np.isfinite(volume).all():
            # a short run's field may not reach the family's default level
            # (density 15, sdf 0.05): mesh the cached volume at its mid-range
            level = float(volume.min() + volume.max()) / 2.0
            v, t = fields_visualizer.main(
                [str(run_dir), "--epoch", str(epoch), "--resolution", str(GEOMETRY_RES),
                 "--threshold", str(level), "--slices", "0"])
            log(f"[18d] {family} again at level {level:.4g} (the cached volume): mesh "
                f"{v.shape[0]} vertices, {t.shape[0]} triangles")
            mesh[f"level_{level:.6g}"] = [int(v.shape[0]), int(t.shape[0])]
        if t.shape[0] < 1 or not np.isfinite(volume).all():
            fail(f"[18d] the {family} mesh has no triangle")
        out[f"mesh_{family}"] = mesh
    return out


def geometry_launches(geometry: dict, counter: str, family: str) -> dict:
    """Launches of one kernel wrapper on each phase-18 path of ``family``
    (``launches_geometry`` in the kernels line)."""
    return {path: counts[counter] for path, (fam, counts) in geometry["launches"].items()
            if fam == family and counts.get(counter)}


# ---------------------------------------------------------------- phase 19
# the forward-facing path's runs: 15 epochs of the 21 train frames
LLFF_EPOCH_MAX = 14  # trainer.epoch_max: epochs 0..14
LLFF_TRAIN_FRAMES = 21  # 24 images, every 8th held out
# the kernels each path launches (wrapper counters); no plain version may run
LLFF_EVAL_KERNELS = {"neddf": ("dual_mlp_trunk", "mlp_seg"), "nerf": ("mlp_seg",)}
# the small capture's decoded pixels against the JAX generator's: another
# numpy build may round a shade to the other level
LLFF_IMAGE_LEVELS = 1
LLFF_IMAGE_SHARE = 1e-3
# LLFFDataset's cameras, intrinsics and bounds against the JAX package's
LLFF_DATASET_TOL = 1e-6


def start_llff_capture(capture: Path):
    """The phase-19 capture (``LLFF_CAPTURE``) by the port's generator, in a
    subprocess that runs while the card works on the earlier phases;
    returns (process, log path)."""
    if capture.exists():
        shutil.rmtree(capture)
    capture.parent.mkdir(parents=True, exist_ok=True)
    log_path = capture.parent / "llff_capture.log"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from neddf_tpu_torch.data.llff import generate_forward_facing_dataset as g; "
            f"g(sys.argv[2], n_images={LLFF_CAPTURE['n_images']}, "
            f"image_size={LLFF_CAPTURE['image_size']})")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code, str(REPO), str(capture)],
                                stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, log_path


def llff_reference() -> dict:
    import numpy as np

    with np.load(LLFF_REF) as z:
        ref = {k: z[k] for k in z.files}
    ref["step"] = json.loads(str(ref["step"]))
    return ref


def phase_llff_capture(ref: dict, card: str, capture_run) -> dict:
    """Phase 19a: the port's generator and LLFFDataset against the JAX
    package's (``tools/llff_reference.npz``), then the 400x400 capture."""
    import numpy as np

    from neddf_tpu_torch.data import LLFFDataset
    from neddf_tpu_torch.data.llff import generate_forward_facing_dataset
    from neddf_tpu_torch.utils.png import read_png, write_png

    small = generate_forward_facing_dataset(OUT / "llff_small", **LLFF_SMALL)
    images = np.stack([read_png(p) for p in sorted((small / "images").iterdir())])
    if images.shape != ref["images"].shape:
        fail(f"[19a] generated images {images.shape}, the JAX package's {ref['images'].shape}")
    diff = np.abs(images.astype(np.int64) - ref["images"])
    share = float((diff.max(axis=-1) > 0).mean())
    poses_gap = float(np.abs(np.load(small / "poses_bounds.npy") - ref["poses_bounds"]).max())
    log(f"[19a] {LLFF_SMALL['n_images']} frames of {LLFF_SMALL['image_size']} px by the port's "
        f"generator vs the JAX package's: max {int(diff.max())} levels, on {share:.2e} of the "
        f"pixels (bars {LLFF_IMAGE_LEVELS}, {LLFF_IMAGE_SHARE}); poses_bounds max gap "
        f"{poses_gap:.3g}")
    if diff.max() > LLFF_IMAGE_LEVELS or share > LLFF_IMAGE_SHARE or poses_gap > 1e-9:
        fail("[19a] the port's forward-facing capture differs from the JAX package's")

    # LLFFDataset on the reference's own files
    ref_dir = OUT / "llff_small_ref"
    (ref_dir / "images").mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(ref["images"]):
        write_png(ref_dir / "images" / f"img_{i:03}.png", img)
    np.save(ref_dir / "poses_bounds.npy", ref["poses_bounds"])
    worst = 0.0
    for rc in (0, 1):
        train = LLFFDataset(str(ref_dir), "train", factor=1, recenter=bool(rc))
        test = LLFFDataset(str(ref_dir), "test", factor=1, recenter=bool(rc))
        test_ids = np.flatnonzero(np.arange(len(ref["images"])) % test.hold_every == 0)
        gaps = [np.abs(train.camera_params - ref[f"cam_train_{rc}"]).max(),
                np.abs(test.camera_params - ref[f"cam_test_{rc}"]).max(),
                np.abs(train.camera_calib_params - ref[f"calib_{rc}"]).max(),
                abs(train.near - float(ref[f"near_{rc}"])), abs(train.far - float(ref[f"far_{rc}"]))]
        worst = max(worst, *map(float, gaps))
        same_images = np.array_equal(test.rgb_images,
                                     ref["images"][test_ids][..., 2::-1].astype(np.float32))
        if max(gaps) > LLFF_DATASET_TOL or not np.array_equal(test_ids, ref[f"test_ids_{rc}"]) \
                or not same_images or (test.mask_images != 255).any():
            fail(f"[19a] LLFFDataset recenter={bool(rc)}: gaps {gaps}, test ids {test_ids}, "
                 f"images equal {same_images}")
    log(f"[19a] LLFFDataset on the reference's files, recenter false and true: cameras, "
        f"intrinsics and bounds within {worst:.3g} of the JAX package's (bar "
        f"{LLFF_DATASET_TOL}), splits and images equal")

    proc, log_path = capture_run
    start = time.perf_counter()
    if proc.wait() != 0:
        fail(f"[19a] the capture's generator failed: {log_path.read_text()[-2000:]}")
    capture = Path(proc.args[-1])
    frames = sorted((capture / "images").iterdir())
    log(f"[19a] {len(frames)} frames of {LLFF_CAPTURE['image_size']} px generated under "
        f"{capture} (in a subprocess beside phases 2-18; waited "
        f"{time.perf_counter() - start:.1f} s for it here); ndc_near "
        f"{llff_ndc_near(capture):.6f}")
    return {"image_max_levels": int(diff.max()), "image_share_off": share,
            "poses_bounds_gap": poses_gap, "dataset_worst_gap": worst,
            "capture_wait_s": time.perf_counter() - start, "capture": str(capture)}


def llff_trainer(torch, family: str, capture: Path, extra=()):
    """A family's phase-19 trainer on the card, composed as
    ``scripts/run.py`` composes it."""
    from neddf_tpu_torch import config as config_lib

    cfg = config_lib.compose(REPO / "config", overrides=[*llff_overrides(family, capture),
                                                         *extra])
    cfg["trainer"]["device"] = "cuda"
    return config_lib.instantiate(cfg["trainer"], global_config=cfg)


def phase_llff_step(torch, card: str, ref: dict, capture: Path) -> dict:
    """Phase 19b: one full-width f32 step of NeDDF-NDC and NeRF-NDC through
    the kernels from the seeded parameters, against the JAX package's."""
    out = {}
    for family in LLFF_OVERRIDES:
        trainer = llff_trainer(torch, family, capture, ["network.compute_dtype=float32"])
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=LLFF_DRAW_SEED, batch=LLFF_BATCH)
        us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
        reset_path_counts()
        loss, loss_dict, mse = trainer.step_grads(LLFF_CAMERA, us.long(), vs.long(), u_strat,
                                                  u_pdf)
        torch.cuda.synchronize()
        counts = read_path_counts(f"[19b] {family} f32 step", PATH_KERNELS[family])
        check_routes(f"[19b] {family} f32 step", counts["routes"], "tf32x3")
        got = {"loss": loss.item(), "mse": mse.item(),
               "losses": {k: v.item() for k, v in loss_dict.items()},
               "grad_norms": {n: p.grad.norm().item() for n, p in render.named_parameters()}}
        worst, wider = hold_step(f"[19b] {family}-NDC", got, ref["step"][family], card,
                                 "a 1e-7 camera shift or a one-step move of each ray's T")
        out[family] = {"got": got, "worst_rel_vs_jax": worst, "wider_bars": wider,
                       "launches": counts["launches"]}
        del trainer, render
        torch.cuda.empty_cache()
    return out


def phase_llff_runs(torch, card: str, capture: Path) -> dict:
    """Phases 19c-f: each family's NDC run through ``scripts/run.py``, its
    held-out views through ``run_eval`` (kernels and plain versions), the
    NeDDF run's field slices through ``fields_visualizer``, and the
    refusals of the world-space grid."""
    import numpy as np

    from neddf_tpu_torch.scripts import fields_visualizer, run_eval
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio
    from neddf_tpu_torch.utils.png import read_png

    out = {"launches": {}, "routes": {}}
    for family in LLFF_OVERRIDES:
        run_dir = OUT / f"train_llff_{family}"
        # ---- 19c: the run
        reset_path_counts()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        trainer = run_main_path(torch, run_dir, [
            *llff_overrides(family, capture.relative_to(REPO)),
            f"trainer.epoch_max={LLFF_EPOCH_MAX}", f"trainer.epoch_save_model={LLFF_EPOCH_MAX}"])
        wall = time.perf_counter() - start
        counts = read_path_counts(f"[19c] {family}-NDC run", PATH_KERNELS[family])
        check_routes(f"[19c] {family}-NDC run", counts["routes"], "tc")
        out["launches"][f"{family}_ndc_train"] = (family, counts["launches"])
        out["routes"][f"{family}_ndc_train"] = counts["routes"]
        hist = trainer.history
        steps = LLFF_TRAIN_FRAMES * (LLFF_EPOCH_MAX + 1)
        if len(trainer.dataset) != LLFF_TRAIN_FRAMES or len(hist) != steps:
            fail(f"[19c] {family}: {len(trainer.dataset)} train frames, {len(hist)} steps")
        if not all(math.isfinite(r["loss"]) and all(map(math.isfinite, r["losses"].values()))
                   for r in hist):
            fail(f"[19c] {family}: a non-finite loss")
        first, last = mean([r["psnr"] for r in hist[:50]]), mean([r["psnr"] for r in hist[-50:]])
        steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
        ms_step, rays_s = 1000.0 * mean(steady), trainer.batch_size / mean(steady)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"[19c] {family}-NDC run: {len(hist)} steps in {wall:.1f} s (load, hooks and "
            f"checkpoints included), launches {counts['launches']}, plain calls 0; train PSNR "
            f"first 50 steps {first:.3f} dB, last 50 {last:.3f} dB (gain bar {PSNR_GAIN_MIN}); "
            f"{ms_step:.2f} ms/step, {rays_s:.0f} rays/s (steps 100-199, "
            f"{trainer.batch_size} rays, bf16), peak {peak_gib:.2f} GiB | card: {card}")
        if not last - first >= PSNR_GAIN_MIN:
            fail(f"[19c] {family}: train PSNR did not rise")
        prof = profile_train(torch, trainer, card, f"profile_train_llff_{family}.txt",
                             f"{family}-NDC, {trainer.batch_size} rays, bf16", "19c")
        del trainer
        torch.cuda.empty_cache()

        # ---- 19d: run_eval of the held-out views, kernels then plain versions
        reset_path_counts()
        (ev, wall_eval) = timed(torch, lambda: run_eval.evaluate(run_dir, LLFF_EPOCH_MAX))
        counts = read_path_counts(f"[19d] {family}-NDC run_eval", LLFF_EVAL_KERNELS[family])
        out["launches"][f"{family}_ndc_eval"] = (family, counts["launches"])
        out["routes"][f"{family}_ndc_eval"] = counts["routes"]
        views = len(ev.dataset)
        gts = [ev.dataset[i]["rgb_images"].astype("uint8") for i in range(views)]
        # run_eval's own images (RGB files of BGR renders), then the same
        # draws again: view 0 through the kernels (timed), every view through
        # the plain versions
        psnrs = {"kernels": [peak_signal_noise_ratio(
            read_png(run_dir / "eval" / f"{i:03}_rgb.png")[:, :, ::-1], gts[i])
            for i in range(views)], "plain": []}
        ev.generator.manual_seed(ev.seed)
        _, s_kernels = timed(torch, lambda: ev.render_test(run_dir / "eval_kernels", 0, 1))
        secs = {"kernels": [s_kernels], "plain": []}
        for net in {ev.neural_render.network_fine, ev.neural_render.coarse_network()}:
            net.fused = "off"
        ev.generator.manual_seed(ev.seed)
        for i in range(views):
            rgb, s_plain = timed(torch, lambda i=i: ev.render_test(run_dir / "eval_plain", i, 1))
            psnrs["plain"].append(peak_signal_noise_ratio(rgb, gts[i]))
            secs["plain"].append(s_plain)
        gaps = [abs(a - b) for a, b in zip(psnrs["kernels"], psnrs["plain"])]
        h, w = gts[0].shape[:2]
        log(f"[19d] {family}-NDC run_eval of the {views} held-out views at {w}x{h} "
            f"({wall_eval:.2f} s with loading; launches {counts['launches']}): PSNR "
            f"{[round(x, 4) for x in psnrs['kernels']]} dB through the kernels "
            f"({mean(secs['kernels']):.3f} s/image), {[round(x, 4) for x in psnrs['plain']]} "
            f"through the plain versions ({mean(secs['plain']):.3f} s/image); largest gap "
            f"{max(gaps):.4f} dB (bar {EVAL_PSNR_GAP_DB}) | card: {card}")
        if views != 3 or not max(gaps) <= EVAL_PSNR_GAP_DB:
            fail(f"[19d] {family}: run_eval through the kernels and the plain versions disagree")
        out[family] = {"steps": len(hist), "wall_s": wall, "ms_per_step": ms_step,
                       "rays_per_s": rays_s, "busy_share": prof["busy_share"],
                       "device_ms_per_step": prof["device_ms_per_step"],
                       "launches_per_step": prof["launches_per_step"], "peak_memory_gib": peak_gib,
                       "psnr_first50": first, "psnr_last50": last,
                       "eval_psnr": psnrs, "eval_s_per_image": secs, "eval_wall_s": wall_eval,
                       "loss_curve": [r["loss"] for r in hist],
                       "psnr_curve": [r["psnr"] for r in hist]}

        if family == "neddf":
            # ---- 19f: the refusals of the world-space grid
            calib, (r, t) = ev.calib, ev.camera_pose(0)
            uv = torch.zeros((4, 2), dtype=torch.long, device=ev.device)
            u = torch.rand((4, 65), device=ev.device), torch.rand((4, 129), device=ev.device)
            refusals = {}
            for what, fn in (
                    ("run_eval --ray-cull", lambda: run_eval.main(
                        [str(run_dir), "--epoch", str(LLFF_EPOCH_MAX), "--ray-cull"])),
                    ("render_rays_accel", lambda: ev.neural_render.render_rays_accel(
                        calib, r, t, uv, *u, None)),
                    ("build_occupancy", lambda: ev.neural_render.build_occupancy())):
                try:
                    fn()
                except ValueError as exc:
                    if "does not support ndc=true" not in str(exc):
                        raise
                    refusals[what] = str(exc)
                else:
                    fail(f"[19f] {what} accepted an NDC run")
            log(f"[19f] refused under ndc=true: {json.dumps(refusals)}")
            out["refusals"] = refusals
        del ev
        torch.cuda.empty_cache()

    # ---- 19e: the field slices of the NeDDF-NDC run dir
    run_dir = OUT / "train_llff_neddf"
    reset_path_counts()
    (_, t), wall = timed(torch, lambda: fields_visualizer.main(
        [str(run_dir), "--epoch", str(LLFF_EPOCH_MAX), "--resolution", str(GEOMETRY_RES)]))
    counts = read_path_counts("[19e] fields_visualizer of the NeDDF-NDC run",
                              GEOMETRY_EVAL_KERNELS)
    out["launches"]["neddf_ndc_fields_visualizer"] = ("neddf", counts["launches"])
    out["routes"]["neddf_ndc_fields_visualizer"] = counts["routes"]
    slices = sorted(p.name for p in (run_dir / "fields").glob("slice_*.png"))
    volume = np.load(run_dir / "mesh" / f"voxel_{GEOMETRY_RES}.npy")
    log(f"[19e] fields_visualizer of the NeDDF-NDC run dir: {wall:.2f} s, {len(slices)} slice "
        f"images, the {GEOMETRY_RES}^3 distance volume in [{volume.min():.4g}, "
        f"{volume.max():.4g}] (NDC coordinates), {t.shape[0]} triangles at the default level; "
        f"launches {counts['launches']} | card: {card}")
    if len(slices) < 5 or not np.isfinite(volume).all():
        fail("[19e] the NDC run's slices or volume are missing or not finite")
    out["fields_visualizer"] = {"wall_s": wall, "slices": slices, "triangles": int(t.shape[0])}
    return out


def llff_launches(llff: dict, counter: str, family: str) -> dict:
    """Launches of one kernel wrapper on each phase-19 path of ``family``
    (``launches_llff`` in the kernels line)."""
    return {path: counts[counter] for path, (fam, counts) in llff["launches"].items()
            if fam == family and counts.get(counter)}


# phase 20: data parallelism. The step's rays and draw seed; every launch
# count of one rank's sharded step (the single-process step's counts at
# half the rows: two passes, each one K=3 trunk, one K=1 colour trunk and
# one epilogue forward, one epilogue backward in top mode and two dual
# backwards); the time limit of the spawned ranks
DP_BATCH = 512
DP_DRAW_SEED = 4
DP_WORLD = 2
DP_STEP_LAUNCHES = {"dual_mlp_trunk": 2, "dual_mlp_seg": 2, "neddf_epilogue": 2,
                    "neddf_epilogue_gstack": 2, "dual_mlp_seg_bwd": 4}
DP_F32_TOL = 1e-5  # f32: two half-batch means summed in another order
DP_TIMEOUT = 300.0
DP_STEP_REPS = 5
DP_EVAL_DOWNSAMPLING = 8
DP_EVAL_TOL = 1e-3  # two ranks' gathered render vs one process's: chunk halves


def dp_step_inputs(torch) -> dict:
    """The default config's step (NeDDF on bunny_smoke, width 256) from
    seeded parameters: its config, camera 0's images and camera, the
    parameters and the draws of ``DP_BATCH`` rays, as host arrays (the
    ranks take them instead of decoding the dataset again)."""
    trainer = family_trainer(torch, "neddf")
    render = trainer.neural_render
    shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
    draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                               render.sample_coarse + 1, render.sample_fine + 1,
                               seed=DP_DRAW_SEED, batch=DP_BATCH)
    out = {"cfg": trainer.config, "params": family_params(shapes), "draws": draws,
           "rgb": trainer.rgb_images[0].cpu().numpy(), "mask": trainer.mask_images[0].cpu().numpy(),
           "calib": trainer.calib.params.cpu().numpy(),
           "camera": trainer.camera_initials[0].cpu().numpy(),
           "iteration": MACHINE_ITERATION, "device": str(trainer.device)}
    del trainer
    torch.cuda.empty_cache()
    return out


def dp_local_step(torch, inp: dict, device):
    """(renderer, local(rows)) of the library-level step on ``inp``: the
    step's math (``step.py::accumulate_grads``) over rows of the drawn
    batch, as ``NeRFTrainer.local_grads`` runs it."""
    from neddf_tpu_torch import config as config_lib
    from neddf_tpu_torch.geometry.camera import PinholeCalib
    from neddf_tpu_torch.geometry.se3 import camera_pose
    from neddf_tpu_torch.training.step import accumulate_grads, construct_targets
    from neddf_tpu_torch.training.trainer import build_renderer

    cfg = inp["cfg"]
    render = build_renderer(cfg, 0, device)
    render.load_state_dict({k: torch.from_numpy(v) for k, v in inp["params"].items()})
    losses = [config_lib.instantiate(fn) for fn in cfg["loss"]["functions"]]
    us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=device) for x in inp["draws"])
    us, vs = us.long(), vs.long()
    targets = construct_targets([fn.key_target for fn in losses],
                                torch.as_tensor(inp["rgb"], device=device),
                                torch.as_tensor(inp["mask"], device=device), us, vs)
    calib = PinholeCalib(torch.as_tensor(inp["calib"], dtype=torch.float32, device=device))
    init = torch.as_tensor(inp["camera"], dtype=torch.float32, device=device)
    uv = torch.stack([us, vs], dim=1)

    def local(rows=slice(None)):
        return accumulate_grads(render, losses, calib,
                                lambda: camera_pose(init, torch.zeros_like(init)), uv, targets,
                                u_strat, u_pdf, inp["iteration"], 1, None, rows)

    return render, local


def dp_numbers(render, loss, loss_dict, mse) -> dict:
    return {"loss": loss.item(), "mse": mse.item(),
            "losses": {k: v.item() for k, v in loss_dict.items()},
            "grad_norms": {n: p.grad.norm().item() for n, p in render.named_parameters()}}


def dp_rank(rank: int, world: int, store: str, inp: dict, eval_inp: dict) -> None:
    """One rank of phase 20a, on ``inp["device"]`` (cuda:0) beside the
    other, in a gloo group:
    per precision the single-process step and the library-level
    ``make_sharded_grads`` step on the same draws (counts set to 0 just
    before the sharded step and read just after), ms per sharded step,
    then the sharded eval render's launches; results into
    ``OUT/dp_rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    from neddf_tpu_torch.geometry.camera import PinholeCalib
    from neddf_tpu_torch.parallel import make_sharded_grads, make_sharded_render
    from neddf_tpu_torch.training.trainer import build_renderer

    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        render, local = dp_local_step(torch, inp, dev)
        params = list(render.parameters())
        sharded = make_sharded_grads(None, DP_BATCH, 1)

        def step(fn):
            for p in params:
                p.grad = None
            return fn(local, params, None)

        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            render.network_fine.compute_dtype = dtype
            for p in params:
                p.grad = None
            single = dp_numbers(render, *local())
            reset_path_counts()
            got = step(sharded)
            torch.cuda.synchronize()
            counts = read_path_counts(f"[20a] rank {rank} {name} sharded step",
                                      tuple(DP_STEP_LAUNCHES))
            out[name] = {"single": single, "sharded": dp_numbers(render, *got), **counts}
        times = []
        for _ in range(DP_STEP_REPS + 1):
            torch.cuda.synchronize()
            dist.barrier()
            start = time.perf_counter()
            step(sharded)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - start))
        out["ms_per_step"] = times[1:]

        # the sharded eval render of machine_neddf's test camera 0: gathered
        # as host copies (gloo's all_gather takes CPU tensors)
        eval_render = build_renderer(eval_inp["cfg"], 0, dev)
        eval_render.load_state_dict(
            {k: torch.from_numpy(v) for k, v in eval_inp["params"].items()})
        shard = make_sharded_render(None)
        r, t = (torch.as_tensor(x, device=dev) for x in eval_inp["pose"])
        calib = PinholeCalib(torch.as_tensor(eval_inp["calib"], device=dev))
        reset_path_counts()
        image = eval_render.render_image(
            calib, r, t, eval_inp["width"], eval_inp["height"], ["color", "depth"],
            eval_inp["downsampling"], eval_inp["chunk"],
            generator=torch.Generator(device=dev).manual_seed(0),
            render_fn=lambda program: shard(
                lambda *a: {k: v.cpu() for k, v in program(*a).items()}))
        out["eval"] = read_path_counts(f"[20a] rank {rank} sharded eval render",
                                       ("dual_mlp_trunk", "mlp_seg"))
        out["eval_color"] = image["color"]
    finally:
        torch.save(out, OUT / f"dp_rank{rank}.pt")
        dist.destroy_process_group()


def join_ranks(context, seconds: float, what: str) -> None:
    """Wait for spawned ranks; past ``seconds`` end them and fail."""
    deadline = time.monotonic() + seconds
    while not context.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
            fail(f"{what}: the ranks did not end within {seconds:.0f} s")


def phase_data_parallel(torch, card: str) -> dict:
    """Phase 20: (b) NCCL at world size 1 here, bitwise against the single
    path; (a) two gloo ranks of the library-level sharded step on the one
    card; (c) the trainer refusing more ranks than cards."""
    import numpy as np
    import torch.distributed as dist

    from neddf_tpu_torch.parallel import make_sharded_grads, make_sharded_render
    from neddf_tpu_torch.scripts import run as run_script
    from neddf_tpu_torch.scripts.run_eval import load_trainer
    from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
    from neddf_tpu_torch.training.trainer import launch_world

    out = {}
    start = time.perf_counter()
    inp = dp_step_inputs(torch)
    dev = torch.device(inp["device"])

    # ---- (b) NCCL at world size 1: the step and the eval render, bitwise
    store = OUT / f"dp_nccl_store_{time.time_ns()}"
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        render, local = dp_local_step(torch, inp, dev)
        params = list(render.parameters())
        single = local()
        single_grads = [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        reset_path_counts()
        got = make_sharded_grads(None, DP_BATCH, 1)(local, params, None)
        torch.cuda.synchronize()
        step_counts = read_path_counts("[20b] NCCL world-1 step", tuple(DP_STEP_LAUNCHES))
        same = all(torch.equal(a, b) for a, b in zip(single_grads, (p.grad for p in params)))
        same = same and torch.equal(got[0], single[0]) and torch.equal(got[2], single[2]) and all(
            torch.equal(got[1][k], v) for k, v in single[1].items())
        log(f"[20b] NCCL world 1, the default step ({DP_BATCH} rays, bf16, seeded params): "
            f"bitwise equal to the single-process step: {same}; launches "
            f"{step_counts['launches']}")
        if not same:
            fail("[20b] the world-1 sharded step is not bitwise the single-process step")
        del render, local, params, single_grads
        trainer = load_trainer(OUT / "machine_neddf", EPOCH)
        w, h = trainer.dataset.image_width, trainer.dataset.image_height
        with torch.no_grad():
            r, t = trainer.camera_pose(0)
        kwargs = dict(target_types=["color", "depth"], downsampling=DP_EVAL_DOWNSAMPLING,
                      chunk=trainer.chunk)
        want = trainer.neural_render.render_image(
            trainer.calib, r, t, w, h, generator=torch.Generator(device=dev).manual_seed(0),
            **kwargs)
        reset_path_counts()
        got_img = trainer.neural_render.render_image(
            trainer.calib, r, t, w, h, generator=torch.Generator(device=dev).manual_seed(0),
            render_fn=make_sharded_render(None), **kwargs)
        torch.cuda.synchronize()
        render_counts = read_path_counts("[20b] NCCL world-1 eval render",
                                         ("dual_mlp_trunk", "mlp_seg"))
        same_img = all(np.array_equal(got_img[k], want[k]) for k in want)
        log(f"[20b] NCCL world 1, machine_neddf cam 0 at downsampling 8: bitwise equal to the "
            f"single-process render: {same_img}; launches {render_counts['launches']}")
        if not same_img:
            fail("[20b] the world-1 sharded render is not bitwise the single-process render")
        eval_inp = {"cfg": trainer.config, "pose": (r.cpu().numpy(), t.cpu().numpy()),
                    "params": {k: v.numpy() for k, v in params_from_jax(load_msgpack_params(
                        RUN / "models" / f"model_{EPOCH:05}.ckpt")).items()},
                    "calib": trainer.calib.params.cpu().numpy(), "width": w, "height": h,
                    "downsampling": DP_EVAL_DOWNSAMPLING, "chunk": trainer.chunk}
        want_color = want["color"]
        out["nccl_world1"] = {"step_bitwise": same, "render_bitwise": same_img,
                              "step_launches": step_counts["launches"],
                              "render_launches": render_counts["launches"]}
        del trainer
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    # ---- (a) two gloo ranks on the one card: the library-level sharded step
    store = OUT / f"dp_gloo_store_{time.time_ns()}"
    for r in range(DP_WORLD):
        (OUT / f"dp_rank{r}.pt").unlink(missing_ok=True)
    context = torch.multiprocessing.start_processes(
        dp_rank, args=(DP_WORLD, f"file://{store}", inp, eval_inp), nprocs=DP_WORLD,
        join=False, start_method="spawn")
    try:
        join_ranks(context, DP_TIMEOUT, "[20a]")
    finally:
        store.unlink(missing_ok=True)
    ranks = [torch.load(OUT / f"dp_rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    for rank in ranks:
        for name in ("float32", "bfloat16"):
            got, ref = rank[name]["sharded"], rank[name]["single"]
            if name == "float32":
                worst = max([check_close(f"[20a] f32 {k}", got[k], ref[k], DP_F32_TOL)
                             for k in ("loss", "mse")]
                            + [check_close(f"[20a] f32 loss {k}", got["losses"][k], v, DP_F32_TOL)
                               for k, v in ref["losses"].items()]
                            + [check_close(f"[20a] f32 grad norm {k}", got["grad_norms"][k], v,
                                           DP_F32_TOL) for k, v in ref["grad_norms"].items()])
                gaps = {"worst_rel": worst}
            else:
                worst_loss, worst_grad = bf16_step_gaps(got, ref)
                gaps = {"worst_loss_rel": worst_loss, "worst_grad_norm_rel": worst_grad}
            launches = {k: rank[name]["launches"].get(k, 0) for k in DP_STEP_LAUNCHES}
            if launches != DP_STEP_LAUNCHES:
                fail(f"[20a] rank {rank['rank']} {name}: launches {launches}, expected "
                     f"{DP_STEP_LAUNCHES}")
            check_routes(f"[20a] rank {rank['rank']} {name}", rank[name]["routes"],
                         "tc" if name == "bfloat16" else "tf32x3")
            rank[name]["gaps"] = gaps
            log(f"[20a] rank {rank['rank']} {name}: sharded step vs the single-process step on "
                f"the same draws: {json.dumps(gaps)} (bars: f32 {DP_F32_TOL}, bf16 "
                f"{json.dumps(BF16_STEP_TOL)}); launches {rank[name]['launches']}, routes "
                f"{rank[name]['routes']['products']}, plain calls {rank[name]['plain_calls']}")
        log(f"[20a] rank {rank['rank']}: {statistics.median(rank['ms_per_step']):.2f} ms per "
            f"sharded bf16 step (median of {DP_STEP_REPS}: {rank['ms_per_step']}), two ranks "
            f"sharing ONE card over gloo, not a data-parallel speed; the library's all_reduce "
            f"of CUDA tensors over gloo | card: {card}")
        log(f"[20a] rank {rank['rank']}: the sharded eval render (machine_neddf cam 0, "
            f"downsampling 8, gathered over gloo): launches {rank['eval']['launches']}")
    if not np.array_equal(ranks[0]["eval_color"], ranks[1]["eval_color"]):
        fail("[20a] the ranks' gathered eval images differ")
    # the gathered image against phase 20b's single-process render of the
    # same checkpoint, camera, downsampling and generator seed (the halved
    # chunks' products may sum in another order)
    eval_err = float(np.abs(np.asarray(ranks[0]["eval_color"], np.float64)
                            - np.asarray(want_color, np.float64)).max())
    log(f"[20a] the gathered eval image vs the single-process render: max abs err "
        f"{eval_err:.3e} (bar {DP_EVAL_TOL})")
    if not eval_err <= DP_EVAL_TOL:
        fail(f"[20a] the two-rank eval render is {eval_err:.3e} from the single-process "
             f"render (bar {DP_EVAL_TOL})")
    out["eval_vs_single_max_abs_err"] = eval_err
    out["gloo_two_ranks"] = [{k: v for k, v in rank.items() if k != "eval_color"}
                             for rank in ranks]

    # ---- (c) more ranks than cards: refused before any training starts
    refused = OUT / "dp_refused"
    if refused.exists():
        shutil.rmtree(refused)
    try:
        run_script.main(["trainer.mesh.data=2", f"hydra.run.dir={refused}"])
    except ValueError as err:
        message = str(err)
    else:
        fail("[20c] scripts/run.py trainer.mesh.data=2 trained on one card")
    if "needs 2 devices" not in message or refused.exists():
        fail(f"[20c] trainer.mesh.data=2 on one card: {message!r}, run dir made: "
             f"{refused.exists()}")
    auto = launch_world({"data": "auto", "model": 1}, "tpu")
    log(f"[20c] trainer.mesh.data=2 refused before the run dir is made: {message!r}; "
        f"data: auto resolves to {auto} (the single-process path, phase 8's run)")
    if auto is not None:
        fail("[20c] data: auto on one card is not the single-process path")
    out["refused"] = message
    out["wall_s"] = time.perf_counter() - start
    log(f"[20] the data-parallel phase took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------- phase 24
# the per-layer route of the kernels (tensor parallelism's column shards,
# widths over 512): (a) its kernel modes against their plain versions at
# the fine pass's rows, timed; (b) NeDDF with both trunks 1024 wide on the
# card (the route with one shard); (c) tensor parallelism over two gloo
# ranks sharing the card (data 1 x model 2)
TP_ROWS = 512 * 194  # the fine pass of 512 rays
TP_WIDTH = 1024
TP_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
TP_TRUNK_LAYOUT = tuple(li == 5 for li in range(7))  # NeDDF's trunk: [embed, h] at layer 5
# the route's wrappers on the training path and in the eval render, and the
# fused route's, which it never launches
TP_RUN_KERNELS = ("dual_mlp_layers", "neddf_epilogue", "neddf_epilogue_bwd")
TP_EVAL_KERNELS = ("mlp_seg_layers",)
FUSED_KERNELS = ("dual_mlp_trunk", "dual_mlp_seg", "dual_mlp_seg_bwd", "neddf_epilogue_gstack",
                 "mlp_seg")
TP_WORLD = 2
TP_RANK_TIMEOUT = 420.0
TP_F32_TOL = 1e-5  # two ranks' f32 step vs one rank's: the column shards' sums
TP_EVAL_GAP_DB = 0.05
# phase 24b's run: trainer.epoch_max (200 steps; 300 before phase 26 took
# its share of the smoke's time limit: its PSNR rose 6.7 dB in 300)
TP_RUN_EPOCHS = 1
# phase 24c: (width, rays) of the two ranks' steps, both ranks on the one
# card: gloo moves each layer's gather through the host (two ranks sharing
# a card are no TP speed; a 512-ray step took 8 s), so the steps are
# small, and the 1024-wide f32 route keeps every layer's input and stash
TP_RANK_STEPS = ((256, 128), (TP_WIDTH, 32))


def _route_fwd_work(s, m, ks, n, dtype_name, stash):
    e = 2 if dtype_name == "bfloat16" else 4
    k = sum(ks)
    return 2.0 * s * m * k * n, (s * m * k + k * n + s * m * n * (2 if stash else 1)) * e + 4 * n


def _route_bound(flops, nbytes, dtype_name):
    return bound(flops, nbytes, "bfloat16" if dtype_name == "bfloat16" else "tf32x3")


def epilogue_cases(torch, g, rnd, m: int, n: int, e: int, hold) -> dict:
    """The epilogue forward (#5) and its standalone backward (#6) at width
    ``n`` over ``m`` rows against their plain versions on the same inputs
    (``rnd`` draws them in the operand type of ``e`` bytes from ``g``;
    ``hold(name, got, want)`` holds each output to its bar and returns its
    max abs error), timed (CUDA events, kernel and plain in turns), with
    their bounds; two backward runs must give bitwise-equal dwd, dwa and
    db2 (summed over blocks in a fixed order)."""
    from neddf_tpu_torch.kernels import neddf_epilogue as epi

    dev = g.device
    out = {}
    v, j = rnd(m, n, scale=0.3), rnd(3, m, n, scale=0.3)
    wd = torch.randn(n, generator=g, device=dev) * n ** -0.5
    wa = torch.randn(n, generator=g, device=dev) * n ** -0.5
    b2 = torch.tensor([0.3, -0.2], device=dev)
    scal = torch.tensor([0.01, 0.8, 1.5, 0.05, 0.05, 1.0, 1.0, 0.0], device=dev)
    g_out = torch.randn((10, m), generator=g, device=dev)
    g_t = rnd(m, n, scale=0.1)
    fwd = (v, j, wd, wa, b2, scal, DENSITY)
    got, want = epi.neddf_epilogue(*fwd), epi.neddf_epilogue_plain(*fwd)
    torch.cuda.synchronize()
    err = max(hold("epilogue out", got[0], want[0]), hold("epilogue t_feat", got[1], want[1]))
    del got, want
    ms, plain_ms = time_pair(torch, lambda: epi.neddf_epilogue(*fwd),
                             lambda: epi.neddf_epilogue_plain(*fwd))
    out["epilogue"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                       **bound(2.0 * 8 * m * n + 3.0 * 2 * m * n,
                               5 * m * n * e + 10 * m * 4 + 2 * n * 4, "float32")}
    bwd = (v, j, wd, wa, b2, scal, g_out, g_t, DENSITY)
    got, want = epi.neddf_epilogue_bwd(*bwd), epi.neddf_epilogue_bwd_plain(*bwd)
    torch.cuda.synchronize()
    err = max(hold(f"epilogue_bwd {i}", a, c) for i, (a, c) in enumerate(zip(got, want)))
    del want
    again = epi.neddf_epilogue_bwd(*bwd)
    if not all(torch.equal(a, c) for a, c in zip(got[2:], again[2:])):
        fail(f"the epilogue backward at width {n}: dwd, dwa, db2 differ over two runs")
    del got, again
    ms, plain_ms = time_pair(torch, lambda: epi.neddf_epilogue_bwd(*bwd),
                             lambda: epi.neddf_epilogue_bwd_plain(*bwd))
    out["epilogue_bwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None,
                           **bound(2.0 * 2 * 8 * m * n, 9 * m * n * e + 4 * m * 4 + 4 * n * 4,
                                   "float32")}
    del v, j, g_t, fwd, bwd
    torch.cuda.empty_cache()
    return out


def walk_route_products(fn, what: str):
    """(fn(), the plain products it launched by kernel: route_nt,
    route_tn, shallow_nt): a walk backward's plain products on
    route_nt and route_tn (fails unless both launched; the sweep's
    adjoint runs on route_nt with its epilogue, counted apart)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    before = product_kernel(dm)
    got = fn()
    ran = dict(zip(("nt", "tn", "tc"), (a - b for a, b in zip(product_kernel(dm), before))))
    if ran["nt"] < 1 or ran["tn"] < 1:
        fail(f"{what}: products launched {ran}: route_nt and route_tn expected")
    return got, ran


def tp_route_cases(torch, dev, dtype_name: str) -> dict:
    """Phase 24a at one operand type: every new mode of the per-layer route
    against its plain version at TP_ROWS rows and width TP_WIDTH, timed
    (kernel, plain, ``torch.addmm`` on the same operands where one call
    computes the product), with its bound; and the K=3 trunk's whole walk,
    forward and backward."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    e = 2 if dtype_name == "bfloat16" else 4
    g = torch.Generator(device=dev).manual_seed(24)
    k, kp = dm.DualProducts(dtype, dev), dm.DualProductsPlain(dtype)
    m, n = TP_ROWS, TP_WIDTH
    tol = TP_TOL[dtype_name]
    out = {}

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def hold(name, got, want):
        err, rel = rel_err(torch, got, want)
        if not torch.isfinite(got).all() or not rel <= tol:
            fail(f"[24a] {name} {dtype_name}: rel err {rel:.3g} > {tol}")
        return err

    # the layer forward: the K=3 trunk's hidden and post-skip layers, the K=1
    # colour trunk's layer 0, the value-only eval colour's layer 0
    for name, s, ks, act, stash in (("fwd_trunk", 4, (n,), "tanhExp", True),
                                    ("fwd_trunk_skip", 4, (60, n), "tanhExp", True),
                                    ("fwd_color", 2, (87, n), "tanhExp", True),
                                    ("fwd_value", 1, (87, n), "tanhExp", False)):
        xs = [rnd(s, m, kk) for kk in ks]
        w = rnd(sum(ks), n, scale=sum(ks) ** -0.5)
        b = torch.randn(n, generator=g, device=dev) * 0.1
        got = k.layer_fwd(xs, w, b, act, stash)
        want = kp.layer_fwd(xs, w, b, act, stash)
        torch.cuda.synchronize()
        err = max(hold(name, a, c) for a, c in zip(got, want) if a is not None)
        # device time, as torch.addmm's: three launches back to back a reading;
        # beside it one launch alone (the host's time before the kernel starts
        # included)
        ms, plain_ms = time_pair(torch, lambda: k.layer_fwd(xs, w, b, act, stash),
                                 lambda: kp.layer_fwd(xs, w, b, act, stash), inner=3)
        ms_one = time_one(torch, lambda: k.layer_fwd(xs, w, b, act, stash), inner=1)
        x2d = torch.cat(xs, dim=-1).view(s * m, sum(ks))
        bt = b.to(dtype)
        library_ms = time_one(torch, lambda: torch.addmm(bt, x2d, w), inner=3)
        out[name] = {"max_abs_err": err, "ms": ms, "ms_one_launch": ms_one, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     **_route_bound(*_route_fwd_work(s, m, ks, n, dtype_name, stash), dtype_name)}
        del xs, w, got, want, x2d

    # gstack from f32 cotangents (the cotangent after the gather's backward)
    z = rnd(4, m, n)
    gg = torch.randn((4, m, n), generator=g, device=dev)
    got = k.gstack(gg[0], gg[1:], z, "tanhExp")
    want = kp.gstack(gg[0], gg[1:], z, "tanhExp")
    torch.cuda.synchronize()
    err = max(hold("gstack", got[0], want[0]), hold("gstack db", got[1], want[1]))
    ms, plain_ms = time_pair(torch, lambda: k.gstack(gg[0], gg[1:], z, "tanhExp"),
                             lambda: kp.gstack(gg[0], gg[1:], z, "tanhExp"))
    out["gstack_f32"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                         **bound(10.0 * 4 * m * n, 4 * m * n * (4 + 2 * e) + 4 * n, "float32")}
    del z, gg, got, want

    # the epilogue past 512 (#5, #6's standalone mode, the route's)
    out.update(epilogue_cases(torch, g, rnd, m, n, e, hold))

    # the K=3 trunk's whole walk at width 1024 (7 layers, [embed, h] at
    # layer 5): the route's #1 forward with its stash and #2 backward
    e0 = rnd(m, 60)
    j0 = rnd(3, m, 60)
    ws, bs, fans = [], [], []
    for li, skip in enumerate(TP_TRUNK_LAYOUT):
        fan = 60 if li == 0 else n + 60 * skip
        fans.append(fan)
        ws.append(rnd(fan, n, scale=1.5 * fan ** -0.5))
        bs.append(torch.randn(n, generator=g, device=dev) * 0.1)
    args = ([e0], [j0], ws, bs, TP_TRUNK_LAYOUT, "tanhExp", (True,), 3)

    def walk(launcher, stash=True):
        return dm.dual_mlp_layers_walk(*args, launcher, stash=stash)

    full, ins, pres = walk(k)
    pfull, pins, ppres = walk(kp)
    torch.cuda.synchronize()
    err_f = hold("walk forward", full, pfull)
    gtop = torch.randn((4, m, n), generator=g, device=dev)

    def walk_bwd(launcher, x, z):
        return dm.dual_mlp_layers_bwd(x, ws, TP_TRUNK_LAYOUT, "tanhExp", [60], (True,), z, gtop,
                                      launcher)

    got, routed = walk_route_products(lambda: walk_bwd(k, ins, pres), "[24a] walk backward")
    want = walk_bwd(kp, pins, ppres)
    torch.cuda.synchronize()
    err_b = max(hold(f"walk backward {i}", a, c) for gs_, ws_ in zip(got, want)
                for i, (a, c) in enumerate(zip(gs_, ws_)))
    del got, want, pfull, pins, ppres
    torch.cuda.empty_cache()
    flops_f = sum(2.0 * 4 * m * f * n for f in fans)
    bytes_f = (4 * m * 60 + 4 * m * n * 2 * len(fans) + sum(f * n for f in fans)) * e \
        + 4 * n * len(fans)
    ms, plain_ms = time_pair(torch, lambda: walk(k), lambda: walk(kp))
    out["walk_fwd"] = {"max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                       **_route_bound(flops_f, bytes_f, dtype_name)}
    # the backward's inputs: every layer's input and stash, the weights, g;
    # its outputs: dW and db (f32) and the input cotangents
    bytes_b = (sum(4 * m * f for f in fans) + 4 * m * n * len(fans) + sum(f * n for f in fans)
               + 4 * m * 60) * e + 4 * m * n * 4 + sum(f * n + n for f in fans) * 4
    ms, plain_ms = time_pair(torch, lambda: walk_bwd(k, ins, pres),
                             lambda: walk_bwd(kp, ins, pres))
    out["walk_bwd"] = {"max_abs_err": err_b, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                       "route_products_per_call": routed,
                       **_route_bound(2.0 * flops_f, bytes_b, dtype_name)}
    del full, ins, pres, gtop, ws
    torch.cuda.empty_cache()
    return out


# the layer forward's grid beside the main paths' shapes (24a: the dual
# trunks' S = 2 and 4; 25a: the value-only S = 1): N = 3 (the narrow
# kernel), 45 and 257 (the wide one at ragged column tiles) under every
# activation, at LAYER_GRID_ROWS points of two K segments
LAYER_GRID_ROWS = 20011
LAYER_GRID_WIDTHS = (3, 45, 257)
LAYER_GRID_ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")


def layer_fwd_grid(torch, dev, dtype_name: str, streams, tag: str) -> dict:
    """Both layer-forward kernels against the plain version over the grid
    (bf16 segments [87 | 1024], which the wide launcher pads; f32 [1024 |
    36], which TMA takes as they are), within TP_TOL; under ReLU and
    LeakyReLU the tangent outputs only where the plain z_v is not within
    1e-3 of 0 (a pre-activation within a rounding of the kink may take the
    other side in the plain sums). Returns the cases, the largest error
    and the launches by kernel."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    ks = (87, 1024) if dtype_name == "bfloat16" else (1024, 36)
    k, kp = dm.Products(dtype, dev), dm.ProductsPlain(dtype)
    g = torch.Generator(device=dev).manual_seed(17)
    before = dict(dm.LAYER_FWD_LAUNCHES)
    worst, cases = 0.0, 0
    for n in LAYER_GRID_WIDTHS:
        for s in streams:
            for act in LAYER_GRID_ACTS:
                xs = [torch.randn((s, LAYER_GRID_ROWS, kk), generator=g, device=dev).to(dtype)
                      for kk in ks]
                w = (torch.randn((sum(ks), n), generator=g, device=dev)
                     * sum(ks) ** -0.5).to(dtype)
                b = torch.randn(n, generator=g, device=dev) * 0.5
                out, z = k.layer_fwd(xs, w, b, act, True)
                pout, pz = kp.layer_fwd(xs, w, b, act, True)
                torch.cuda.synchronize()
                pairs = [("stash", z, pz), ("value", out[0], pout[0])]
                if s > 1:
                    t, pt = out[1:].float(), pout[1:].float()
                    if act in ("ReLU", "LeakyReLU"):
                        far = (pz[0].float().abs() > 1e-3)[None]
                        t, pt = t * far, pt * far
                    pairs.append(("tangents", t, pt))
                for what, a, c in pairs:
                    err, rel = rel_err(torch, a, c)
                    if not torch.isfinite(a).all() or not rel <= TP_TOL[dtype_name]:
                        fail(f"[{tag}] layer forward N={n} S={s} {act} {dtype_name} {what}: "
                             f"rel err {rel:.3g} > {TP_TOL[dtype_name]}")
                    worst = max(worst, err)
                cases += 1
                del xs, w, out, z, pout, pz
    launches = {key: dm.LAYER_FWD_LAUNCHES[key] - before[key] for key in before}
    per = len(streams) * len(LAYER_GRID_ACTS)
    if launches != {"narrow": per, "wide": 2 * per}:
        fail(f"[{tag}] the layer forward's grid launched {launches}")
    torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": worst, "launches": launches}


def log_layer_grid(tag: str, dtype_name: str, grid: dict, streams, card: str) -> None:
    log(f"[{tag}] layer forward grid {dtype_name}: {grid['cases']} cases (N "
        f"{LAYER_GRID_WIDTHS} x S {tuple(streams)} x {len(LAYER_GRID_ACTS)} activations, "
        f"{LAYER_GRID_ROWS} points), max abs err {grid['max_abs_err']:.3g}, launches "
        f"{grid['launches']} | card: {card}")


def phase_tp_kernels(torch, card: str) -> dict:
    """Phase 24a: ``tp_route_cases`` in f32 and bf16, and the layer
    forward's grid at S = 2 and 4."""
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    out = {}
    for dtype_name in ("float32", "bfloat16"):
        out[f"grid/{dtype_name}"] = grid = layer_fwd_grid(torch, dev, dtype_name, (2, 4), "24a")
        log_layer_grid("24a", dtype_name, grid, (2, 4), card)
        cases = tp_route_cases(torch, dev, dtype_name)
        for name, r in cases.items():
            log(f"[24a] {name} {dtype_name} (rows {TP_ROWS}, width {TP_WIDTH}): max abs err "
                f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms{one_launch(r)}, plain "
                f"{r['plain_ms']:.4f} ms, "
                f"torch.addmm {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) | card: {card}")
        out[dtype_name] = cases
    out["wall_s"] = time.perf_counter() - start
    log(f"[24a] took {out['wall_s']:.1f} s")
    return out


def layer_forward_counts(what: str, counts: dict) -> dict:
    """``counts["layer_forward"]``, the per-layer route's layer forwards of
    ``counts`` (read just after a path was driven): by walk ("fwd", the
    dual trunks'; "fwd_value", the value-only ones), by kernel ("narrow",
    "wide"; csrc/layer_fwd.cu), the wide ones by stream count ("s1",
    "s2", "s4"), and the host seconds spent in ``Products.layer_fwd``
    ("host_s"). Fails unless every one went through a new kernel, the
    wide one among them (the plain layer forward's calls are
    ``read_path_counts``'s plain calls)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    routes = counts["routes"]
    kernels, streams = routes["layer_forward_kernels"], routes["layer_forward_wide_streams"]
    if (sum(kernels.values()) != sum(dm.ROUTE_LAUNCHES.values()) or kernels["wide"] < 1
            or sum(streams.values()) != kernels["wide"]):
        fail(f"{what}: layer forwards {dict(dm.ROUTE_LAUNCHES)}, by kernel {kernels}, the "
             f"wide ones by streams {streams}")
    counts["layer_forward"] = {**dm.ROUTE_LAUNCHES, **kernels, **streams,
                               "host_s": routes["layer_forward_host_s"]}
    return counts


def one_launch(r: dict) -> str:
    """A layer forward's single-launch reading beside its three-launch one
    in a log line (empty for the other modes)."""
    return f" (one launch alone {r['ms_one_launch']:.4f} ms)" if "ms_one_launch" in r else ""


def layer_forward_host(what: str, counts: dict, steps: int, ms_step: float) -> dict:
    """The host's time in ``Products.layer_fwd`` over a run of ``steps``
    steps (``layer_forward_counts``; the run's test renders' forwards in):
    ms per call, ms per step and its share of the untraced ms/step."""
    lf = counts["layer_forward"]
    calls = lf["narrow"] + lf["wide"]
    per_step = 1000.0 * lf["host_s"] / steps
    out = {"calls_per_step": calls / steps, "ms_per_call": 1000.0 * lf["host_s"] / calls,
           "ms_per_step": per_step, "share_of_step": per_step / ms_step}
    log(f"{what}: the host in Products.layer_fwd {out['ms_per_call']:.4f} ms per call, "
        f"{out['calls_per_step']:.2f} calls and {per_step:.3f} ms per step, "
        f"{out['share_of_step']:.3f} of the {ms_step:.2f} ms step")
    return out


def route_product_counts(what: str, counts: dict) -> dict:
    """``counts["route_products"]``: the per-layer route's plain products of
    a path (read just after it was driven), by kernel (route_nt, route_tn;
    csrc/route_products.cu) and the host seconds in ``Products.nt`` /
    ``.tn`` on them; fails unless both launched (shallow_nt takes
    nothing but an nt of a depth under 8; the plain versions' calls are
    ``read_path_counts``'s plain calls)."""
    routes = counts["routes"]
    launches = routes["route_products"]
    if min(launches.values()) < 1:
        fail(f"{what}: the route's products launched {launches}: route_nt and route_tn expected")
    counts["route_products"] = {**launches, "host_s": routes["route_products_host_s"]}
    return counts


def route_product_host(what: str, counts: dict, steps: int, ms_step: float) -> dict:
    """The host's time in ``Products.nt`` / ``.tn`` on route_nt and route_tn
    over a run of ``steps`` steps (``route_product_counts``): calls per
    step, ms per call, ms per step and its share of the untraced ms/step."""
    rp = counts["route_products"]
    calls = rp["nt"] + rp["tn"]
    per_step = 1000.0 * rp["host_s"] / steps
    out = {"nt_per_step": rp["nt"] / steps, "tn_per_step": rp["tn"] / steps,
           "ms_per_call": 1000.0 * rp["host_s"] / calls, "ms_per_step": per_step,
           "share_of_step": per_step / ms_step}
    log(f"{what}: route_nt {out['nt_per_step']:.2f} and route_tn {out['tn_per_step']:.2f} "
        f"launches per step; the host in Products.nt/.tn {out['ms_per_call']:.4f} ms per call, "
        f"{per_step:.3f} ms per step, {out['share_of_step']:.3f} of the {ms_step:.2f} ms step")
    return out


def tp_route_counts(what: str, needed, backward: bool = True) -> dict:
    """``read_path_counts`` on the per-layer route: every kernel of
    ``needed`` and the layer forward launched (with ``backward``, route_nt
    and route_tn too: ``route_product_counts``), no fused wrapper, no
    plain version."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    counts = read_path_counts(what, needed)
    fused = {k: counts["launches"].get(k, 0) for k in FUSED_KERNELS}
    if any(fused.values()) or dm.ROUTE_LAUNCHES["fwd"] < 1:
        fail(f"{what}: the fused route launched {fused}, the layer forward "
             f"{dict(dm.ROUTE_LAUNCHES)}")
    counts = layer_forward_counts(what, counts)
    return route_product_counts(what, counts) if backward else counts


def phase_tp_run(torch, card: str) -> dict:
    """Phase 24b: NeDDF with both trunks TP_WIDTH wide on the card (the
    per-layer route with one shard): its f32 step from the seeded
    parameters against the JAX package (TP_STEP_REF), a 200-step run
    through scripts/run.py (bf16, 512 rays: every loss finite, train PSNR
    up >= 3 dB, every launch on the route and no plain call; ms/step, the
    busy share, peak memory) and run_eval of its run dir through the
    kernels and the plain versions within 0.05 dB."""
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    start = time.perf_counter()
    refs = json.loads(TP_STEP_REF.read_text())
    reset_path_counts()
    out = {"step": phase_family_step(torch, card, TP_OVERRIDES, refs, TP_BATCH, "24b")}
    out["step"]["counts"] = tp_route_counts("[24b] the f32 step", TP_RUN_KERNELS)
    run_dir = OUT / "train_neddf_1024"
    reset_path_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = run_main_path(torch, run_dir, [*TP_OVERRIDES["neddf_1024"],
                                             f"trainer.epoch_max={TP_RUN_EPOCHS}",
                                             f"trainer.epoch_save_model={TP_RUN_EPOCHS}"])
    wall = time.perf_counter() - t0
    counts = tp_route_counts("[24b] the 1024-wide run", TP_RUN_KERNELS)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = trainer.history
    if len(hist) != 100 * (TP_RUN_EPOCHS + 1) or not all(
            math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
            for r in hist):
        fail(f"[24b] {len(hist)} logged steps, or a non-finite loss")
    first, last = mean([r["psnr"] for r in hist[:50]]), mean([r["psnr"] for r in hist[-50:]])
    steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
    ms_step = 1000.0 * mean(steady)
    log(f"[24b] 1024-wide NeDDF run: {trainer.iteration} steps in {wall:.1f} s, train PSNR "
        f"{first:.3f} -> {last:.3f} dB (gain bar {PSNR_GAIN_MIN}), {ms_step:.2f} ms/step "
        f"(steps 100-199, bf16, {trainer.batch_size} rays), peak {peak_gib:.2f} GiB; launches "
        f"{counts['launches']}, layer forward {counts['layer_forward']}, products "
        f"{counts['routes']['products']}, plain calls {counts['plain_calls']} | card: {card}")
    if not last - first >= PSNR_GAIN_MIN:
        fail("[24b] the 1024-wide run's train PSNR did not rise")
    host = layer_forward_host("[24b] 1024-wide NeDDF run", counts, trainer.iteration, ms_step)
    route_host = route_product_host("[24b] 1024-wide NeDDF run", counts, trainer.iteration,
                                    ms_step)
    prof = profile_train(torch, trainer, card, "profile_train_neddf_1024.txt",
                         f"{trainer.batch_size} rays, bf16, width {TP_WIDTH}", "24b")
    del trainer
    torch.cuda.empty_cache()
    reset_path_counts()
    ev = evaluate(run_dir, TP_RUN_EPOCHS, cameras=[0], downsampling=8)
    eval_counts = tp_route_counts("[24b] run_eval", TP_EVAL_KERNELS, backward=False)
    gt = ev.dataset[0]["rgb_images"].astype("uint8")[::8, ::8]
    psnrs = {}
    for mode in ("kernels", "plain"):
        ev.neural_render.network_fine.fused = "auto" if mode == "kernels" else "off"
        ev.generator.manual_seed(ev.seed)
        rgb = ev.render_test(run_dir / f"eval_{mode}", 0, 8)
        psnrs[mode] = peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])
    gap = abs(psnrs["kernels"] - psnrs["plain"])
    log(f"[24b] run_eval cam 0 at downsampling 8: {psnrs['kernels']:.4f} dB through the "
        f"kernels (launches {eval_counts['launches']}), {psnrs['plain']:.4f} dB plain, gap "
        f"{gap:.4f} dB (bar {TP_EVAL_GAP_DB})")
    if not gap <= TP_EVAL_GAP_DB:
        fail("[24b] run_eval through the kernels and the plain versions disagree")
    del ev
    torch.cuda.empty_cache()
    out.update({"launches": counts["launches"], "layer_forward": counts["layer_forward"],
                "layer_forward_host": host, "route_products": counts["route_products"],
                "route_product_host": route_host,
                "routes": counts["routes"], "plain_calls": counts["plain_calls"],
                "wall_s": wall, "ms_per_step": ms_step,
                "rays_per_s": 512 / mean(steady), "busy_share": prof["busy_share"],
                "device_ms_per_step": prof["device_ms_per_step"],
                "launches_per_step": prof["launches_per_step"], "peak_memory_gib": peak_gib,
                "psnr_first50": first, "psnr_last50": last, "eval_psnr": psnrs,
                "eval_launches": eval_counts["launches"],
                "eval_layer_forward": eval_counts["layer_forward"]})
    out["phase_s"] = time.perf_counter() - start
    return out


def tp_rank(rank: int, world: int, store: str, inp: dict) -> None:
    """One rank of phase 24c (26c) on cuda:0 beside the other, in a gloo
    group of data 1 x model ``world``: per (width, rays) of
    ``inp["rank_steps"]``, the one-rank step (whole parameters) in each
    dtype of ``inp["dtypes"]``, then the TP step over the rank's column
    shards (``shard_parameters``, ``tp_renderer``, ``make_sharded_grads``;
    counts at 0 just before, read just after), the gathered gradients'
    norms, and (``inp["timed"]``) three more TP steps timed; then, where
    ``inp["eval"]`` is given, machine_neddf cam 0 at downsampling 8,
    rendered whole and over the shards. Results into
    ``OUT/tp_rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from neddf_tpu_torch.geometry.camera import PinholeCalib
    from neddf_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        make_sharded_grads,
        shard_parameters,
        tp_shard_names,
    )
    from neddf_tpu_torch.render.renderer import tp_renderer
    from neddf_tpu_torch.training.trainer import build_renderer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    out = {"rank": rank}
    tag = inp["tag"]
    dtypes = [(name, getattr(torch, name)) for name in inp["dtypes"]]
    try:
        mesh = make_mesh(world)
        for width, batch in inp["rank_steps"]:
            render, local = dp_local_step(torch, inp["steps"][width], dev)
            params = list(render.parameters())
            res = {}
            for name, dtype in dtypes:
                render.network_fine.compute_dtype = dtype
                for p in params:
                    p.grad = None
                res[name] = {"single": dp_numbers(render, *local())}
            names = tp_shard_names(render, world)
            shard_parameters(render, mesh, names)
            tp_renderer(render, mesh.model_group)
            sharded = make_sharded_grads(mesh, batch, 1,
                                         [p for n, p in render.named_parameters() if n in names])
            for name, dtype in dtypes:
                render.network_fine.compute_dtype = dtype
                for p in params:
                    p.grad = None
                reset_path_counts()
                loss, loss_dict, mse = sharded(local, params, None)
                torch.cuda.synchronize()
                counts = tp_route_counts(f"[{tag}] rank {rank} width {width} {name} TP step",
                                         TP_RUN_KERNELS)
                grads = gather_state({n: p.grad for n, p in render.named_parameters()}, mesh,
                                     names)
                res[name]["tp"] = {"loss": loss.item(), "mse": mse.item(),
                                   "losses": {k: v.item() for k, v in loss_dict.items()},
                                   "grad_norms": {k: v.norm().item() for k, v in grads.items()}}
                res[name].update(counts)
            times = []
            for _ in range(3 if inp["timed"] else 0):
                for p in params:
                    p.grad = None
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                sharded(local, params, None)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            res["ms_per_step"] = times[1:]
            out[width] = res
            del render, local, params
            torch.cuda.empty_cache()

        # machine_neddf cam 0 at downsampling 8: whole, then over the shards
        ev = inp["eval"]
        if ev is None:
            return
        render = build_renderer(ev["cfg"], 0, dev)
        render.load_state_dict({k: torch.from_numpy(v) for k, v in ev["params"].items()})
        r, t = (torch.as_tensor(x, device=dev) for x in ev["pose"])
        calib = PinholeCalib(torch.as_tensor(ev["calib"], device=dev))

        def image():
            return render.render_image(calib, r, t, ev["width"], ev["height"], ["color"],
                                       ev["downsampling"], ev["chunk"],
                                       generator=torch.Generator(device=dev).manual_seed(0))

        out["eval_whole"] = image()["color"]
        names = tp_shard_names(render, world)
        shard_parameters(render, mesh, names)
        tp_renderer(render, mesh.model_group)
        reset_path_counts()
        out["eval_tp"] = image()["color"]
        out["eval"] = tp_route_counts(f"[{tag}] rank {rank} TP eval render", TP_EVAL_KERNELS,
                                      backward=False)
    finally:
        torch.save(out, OUT / f"tp_rank{rank}.pt")
        dist.destroy_process_group()


def tp_width_overrides(width: int) -> list:
    """NeDDF's overrides for both trunks ``width`` wide (none at the
    shipped 256)."""
    if width == 256:
        return []
    return [f"network.ddf_layer_width={width}", f"network.col_layer_width={width}"]


def phase_tp_ranks(torch, card: str, rank_steps=TP_RANK_STEPS,
                   dtypes=("float32", "bfloat16"), with_eval: bool = True,
                   tag: str = "24c") -> dict:
    """Phase 24c: two gloo ranks of data 1 x model 2 on the one card
    (``tp_rank``): the f32 TP step within TP_F32_TOL of the one-rank step,
    bf16 within the step bars, each rank's launches on the route, and the
    TP eval render of machine_neddf cam 0 within TP_EVAL_GAP_DB of the
    whole one. Phase 26c passes its own (width, rays), f32 alone and no
    render (``tag`` names the phase in the log)."""
    import numpy as np

    from neddf_tpu_torch.scripts.run_eval import load_trainer
    from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    start = time.perf_counter()
    steps = {}
    for width, batch in rank_steps:
        trainer = family_trainer(torch, "neddf", tp_width_overrides(width))
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=DP_DRAW_SEED, batch=batch)
        steps[width] = {"cfg": trainer.config, "params": family_params(shapes), "draws": draws,
                        "rgb": trainer.rgb_images[0].cpu().numpy(),
                        "mask": trainer.mask_images[0].cpu().numpy(),
                        "calib": trainer.calib.params.cpu().numpy(),
                        "camera": trainer.camera_initials[0].cpu().numpy(),
                        "iteration": MACHINE_ITERATION}
        del trainer, render
        torch.cuda.empty_cache()
    ev = None
    if with_eval:
        ev_trainer = load_trainer(RUN, EPOCH)
        with torch.no_grad():
            pose = ev_trainer.camera_pose(0)
        gt = ev_trainer.dataset[0]["rgb_images"].astype("uint8")
        ev = {"cfg": ev_trainer.config, "pose": tuple(x.cpu().numpy() for x in pose),
              "params": {k: v.numpy() for k, v in params_from_jax(load_msgpack_params(
                  RUN / "models" / f"model_{EPOCH:05}.ckpt")).items()},
              "calib": ev_trainer.calib.params.cpu().numpy(),
              "width": ev_trainer.dataset.image_width,
              "height": ev_trainer.dataset.image_height,
              "downsampling": DP_EVAL_DOWNSAMPLING, "chunk": ev_trainer.chunk}
        del ev_trainer
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    store = OUT / f"tp_gloo_store_{time.time_ns()}"
    for r in range(TP_WORLD):
        (OUT / f"tp_rank{r}.pt").unlink(missing_ok=True)
    inp = {"steps": steps, "eval": ev, "rank_steps": rank_steps, "dtypes": dtypes,
           "timed": "bfloat16" in dtypes, "tag": tag}
    context = torch.multiprocessing.start_processes(
        tp_rank, args=(TP_WORLD, f"file://{store}", inp), nprocs=TP_WORLD, join=False,
        start_method="spawn")
    try:
        join_ranks(context, TP_RANK_TIMEOUT, f"[{tag}]")
    finally:
        store.unlink(missing_ok=True)
    ranks = [torch.load(OUT / f"tp_rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]
    out = {"ranks": []}
    ds = DP_EVAL_DOWNSAMPLING
    for rank in ranks:
        entry = {"rank": rank["rank"]}
        for width, batch in rank_steps:
            res = rank[width]
            for name in dtypes:
                got, ref = res[name]["tp"], res[name]["single"]
                if name == "float32":
                    worst = max([check_close(f"[{tag}] width {width} f32 {k}", got[k], ref[k],
                                             TP_F32_TOL) for k in ("loss", "mse")]
                                + [check_close(f"[{tag}] width {width} f32 loss {k}",
                                               got["losses"][k], v, TP_F32_TOL)
                                   for k, v in ref["losses"].items()]
                                + [check_close(f"[{tag}] width {width} f32 grad norm {k}",
                                               got["grad_norms"][k], v, TP_F32_TOL)
                                   for k, v in ref["grad_norms"].items()])
                    gaps = {"worst_rel": worst}
                else:
                    worst_loss, worst_grad = bf16_step_gaps(got, ref)
                    gaps = {"worst_loss_rel": worst_loss, "worst_grad_norm_rel": worst_grad}
                log(f"[{tag}] rank {rank['rank']} width {width} {name}: the TP step (data 1 x "
                    f"model 2) vs one rank's on the same draws: {json.dumps(gaps)} (bars: f32 "
                    f"{TP_F32_TOL}, bf16 {json.dumps(BF16_STEP_TOL)}); launches "
                    f"{res[name]['launches']}, layer forward {res[name]['layer_forward']}, "
                    f"products {res[name]['routes']['products']}, plain calls "
                    f"{res[name]['plain_calls']}")
                entry[f"{width}/{name}"] = {"gaps": gaps, "launches": res[name]["launches"],
                                            "layer_forward": res[name]["layer_forward"],
                                            "products": res[name]["routes"]["products"],
                                            "passes": res[name]["routes"]["passes"]}
            if res["ms_per_step"]:
                entry[f"{width}/ms_per_step"] = res["ms_per_step"]
                log(f"[{tag}] rank {rank['rank']} width {width}, {batch} rays: "
                    f"{statistics.median(res['ms_per_step']):.2f} ms per TP bf16 step (two "
                    f"ranks sharing ONE card over gloo: not a TP speed) | card: {card}")
        if not with_eval:
            out["ranks"].append(entry)
            continue
        psnr = {k: peak_signal_noise_ratio(
            np.clip(np.asarray(rank[k]) * 255, 0, 255).astype("uint8"),
            gt[::ds, ::ds][: rank[k].shape[0], : rank[k].shape[1]])
            for k in ("eval_whole", "eval_tp")}
        gap = abs(psnr["eval_tp"] - psnr["eval_whole"])
        log(f"[{tag}] rank {rank['rank']} machine_neddf cam 0 at downsampling {ds}: {psnr['eval_tp']:.4f} "
            f"dB over the two ranks' shards, {psnr['eval_whole']:.4f} dB whole, gap {gap:.4f} dB "
            f"(bar {TP_EVAL_GAP_DB}); launches {rank['eval']['launches']}, layer forward "
            f"{rank['eval']['layer_forward']}")
        if not gap <= TP_EVAL_GAP_DB:
            fail(f"[{tag}] the TP render is {gap:.4f} dB from the whole one")
        entry["eval_psnr"] = psnr
        entry["eval_launches"] = rank["eval"]["launches"]
        entry["eval_layer_forward"] = rank["eval"]["layer_forward"]
        out["ranks"].append(entry)
    if with_eval and not np.array_equal(np.asarray(ranks[0]["eval_tp"]),
                                     np.asarray(ranks[1]["eval_tp"])):
        fail(f"[{tag}] the ranks' TP renders differ")
    out["wall_s"] = time.perf_counter() - start
    log(f"[{tag}] took {out['wall_s']:.1f} s")
    return out


def phase_24_alone(torch) -> int:
    """``python3 chip_smoke.py --phase 24``: the build and phase 24 alone
    (its results into ``OUT/phase24.json``), for work on the per-layer
    route; the full smoke runs every phase."""
    from neddf_tpu_torch.kernels import _build

    card = card_line()
    start = time.perf_counter()
    _build.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - start:.1f} s | card: {card}")
    out = {"kernels": phase_tp_kernels(torch, card), "ranks": phase_tp_ranks(torch, card),
           "run": phase_tp_run(torch, card)}
    drop_large_outputs()
    (OUT / "phase24.json").write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps({"ok": True, "phase": 24, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------- phase 25
# NeRF's and NeuS's per-layer route (their tensor parallelism and widths
# over 512): (a) its new kernel modes against their plain versions at the
# paths' rows and width 1024, timed, and the two walks; (b) NeRF-1024
# (bf16) and NeuS-1024 (f32) on one card (the route with one shard); (c)
# NeRF and NeuS at width 256 over two gloo ranks sharing the card (data 1
# x model 2)
TPF_WIDTH = 1024
# rows of the fine pass: NeRF's 1024 rays x 194 samples, NeuS's 1024 x 259
TPF_ROWS = {"nerf": 1024 * 194, "neus": 1024 * 259}
TPF_SEG0 = {"nerf": 60, "neus": 36}  # the skip's segment: PE(pos) of ranks 10 and 6
TPF_LAYOUT = tuple(li == 5 for li in range(8))  # both trunks: [h, embed] at layer 5
TPF_WALK_ROWS = 65536  # the two walks, forward and backward, at 1024 wide
# the route's wrappers of each run (their calls that ran the kernels), and
# the fused route's, which the route never launches
TPF_RUN_KERNELS = {"nerf_1024": ("mlp_seg_layers",),
                   "neus_1024": ("sdf_mlp_layers", "mlp_seg_layers")}
TPF_FUSED = ("mlp_seg", "mlp_seg_bwd", "sdf_mlp", "sdf_mlp_bwd")
# phase 25b's runs: rays, trainer.epoch_max (100 steps an epoch) and the
# train PSNR gain of the last 50 steps over the first 50 (NeuS-1024 in f32
# runs fewer rays and steps, so its bar is lower)
TPF_RUNS = {"nerf_1024": {"rays": 1024, "epoch_max": 1, "gain_min": PSNR_GAIN_MIN},
            "neus_1024": {"rays": 256, "epoch_max": 1, "gain_min": 1.0}}
TPF_RANK_RAYS = 64  # phase 25c's steps at width 256 over two ranks on one card
# NeuS's 25c step runs tanhExp: under ReLU a pre-activation within a
# rounding of the kink may take the other side in the shards' sums, which
# moves a gradient norm by more than the f32 bar (6.2e-6 between the
# one-shard route and the fused one in one CPU process, 1.7e-7 under
# tanhExp); tanhExp also drives the sweep's f'' terms over the shards
TPF_RANK_OVERRIDES = {"nerf": [], "neus": ["network.activation_type=tanhExp"]}
TPF_RANK_TIMEOUT = 420.0
TPF_F32_TOL = 1e-6  # two ranks' f32 step vs one rank's


def _tpf_nets(render):
    nets = [render.network_fine]
    if render.use_coarse_network:
        nets.append(render.network_coarse)
    return nets


def tpf_route_counts(what: str, needed, backward: bool = True) -> dict:
    """``read_path_counts`` on NeRF's and NeuS's per-layer route: every
    kernel of ``needed`` and the value-only layer forward launched (with
    ``backward``, route_nt and route_tn too), no fused wrapper and no tile
    forward, no plain version."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    counts = read_path_counts(what, needed)
    fused = {k: counts["launches"].get(k, 0) for k in TPF_FUSED}
    tile = counts["routes"]["tile_forward"]
    if any(fused.values()) or any(tile.values()) or dm.ROUTE_LAUNCHES["fwd_value"] < 1:
        fail(f"{what}: the fused route launched {fused}, tile forwards {tile}, the layer "
             f"forward {dict(dm.ROUTE_LAUNCHES)}")
    counts = layer_forward_counts(what, counts)
    return route_product_counts(what, counts) if backward else counts


def tpf_cases(torch, dev, dtype_name: str) -> dict:
    """Phase 25a at one operand type: the route's new modes against their
    plain versions at each path's rows (TPF_ROWS) and width 1024, ReLU,
    timed (kernel, plain, ``torch.addmm`` on the same operands where one
    call computes the product), with their bounds; then NeRF's trunk walk
    and (f32) NeuS's sdf walk at TPF_WALK_ROWS, held layer by layer over
    the kernel's own stash (a pre-activation within a rounding of ReLU's
    kink may take the other side in the plain sums)."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    e = 2 if dtype_name == "bfloat16" else 4
    g = torch.Generator(device=dev).manual_seed(25)
    k, kp = sk.SDFProducts(dtype, dev), sk.SDFProductsPlain(dtype)
    n, act = TPF_WIDTH, "ReLU"
    tol = TP_TOL[dtype_name]
    out = {}

    def rnd(*shape, scale=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def hold(name, got, want):
        err, rel = rel_err(torch, got, want)
        if not torch.isfinite(got).all() or not rel <= tol:
            fail(f"[25a] {name} {dtype_name}: rel err {rel:.3g} > {tol}")
        return err

    def record(name, err, pair, library_ms, b):
        out[name] = {"max_abs_err": err, "ms": pair[0], "plain_ms": pair[1],
                     "library_ms": library_ms, **b}

    # the layer forward: a post-skip layer reading [h | embed] (hidden
    # first), and NeuS's colour trunk's whole 3-wide last layer
    for name, m, ks, n_out in (("fwd_hidden_first/nerf", TPF_ROWS["nerf"], (n, 60), n),
                               ("fwd_hidden_first/neus", TPF_ROWS["neus"], (n, 36), n),
                               ("fwd_narrow/neus", TPF_ROWS["neus"], (n,), 3)):
        xs = [rnd(1, m, kk) for kk in ks]
        w = rnd(sum(ks), n_out, scale=sum(ks) ** -0.5)
        b = torch.randn(n_out, generator=g, device=dev) * 0.1
        got, want = k.layer_fwd(xs, w, b, act, True), kp.layer_fwd(xs, w, b, act, True)
        torch.cuda.synchronize()
        err = max(hold(name, a, c) for a, c in zip(got, want))
        pair = time_pair(torch, lambda: k.layer_fwd(xs, w, b, act, True),
                         lambda: kp.layer_fwd(xs, w, b, act, True), inner=3)
        ms_one = time_one(torch, lambda: k.layer_fwd(xs, w, b, act, True), inner=1)
        x2d, bt = torch.cat(xs, dim=-1).view(m, sum(ks)), b.to(dtype)
        library_ms = time_one(torch, lambda: torch.addmm(bt, x2d, w), inner=3)
        record(name, err, pair, library_ms,
               _route_bound(*_route_fwd_work(1, m, ks, n_out, dtype_name, True), dtype_name))
        out[name]["ms_one_launch"] = ms_one
        del xs, w, got, want, x2d
    torch.cuda.empty_cache()

    # the activation pass after the reduce-scatter (gpre on the f32 sum):
    # NeRF's layer cotangent, and NeuS's descending trunk with zs added
    for name, path, with_add in (("gpre_f32/nerf", "nerf", False),
                                 ("gpre_f32/neus", "neus", True)):
        m = TPF_ROWS[path]
        z = rnd(m, n)
        gg = torch.randn((m, n), generator=g, device=dev)
        add = torch.randn((m, n), generator=g, device=dev) if with_add else None
        got, want = k.gpre(gg, z, act, add), kp.gpre(gg, z, act, add)
        torch.cuda.synchronize()
        err = max(hold(name, got[0], want[0]), hold(f"{name} db", got[1], want[1]))
        pair = time_pair(torch, lambda: k.gpre(gg, z, act, add),
                         lambda: kp.gpre(gg, z, act, add))
        nbytes = m * n * (4 + 2 * e + 4 * with_add) + 4 * n * -(-m // 64) + 4 * n
        record(name, err, pair, None, bound(3.0 * m * n, nbytes, "float32"))
        del z, gg, add, got, want
    torch.cuda.empty_cache()

    if dtype == torch.float32:
        # the sweep's top at a column shard of 512: channel 0 on rank 0 only
        m = TPF_ROWS["neus"]
        z = rnd(m, n // 2)
        err = 0.0
        for holds0 in (True, False):
            err = max(err, hold(f"sdf_top holds0={holds0}", k.sdf_top(z, act, holds0),
                                kp.sdf_top(z, act, holds0)))
        pair = time_pair(torch, lambda: k.sdf_top(z, act), lambda: kp.sdf_top(z, act))
        # the function reads z's column 0 and writes p
        record("sdf_top_shard", err, pair, None, bound(float(m), 4.0 * m * (n // 2 + 1),
                                                       "float32"))
        del z
        torch.cuda.empty_cache()

    # NeRF's trunk: the value-only walk (8 x 1024, [h | 60] at layer 5) and
    # its backward
    m = TPF_WALK_ROWS
    fans = [60] + [n + 60 * s for s in TPF_LAYOUT[1:]]
    ws = [rnd(f, n, scale=1.5 * f ** -0.5) for f in fans]
    bs = [torch.randn(n, generator=g, device=dev) * 0.1 for _ in fans]
    x0 = rnd(m, 60)
    no_j = (False,)

    def walk(launcher):
        return dm.dual_mlp_layers_walk([x0], [], ws, bs, TPF_LAYOUT, act, no_j, 0, launcher,
                                       stash=True, hidden_first=True)

    full, ins, pres = walk(k)
    torch.cuda.synchronize()
    # each layer against its plain version on the kernel's own inputs
    err_f = max(max(hold(f"mlp walk layer {li}", a, c) for a, c in zip(
        (ins[li + 1][0] if li + 1 < len(ws) else full, pres[li]),
        kp.layer_fwd(ins[li], ws[li], bs[li], act, True))) for li in range(len(ws)))
    gtop = torch.randn((1, m, n), generator=g, device=dev)

    def walk_bwd(launcher):
        return dm.dual_mlp_layers_bwd(ins, ws, TPF_LAYOUT, act, [60], no_j, pres, gtop,
                                      launcher, hidden_first=True)

    got, routed = walk_route_products(lambda: walk_bwd(k), "[25a] mlp walk backward")
    want = walk_bwd(kp)
    torch.cuda.synchronize()
    err_b = max(hold(f"mlp walk backward {i}", a, c) for gs_, ws_ in zip(got, want)
                for i, (a, c) in enumerate(zip(gs_, ws_)))
    del got, want
    flops = sum(2.0 * m * f * n for f in fans)
    io = (m * 60 + 2 * m * n * len(fans) + sum(f * n for f in fans)) * e + 4 * n * len(fans)
    record("mlp_walk_fwd", err_f, time_pair(torch, lambda: walk(k), lambda: walk(kp), reps=3),
           None, _route_bound(flops, io, dtype_name))
    io_b = (sum(m * f for f in fans) + m * n * len(fans) + sum(f * n for f in fans)
            + m * 60) * e + 4 * m * n + sum(f * n + n for f in fans) * 4
    record("mlp_walk_bwd", err_b, time_pair(torch, lambda: walk_bwd(k), lambda: walk_bwd(kp),
                                            reps=3), None, _route_bound(2.0 * flops, io_b,
                                                                        dtype_name))
    out["mlp_walk_bwd"]["route_products_per_call"] = routed
    del full, ins, pres, gtop, ws
    torch.cuda.empty_cache()

    if dtype == torch.float32:
        # NeuS's sdf trunk with its sweep (8 x 1024, [h | 36] at layer 5) and
        # its second-order backward
        fans = [36] + [n + 36 * s for s in TPF_LAYOUT[1:]]
        ws = [rnd(f, n, scale=1.5 * f ** -0.5) for f in fans]
        bs = [torch.randn(n, generator=g, device=dev) * 0.1 for _ in fans]
        e0 = rnd(m, 36)
        h, g_e, ins, pres = sk.sdf_layers_walk(e0, ws, bs, TPF_LAYOUT, act, k)
        torch.cuda.synchronize()
        err_f = max(max(hold(f"sdf walk layer {li}", a, c[0]) for a, c in zip(
            (ins[li + 1][0] if li + 1 < len(ws) else h, pres[li]),
            kp.layer_fwd([x[None] for x in ins[li]], ws[li], bs[li], act, True)))
            for li in range(len(ws)))
        err_f = max(err_f, hold("sdf walk gE", g_e, sdf_grad.channel0_sweep(
            ws, TPF_LAYOUT, act, pres, 36)))
        ch = torch.randn((m, n), generator=g, device=dev)
        cg = torch.randn((m, 36), generator=g, device=dev)

        def sdf_bwd(launcher):
            return sk.sdf_layers_bwd(ins, ws, TPF_LAYOUT, act, pres, ch, cg, launcher)

        got, sdf_routed = walk_route_products(lambda: sdf_bwd(k), "[25a] sdf walk backward")
        want = sdf_bwd(kp)
        torch.cuda.synchronize()
        err_b = max([hold("sdf walk de", got[0], want[0])]
                    + [hold(f"sdf walk d{kind} {i}", a, c) for kind, gs_, ws_ in
                       (("W", got[1], want[1]), ("b", got[2], want[2]))
                       for i, (a, c) in enumerate(zip(gs_, ws_))])
        del got, want
        flops = sum(2.0 * m * f * n for f in fans)
        io = (m * 36 + 2 * m * n * len(fans) + sum(f * n for f in fans)) * 4 + 4 * m * 36

        def sdf_fwd(launcher):
            return sk.sdf_layers_walk(e0, ws, bs, TPF_LAYOUT, act, launcher)

        record("sdf_walk_fwd", err_f, time_pair(torch, lambda: sdf_fwd(k), lambda: sdf_fwd(kp),
                                                reps=3), None,
               _route_bound(2.0 * flops, io, "float32"))
        io_b = (2 * sum(m * f for f in fans) + m * n * len(fans) + sum(f * n for f in fans)
                + 2 * m * 36 + m * n) * 4 + sum(f * n + n for f in fans) * 4
        record("sdf_walk_bwd", err_b, time_pair(torch, lambda: sdf_bwd(k), lambda: sdf_bwd(kp),
                                                reps=3), None,
               _route_bound(5.0 * flops, io_b, "float32"))
        out["sdf_walk_bwd"]["route_products_per_call"] = sdf_routed
        del h, g_e, ins, pres, ws, ch, cg
        torch.cuda.empty_cache()
    return out


def phase_tp_family_kernels(torch, card: str) -> dict:
    """Phase 25a: ``tpf_cases`` in f32 and bf16, and the layer forward's
    grid at S = 1."""
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    out = {}
    for dtype_name in ("float32", "bfloat16"):
        out[f"grid/{dtype_name}"] = grid = layer_fwd_grid(torch, dev, dtype_name, (1,), "25a")
        log_layer_grid("25a", dtype_name, grid, (1,), card)
        cases = tpf_cases(torch, dev, dtype_name)
        for name, r in cases.items():
            lib = r["library_ms"]
            log(f"[25a] {name} {dtype_name} (width {TPF_WIDTH}): max abs err "
                f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms{one_launch(r)}, plain "
                f"{r['plain_ms']:.4f} ms, torch.addmm {lib if lib is None else round(lib, 4)} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}) | card: {card}")
        out[dtype_name] = cases
    out["wall_s"] = time.perf_counter() - start
    log(f"[25a] took {out['wall_s']:.1f} s")
    return out


def phase_tp_family_run(torch, card: str) -> dict:
    """Phase 25b: NeRF-1024 (bf16) and NeuS-1024 (f32) on the card (the
    per-layer route with one shard): each f32 step from the seeded
    parameters against the JAX package (TP_FAMILY_STEP_REF), a short run
    through scripts/run.py (TPF_RUNS: every loss finite, train PSNR up by
    its bar, every launch on the route and no plain call; ms/step, the busy
    share, peak memory) and run_eval of its run dir through the kernels and
    the plain versions within EVAL_PSNR_GAP_DB."""
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    start = time.perf_counter()
    refs = json.loads(TP_FAMILY_STEP_REF.read_text())
    out = {}
    for name, spec in TPF_RUNS.items():
        needed = TPF_RUN_KERNELS[name]
        reset_path_counts()
        res = {"step": phase_family_step(torch, card, {name: TP_FAMILY_OVERRIDES[name]}, refs,
                                         TP_FAMILY_BATCH, "25b")[name]}
        res["step"]["counts"] = tpf_route_counts(f"[25b] {name} f32 step", needed)
        run_dir = OUT / f"train_{name}"
        reset_path_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = run_main_path(torch, run_dir, [
            *TP_FAMILY_OVERRIDES[name], f"trainer.batch_size={spec['rays']}",
            f"trainer.epoch_max={spec['epoch_max']}",
            f"trainer.epoch_save_model={max(1, spec['epoch_max'])}"])
        wall = time.perf_counter() - t0
        counts = tpf_route_counts(f"[25b] the {name} run", needed)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        hist = trainer.history
        if len(hist) != 100 * (spec["epoch_max"] + 1) or not all(
                math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
                for r in hist):
            fail(f"[25b] {name}: {len(hist)} logged steps, or a non-finite loss")
        first = mean([r["psnr"] for r in hist[:50]])
        last = mean([r["psnr"] for r in hist[-50:]])
        steady = [r["seconds"] for r in hist[50:]]
        ms_step = 1000.0 * mean(steady)
        dtype = "bfloat16" if name.startswith("nerf") else "float32"
        log(f"[25b] {name} run: {trainer.iteration} steps in {wall:.1f} s, train PSNR "
            f"{first:.3f} -> {last:.3f} dB (gain bar {spec['gain_min']}), {ms_step:.2f} ms/step "
            f"(steps 50-, {dtype}, {spec['rays']} rays), peak {peak_gib:.2f} GiB; launches "
            f"{counts['launches']}, layer forward {counts['layer_forward']}, products "
            f"{counts['routes']['products']}, passes {counts['routes']['passes']}, plain calls "
            f"{counts['plain_calls']} | card: {card}")
        if not last - first >= spec["gain_min"]:
            fail(f"[25b] the {name} run's train PSNR did not rise")
        host = layer_forward_host(f"[25b] {name} run", counts, trainer.iteration, ms_step)
        route_host = route_product_host(f"[25b] {name} run", counts, trainer.iteration, ms_step)
        prof = profile_train(torch, trainer, card, f"profile_train_{name}.txt",
                             f"{spec['rays']} rays, {dtype}, width {TPF_WIDTH}", "25b")
        del trainer
        torch.cuda.empty_cache()
        reset_path_counts()
        ev = evaluate(run_dir, spec["epoch_max"], cameras=[0], downsampling=8)
        eval_counts = tpf_route_counts(f"[25b] {name} run_eval", needed, backward=False)
        gt = ev.dataset[0]["rgb_images"].astype("uint8")[::8, ::8]
        psnrs = {}
        for mode in ("kernels", "plain"):
            for net in _tpf_nets(ev.neural_render):
                net.fused = "auto" if mode == "kernels" else "off"
            ev.generator.manual_seed(ev.seed)
            rgb = ev.render_test(run_dir / f"eval_{mode}", 0, 8)
            psnrs[mode] = peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])
        gap = abs(psnrs["kernels"] - psnrs["plain"])
        log(f"[25b] {name} run_eval cam 0 at downsampling 8: {psnrs['kernels']:.4f} dB through "
            f"the kernels (launches {eval_counts['launches']}, layer forward "
            f"{eval_counts['layer_forward']}), {psnrs['plain']:.4f} dB plain, gap {gap:.4f} dB "
            f"(bar {EVAL_PSNR_GAP_DB})")
        if not gap <= EVAL_PSNR_GAP_DB:
            fail(f"[25b] {name}: run_eval through the kernels and the plain versions disagree")
        del ev
        torch.cuda.empty_cache()
        res.update({"launches": counts["launches"], "layer_forward": counts["layer_forward"],
                    "layer_forward_host": host, "route_products": counts["route_products"],
                    "route_product_host": route_host,
                    "routes": counts["routes"], "plain_calls": counts["plain_calls"],
                    "wall_s": wall, "ms_per_step": ms_step,
                    "rays_per_s": spec["rays"] / mean(steady), "busy_share": prof["busy_share"],
                    "device_ms_per_step": prof["device_ms_per_step"],
                    "launches_per_step": prof["launches_per_step"], "peak_memory_gib": peak_gib,
                    "psnr_first50": first, "psnr_last50": last, "eval_psnr": psnrs,
                    "eval_launches": eval_counts["launches"],
                    "eval_layer_forward": eval_counts["layer_forward"]})
        out[name] = res
    out["phase_s"] = time.perf_counter() - start
    log(f"[25b] took {out['phase_s']:.1f} s")
    return out


def tpf_rank(rank: int, world: int, store: str, inp: dict) -> None:
    """One rank of phase 25c on cuda:0 beside the other, in a gloo group of
    data 1 x model ``world``: per family of ``inp`` (width 256, shipped
    configs), the one-rank step (whole parameters) in f32 (and bf16 for
    NeRF), then the TP step over the rank's column shards (counts at 0 just
    before, read just after), the gathered gradients' norms and the TP
    step's time. Results into ``OUT/tpf_rank{rank}.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO))
    from neddf_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        make_sharded_grads,
        shard_parameters,
        tp_shard_names,
    )
    from neddf_tpu_torch.render.renderer import tp_renderer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    out = {"rank": rank}
    try:
        mesh = make_mesh(world)
        for family, step in inp.items():
            needed = TPF_RUN_KERNELS[f"{family}_1024"]
            dtypes = (("float32", torch.float32),) + (
                (("bfloat16", torch.bfloat16),) if family == "nerf" else ())
            render, local = dp_local_step(torch, step, dev)
            params = list(render.parameters())

            def set_dtype(dtype):
                for net in _tpf_nets(render):
                    if hasattr(net, "compute_dtype"):
                        net.compute_dtype = dtype

            res = {}
            for name, dtype in dtypes:
                set_dtype(dtype)
                for p in params:
                    p.grad = None
                res[name] = {"single": dp_numbers(render, *local())}
            names = tp_shard_names(render, world)
            shard_parameters(render, mesh, names)
            tp_renderer(render, mesh.model_group)
            sharded = make_sharded_grads(mesh, TPF_RANK_RAYS, 1,
                                         [p for n, p in render.named_parameters() if n in names])
            for name, dtype in dtypes:
                set_dtype(dtype)
                for p in params:
                    p.grad = None
                reset_path_counts()
                loss, loss_dict, mse = sharded(local, params, None)
                torch.cuda.synchronize()
                counts = tpf_route_counts(f"[25c] rank {rank} {family} {name} TP step", needed)
                grads = gather_state({n: p.grad for n, p in render.named_parameters()}, mesh,
                                     names)
                res[name]["tp"] = {"loss": loss.item(), "mse": mse.item(),
                                   "losses": {k: v.item() for k, v in loss_dict.items()},
                                   "grad_norms": {k: v.norm().item() for k, v in grads.items()}}
                res[name].update(counts)
            times = []
            for _ in range(2):
                for p in params:
                    p.grad = None
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                sharded(local, params, None)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
            res["ms_per_step"] = times
            out[family] = res
            del render, local, params
            torch.cuda.empty_cache()
    finally:
        torch.save(out, OUT / f"tpf_rank{rank}.pt")
        dist.destroy_process_group()


def phase_tp_family_ranks(torch, card: str) -> dict:
    """Phase 25c: NeRF and NeuS (width 256, shipped configs but
    TPF_RANK_OVERRIDES, seeded parameters, TPF_RANK_RAYS rays) over two
    gloo ranks of data 1 x model 2 on the one card (``tpf_rank``): the
    f32 TP step within TPF_F32_TOL of the one-rank step, NeRF's bf16
    within the step bars, each rank's launches on the route and no plain
    call."""
    start = time.perf_counter()
    steps = {}
    for family, extra in TPF_RANK_OVERRIDES.items():
        trainer = family_trainer(torch, family, extra)
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=DP_DRAW_SEED, batch=TPF_RANK_RAYS)
        steps[family] = {"cfg": trainer.config, "params": family_params(shapes),
                         "draws": draws, "rgb": trainer.rgb_images[0].cpu().numpy(),
                         "mask": trainer.mask_images[0].cpu().numpy(),
                         "calib": trainer.calib.params.cpu().numpy(),
                         "camera": trainer.camera_initials[0].cpu().numpy(), "iteration": 0}
        del trainer, render
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    store = OUT / f"tpf_gloo_store_{time.time_ns()}"
    for r in range(TP_WORLD):
        (OUT / f"tpf_rank{r}.pt").unlink(missing_ok=True)
    context = torch.multiprocessing.start_processes(
        tpf_rank, args=(TP_WORLD, f"file://{store}", steps), nprocs=TP_WORLD, join=False,
        start_method="spawn")
    try:
        join_ranks(context, TPF_RANK_TIMEOUT, "[25c]")
    finally:
        store.unlink(missing_ok=True)
    ranks = [torch.load(OUT / f"tpf_rank{r}.pt", weights_only=False) for r in range(TP_WORLD)]
    out = {"ranks": []}
    for rank in ranks:
        entry = {"rank": rank["rank"]}
        for family in steps:
            res = rank[family]
            for name in ("float32", "bfloat16"):
                if name not in res:
                    continue
                got, ref = res[name]["tp"], res[name]["single"]
                if name == "float32":
                    worst = max([check_close(f"[25c] {family} f32 {k}", got[k], ref[k],
                                             TPF_F32_TOL) for k in ("loss", "mse")]
                                + [check_close(f"[25c] {family} f32 loss {k}",
                                               got["losses"][k], v, TPF_F32_TOL)
                                   for k, v in ref["losses"].items()]
                                + [check_close(f"[25c] {family} f32 grad norm {k}",
                                               got["grad_norms"][k], v, TPF_F32_TOL)
                                   for k, v in ref["grad_norms"].items()])
                    gaps = {"worst_rel": worst}
                else:
                    worst_loss, worst_grad = bf16_step_gaps(got, ref)
                    gaps = {"worst_loss_rel": worst_loss, "worst_grad_norm_rel": worst_grad}
                log(f"[25c] rank {rank['rank']} {family} width 256 {name}: the TP step (data 1 "
                    f"x model 2) vs one rank's on the same draws: {json.dumps(gaps)} (bars: "
                    f"f32 {TPF_F32_TOL}, bf16 {json.dumps(BF16_STEP_TOL)}); launches "
                    f"{res[name]['launches']}, layer forward {res[name]['layer_forward']}, "
                    f"products {res[name]['routes']['products']}, passes "
                    f"{res[name]['routes']['passes']}, plain calls {res[name]['plain_calls']}")
                entry[f"{family}/{name}"] = {"gaps": gaps, "launches": res[name]["launches"],
                                             "layer_forward": res[name]["layer_forward"],
                                             "products": res[name]["routes"]["products"],
                                             "passes": res[name]["routes"]["passes"]}
            entry[f"{family}/ms_per_step"] = res["ms_per_step"]
            log(f"[25c] rank {rank['rank']} {family} width 256, {TPF_RANK_RAYS} rays: "
                f"{min(res['ms_per_step']):.2f} ms per TP step (the last dtype; two ranks "
                f"sharing ONE card over gloo: not a TP speed) | card: {card}")
        out["ranks"].append(entry)
    out["wall_s"] = time.perf_counter() - start
    log(f"[25c] took {out['wall_s']:.1f} s")
    return out


def tpf_kernel_entries(tpf: dict) -> list:
    """The kernels line's entries of phase 25: each new mode and walk with
    its numbers from 25a (max_abs_err over both operand types; ms, plain
    ms, bound and library ms at the type the main path runs it: bf16 for
    NeRF's, f32 for NeuS's), its launches in 25b's runs and per rank in
    25c's TP steps."""
    runs = {k: v for k, v in tpf["run"].items() if isinstance(v, dict)}
    rank0 = tpf["ranks"]["ranks"][0]
    per_rank = {f: rank0[f"{f}/float32"] for f in ("nerf", "neus")}

    def run_sum(fn):
        return sum(fn(r) for r in runs.values())

    src = "neddf_tpu_torch/csrc/dual_mlp_bwd.cu"
    fwd_src = "neddf_tpu_torch/csrc/layer_fwd.cu"
    rows = (
        ("layer_fwd_wide (value-only route, NeRF trunk post-skip [h 1024 | 60] -> 1024)",
         "fwd_hidden_first/nerf", "bfloat16", fwd_src, "neddf_tpu/kernels/mlp.py:192",
         runs["nerf_1024"]["layer_forward"]["wide"],
         per_rank["nerf"]["layer_forward"]["wide"]),
        ("layer_fwd_wide (value-only route, NeuS sdf trunk [h 1024 | 36] -> 1024, 3xTF32)",
         "fwd_hidden_first/neus", "float32", fwd_src, "neddf_tpu/kernels/sdf_mlp.py:257",
         runs["neus_1024"]["layer_forward"]["wide"],
         per_rank["neus"]["layer_forward"]["wide"]),
        ("layer_fwd_narrow (NeuS colour's whole last layer 1024 -> 3)", "fwd_narrow/neus",
         "float32", fwd_src, "neddf_tpu/kernels/mlp.py:192",
         runs["neus_1024"]["layer_forward"]["narrow"],
         per_rank["neus"]["layer_forward"]["narrow"]),
        ("gpre_kernel (the f32 cotangent after the reduce-scatter, every layer of the route's "
         "backwards and the sweep's steps)", "gpre_f32/nerf", "bfloat16",
         "neddf_tpu_torch/csrc/mlp_bwd.cu", "neddf_tpu/kernels/mlp.py:248",
         run_sum(lambda r: r["routes"]["passes"]["gpre"]),
         per_rank["neus"]["passes"]["gpre"]),
        ("sdf_top_kernel (the sweep's top at a column shard)", "sdf_top_shard", "float32",
         "neddf_tpu_torch/csrc/sdf_mlp.cu", "neddf_tpu/kernels/sdf_mlp.py:257",
         runs["neus_1024"]["routes"]["passes"]["sdf_top"], per_rank["neus"]["passes"]["sdf_top"]),
        ("MLPLayers forward walk (NeRF trunk, 8 x 1024, hidden-first skip)", "mlp_walk_fwd",
         "bfloat16", fwd_src, "neddf_tpu/kernels/mlp.py:192",
         runs["nerf_1024"]["launches"]["mlp_seg_layers"],
         per_rank["nerf"]["launches"]["mlp_seg_layers"]),
        ("MLPLayers backward walk (gpre, tn and nt products per layer)", "mlp_walk_bwd",
         "bfloat16", src, "neddf_tpu/kernels/mlp.py:248",
         runs["nerf_1024"]["launches"]["mlp_seg_layers"],
         per_rank["nerf"]["launches"]["mlp_seg_layers"]),
        ("SDFLayers forward walk (NeuS sdf trunk + the sweep per layer, 8 x 1024)",
         "sdf_walk_fwd", "float32", src, "neddf_tpu/kernels/sdf_mlp.py:257",
         runs["neus_1024"]["launches"]["sdf_mlp_layers"],
         per_rank["neus"]["launches"]["sdf_mlp_layers"]),
        ("SDFLayers backward walk (replayed sweep, ascending adjoint, descending trunk)",
         "sdf_walk_bwd", "float32", src, "neddf_tpu/kernels/sdf_mlp.py:304",
         runs["neus_1024"]["launches"]["sdf_mlp_layers"],
         per_rank["neus"]["launches"]["sdf_mlp_layers"]),
    )
    entries = []
    for name, key, dtype, source, replaces, launches, rank_launches in rows:
        r = tpf["kernels"][dtype][key]
        err = max(tpf["kernels"][d][key]["max_abs_err"] for d in ("float32", "bfloat16")
                  if key in tpf["kernels"][d])
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "launches_tp_rank_step": rank_launches})
    return entries


def phase_25_alone(torch) -> int:
    """``python3 chip_smoke.py --phase 25``: the build and phase 25 alone
    (its results into ``OUT/phase25.json``, its kernels line printed), for
    work on NeRF's and NeuS's per-layer route; the full smoke runs every
    phase."""
    from neddf_tpu_torch.kernels import _build

    card = card_line()
    start = time.perf_counter()
    _build.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - start:.1f} s | card: {card}")
    out = {"kernels": phase_tp_family_kernels(torch, card),
           "run": phase_tp_family_run(torch, card),
           "ranks": phase_tp_family_ranks(torch, card)}
    drop_large_outputs()
    (OUT / "phase25.json").write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"kernels": tpf_kernel_entries(out)}))
    print(card)
    print(json.dumps({"ok": True, "phase": 25, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------- phase 26
# trunks of any depth and widths over 2048: (a) the epilogue forward (#5)
# and its standalone backward (#6: past 2048 its column-chunked kernel)
# against their plain versions at the fine pass's rows, timed; (b) each
# configuration of DEEP_OVERRIDES on one card through the per-layer route;
# (c) NeDDF with both trunks 4096 wide on one card, and over two gloo
# ranks sharing it (shards of 2048)
EPI_WIDE_WIDTHS = (2056, 3072, 4096)
# the route's wrappers of each deep run (their calls that ran the kernels)
DEEP_RUN_KERNELS = {"neddf_deep": TP_RUN_KERNELS, "nerf_deep": ("mlp_seg_layers",),
                    "neus_deep": ("sdf_mlp_layers", "mlp_seg_layers")}
DEEP_LOSS_STEPS = 20  # the run's gate: the mean loss of the last 20 steps below the first 20
WIDTH_4096 = 4096
WIDE_4096_RAYS = 128  # the 4096-wide run's rays (each layer's input and stash stay saved)
WIDE_4096_STEPS = 20
WIDE_4096_STEP_RAYS = 32  # its f32 step, kernels against the plain versions
WIDE_4096_RANK_STEPS = ((WIDTH_4096, 32),)  # 26c's two ranks: (width, rays)


def deep_route_counts(what: str, needed, route: str, backward: bool = True) -> dict:
    """``read_path_counts`` on the per-layer route: every kernel of
    ``needed`` and a layer forward launched, no shallow_nt product on
    the route of the other operand type than ``route`` ("tc" bf16,
    "tf32x3" f32) and, with ``backward``, route_nt and route_tn launched
    (``route_product_counts``); no fused wrapper, no tile forward, no
    plain version."""
    from neddf_tpu_torch.kernels import dual_mlp as dm

    counts = read_path_counts(what, needed)
    fused = {k: counts["launches"].get(k, 0) for k in (*FUSED_KERNELS, *TPF_FUSED)}
    routes = counts["routes"]
    other = {"tc": "tf32x3", "tf32x3": "tc"}[route]
    if (any(fused.values()) or any(routes["tile_forward"].values())
            or sum(dm.ROUTE_LAUNCHES.values()) < 1 or routes["products"][other]):
        fail(f"{what}: the fused route launched {fused}, tile forwards "
             f"{routes['tile_forward']}, the layer forward {dict(dm.ROUTE_LAUNCHES)}, "
             f"products {routes['products']} (expected {route} only)")
    counts = layer_forward_counts(what, counts)
    return route_product_counts(what, counts) if backward else counts


def phase_epilogue_wide(torch, card: str) -> dict:
    """Phase 26a: ``epilogue_cases`` at the widths EPI_WIDE_WIDTHS over the
    fine pass's TP_ROWS rows, f32 and bf16 (past 2048 the backward runs
    ``epi_bwd_wide_kernel``), within the route's bars (TP_TOL)."""
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    out = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        tol = TP_TOL[dtype_name]
        e = 2 if dtype_name == "bfloat16" else 4
        for n in EPI_WIDE_WIDTHS:
            g = torch.Generator(device=dev).manual_seed(n)

            def rnd(*shape, scale=1.0):
                return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

            def hold(name, got, want):
                err, rel = rel_err(torch, got, want)
                if not torch.isfinite(got).all() or not rel <= tol:
                    fail(f"[26a] {name} width {n} {dtype_name}: rel err {rel:.3g} > {tol}")
                return err

            cases = epilogue_cases(torch, g, rnd, TP_ROWS, n, e, hold)
            for name, r in cases.items():
                log(f"[26a] {name} {dtype_name} (rows {TP_ROWS}, width {n}): max abs err "
                    f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); dwd, dwa, db2 bitwise "
                    f"over two runs | card: {card}")
                out[f"{name}/{n}/{dtype_name}"] = r
    out["wall_s"] = time.perf_counter() - start
    log(f"[26a] took {out['wall_s']:.1f} s")
    return out


def phase_deep(torch, card: str) -> dict:
    """Phase 26b: each configuration of DEEP_OVERRIDES (trunks deeper than
    the fused kernels hold) on the card: its f32 step from the seeded
    parameters against the JAX package (DEEP_STEP_REF, phase 10's bars), a
    100-step run through scripts/run.py (every loss finite, the mean loss
    of the last DEEP_LOSS_STEPS steps below the first's, every launch on
    the route's tensor-core products, none of the fused route's, no plain
    call; ms/step over steps 50-99, the busy share, the peak memory), and
    run_eval of NeDDF-deep's run through the kernels and the plain
    versions within EVAL_PSNR_GAP_DB."""
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    start = time.perf_counter()
    refs = json.loads(DEEP_STEP_REF.read_text())
    out = {}
    for name, overrides in DEEP_OVERRIDES.items():
        needed = DEEP_RUN_KERNELS[name]
        route = "tf32x3" if name.startswith("neus") else "tc"
        reset_path_counts()
        res = {"step": phase_family_step(torch, card, {name: overrides}, refs, DEEP_BATCH,
                                         "26b")[name]}
        res["step"]["counts"] = deep_route_counts(f"[26b] {name} f32 step", needed, "tf32x3")
        run_dir = OUT / f"train_{name}"
        reset_path_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = run_main_path(torch, run_dir, [*overrides, "trainer.epoch_max=0"])
        wall = time.perf_counter() - t0
        counts = deep_route_counts(f"[26b] the {name} run", needed, route)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        hist = trainer.history
        if len(hist) != 100 or not all(
                math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
                for r in hist):
            fail(f"[26b] {name}: {len(hist)} logged steps, or a non-finite loss")
        first = mean([r["loss"] for r in hist[:DEEP_LOSS_STEPS]])
        last = mean([r["loss"] for r in hist[-DEEP_LOSS_STEPS:]])
        ms_step = 1000.0 * mean([r["seconds"] for r in hist[50:]])
        steps = len(hist)
        per_step = {"layer_forward": {k: v / steps for k, v in counts["layer_forward"].items()},
                    "products": {k: v / steps for k, v in counts["routes"]["products"].items()},
                    "passes": {k: v / steps for k, v in counts["routes"]["passes"].items() if v}}
        log(f"[26b] {name} run: {steps} steps in {wall:.1f} s, mean loss of the first "
            f"{DEEP_LOSS_STEPS} {first:.5f} -> last {DEEP_LOSS_STEPS} {last:.5f}, "
            f"{ms_step:.2f} ms/step (steps 50-99, {trainer.batch_size} rays), peak "
            f"{peak_gib:.2f} GiB; launches {counts['launches']}, per step "
            f"{json.dumps(per_step)}, plain calls {counts['plain_calls']} | card: {card}")
        if not last < first:
            fail(f"[26b] the {name} run's loss did not fall")
        host = layer_forward_host(f"[26b] {name} run", counts, steps, ms_step)
        route_host = route_product_host(f"[26b] {name} run", counts, steps, ms_step)
        prof = profile_train(torch, trainer, card, f"profile_train_{name}.txt",
                             f"{trainer.batch_size} rays, {name}", "26b")
        del trainer
        torch.cuda.empty_cache()
        res.update({"launches": counts["launches"], "per_step": per_step,
                    "layer_forward_host": host, "route_products": counts["route_products"],
                    "route_product_host": route_host,
                    "plain_calls": counts["plain_calls"], "wall_s": wall,
                    "ms_per_step": ms_step, "busy_share": prof["busy_share"],
                    "device_ms_per_step": prof["device_ms_per_step"],
                    "launches_per_step": prof["launches_per_step"], "peak_memory_gib": peak_gib,
                    "loss_first": first, "loss_last": last})
        if name == "neddf_deep":
            reset_path_counts()
            ev = evaluate(run_dir, 0, cameras=[0], downsampling=8)
            eval_counts = deep_route_counts(f"[26b] {name} run_eval", TP_EVAL_KERNELS, "tc",
                                            backward=False)
            gt = ev.dataset[0]["rgb_images"].astype("uint8")[::8, ::8]
            psnrs = {}
            for mode in ("kernels", "plain"):
                ev.neural_render.network_fine.fused = "auto" if mode == "kernels" else "off"
                ev.generator.manual_seed(ev.seed)
                rgb = ev.render_test(run_dir / f"eval_{mode}", 0, 8)
                psnrs[mode] = peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])
            gap = abs(psnrs["kernels"] - psnrs["plain"])
            log(f"[26b] {name} run_eval cam 0 at downsampling 8: {psnrs['kernels']:.4f} dB "
                f"through the kernels (launches {eval_counts['launches']}, layer forward "
                f"{eval_counts['layer_forward']}), {psnrs['plain']:.4f} dB plain, gap "
                f"{gap:.4f} dB (bar {EVAL_PSNR_GAP_DB})")
            if not gap <= EVAL_PSNR_GAP_DB:
                fail(f"[26b] {name}: run_eval through the kernels and the plain versions "
                     f"disagree")
            res.update({"eval_psnr": psnrs, "eval_launches": eval_counts["launches"],
                        "eval_layer_forward": eval_counts["layer_forward"]})
            del ev
            torch.cuda.empty_cache()
        out[name] = res
    out["wall_s"] = time.perf_counter() - start
    log(f"[26b] took {out['wall_s']:.1f} s")
    return out


def wide_4096_step(torch, card: str) -> dict:
    """Phase 26c's f32 step of NeDDF at width 4096 from the seeded
    parameters, WIDE_4096_STEP_RAYS rays, through the kernels and through
    the plain versions on the same draws: every loss and gradient norm
    within phase 10's JAX_STEP_TOL; the kernels' counts."""
    trainer = family_trainer(torch, "neddf", [*tp_width_overrides(WIDTH_4096),
                                              "network.compute_dtype=float32"])
    render = trainer.neural_render
    shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
    render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
    draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                               render.sample_coarse + 1, render.sample_fine + 1,
                               seed=FAMILY_DRAW_SEED, batch=WIDE_4096_STEP_RAYS)
    us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
    got, counts = {}, None
    for mode in ("kernels", "plain"):
        render.network_fine.fused = "auto" if mode == "kernels" else "off"
        for p in render.parameters():
            p.grad = None
        reset_path_counts()
        loss, loss_dict, mse = trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(),
                                                  u_strat, u_pdf)
        torch.cuda.synchronize()
        if mode == "kernels":
            counts = deep_route_counts("[26c] the 4096-wide f32 step", TP_RUN_KERNELS,
                                       "tf32x3")
        got[mode] = {"loss": loss.item(), "mse": mse.item(),
                     "losses": {k: v.item() for k, v in loss_dict.items()},
                     "grad_norms": {n: p.grad.norm().item()
                                    for n, p in render.named_parameters()}}
    k, p = got["kernels"], got["plain"]
    worst = max([check_close(f"[26c] 4096 f32 {key}", k[key], p[key], JAX_STEP_TOL)
                 for key in ("loss", "mse")]
                + [check_close(f"[26c] 4096 f32 loss {key}", k["losses"][key], v, JAX_STEP_TOL)
                   for key, v in p["losses"].items()]
                + [check_close(f"[26c] 4096 f32 grad norm {key}", k["grad_norms"][key], v,
                               JAX_STEP_TOL) for key, v in p["grad_norms"].items()])
    log(f"[26c] NeDDF-4096 f32 step ({WIDE_4096_STEP_RAYS} rays) through the kernels vs the "
        f"plain versions: worst relative gap {worst:.3g} (bar {JAX_STEP_TOL}); launches "
        f"{counts['launches']}, layer forward {counts['layer_forward']} | card: {card}")
    del trainer, render
    torch.cuda.empty_cache()
    return {"worst_rel_vs_plain": worst, "got": k, "launches": counts["launches"],
            "layer_forward": counts["layer_forward"]}


# phase 26d: a configuration whose fused plans do not fit the shared memory
# takes the per-layer route: NeDDF with both trunks 512 wide in f32 at
# embed_pos_rank 11 (the colour trunks' row-tile plans, segments 66, 24, 3
# and 512, need more than 232,448 bytes): its f32 step from the seeded
# parameters through the kernels against the plain versions at phase 10's
# bars, then REFUSED_STEPS steps of the shipped batch, every loss finite
REFUSED_OVERRIDES = ["network.ddf_layer_width=512", "network.col_layer_width=512",
                     "network.embed_pos_rank=11", "network.compute_dtype=float32"]
REFUSED_STEP_RAYS = 64
REFUSED_STEPS = 20


def phase_refused_plan(torch, card: str) -> dict:
    """Phase 26d (``REFUSED_OVERRIDES``): every network of the field takes
    the per-layer route (``per_layer``: its fused plans raise); the f32 step
    through the route's kernels against the plain versions on the same
    draws within JAX_STEP_TOL, every launch on the route, none of the fused
    kernels', no plain call; REFUSED_STEPS finite steps."""
    start = time.perf_counter()
    trainer = family_trainer(torch, "neddf", REFUSED_OVERRIDES)
    render = trainer.neural_render
    nets = [render.network_fine] + ([render.network_coarse]
                                    if getattr(render, "use_coarse_network", False) else [])
    if not all(net.per_layer for net in nets):
        fail("[26d] NeDDF 512 f32 at embed_pos_rank 11 keeps the fused route")
    shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
    render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
    draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                               render.sample_coarse + 1, render.sample_fine + 1,
                               seed=FAMILY_DRAW_SEED, batch=REFUSED_STEP_RAYS)
    us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
    got, counts = {}, None
    for mode in ("kernels", "plain"):
        for net in nets:
            net.fused = "auto" if mode == "kernels" else "off"
        for p in render.parameters():
            p.grad = None
        reset_path_counts()
        loss, loss_dict, mse = trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(),
                                                  u_strat, u_pdf)
        torch.cuda.synchronize()
        if mode == "kernels":
            counts = deep_route_counts("[26d] the refused plan's f32 step", TP_RUN_KERNELS,
                                       "tf32x3")
        got[mode] = {"loss": loss.item(), "mse": mse.item(),
                     "losses": {k: v.item() for k, v in loss_dict.items()},
                     "grad_norms": {n: p.grad.norm().item()
                                    for n, p in render.named_parameters()}}
    k, p = got["kernels"], got["plain"]
    worst = max([check_close(f"[26d] {key}", k[key], p[key], JAX_STEP_TOL)
                 for key in ("loss", "mse")]
                + [check_close(f"[26d] loss {key}", k["losses"][key], v, JAX_STEP_TOL)
                   for key, v in p["losses"].items()]
                + [check_close(f"[26d] grad norm {key}", k["grad_norms"][key], v, JAX_STEP_TOL)
                   for key, v in p["grad_norms"].items()])
    for net in nets:
        net.fused = "auto"
    reset_path_counts()
    for it in range(REFUSED_STEPS):
        trainer.run_train_step(it % 2)
    torch.cuda.synchronize()
    trainer.flush_logs()
    run_counts = deep_route_counts("[26d] the refused plan's steps", TP_RUN_KERNELS,
                                   "tf32x3")
    losses = [r["loss"] for r in trainer.history]
    if len(losses) != REFUSED_STEPS or not all(
            math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
            for r in trainer.history):
        fail(f"[26d] {len(losses)} logged steps, or a non-finite loss")
    out = {"worst_rel_vs_plain": worst, "step_launches": counts["launches"],
           "layer_forward": run_counts["layer_forward"], "launches": run_counts["launches"],
           "losses": losses, "wall_s": time.perf_counter() - start}
    log(f"[26d] NeDDF 512 f32 at embed_pos_rank 11 (its fused plans do not fit): the "
        f"per-layer route; the f32 step ({REFUSED_STEP_RAYS} rays) through the kernels vs "
        f"plain: worst relative gap {worst:.3g} (bar {JAX_STEP_TOL}); {REFUSED_STEPS} steps "
        f"({trainer.batch_size} rays), losses {losses[0]:.5f} -> {losses[-1]:.5f}, all "
        f"finite; launches {run_counts['launches']}, layer forward "
        f"{run_counts['layer_forward']}, plain calls {run_counts['plain_calls']}; "
        f"{out['wall_s']:.1f} s | card: {card}")
    del trainer, render
    torch.cuda.empty_cache()
    return out


def phase_wide_4096(torch, card: str, ranks=None) -> dict:
    """Phase 26c: NeDDF with both trunks 4096 wide on the card:
    WIDE_4096_STEPS bf16 steps of WIDE_4096_RAYS rays (every loss finite,
    every launch on the route, no plain call; ms/step over the last 10,
    the peak memory), its f32 step through the kernels against the plain
    versions (``wide_4096_step``), and two gloo ranks of data 1 x model 2
    (shards of 2048) against one rank in f32 (``phase_tp_ranks``; the full
    smoke runs them beside phase 14b and passes their ``ranks``)."""
    start = time.perf_counter()
    out = {"step": wide_4096_step(torch, card)}
    reset_path_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer = family_trainer(torch, "neddf", [*tp_width_overrides(WIDTH_4096),
                                              f"trainer.batch_size={WIDE_4096_RAYS}"])
    seconds = []
    for it in range(WIDE_4096_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_train_step(it % 2)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    trainer.flush_logs()
    counts = deep_route_counts("[26c] the 4096-wide steps", TP_RUN_KERNELS, "tc")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    hist = trainer.history
    if len(hist) != WIDE_4096_STEPS or not all(
            math.isfinite(r["loss"]) and all(math.isfinite(v) for v in r["losses"].values())
            for r in hist):
        fail(f"[26c] NeDDF-4096: {len(hist)} logged steps, or a non-finite loss")
    ms_step = 1000.0 * mean(seconds[-10:])
    log(f"[26c] NeDDF-4096 ({WIDE_4096_RAYS} rays, bf16): {WIDE_4096_STEPS} steps, losses "
        f"{hist[0]['loss']:.5f} -> {hist[-1]['loss']:.5f}, all finite; {ms_step:.2f} ms/step "
        f"(the last 10), peak {peak_gib:.2f} GiB; launches {counts['launches']}, layer "
        f"forward {counts['layer_forward']}, plain calls {counts['plain_calls']} | card: {card}")
    del trainer
    torch.cuda.empty_cache()
    out.update({"ms_per_step": ms_step, "peak_memory_gib": peak_gib,
                "launches": counts["launches"], "layer_forward": counts["layer_forward"],
                "losses": [r["loss"] for r in hist]})
    out["ranks"] = phase_wide_ranks(torch, card) if ranks is None else ranks
    out["wall_s"] = time.perf_counter() - start
    log(f"[26c] took {out['wall_s']:.1f} s")
    return out


def phase_wide_ranks(torch, card: str) -> dict:
    """Phase 26c's two gloo ranks (shards of 2048) against one rank, f32."""
    return phase_tp_ranks(torch, card, WIDE_4096_RANK_STEPS, ("float32",), False, "26c")


def deep_kernel_entries(deep: dict) -> list:
    """The kernels line's entries of phase 26: the standalone epilogue
    backward past 2048 (the new kernel) and the forward there, each with
    26a's numbers at 4096 in bf16 (max_abs_err over every width and both
    types) and its launches in the 4096-wide steps of 26c."""
    wide = deep["wide_4096"]
    entries = []
    for name, key, replaces in (
            ("epi_bwd_wide_kernel (neddf_epilogue_bwd standalone mode past 2048, width 4096)",
             "epilogue_bwd", "neddf_tpu/kernels/neddf_epilogue.py:365"),
            ("neddf_epilogue (epi_fwd_wide_kernel past 2048, width 4096)", "epilogue",
             "neddf_tpu/kernels/neddf_epilogue.py:329")):
        r = deep["epilogue"][f"{key}/{WIDTH_4096}/bfloat16"]
        err = max(v["max_abs_err"] for k, v in deep["epilogue"].items()
                  if isinstance(v, dict) and k.startswith(f"{key}/"))
        counter = "neddf_epilogue_bwd" if key == "epilogue_bwd" else "neddf_epilogue"
        entries.append({"name": name, "route": "cuda",
                        "source": "neddf_tpu_torch/csrc/neddf_epilogue.cu",
                        "replaces": replaces, "launches": wide["launches"][counter],
                        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    return entries


def phase_26_alone(torch) -> int:
    """``python3 chip_smoke.py --phase 26``: the build and phase 26 alone
    (its results into ``OUT/phase26.json``, its kernels line printed), for
    work on deep trunks and widths over 2048; the full smoke runs every
    phase."""
    from neddf_tpu_torch.kernels import _build

    card = card_line()
    start = time.perf_counter()
    _build.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - start:.1f} s | card: {card}")
    check_spill_functions(_build.build_dir())
    out = {"epilogue": phase_epilogue_wide(torch, card), "deep": phase_deep(torch, card),
           "wide_4096": phase_wide_4096(torch, card),
           "refused_plan": phase_refused_plan(torch, card)}
    drop_large_outputs()
    (OUT / "phase26.json").write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({"kernels": deep_kernel_entries(out)}))
    print(card)
    print(json.dumps({"ok": True, "phase": 26, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drop_large_outputs(limit: int = 1 << 20) -> int:
    """Delete the checkpoints, ``.pth`` files and Chrome traces over
    ``limit`` bytes under ``OUT`` (checked by then), so that the output
    directory stays a few MiB; returns the bytes left."""
    for p in OUT.rglob("*"):
        if (p.is_file() and p.suffix in (".ckpt", ".pth", ".json") and p.name != "summary.json"
                and p.stat().st_size > limit):
            p.unlink()
    return sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())


def time_one(torch, fn, reps: int = 5, inner: int = 10) -> float:
    """Median CUDA-event ms of one call of ``fn`` (each reading the mean of
    ``inner`` calls back to back), after a warm-up."""
    fn()
    readings = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / inner)
    return statistics.median(readings)



def main() -> int:
    if not (REPO / "neddf_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(neddf_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cache_datasets()
    if sys.argv[1:] == ["--phase", "24"]:
        return phase_24_alone(torch)
    if sys.argv[1:] == ["--phase", "25"]:
        return phase_25_alone(torch)
    if sys.argv[1:] == ["--phase", "26"]:
        return phase_26_alone(torch)

    from neddf_tpu_torch.kernels import _build, dual_mlp
    from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_trunk, dual_mlp_trunk_plain
    from neddf_tpu_torch.kernels.mlp import mlp_seg, mlp_seg_plain
    from neddf_tpu_torch.ops.dual import pe_dual_planes_mip
    from neddf_tpu_torch.ops.pe import pe_grad_scale, positional_encoding_mip
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
    from neddf_tpu_torch.training.metrics import (
        peak_signal_noise_ratio,
        structural_similarity,
    )
    from neddf_tpu_torch.utils.png import read_png

    # ---- phase 1: versions and card
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {nvcc}")
    log(f"[1] card: {card} | devices: {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # ---- phase 2: build
    start = time.perf_counter()
    _build.library()
    log(f"[2] kernels built/loaded in {time.perf_counter() - start:.1f} s "
        f"({_build.build_dir()})")
    # phase 19's capture, made on the host while the card runs phases 3-18
    # (started after the build, whose nvcc processes take every core)
    llff_capture = start_llff_capture(OUT / "llff400")
    atexit.register(stop_process, llff_capture[0])
    build_log = _build.build_dir() / "build.log"
    if build_log.exists():
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line or "[build]" in line:
                log(f"[2]   {line.strip()}")
    tc_build = check_tensor_core_build(_build.build_dir())
    lib = _build.library()
    left = [name for name in REMOVED_PASSES if hasattr(lib, name)]
    if left:
        fail(f"the library still exports the folded elementwise passes {left}")
    log(f"[2] the elementwise passes folded into the products are gone from the library: "
        f"{', '.join(REMOVED_PASSES)}")
    for fn_name, count in tc_build["hgmma"].items():
        log(f"[2] SASS {fn_name}: {count} HGMMA, "
            f"{tc_build['spill_bytes'][fn_name]} bytes spilled")
    tc_build["other_spill_bytes"] = check_spill_functions(_build.build_dir())
    for fn_name, nbytes in tc_build["other_spill_bytes"].items():
        log(f"[2] ptxas {fn_name}: {nbytes} bytes spilled")

    # ---- phase 3: kernels against their plain versions
    sd = params_from_jax(load_msgpack_params(RUN / "models" / f"model_{EPOCH:05}.ckpt"))
    n_ddf = sum(1 for k in sd if k.startswith("network_fine.layers_ddf.") and k.endswith(".w"))
    n_col = sum(1 for k in sd if k.startswith("network_fine.layers_col.") and k.endswith(".w"))
    ddf_w = [sd[f"network_fine.layers_ddf.{i}.w"].to(dev) for i in range(n_ddf)]
    ddf_b = [sd[f"network_fine.layers_ddf.{i}.b"].to(dev) for i in range(n_ddf)]
    col_w = [sd[f"network_fine.layers_col.{i}.w"].to(dev) for i in range(n_col)]
    col_b = [sd[f"network_fine.layers_col.{i}.b"].to(dev) for i in range(n_col)]
    layout = tuple(li == 5 for li in range(n_ddf))  # skip after layer 4

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for m in (M_FULL, M_RAGGED):
        pos = torch.rand((m, 3), generator=gen, device=dev) * 2.0 - 1.0
        var = torch.rand((m, 3), generator=gen, device=dev) * 1e-5
        dirs = torch.randn((m, 3), generator=gen, device=dev)
        dirs = dirs / dirs.norm(dim=1, keepdim=True)
        normal = torch.randn((m, 3), generator=gen, device=dev)
        normal = normal / normal.norm(dim=1, keepdim=True)
        emb_v, emb_j = pe_dual_planes_mip(pos, 10, var=var, chan_scale=pe_grad_scale(10, dev))
        for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            w = [x.to(dtype).contiguous() for x in ddf_w]
            v0, j0 = emb_v.to(dtype).contiguous(), emb_j.to(dtype).contiguous()
            vk, jk = dual_mlp_trunk(v0, j0, w, ddf_b, layout)
            vp, jp = dual_mlp_trunk_plain(v0, j0, w, ddf_b, layout)
            torch.cuda.synchronize()
            err_v, rel_v = rel_err(torch, vk, vp)
            err_j, rel_j = rel_err(torch, jk, jp)
            if not (torch.isfinite(vk).all() and torch.isfinite(jk).all()):
                fail(f"dual_mlp_trunk {dtype_name} M={m}: non-finite output")
            if max(rel_v, rel_j) > REL_TOL[dtype_name]:
                fail(f"dual_mlp_trunk {dtype_name} M={m}: rel err {rel_v:.3g}/{rel_j:.3g} "
                     f"> {REL_TOL[dtype_name]}")
            segs = [
                positional_encoding_mip(pos, 10, var=var).to(dtype).contiguous(),
                positional_encoding_mip(dirs, 4).to(dtype).contiguous(),
                normal.to(dtype).contiguous(),
                vp,
            ]
            cw = [x.to(dtype).contiguous() for x in col_w]
            clay = (False,) * n_col
            hk = mlp_seg(segs, cw, col_b, clay)
            hp = mlp_seg_plain(segs, cw, col_b, clay)
            torch.cuda.synchronize()
            err_c, rel_c = rel_err(torch, hk, hp)
            if not torch.isfinite(hk).all():
                fail(f"mlp_seg {dtype_name} M={m}: non-finite output")
            if rel_c > REL_TOL[dtype_name]:
                fail(f"mlp_seg {dtype_name} M={m}: rel err {rel_c:.3g} > {REL_TOL[dtype_name]}")
            entry = {"trunk_max_abs_err": max(err_v, err_j), "trunk_rel": max(rel_v, rel_j),
                     "col_max_abs_err": err_c, "col_rel": rel_c}
            if m == M_FULL:
                entry["trunk_ms"], entry["trunk_plain_ms"] = time_pair(
                    torch, lambda: dual_mlp_trunk(v0, j0, w, ddf_b, layout),
                    lambda: dual_mlp_trunk_plain(v0, j0, w, ddf_b, layout))
                entry["col_ms"], entry["col_plain_ms"] = time_pair(
                    torch, lambda: mlp_seg(segs, cw, col_b, clay),
                    lambda: mlp_seg_plain(segs, cw, col_b, clay))
            results[(m, dtype_name)] = entry
            log(f"[3] M={m} {dtype_name}: {json.dumps(entry)} | card: {card}")
            del vk, jk, vp, jp, hk, hp
        torch.cuda.empty_cache()

    # ---- phase 4: the eval render through run_eval's code path
    run_copy = OUT / "machine_neddf"
    if run_copy.exists():
        shutil.rmtree(run_copy)
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copytree(RUN, run_copy)
    dual_mlp_trunk.launches = 0
    mlp_seg.launches = 0
    dual_mlp_trunk_plain.calls = 0
    mlp_seg_plain.calls = 0
    reset_route_counts(dual_mlp)

    start = time.perf_counter()
    trainer = evaluate(run_copy, EPOCH, cameras=[0], downsampling=8)
    log(f"[4] load + downsampling-8 render: {time.perf_counter() - start:.2f} s")
    eval_dir = run_copy / "eval"
    ds = 8
    rgb = read_png(eval_dir / "000_rgb.png")[:, :, ::-1]
    gt = read_png(eval_dir / "000_rgb_gt.png")[:, :, ::-1]
    gt = gt[::ds, ::ds][: rgb.shape[0], : rgb.shape[1]]
    psnr8 = peak_signal_noise_ratio(rgb, gt)
    ssim8 = structural_similarity(rgb, gt, channel_axis=2)
    log(f"[4] cam 0 downsampling 8: {psnr8:.4f} dB, SSIM {ssim8:.4f} "
        f"(bar >= {PSNR_DS8_MIN} dB, >= {SSIM_DS8_MIN})")
    if not (psnr8 >= PSNR_DS8_MIN and ssim8 >= SSIM_DS8_MIN):
        fail("downsampling-8 render below the bar")

    h, w = trainer.dataset.image_height, trainer.dataset.image_width
    torch.cuda.synchronize()
    start = time.perf_counter()
    rgb_full = trainer.render_test(eval_dir, 0, 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    gt_full = trainer.dataset[0]["rgb_images"].astype("uint8")
    psnr1 = peak_signal_noise_ratio(rgb_full, gt_full)
    ssim1 = structural_similarity(rgb_full, gt_full, channel_axis=2)
    log(f"[4] cam 0 full resolution {w}x{h}: {psnr1:.4f} dB, SSIM {ssim1:.4f}; "
        f"{secs:.3f} s/image, {h * w / secs:.0f} rays/s | card: {card}")
    log(f"[4] vs the JAX package on the CPU: {psnr1 - PSNR_FULL_REF:+.4f} dB; "
        f"vs the TPU figure {PSNR_FULL_TPU}: {psnr1 - PSNR_FULL_TPU:+.4f} dB")
    if not abs(psnr1 - PSNR_FULL_REF) <= PSNR_FULL_TOL:
        fail(f"full-resolution PSNR {psnr1:.4f} not within {PSNR_FULL_TOL} of {PSNR_FULL_REF}")
    if rgb_full.shape != (h, w, 3):
        fail(f"full-resolution image shape {rgb_full.shape}")

    launches = {"dual_mlp_trunk": dual_mlp_trunk.launches, "mlp_seg": mlp_seg.launches}
    eval_routes = route_counts(dual_mlp)
    plain_calls = dual_mlp_trunk_plain.calls + mlp_seg_plain.calls
    log(f"[4] kernel launches on the main path: {launches}; routes {eval_routes}; "
        f"plain calls: {plain_calls}")
    if min(launches.values()) < 1 or plain_calls:
        fail("the main path did not run through both kernels alone")
    check_routes("eval render", eval_routes, "tc", backward=False)

    # the same rays rendered with the kernels and with the plain versions:
    # in f32 only the order of the sums differs (amplified by 1/D in the
    # density and by the inverse CDF); in bf16 a rounding may flip and move
    # a fine sample, so there the bar is on the whole patch (>= 40 dB)
    net = trainer.neural_render.network_fine
    cam_r, cam_t = trainer.camera_pose(0)
    uv = torch.stack(torch.meshgrid(torch.arange(200, 264, 2, device=dev),
                                    torch.arange(200, 264, 2, device=dev),
                                    indexing="xy"), -1).reshape(-1, 2)
    g = torch.Generator(device=dev).manual_seed(1)
    u_s = torch.rand((uv.shape[0], 65), generator=g, device=dev)
    u_p = torch.rand((uv.shape[0], 129), generator=g, device=dev)
    compute_dtype = net.compute_dtype
    render_check = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        net.compute_dtype = dtype
        with torch.no_grad():
            out_k = trainer.neural_render.render_rays(trainer.calib, cam_r, cam_t, uv, u_s, u_p)
            net.fused = "off"
            out_p = trainer.neural_render.render_rays(trainer.calib, cam_r, cam_t, uv, u_s, u_p)
            net.fused = "auto"
        diff = out_k["color"] - out_p["color"]
        max_diff = diff.abs().max().item()
        psnr = -10.0 * math.log10(max(diff.square().mean().item(), 1e-20))
        render_check[name] = {"max_abs_color_diff": max_diff, "psnr_vs_plain": psnr}
        log(f"[4] {uv.shape[0]} rays, {name} trunks, kernels vs plain versions: "
            f"max |color diff| {max_diff:.3g}, {psnr:.2f} dB")
        if not torch.isfinite(out_k["color"]).all():
            fail(f"{name} kernel render: non-finite colour")
        if name == "float32" and max_diff > 1e-3:
            fail("f32 kernel render disagrees with the plain render (bar 1e-3)")
        if name == "bfloat16" and psnr < 40.0:
            fail("bf16 kernel render disagrees with the plain render (bar 40 dB)")
    net.compute_dtype = compute_dtype

    # ---- phase 5: device profile of one render
    profile_render(torch, trainer, eval_dir, card, secs)

    del trainer
    torch.cuda.empty_cache()

    # ---- phase 6: the training path's kernel routes against their plain versions
    train_kernels = phase_train_kernels(torch, sd, card)
    products = phase_products(torch, card)
    fold = phase_fold_products(torch, card)

    # ---- phase 7: the full-width machine_neddf step against the JAX package
    machine = phase_machine_step(torch, card)

    # ---- phase 8: the main path, the default config's training run
    train, run_a = phase_train_run(torch, card)

    # ---- phases 9-12: the NeRF and NeuS configurations
    family_kernels = phase_family_kernels(torch, card)
    family_steps = phase_family_step(torch, card)
    family_runs = phase_family_runs(torch, card)
    other_configs = phase_other_configs(torch, card)

    # ---- phases 21-23: every width up to 512, Softplus and Sigmoid, the
    # density activation: the kernels against their plain versions, then
    # paths (a) (NeDDF wide and smooth) and (b) (NeuS narrow)
    widths_acts = phase_widths_acts(torch, card)
    wide_steps = phase_wide_step(torch, card)
    wide_runs = phase_wide_runs(torch, card)

    # ---- phases 14-17: resume, the camera path, grad_accum, the rest.
    # Run B of phase 14 and the --watchdog run start first: they decode
    # their dataset while phases 15a-b run here
    run_b = start_run_b(OUT / "train_resume")
    run_w = start_watchdog_run(OUT / "train_watchdog")
    try:
        camera = {"machine": phase_camera_machine(torch, card),
                  "kernels": phase_camera_kernels(torch, card)}
        resume = phase_resume(torch, card, run_b, run_a["state"], run_a["losses"])
        # phases 24c and 25c (gloo ranks on the card: correctness, their
        # step times no TP speed) while the --watchdog run (~200 s, anomaly
        # mode) ends, which the card would otherwise wait for
        tp_ranks = phase_tp_ranks(torch, card)
        tpf_ranks = phase_tp_family_ranks(torch, card)
        wide_ranks = phase_wide_ranks(torch, card)
        resume["watchdog_run"] = finish_watchdog_run(torch, card, run_w)
    finally:
        for proc in (run_b[0], run_w[0]):
            stop_process(proc)
    del run_a
    camera["run"] = phase_camera_run(torch, card, train)
    camera["discarded_cotangents"] = phase_discarded_cotangents(torch, card)
    accum = phase_grad_accum(torch, card, train)
    rest = phase_rest(torch, card)

    # ---- phase 18: geometry extraction and the culled eval render
    geometry = phase_geometry(torch, card, {family: (OUT / f"train_{family}", TRAIN_EPOCHS)
                                            for family in ("nerf", "neus")})

    # ---- phase 19: the forward-facing path (an LLFF capture, NDC rays)
    start = time.perf_counter()
    ref = llff_reference()
    llff = {"capture": phase_llff_capture(ref, card, llff_capture)}
    capture = Path(llff["capture"]["capture"])
    llff["steps"] = phase_llff_step(torch, card, ref, capture)
    llff.update(phase_llff_runs(torch, card, capture))
    llff["wall_s"] = time.perf_counter() - start
    log(f"[19] the forward-facing phase took {llff['wall_s']:.1f} s")

    # ---- phase 20: data parallelism (NCCL at world 1, two gloo ranks on the card)
    dp = phase_data_parallel(torch, card)
    dp_step, dp_eval = dp["gloo_two_ranks"][0]["bfloat16"], dp["gloo_two_ranks"][0]["eval"]
    dp_f32 = dp["gloo_two_ranks"][0]["float32"]

    # ---- phase 24: the per-layer route (tensor parallelism, widths over 512)
    # (24c ran beside phase 14b)
    tp = {"kernels": phase_tp_kernels(torch, card), "run": phase_tp_run(torch, card),
          "ranks": tp_ranks}

    # ---- phase 25: NeRF's and NeuS's per-layer route (their tensor
    # parallelism, widths over 512; 25c ran beside phase 14b)
    tpf = {"kernels": phase_tp_family_kernels(torch, card),
           "run": phase_tp_family_run(torch, card), "ranks": tpf_ranks}

    # ---- phase 26: trunks of any depth and widths over 2048 (26c's ranks
    # ran beside phase 14b)
    deep = {"epilogue": phase_epilogue_wide(torch, card), "deep": phase_deep(torch, card),
            "wide_4096": phase_wide_4096(torch, card, wide_ranks),
            "refused_plan": phase_refused_plan(torch, card)}

    def dp_launches(counter: str) -> dict:
        # one rank's launches per sharded step (bf16) and in the sharded eval render
        return {"step_per_rank": dp_step["launches"].get(counter, 0),
                "eval_per_rank": dp_eval["launches"].get(counter, 0)}

    # ---- phase 13: results
    bf16 = results[(M_FULL, "bfloat16")]
    key = f"{M_TRAIN}/bfloat16"
    bounds = slice12_bounds(n_ddf, n_col)

    def bound_keys(b):
        # no single PyTorch call computes any of these routes (a whole MLP
        # with its stash, its backward, the epilogue): library_ms is null
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}

    def entry(name, launch_key, route):
        r = train_kernels[route][key]
        source, replaces = KERNEL_SOURCES[launch_key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train["launches"][launch_key], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_keys(bounds[route]),
                "launches_geometry": geometry_launches(geometry, launch_key, "neddf"),
                "launches_llff": llff_launches(llff, launch_key, "neddf"),
                "launches_dp": dp_launches(launch_key)}

    def family_entry(name, family, route, fkey):
        r = family_kernels[route][fkey]
        source, replaces = KERNEL_SOURCES[route]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": family_runs[family]["launches"][route],
                "max_abs_err": max(v["max_abs_err"] for k, v in family_kernels[route].items()
                                   if k.split("/")[0] == fkey.split("/")[0]),
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_keys(r),
                "launches_geometry": geometry_launches(geometry, route, family),
                "launches_llff": llff_launches(llff, route, family),
                # phase 20 drives the default (NeDDF) configuration only
                "launches_dp": {}}

    bwd = entry("dual_mlp_seg_bwd (trunk K=3; gstack and the layer input folded into the "
                "products over a stream-grouped row tile)", "dual_mlp_seg_bwd",
                "dual_mlp_seg_bwd_trunk")
    bwd["max_abs_err"] = max(bwd["max_abs_err"],
                             train_kernels["dual_mlp_seg_bwd_color"][key]["max_abs_err"])
    nerf_key = f"nerf/{M_NERF_FINE}/bfloat16"
    neus_key = f"neus_color/{M_NEUS}/float32"
    sdf_key = f"ReLU/{M_NEUS}/float32"
    kernels = [
        entry("dual_mlp_trunk (K=3, stash)", "dual_mlp_trunk", "dual_mlp_trunk_stash"),
        {"name": "mlp_seg (NeDDF eval colour)", "route": "cuda",
         "source": KERNEL_SOURCES["mlp_seg"][0], "replaces": KERNEL_SOURCES["mlp_seg"][1],
         "launches": train["launches"]["mlp_seg"],
         "max_abs_err": bf16["col_max_abs_err"],
         "ms": bf16["col_ms"], "plain_ms": bf16["col_plain_ms"],
         **bound_keys(bounds["mlp_seg_eval"]),
         "launches_geometry": geometry_launches(geometry, "mlp_seg", "neddf"),
         "launches_llff": llff_launches(llff, "mlp_seg", "neddf"),
         "launches_dp": dp_launches("mlp_seg")},
        entry("dual_mlp_seg (colour K=1, stash)", "dual_mlp_seg", "dual_mlp_color_k1"),
        bwd,
        entry("neddf_epilogue", "neddf_epilogue", "neddf_epilogue"),
        entry("neddf_epilogue_bwd (standalone mode: dv, dj; off the main path)",
              "neddf_epilogue_bwd", "neddf_epilogue_bwd"),
        entry("neddf_epilogue_gstack (top mode: the epilogue's VJP with the K=3 trunk's "
              "top-layer stacked cotangent)", "neddf_epilogue_gstack", "neddf_epilogue_gstack"),
        family_entry("mlp_seg (NeRF trunk, [h, seg0], ReLU, stash)", "nerf", "mlp_seg",
                     nerf_key),
        family_entry("mlp_seg_bwd (NeRF trunk)", "nerf", "mlp_seg_bwd", nerf_key),
        family_entry("mlp_seg (NeuS colour, 3-wide last layer, stash)", "neus", "mlp_seg",
                     neus_key),
        family_entry("mlp_seg_bwd (NeuS colour)", "neus", "mlp_seg_bwd", neus_key),
        family_entry("sdf_mlp (NeuS trunk + channel-0 sweep)", "neus", "sdf_mlp", sdf_key),
        family_entry("sdf_mlp_bwd", "neus", "sdf_mlp_bwd", sdf_key),
    ]
    # the NeuS sweep alone (phase 9: its second launch over the stash; wgmma
    # + TMA), launched by every sdf_mlp call of the NeuS run
    sw = family_kernels["sdf_sweep"][sdf_key]
    kernels.append({
        "name": "sdf_sweep_kernel (the NeuS reverse sweep of channel 0, f32 by 3xTF32; wgmma "
                "+ TMA)", "route": "cuda", "source": "neddf_tpu_torch/csrc/sdf_sweep.cuh",
        "replaces": "neddf_tpu/kernels/sdf_mlp.py:69", "launches":
        family_runs["neus"]["routes"]["sweep"], "max_abs_err": sw["max_abs_err"],
        "ms": sw["ms"], "plain_ms": sw["plain_ms"], "bound_ms": sw["bound_ms"],
        "bound_by": sw["bound_by"], "library_ms": None, "trunk_ms": sw["trunk_ms"],
        "launches_geometry": {}, "launches_llff": {}, "launches_dp": {}})
    # shallow_nt (the products inside the Pallas _bwd_kernel of a depth under
    # 8, a 3-wide layer's dx; FMA, bound by its f32 output's bytes): phase
    # 6b's K = 3 cases; library_ms torch.matmul on the same operands. An
    # entry where a run launched it (the shipped runs' and, f32,
    # NeuS-1024's colour output on the per-layer route, phase 25b)
    for name, case, dtype, launches, route in (
            ("shallow_nt (bf16 operands: an nt of a depth under 8, f32 FMA, 16-byte "
             "stores)", "nt NeRF last layer dx (K=3)", "bfloat16",
             train["routes"]["products"]["tc"] + family_runs["nerf"]["routes"]["products"]["tc"],
             "tc"),
            ("shallow_nt (f32 operands: an nt of a depth under 8, f32 FMA, 16-byte stores)",
             "f32 nt NeuS colour last layer dx (K=3)", "float32",
             family_runs["neus"]["routes"]["products"]["tf32x3"]
             + tpf["run"]["neus_1024"]["routes"]["products"]["tf32x3"], "tf32x3")):
        if not launches:
            continue
        r = products[case]
        kernels.append({
            "name": name, "route": "cuda", "source": "neddf_tpu_torch/csrc/route_products.cu",
            "replaces": "neddf_tpu/kernels/dual_mlp.py:728", "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in products.values()
                               if v["dtype"] == dtype and v["kernel"] == "shallow_nt"),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "launches_geometry": {},
            "launches_llff": {path: routes["products"][route]
                              for path, routes in llff["routes"].items()
                              if routes["products"][route]},
            "launches_dp": {"step_per_rank": (dp_step if route == "tc" else dp_f32)[
                "routes"]["products"][route], "eval_per_rank": 0}})
    # the products with an activation folded in, on wgmma + TMA (route_nt
    # with the epilogue, route_tn with the prologue; phase 6b at the shipped
    # shapes); launches: the main path's (NeDDF: the dual modes), the NeRF
    # run's (bf16 nt_act, tn_act) and the NeuS run's (f32 nt_act,
    # nn_adjoint, tn_act)
    for mode, case, run, replaces in (
            ("nt_gstack", "nt_gstack K=3 trunk (S=4, 99328 points, bf16, tanhExp)", train,
             "neddf_tpu/kernels/dual_mlp.py:728"),
            ("tn_dual_act", "tn_dual_act K=3 trunk (S=4, 99328 points, bf16, tanhExp)", train,
             "neddf_tpu/kernels/dual_mlp.py:728"),
            ("nt_act", f"nt_act NeRF hidden ({M_NERF_FINE} rows, bf16, ReLU, db)",
             family_runs["nerf"], "neddf_tpu/kernels/mlp.py:248"),
            ("tn_act", f"tn_act NeRF ({M_NERF_FINE} rows, bf16, ReLU)", family_runs["nerf"],
             "neddf_tpu/kernels/mlp.py:248"),
            ("nt_act", f"nt_act NeuS sdf trunk (post-skip, side plane, {SDF_FANS[0]} raw, db; "
             f"{M_NEUS} rows, f32, ReLU)", family_runs["neus"], "neddf_tpu/kernels/sdf_mlp.py:304"),
            ("nn_adjoint", f"nn_adjoint NeuS [qbar | cg] W (256 + {SDF_FANS[0]}; {M_NEUS} rows, "
             f"f32, ReLU)", family_runs["neus"], "neddf_tpu/kernels/sdf_mlp.py:304"),
            ("tn_act", f"tn_act NeuS ({M_NEUS} rows, f32, ReLU)", family_runs["neus"],
             "neddf_tpu/kernels/sdf_mlp.py:304")):
        r = fold["shipped"][case]
        kname = "route_tn" if mode.startswith("tn") else "route_nt"
        kernels.append({
            "name": f"{kname} ({mode}: {case}; wgmma + TMA)", "route": "cuda",
            "source": "neddf_tpu_torch/csrc/route_products.cu", "replaces": replaces,
            "launches": run["routes"]["fold"][mode],
            "max_abs_err": max([r["max_abs_err"]] + [v["max_abs_err"] for k, v in
                                                     fold["grid"][r["dtype"]].items()
                                                     if k.startswith(mode)]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "host_ms": r["host_ms"]})
    # the per-layer route's plain products on wgmma + TMA (phase 6b at width
    # 1024: bf16 the K=3 trunk's 4 x 99,328 rows, f32 NeuS's 265,216);
    # launches: the main path's (layer 0's sides, the post-skip layer's
    # seg0 rows of the fused NeDDF backward), the NeuS run's, and those of
    # the per-layer route's runs (24b, 25b, 26b)
    for kname, layout in (("route_nt", "nt"), ("route_tn", "tn")):
        for dtype, case, launches in (
                ("bfloat16", f"{layout} route {'dx' if layout == 'nt' else 'dW'} 1024",
                 train["routes"]["route_products"][layout]),
                ("float32", f"f32 {layout} route {'dx' if layout == 'nt' else 'dW'} 1024",
                 family_runs["neus"]["routes"]["route_products"][layout])):
            r = products[case]
            kernels.append({
                "name": f"{kname} ({'bf16' if dtype == 'bfloat16' else 'f32 by 3xTF32'}, the "
                        f"per-layer route's {'dx = G W^T' if layout == 'nt' else 'dW = X^T G'}"
                        f", 1024 x 1024; wgmma + TMA)", "route": "cuda",
                "source": "neddf_tpu_torch/csrc/route_products.cu",
                "replaces": "neddf_tpu/kernels/dual_mlp.py:728", "launches": launches,
                "max_abs_err": max(v["max_abs_err"] for v in products.values()
                                   if v["dtype"] == dtype and v["kernel"] == kname),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "host_ms": r["host_ms"],
                "launches_tp_run": tp["run"]["routes"]["route_products"][layout],
                "launches_tpf_runs": {f: v["route_products"][layout]
                                      for f, v in tpf["run"].items()
                                      if isinstance(v, dict) and "route_products" in v},
                "launches_deep_runs": {f: v["route_products"][layout]
                                       for f, v in deep["deep"].items()
                                       if isinstance(v, dict) and "route_products" in v}})
    db = family_kernels["db_sum"]
    kernels.append({
        "name": "sum_rows (the parallel fixed-order db sum of the backwards)", "route": "cuda",
        "source": "neddf_tpu_torch/csrc/dual_mlp_bwd.cu",
        "replaces": "neddf_tpu/kernels/sdf_mlp.py:304",
        "launches": family_runs["neus"]["routes"]["passes"]["db_sum"],
        "max_abs_err": db["max_abs_err"], "ms": db["ms"], "plain_ms": db["plain_ms"],
        "bound_ms": db["bound_ms"], "bound_by": db["bound_by"], "library_ms": db["library_ms"],
        "launches_geometry": {}, "launches_llff": {
            path: routes["passes"]["db_sum"] for path, routes in llff["routes"].items()
            if routes["passes"].get("db_sum")},
        "launches_dp": {"step_per_rank": dp_step["routes"]["passes"]["db_sum"],
                        "eval_per_rank": 0}})
    # phases 21-23: the same kernels beside the shipped width and
    # activations, as paths (a) (NeDDF at width 512, Softplus, a LeakyReLU
    # density; bf16) and (b) (NeuS at width 128, Softplus; f32) launch them:
    # ms, plain ms and bounds of phase 21b at each path's own networks and
    # first rows (path (a)'s mlp_seg: its eval colour), the largest error
    # over the path's rows, the launches of the paths' runs (mlp_seg of
    # path (a): its run_eval)
    for path, spec in WIDE_RUNS.items():
        shape = PATH_SHAPES[path]
        what = (f"path {spec['tag']}: width {shape['width']}, {shape['act']}"
                + (f", {shape['density']} density" if "density" in shape else "")
                + f", {shape['dtype']}")
        run = wide_runs[path]
        runs = {route: v for m, _ in shape["runs"][::-1]
                for route, v in widths_acts["paths"][f"{path}/{m}"].items()
                if isinstance(v, dict)}
        for route in dict.fromkeys((*spec["train"], *spec["eval"])):
            r = runs[route]
            kernels.append({
                "name": f"{route} ({what})", "route": "cuda",
                "source": KERNEL_SOURCES[route][0], "replaces": KERNEL_SOURCES[route][1],
                "launches": run["launches"].get(route, run["eval_launches"].get(route, 0)),
                "max_abs_err": max(widths_acts["paths"][f"{path}/{m}"][route]["max_abs_err"]
                                   for m, _ in shape["runs"]
                                   if route in widths_acts["paths"][f"{path}/{m}"]),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None})
    # phase 24: the per-layer route's modes (24a, bf16 at TP_ROWS rows and
    # width 1024), the launches of 24b's 1024-wide run and of one TP rank's
    # bf16 step at width 1024 (24c)
    tp_run, tp_rank0 = tp["run"], tp["ranks"]["ranks"][0]
    tp_step = tp_rank0[f"{TP_WIDTH}/bfloat16"]
    for name, key, source, replaces, launches, per_rank in (
            ("layer_fwd_wide (per-layer route, K=3 trunk layer, 1024 -> 1024; wgmma + TMA)",
             "fwd_trunk", "neddf_tpu_torch/csrc/layer_fwd.cu",
             "neddf_tpu/kernels/dual_mlp.py:635", tp_run["layer_forward"]["s4"],
             tp_step["layer_forward"]["s4"]),
            ("layer_fwd_wide (per-layer route, K=1 colour layer 0, [87 | 1024] -> 1024)",
             "fwd_color", "neddf_tpu_torch/csrc/layer_fwd.cu",
             "neddf_tpu/kernels/dual_mlp.py:635", tp_run["layer_forward"]["s2"],
             tp_step["layer_forward"]["s2"]),
            ("layer_fwd_wide (value-only per-layer route, eval colour layer 0)", "fwd_value",
             "neddf_tpu_torch/csrc/layer_fwd.cu", "neddf_tpu/kernels/mlp.py:192",
             tp_run["eval_layer_forward"]["s1"],
             tp_rank0["eval_layer_forward"]["s1"]),
            ("dual_mlp_layers forward walk (K=3 trunk, 7 layers at 1024)", "walk_fwd",
             "neddf_tpu_torch/csrc/layer_fwd.cu", "neddf_tpu/kernels/dual_mlp.py:635",
             tp_run["launches"]["dual_mlp_layers"], tp_step["launches"]["dual_mlp_layers"]),
            ("dual_mlp_layers backward walk (K=3 trunk: gstack, tn and nt products per layer)",
             "walk_bwd", "neddf_tpu_torch/csrc/dual_mlp_bwd.cu",
             "neddf_tpu/kernels/dual_mlp.py:935", tp_run["launches"]["dual_mlp_layers"],
             tp_step["launches"]["dual_mlp_layers"]),
            ("gstack_kernel (f32 cotangents, the per-layer route's backward)", "gstack_f32",
             "neddf_tpu_torch/csrc/dual_mlp_bwd.cu", "neddf_tpu/kernels/dual_mlp.py:935",
             tp_run["routes"]["passes"]["gstack"], tp_step["passes"]["gstack"]),
            ("neddf_epilogue (width 1024)", "epilogue", "neddf_tpu_torch/csrc/neddf_epilogue.cu",
             "neddf_tpu/kernels/neddf_epilogue.py:329", tp_run["launches"]["neddf_epilogue"],
             tp_step["launches"]["neddf_epilogue"]),
            ("neddf_epilogue_bwd (standalone mode, width 1024)", "epilogue_bwd",
             "neddf_tpu_torch/csrc/neddf_epilogue.cu", "neddf_tpu/kernels/neddf_epilogue.py:365",
             tp_run["launches"]["neddf_epilogue_bwd"],
             tp_step["launches"]["neddf_epilogue_bwd"])):
        r = tp["kernels"]["bfloat16"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(
                tp["kernels"][d][key]["max_abs_err"] for d in ("float32", "bfloat16")),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "launches_tp_rank_step": per_rank})
    # phase 25: NeRF's and NeuS's per-layer route's modes and walks
    kernels.extend(tpf_kernel_entries(tpf))
    # phase 26: the epilogue past 2048 (#6's column-chunked kernel, #5)
    kernels.extend(deep_kernel_entries(deep))
    summary = {
        "card": card, "psnr_ds8": psnr8, "ssim_ds8": ssim8, "psnr_full": psnr1,
        "ssim_full": ssim1, "seconds_per_image": secs, "rays_per_s": h * w / secs,
        "kernel_checks": {f"{m}/{d}": v for (m, d), v in results.items()},
        "render_check": render_check, "eval_launches": launches,
        "train_kernel_checks": train_kernels, "products": products, "fold_products": fold,
        "tensor_core_build": tc_build,
        "eval_routes": eval_routes, "machine_step": machine, "train_run": train,
        "bounds_slices_1_2": bounds, "family_kernel_checks": family_kernels,
        "family_steps": family_steps, "family_runs": family_runs,
        "other_configs": other_configs, "resume": resume, "camera": camera,
        "grad_accum": accum, "rest": rest, "geometry": geometry, "llff": llff,
        "data_parallel": dp, "widths_acts": widths_acts, "wide_steps": wide_steps,
        "wide_runs": wide_runs, "tensor_parallel": tp, "tensor_parallel_families": tpf,
        "deep_and_wide": deep,
    }
    kept = drop_large_outputs()
    log(f"[13] {kept / 2**20:.1f} MiB of outputs kept under {OUT.relative_to(REPO)} (the "
        f"checkpoints, .pth files and traces over 1 MiB deleted)")
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
