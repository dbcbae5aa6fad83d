#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port: build, check and drive its kernels.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure stops the script with a non-zero exit code):

1. versions of torch, CUDA and nvcc, and the card's name and power limit;
2. build the CUDA kernels from ``neddf_tpu_torch/csrc`` (timed); in the
   built library's SASS every product kernel, tile forward and NeuS
   sweep has HMMA (tensor-core) instructions, on TF32 operands
   in the f32 instantiations (the 3xTF32 split) and not in the bf16
   ones, and ptxas reports no spills in them nor in the epilogue
   backward's 8 instantiations;
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
   NeuS backward's (dx, dW and the sweep adjoint over 265,216 rows, the
   36-wide PE side, the colour trunk's 3-wide last layer, a ragged row
   count), against its plain version, with the times of both, of
   ``torch.matmul`` on the same operands (f32: TF32 off) and the bound,
   and TFLOP/s;
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
   beside the FMA kernels' (before the tensor cores); LeakyReLU on both ``mlp_seg`` precisions and on
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
11b. NeDDF, NeRF and NeuS with LeakyReLU at ``fused="auto"`` through
   their kernels (finite, every kernel launched), and a width the kernels
   do not take raising NotImplementedError on the card;
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
13. (printed last) one JSON line of per-kernel results (with each route's
   bound; the parallel db sum among them; ``launches_geometry`` and
   ``launches_llff``: each kernel's launches on the phase-18 and
   phase-19 paths), the card line, and the final ``{"ok": true,
   "device": {...}}`` line.

Each dataset split is decoded once in this process (``cache_datasets``).
Outputs go to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import atexit
import json
import math
import shutil
import statistics
import subprocess
import sys
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
# names in the library) and how many instantiations each has
# tc_gemm_kernel: bf16 and f32 x nt, tn, nn plain (6); the activation
# prologue on tn (bf16 and f32 x tanhExp, ReLU, LeakyReLU: 6), the
# epilogue on nt (the same 6) and on nn (f32 x 3); the dual backward's
# products over rows grouped by point, its layer-input prologue on tn and
# its stacked-cotangent epilogue on nt (bf16 and f32 x 3 activations x S =
# 2, 4: 12 each)
TC_FUNCTIONS = {"tc_gemm_kernel": 45,
                "mlp_tile_fwd": 18,   # bf16 and f32 x K=3, K=1, K=0 x the 3 activations
                "sdf_sweep_kernel": 3}  # f32 x the 3 activations


# the elementwise passes of the backwards that the products' epilogues and
# prologues took over: their entry points are gone
REMOVED_PASSES = ("neddf_sdf_sweep_p", "neddf_sdf_adjoint", "neddf_sdf_zbar", "neddf_sdf_act",
                  "neddf_mlp_act", "neddf_dual_act")


# phase 2: other kernels whose instantiations ptxas must build without
# spills: the epilogue backward (bf16 and f32 x the standalone mode and the
# top mode's 3 activations), two blocks of 256 threads per SM (128
# registers each)
SPILL_FUNCTIONS = {"epi_bwd_kernel": 8}


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
    the HMMA/HGMMA instructions of every tensor-core function (the
    products, the tile forwards and the NeuS sweep), the f32 ones
    on TF32 operands (3xTF32) and the bf16 ones not; ptxas's ``-v`` lines
    in the build log show their spills; fails on a count of 0, a missing
    instantiation or a spill."""
    from neddf_tpu_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build_dir / _build._LIB_NAME)],
                          capture_output=True, text=True, check=True).stdout
    hmma, tf32, name = {}, {}, None
    for line in sass.splitlines():
        text = line.strip()
        if text.startswith("Function :"):
            name = text.split(":", 1)[1].strip()
            if _is_tc_function(name):
                hmma[name] = tf32[name] = 0
        elif name in hmma and ("HMMA" in text or "HGMMA" in text):
            hmma[name] += 1
            tf32[name] += "TF32" in text
    spills = ptxas_spills(build_dir, TC_FUNCTIONS)
    for key, count in TC_FUNCTIONS.items():
        found = [n for n in hmma if key in n]
        if len(found) != count:
            fail(f"SASS: {len(found)} tensor-core instantiations of {key}, expected {count}")
    if min(hmma.values()) < 1:
        fail(f"SASS: a tensor-core function without HMMA: {hmma}")
    for fn in hmma:
        is_f32 = "nv_bfloat16" not in fn
        if is_f32 != (tf32[fn] > 0) or (is_f32 and tf32[fn] != hmma[fn]):
            fail(f"SASS: {fn}: {tf32[fn]} of {hmma[fn]} HMMA on TF32 operands")
    if set(spills) != set(hmma) or max(spills.values()) > 0:
        fail(f"ptxas: spills in the tensor-core functions (or missing -v lines): {spills}")
    return {"hmma": hmma, "tf32_hmma": tf32, "spill_bytes": spills}


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
    return head if head.startswith("tc_gemm_kernel") else head.split("<")[0]


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
        return (dm.PASS_LAUNCHES["gstack"], dm.PASS_LAUNCHES["dual_act"],
                dm.Products.epilogue_launches, dm.Products.prologue_launches)

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
        v, j, wd_, wa_, b2_, scal_, g_o, g_t, g_c, z, act = args
        before = epi.neddf_epilogue_gstack.launches
        tk = epi.neddf_epilogue_gstack(*args)
        tp = epi.neddf_epilogue_gstack_plain(*args)
        torch.cuda.synchronize()
        if epi.neddf_epilogue_gstack.launches != before + 1:
            fail(f"{route} {dtype_name} M={m}: the top mode's kernel did not launch once")
        r = check(route, m, dtype_name, list(zip(tk, tp)), tol)
        dv, dj = epi.neddf_epilogue_bwd(v, j, wd_, wa_, b2_, scal_, g_o, g_t)[:2]
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
            ek = epi.neddf_epilogue(v_feat, j_feat, wd, wa, b2, scal)
            ep = epi.neddf_epilogue_plain(v_feat, j_feat, wd, wa, b2, scal)
            check("neddf_epilogue", m, dtype_name, [(ek[0], ep[0]), (ek[1], ep[1])], tol)
            g_out = torch.randn((10, m), generator=gen, device=dev)
            g_tf = (torch.randn((m, 256), generator=gen, device=dev) * 0.1).to(dtype)
            ebk = epi.neddf_epilogue_bwd(v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf)
            ebp = epi.neddf_epilogue_bwd_plain(v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf)
            check("neddf_epilogue_bwd", m, dtype_name, list(zip(ebk, ebp)), btol)
            again = epi.neddf_epilogue_bwd(v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf)
            if not all(torch.equal(a, b) for a, b in zip(ebk, again)):
                fail(f"neddf_epilogue_bwd {dtype_name} M={m}: two runs differ")
            # the main path's mode: with the colour trunk's cotangent of
            # v_feat and the trunk's top-layer stash
            g_col = (torch.randn((m, 256), generator=gen, device=dev) * 0.01).to(dtype)
            top_args = (v_feat, j_feat, wd, wa, b2, scal, g_out, g_tf, g_col, t_pres[-1],
                        "tanhExp")
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
                        lambda: epi.neddf_epilogue(v_feat, j_feat, wd, wa, b2, scal),
                        lambda: epi.neddf_epilogue_plain(v_feat, j_feat, wd, wa, b2, scal)),
                    "neddf_epilogue_bwd": (
                        lambda: epi.neddf_epilogue_bwd(v_feat, j_feat, wd, wa, b2, scal,
                                                       g_out, g_tf),
                        lambda: epi.neddf_epilogue_bwd_plain(v_feat, j_feat, wd, wa, b2, scal,
                                                             g_out, g_tf)),
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
                                                    g_tf)[:2]
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

    def replay(vs, js, ws, bs, lay, act, hj, k, pres):
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
                                (uniform(m, 256) * 0.1).to(dtype), gv, fp[2][-1], act)
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
    network over both passes' 265,216 rows): the trunk's dx, dW and the
    sweep adjoint's pbar = qbar W (nn), the PE side (E = 36: dW of layer
    0, cg W_0, the post-skip layer's e rows), the colour trunk's 3-wide
    last layer and a ragged row count."""
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
        ("f32 nn NeuS sweep adjoint", "nn", f32(rs, 256), f32(256, 256)),
        (f"f32 tn NeuS layer 0 dW (m={e})", "tn", f32(rs, e), f32(rs, 256)),
        (f"f32 nn NeuS cg W0 (K={e})", "nn", f32(rs, e), f32(e, 256)),
        (f"f32 nt NeuS e rows dx (N={e})", "nt", f32(rs, 256), f32(e, 256)),
        ("f32 nt NeuS colour last layer dx (K=3)", "nt", f32(rs, 3), f32(256, 3)),
        ("f32 tn NeuS colour last layer dW (N=3)", "tn", f32(rs, 256), f32(rs, 3)),
        (f"f32 tn ragged ({rsr} rows)", "tn", f32(rsr, 256), f32(rsr, 256)),
    ]


def product_call(layout, a, b):
    """The strided call ``(m, n, k, a, sam, sak, b, sbk, sbn)`` of one case
    and the PyTorch call that computes the same product (the yardstick)."""
    import torch

    if layout == "nt":  # a [R, k] times b [n, k]^T
        (m, k), n = a.shape, b.shape[0]
        return (m, n, k, a, k, 1, b, 1, k), lambda: torch.matmul(a, b.T)
    if layout == "tn":  # a [R, m]^T times b [R, n], over R rows
        (k, m), n = a.shape, b.shape[1]
        return (m, n, k, a, 1, m, b, n, 1), lambda: torch.matmul(a.T, b)
    (m, k), n = a.shape, b.shape[1]  # nn: a [R, k] times b [k, n]
    return (m, n, k, a, k, 1, b, n, 1), lambda: torch.matmul(a, b)


def phase_products(torch, card: str) -> dict:
    """Phase 6b: the tensor-core product (``neddf_gemm_tc`` through
    ``Products``) against its plain version, with the times of both, of
    ``torch.matmul`` on the same operands (the yardstick, bf16 out for
    bf16 operands, f32 with TF32 off for f32 ones; the port never calls
    it) and the bound, and TFLOP/s per shape."""
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

        got, ref = kernel(), plain()
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
             "k": k, "max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "tflops": flops / ms / 1e9,
             **bound(flops, t * (m * k + k * n) + 4 * m * n, "tf32x3" if f32 else "bfloat16")}
        if f32:
            r["fma_bound_ms"] = bound(flops, 0, "float32")["bound_ms"]
        results[name] = r
        log(f"[6b] product {name}: {r['tflops']:.1f} TFLOP/s, {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"torch.matmul {r['dtype']} {library_ms:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), rel err {rel:.2e} | card: {card}")
        del got, ref
    torch.cuda.empty_cache()
    return results


def _pass_counters(dm) -> list:
    """The elementwise passes' launch counters of the three kernel modules."""
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    return [mlp.PASS_LAUNCHES, sk.PASS_LAUNCHES, dm.PASS_LAUNCHES]


def route_counts(dm) -> dict:
    """Launches of the product kernel and of the tile forward by operand
    type: "tc" (bf16 mma) and "tf32x3" (f32 by the 3xTF32 split); of the
    products with an activation folded in; of the elementwise passes."""
    passes = {}
    for counter in _pass_counters(dm):
        passes.update(counter)
    return {"products": {"tc": dm.Products.tc_launches, "tf32x3": dm.Products.tf32x3_launches},
            "folded": {"prologue": dm.Products.prologue_launches,
                       "epilogue": dm.Products.epilogue_launches},
            "tile_forward": dict(dm.TILE_LAUNCHES), "passes": passes}


def reset_route_counts(dm) -> None:
    dm.Products.tc_launches = dm.Products.tf32x3_launches = 0
    dm.Products.prologue_launches = dm.Products.epilogue_launches = 0
    dm.TILE_LAUNCHES.update(tc=0, tf32x3=0)
    for counter in _pass_counters(dm):
        counter.update({k: 0 for k in counter})


def check_routes(what: str, counts: dict, route: str, backward: bool = True) -> None:
    """A run in one compute dtype: every product and every tile forward on
    its route ("tc" for bf16, "tf32x3" for f32), none on the other, and
    both launched."""
    other = {"tc": "tf32x3", "tf32x3": "tc"}[route]
    if counts["tile_forward"][other] or counts["tile_forward"][route] < 1:
        fail(f"{what}: tile forward routes {counts['tile_forward']}, expected {route} only")
    if backward and (counts["products"][other] or counts["products"][route] < 1):
        fail(f"{what}: product routes {counts['products']}, expected {route} only")


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
              epi.neddf_epilogue_gstack_plain]
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

    cfg = config_lib.compose(REPO / "config", overrides=[*FAMILY_OVERRIDES.get(family, []),
                                                         *extra])
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


def phase_family_step(torch, card: str) -> dict:
    """Phase 10: one full-width f32 step of each family from the seeded
    parameters, against the JAX package's numbers on the CPU."""
    out = {}
    for family in FAMILY_OVERRIDES:
        extra = ["network.compute_dtype=float32"] if family == "nerf" else []
        trainer = family_trainer(torch, family, [*extra, "trainer.optimize_camera=true"])
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        render.load_state_dict({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
        draws = machine_step_draws(trainer.dataset.image_width, trainer.dataset.image_height,
                                   render.sample_coarse + 1, render.sample_fine + 1,
                                   seed=FAMILY_DRAW_SEED, batch=FAMILY_BATCH)
        us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device) for x in draws)
        loss, loss_dict, mse = trainer.step_grads(FAMILY_CAMERA, us.long(), vs.long(),
                                                  u_strat, u_pdf)
        got = {"loss": loss.item(), "mse": mse.item(),
               "losses": {k: v.item() for k, v in loss_dict.items()},
               "grad_norms": {n: p.grad.norm().item() for n, p in render.named_parameters()}}
        ref = FAMILY_STEP[family]
        worst, wider = hold_step(f"[10] {family}", got, ref, card)
        # the pose-delta gradient (optimize_camera): the kernels' input
        # cotangents through the position encoding into the rays
        cam_bar = max(JAX_STEP_TOL, SPREAD_FACTOR * ref["camera_grad_spread"])
        cam_rel = camera_grad_check(torch, f"[10] {family} camera", trainer.camera_deltas.grad,
                                    ref["camera_grad"], cam_bar, FAMILY_CAMERA)
        log(f"[10] {family} camera {FAMILY_CAMERA}'s pose-delta gradient vs the JAX package: "
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


def expected_folding(family: str, launches: dict, dual_layers=None) -> dict:
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
    mode forms its stacked cotangent and sums its db); no dual_act."""
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
                       "epilogue": col * (layers - 1) + sdf * 3 * (n_sdf - 1)}}


# run_eval at downsampling 8, kernels vs plain versions: PSNR gap (dB)
EVAL_PSNR_GAP_DB = 0.05


def phase_family_runs(torch, card: str) -> dict:
    """Phases 11 and 12: a 300-step run of each configuration through
    ``scripts/run.py``, then a ``run_eval`` render of its run dir through
    the kernels and through the plain versions."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import neddf_epilogue as epi
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio

    kernels = {"mlp_seg": mlp.mlp_seg, "mlp_seg_bwd": mlp.mlp_seg_bwd,
               "sdf_mlp": sk.sdf_mlp, "sdf_mlp_bwd": sk.sdf_mlp_bwd}
    plains = [mlp.mlp_seg_plain, mlp.mlp_seg_bwd_plain, sdf_grad.sdf_trunk_with_grad,
              sdf_grad.sdf_trunk_with_grad_vjp, dm.dual_mlp_trunk_plain, dm.dual_mlp_seg_plain,
              dm.dual_mlp_seg_bwd_plain, epi.neddf_epilogue_plain, epi.neddf_epilogue_bwd_plain]
    out = {}
    for family, needed in FAMILY_RUN_KERNELS.items():
        for fn in kernels.values():
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        reset_route_counts(dm)
        torch.cuda.reset_peak_memory_stats()
        run_dir = OUT / f"train_{family}"
        start = time.perf_counter()
        trainer = run_main_path(torch, run_dir, [*FAMILY_OVERRIDES[family],
                                                 f"trainer.epoch_save_model={TRAIN_EPOCHS}"])
        wall = time.perf_counter() - start
        launches = {k: kernels[k].launches for k in needed}
        routes = route_counts(dm)
        plain_calls = sum(fn.calls for fn in plains)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"[11] {family} run: {trainer.iteration} steps in {wall:.1f} s (load, hooks and "
            f"checkpoints included), peak device memory {peak_gib:.2f} GiB; launches "
            f"{launches}; routes {routes}; plain calls {plain_calls}")
        if min(launches.values()) < 1 or plain_calls:
            fail(f"the {family} run did not go through every kernel alone")
        check_routes(f"the {family} run", routes, FAMILY_ROUTES[family])
        expected = expected_folding(family, launches)
        got = {"passes": routes["passes"], "folded": routes["folded"]}
        log(f"[11] {family} run: elementwise launches {routes['passes']} and products with an "
            f"activation folded in {routes['folded']} (expected {expected}); no launch of "
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
        log(f"[11] {family} train PSNR: first 50 steps {first:.3f} dB, last 50 {last:.3f} dB "
            f"(gain bar {PSNR_GAIN_MIN} dB); loss {mean([r['loss'] for r in hist[:50]]):.5f} -> "
            f"{mean([r['loss'] for r in hist[-50:]]):.5f}")
        if not last - first >= PSNR_GAIN_MIN:
            fail(f"{family}: train PSNR did not rise")
        steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
        ms_step = 1000.0 * mean(steady)
        rays_s = trainer.batch_size / mean(steady)
        dtype = str(trainer.neural_render.network_fine.compute_dtype).replace("torch.", "") \
            if hasattr(trainer.neural_render.network_fine, "compute_dtype") else "float32"
        log(f"[11] {family}: {ms_step:.2f} ms/step, {rays_s:.0f} rays/s (steps 100-199, "
            f"{dtype}, {trainer.batch_size} rays) | card: {card}")
        busy = profile_train(torch, trainer, card, f"profile_train_{family}.txt",
                             f"{trainer.batch_size} rays, {dtype}", "11")["busy_share"]
        del trainer
        torch.cuda.empty_cache()

        # phase 12: run_eval of the run dir, kernels then plain versions
        for fn in kernels.values():
            fn.launches = 0
        ev = evaluate(run_dir, TRAIN_EPOCHS, cameras=[0], downsampling=8)
        eval_launches = {k: kernels[k].launches for k in needed if not k.endswith("_bwd")}
        gt = ev.dataset[0]["rgb_images"].astype("uint8")[::8, ::8]
        psnrs = {}
        for mode in ("kernels", "plain"):
            nets = [ev.neural_render.network_fine]
            if ev.neural_render.use_coarse_network:
                nets.append(ev.neural_render.network_coarse)
            for net in nets:
                net.fused = "auto" if mode == "kernels" else "off"
            ev.generator.manual_seed(ev.seed)
            rgb = ev.render_test(run_dir / f"eval_{mode}", 0, 8)
            psnrs[mode] = peak_signal_noise_ratio(rgb, gt[: rgb.shape[0], : rgb.shape[1]])
        gap = abs(psnrs["kernels"] - psnrs["plain"])
        log(f"[12] {family} run_eval cam 0 at downsampling 8: {psnrs['kernels']:.4f} dB through "
            f"the kernels (launches {eval_launches}), {psnrs['plain']:.4f} dB through the plain "
            f"versions, gap {gap:.4f} dB (bar {EVAL_PSNR_GAP_DB})")
        if min(eval_launches.values()) < 1 or not gap <= EVAL_PSNR_GAP_DB:
            fail(f"{family}: run_eval through the kernels and the plain versions disagree")
        del ev
        torch.cuda.empty_cache()
        out[family] = {"launches": launches, "routes": routes, "plain_calls": plain_calls,
                       "wall_s": wall,
                       "ms_per_step": ms_step, "rays_per_s": rays_s, "busy_share": busy,
                       "peak_memory_gib": peak_gib, "psnr_first50": first, "psnr_last50": last,
                       "eval_psnr": psnrs, "eval_launches": eval_launches,
                       "loss_curve": [r["loss"] for r in hist],
                       "psnr_curve": [r["psnr"] for r in hist]}
    return out


# phase 11b: configurations beside the shipped ones, on a small batch of
# points (rays x samples): every field with LeakyReLU at fused="auto"
# launches its kernels, forward and backward, and a width the kernels do
# not take makes them raise on the card (no plain version runs there)
OTHER_BATCH = (64, 32)
OTHER_REFUSED = {"ddf_layer_width": 128}


def phase_other_configs(torch, card: str) -> dict:
    """Phase 11b: NeDDF, NeRF and NeuS with ``activation_type=LeakyReLU``
    through their kernels at ``fused="auto"`` (every output and gradient
    finite, each kernel of the field launched; the gaps to ``fused="off"``
    printed, the kernels themselves are held to their plain versions in
    phases 6 and 9), and NeDDF at ``OTHER_REFUSED``: NotImplementedError."""
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
    for field, kernels in field_kernels.items():
        torch.manual_seed(0)
        net = field(activation_type="LeakyReLU").to(dev)
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
        out[field.__name__] = {"launches": launched, "finite": finite, "rel_gap_to_off": gaps}
        log(f"[11b] {field.__name__} LeakyReLU at fused='auto': launches {launched}, finite "
            f"{finite}, largest relative gap to fused='off' {json.dumps(gaps)} | card: {card}")
        if not finite or min(launched.values()) < 1:
            fail(f"phase 11b: {field.__name__} with LeakyReLU did not run through its kernels")
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
               "sdf_mlp_bwd": sk.sdf_mlp_bwd}
    plains = [dm.dual_mlp_trunk_plain, dm.dual_mlp_seg_plain, dm.dual_mlp_seg_bwd_plain,
              mlp.mlp_seg_plain, mlp.mlp_seg_bwd_plain, epi.neddf_epilogue_plain,
              epi.neddf_epilogue_bwd_plain, epi.neddf_epilogue_gstack_plain,
              sdf_grad.sdf_trunk_with_grad, sdf_grad.sdf_trunk_with_grad_vjp]
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
    # phase 19's capture, made on the host while the card runs phases 2-18
    llff_capture = start_llff_capture(OUT / "llff400")
    atexit.register(stop_process, llff_capture[0])

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
    for fn_name, count in tc_build["hmma"].items():
        log(f"[2] SASS {fn_name}: {count} HMMA/HGMMA, "
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

    # ---- phase 7: the full-width machine_neddf step against the JAX package
    machine = phase_machine_step(torch, card)

    # ---- phase 8: the main path, the default config's training run
    train, run_a = phase_train_run(torch, card)

    # ---- phases 9-12: the NeRF and NeuS configurations
    family_kernels = phase_family_kernels(torch, card)
    family_steps = phase_family_step(torch, card)
    family_runs = phase_family_runs(torch, card)
    other_configs = phase_other_configs(torch, card)

    # ---- phases 14-17: resume, the camera path, grad_accum, the rest.
    # Run B of phase 14 and the --watchdog run start first: they decode
    # their dataset while phases 15a-b run here
    run_b = start_run_b(OUT / "train_resume")
    run_w = start_watchdog_run(OUT / "train_watchdog")
    try:
        camera = {"machine": phase_camera_machine(torch, card),
                  "kernels": phase_camera_kernels(torch, card)}
        resume = phase_resume(torch, card, run_b, run_a["state"], run_a["losses"])
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

    # ---- phase 13: results
    bf16 = results[(M_FULL, "bfloat16")]
    key = f"{M_TRAIN}/bfloat16"
    bounds = slice12_bounds(n_ddf, n_col)

    def bound_keys(b):
        # no single PyTorch call computes any of these routes (a whole MLP
        # with its stash, its backward, the epilogue): library_ms is null
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": None}

    def entry(name, source, replaces, launch_key, route):
        r = train_kernels[route][key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train["launches"][launch_key], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_keys(bounds[route]),
                "launches_geometry": geometry_launches(geometry, launch_key, "neddf"),
                "launches_llff": llff_launches(llff, launch_key, "neddf")}

    def family_entry(name, source, replaces, family, route, fkey):
        r = family_kernels[route][fkey]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": family_runs[family]["launches"][route],
                "max_abs_err": max(v["max_abs_err"] for k, v in family_kernels[route].items()
                                   if k.split("/")[0] == fkey.split("/")[0]),
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bound_keys(r),
                "launches_geometry": geometry_launches(geometry, route, family),
                "launches_llff": llff_launches(llff, route, family)}

    bwd = entry("dual_mlp_seg_bwd (trunk K=3; gstack and the layer input folded into the "
                "products over a stream-grouped row tile)", "neddf_tpu_torch/csrc/dual_mlp_bwd.cu",
                "neddf_tpu/kernels/dual_mlp.py:935", "dual_mlp_seg_bwd",
                "dual_mlp_seg_bwd_trunk")
    bwd["max_abs_err"] = max(bwd["max_abs_err"],
                             train_kernels["dual_mlp_seg_bwd_color"][key]["max_abs_err"])
    nerf_key = f"nerf/{M_NERF_FINE}/bfloat16"
    neus_key = f"neus_color/{M_NEUS}/float32"
    sdf_key = f"ReLU/{M_NEUS}/float32"
    kernels = [
        entry("dual_mlp_trunk (K=3, stash)", "neddf_tpu_torch/csrc/dual_mlp_fwd.cu",
              "neddf_tpu/kernels/dual_mlp.py:635", "dual_mlp_trunk", "dual_mlp_trunk_stash"),
        {"name": "mlp_seg (NeDDF eval colour)", "route": "cuda",
         "source": "neddf_tpu_torch/csrc/mlp_fwd.cu",
         "replaces": "neddf_tpu/kernels/mlp.py:192",
         "launches": train["launches"]["mlp_seg"],
         "max_abs_err": bf16["col_max_abs_err"],
         "ms": bf16["col_ms"], "plain_ms": bf16["col_plain_ms"],
         **bound_keys(bounds["mlp_seg_eval"]),
         "launches_geometry": geometry_launches(geometry, "mlp_seg", "neddf"),
         "launches_llff": llff_launches(llff, "mlp_seg", "neddf")},
        entry("dual_mlp_seg (colour K=1, stash)", "neddf_tpu_torch/csrc/dual_mlp_fwd.cu",
              "neddf_tpu/kernels/dual_mlp.py:635", "dual_mlp_seg", "dual_mlp_color_k1"),
        bwd,
        entry("neddf_epilogue", "neddf_tpu_torch/csrc/neddf_epilogue.cu",
              "neddf_tpu/kernels/neddf_epilogue.py:329", "neddf_epilogue", "neddf_epilogue"),
        entry("neddf_epilogue_bwd (standalone mode: dv, dj; off the main path)",
              "neddf_tpu_torch/csrc/neddf_epilogue.cu",
              "neddf_tpu/kernels/neddf_epilogue.py:365", "neddf_epilogue_bwd",
              "neddf_epilogue_bwd"),
        entry("neddf_epilogue_gstack (top mode: the epilogue's VJP with the K=3 trunk's "
              "top-layer stacked cotangent)", "neddf_tpu_torch/csrc/neddf_epilogue.cu",
              "neddf_tpu/kernels/neddf_epilogue.py:365", "neddf_epilogue_gstack",
              "neddf_epilogue_gstack"),
        family_entry("mlp_seg (NeRF trunk, [h, seg0], ReLU, stash)",
                     "neddf_tpu_torch/csrc/mlp_fwd.cu", "neddf_tpu/kernels/mlp.py:192",
                     "nerf", "mlp_seg", nerf_key),
        family_entry("mlp_seg_bwd (NeRF trunk)", "neddf_tpu_torch/csrc/mlp_bwd.cu",
                     "neddf_tpu/kernels/mlp.py:248", "nerf", "mlp_seg_bwd", nerf_key),
        family_entry("mlp_seg (NeuS colour, 3-wide last layer, stash)",
                     "neddf_tpu_torch/csrc/mlp_fwd.cu", "neddf_tpu/kernels/mlp.py:192",
                     "neus", "mlp_seg", neus_key),
        family_entry("mlp_seg_bwd (NeuS colour)", "neddf_tpu_torch/csrc/mlp_bwd.cu",
                     "neddf_tpu/kernels/mlp.py:248", "neus", "mlp_seg_bwd", neus_key),
        family_entry("sdf_mlp (NeuS trunk + channel-0 sweep)", "neddf_tpu_torch/csrc/sdf_mlp.cu",
                     "neddf_tpu/kernels/sdf_mlp.py:257", "neus", "sdf_mlp", sdf_key),
        family_entry("sdf_mlp_bwd", "neddf_tpu_torch/csrc/sdf_mlp.cu",
                     "neddf_tpu/kernels/sdf_mlp.py:304", "neus", "sdf_mlp_bwd", sdf_key),
    ]
    # the products of the backwards alone (the products inside the Pallas
    # _bwd_kernel): bf16 at the fine trunk's dx, library_ms torch.matmul on
    # the same bf16 operands (bf16 out);
    # and the f32 product (3xTF32) at the NeuS trunk's dx; library_ms is
    # torch.matmul on the same f32 operands, TF32 off
    for name, case, dtype, launches, route in (
            ("tc_gemm_kernel (bf16 products of the backwards, tensor cores)",
             "nt fine trunk dx", "bfloat16", train["routes"]["products"]["tc"], "tc"),
            ("tc_gemm_kernel (f32 products of the backwards, 3xTF32 on the tensor cores)",
             "f32 nt NeuS trunk dx", "float32",
             family_runs["neus"]["routes"]["products"]["tf32x3"], "tf32x3")):
        r = products[case]
        kernels.append({
            "name": name, "route": "cuda", "source": "neddf_tpu_torch/csrc/dual_mlp_bwd.cu",
            "replaces": "neddf_tpu/kernels/dual_mlp.py:728", "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in products.values()
                               if v["dtype"] == dtype),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "launches_geometry": {},
            "launches_llff": {path: routes["products"][route]
                              for path, routes in llff["routes"].items()
                              if routes["products"][route]}})
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
            if routes["passes"].get("db_sum")}})
    summary = {
        "card": card, "psnr_ds8": psnr8, "ssim_ds8": ssim8, "psnr_full": psnr1,
        "ssim_full": ssim1, "seconds_per_image": secs, "rays_per_s": h * w / secs,
        "kernel_checks": {f"{m}/{d}": v for (m, d), v in results.items()},
        "render_check": render_check, "eval_launches": launches,
        "train_kernel_checks": train_kernels, "products": products, "tensor_core_build": tc_build,
        "eval_routes": eval_routes, "machine_step": machine, "train_run": train,
        "bounds_slices_1_2": bounds, "family_kernel_checks": family_kernels,
        "family_steps": family_steps, "family_runs": family_runs,
        "other_configs": other_configs, "resume": resume, "camera": camera,
        "grad_accum": accum, "rest": rest, "geometry": geometry, "llff": llff,
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
