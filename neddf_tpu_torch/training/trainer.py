"""Trainer: dataset on the device, the train step, epoch hooks,
checkpoints, eval.

Counterpart of ``neddf_tpu/training/trainer.py`` (``BaseTrainer`` and
``NeRFTrainer``), with every keyword of ``BaseTrainer.__init__``:

* the dataset's images, intrinsics and poses are staged on the device
  once; each step gathers its pixels there (``training/step.py``);
* ``run_train_step`` draws the pixel batch and the sample uniforms from
  a ``torch.Generator`` seeded with ``seed``, renders with the training
  path over ``grad_accum`` microbatches (``step.py::accumulate_grads``),
  runs the backward pass (hand-written kernels and their backwards) and
  steps ``torch.optim.Adam(eps=1e-8, weight_decay=...)``: torch's weight
  decay adds ``wd * param`` to the gradient, as
  ``optax.add_decayed_weights`` before ``scale_by_adam`` does. The
  learning rate before step n is ``lr0 * scheduler_lr ** (n //
  len(dataset))``, optax's per-epoch staircase (``:444-460``);
* ``optimize_camera``: ``camera_deltas`` [n_cam, 6] is a leaf that
  requires grad, and ``RowSparseAdam(camera_optimizer_lr)``
  (``training/optim.py``) steps it; the network's Adam never does. The
  gradient reaches it through the kernels' input cotangents;
* ``debug_nans``: torch's anomaly mode with NaN checks over the step,
  and the loss (before its backward) and every gradient checked: the
  first one that is not finite raises ``FloatingPointError``;
  ``profile_trace_start`` / ``profile_trace_steps``: a ``torch.profiler``
  trace of those steps under ``log/profile/`` (``utils/profiling.py``);
* ``run_train`` (``:643-667``): per epoch a camera permutation from
  ``np.random.default_rng(seed)``, one step per camera, then the field
  slice, test render and checkpoint hooks; after ``load_checkpoint`` it
  skips the completed epochs and still draws their permutations, so the
  run goes on as an uninterrupted one would. Every step's loss, loss
  dict, PSNR and wall time go to ``train_log.jsonl`` in the run
  directory and to the logger (``training/logger.py``, under ``log/``);
* ``save_checkpoint`` / ``load_checkpoint``: the full training state in
  the flax msgpack layout (``training/checkpoint.py``), which both
  packages' ``load_pretrained_model`` read, and the JAX package's
  ``load_checkpoint`` too (through its legacy path: this package writes
  no ``key``); ``async_checkpoint`` writes from a thread and
  ``finalize_checkpoints`` waits for the writes;
* ``load_pretrained_model`` (``.ckpt`` or the reference's ``.pth``),
  ``render_test``, ``render_all`` for eval; ``enable_ray_cull`` builds
  an occupancy grid of the loaded field (from a generator seeded with
  ``seed``), and the eval renders then skip the rays that cross no
  occupied cell (``render/renderer.py::render_image``).

* ``mesh`` (``parallel/mesh.py``): the trainer's world is that of the
  process group it is built in (``group_world``); out of any group, or in
  a group of one, it is the single-process path. An explicit ``data``
  times ``model`` must be the group's size. Which world to start is the
  entry point's decision (``launch_world``: ``data: auto`` is every
  visible card divided by ``model``, the JAX trainer's devices, and 1 on
  the CPU; ``scripts/run.py`` starts the ranks, or torchrun does; rank r
  on its host's ``cuda:r``). Every rank draws the whole batch from its
  generator, which stays in lockstep with the others', renders its data
  group's rows of it and averages the gradients and metrics with the
  others (``make_sharded_grads``); the eval renders split each chunk
  over a data group and all-gather the tiles (``make_sharded_render``).
  The parameters start as rank 0's. Under ``model > 1`` (tensor
  parallelism) each rank holds its column shards of the
  trunks' weights and their Adam state (``shard_parameters``), the
  heads and the camera optimizer whole, and its fields gather each
  layer over the model group (``render/renderer.py::tp_renderer``);
  ``enable_ray_cull`` and the field slices run on a copy with the
  gathered parameters, and the checkpoints hold the gathered ones, so
  any ``model`` (and the JAX package) reads them. Every rank runs every
  hook that draws from the generator; only rank 0 writes (``models/``,
  ``render/``, ``log/``, ``train_log.jsonl``, the printed lines) and
  traces, and the others wait for its checkpoints.
"""
from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.geometry.se3 import camera_pose
from neddf_tpu_torch.ops.occupancy import OccupancyGrid
from neddf_tpu_torch.parallel.mesh import (
    broadcast_parameters,
    check_world_batch,
    gather_state,
    group_world,
    launcher_world,
    local_device,
    make_mesh,
    make_sharded_grads,
    make_sharded_render,
    mesh_shape,
    resolve_world,
    shard_parameters,
    shard_tensor,
    tp_shard_names,
)
from neddf_tpu_torch.render.renderer import Draws, tp_renderer
from neddf_tpu_torch.training.checkpoint import (
    AsyncCheckpointer,
    adam_from_optax,
    adam_moments,
    load_msgpack_params,
    optax_adam_tree,
    params_from_jax,
    params_to_jax,
    row_sparse_from_tree,
    row_sparse_to_tree,
    state_dict_from_pth,
)
from neddf_tpu_torch.training.logger import NeRFTBLogger
from neddf_tpu_torch.training.metrics import (
    peak_signal_noise_ratio,
    structural_similarity,
)
from neddf_tpu_torch.training.optim import RowSparseAdam
from neddf_tpu_torch.training.step import (
    accumulate_grads,
    check_target_keys,
    construct_targets,
    draw_pixel_batch,
)
from neddf_tpu_torch.utils.msgpack import load_msgpack, save_msgpack
from neddf_tpu_torch.utils.png import write_png
from neddf_tpu_torch.utils.profiling import (
    StepProfiler,
    enable_nan_debugging,
    raise_if_nonfinite,
)

Tensor = torch.Tensor


def device_type(device: str) -> str:
    """The torch device type of a config device string: ``cpu`` is the
    CPU; ``cuda``, ``cuda:N``, ``gpu`` and ``tpu`` (the JAX snapshots'
    value) are a CUDA card."""
    if device == "cpu":
        return "cpu"
    if device in ("cuda", "gpu", "tpu") or device.startswith("cuda:"):
        return "cuda"
    raise ValueError(f"unknown device {device!r}")


def resolve_device(device: str) -> torch.device:
    """Map a config device string to a torch device (``device_type``).
    Asking for CUDA without a card raises: there is no fallback to the
    CPU."""
    if device_type(device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asks for CUDA, which is not available")
    index = int(device.split(":")[1]) if ":" in device else torch.cuda.current_device()
    return torch.device("cuda", index)


def launch_world(mesh: Optional[Dict[str, Any]], device: str) -> Optional[int]:
    """The number of ranks that an entry point runs for a trainer config's
    ``mesh`` on ``device`` (``parallel/mesh.py::resolve_world`` over the
    visible cards and a launcher's ranks), or None for one process."""
    kind = device_type(device)
    n_cards = torch.cuda.device_count() if kind == "cuda" else 0
    launched = launcher_world()
    if launched is None:
        return resolve_world(mesh, kind, n_cards)
    return resolve_world(mesh, kind, n_cards, launched.world, launched.local_world)


def build_renderer(config: Dict[str, Any], seed: int, device: torch.device) -> Any:
    """The ``render`` config's renderer over its ``network`` config, its
    parameters initialised from ``seed``, on ``device``."""
    init_generator = torch.Generator().manual_seed(seed)
    return config_lib.instantiate(
        config["render"], network_config=config["network"], generator=init_generator,
    ).to(device)


def load_renderer_weights(renderer: Any, model_path: "str | Path") -> None:
    """Load the parameters of a flax msgpack checkpoint (``.ckpt``) or of
    a reference-layout ``.pth`` into ``renderer``; every parameter must
    match."""
    model_path = Path(model_path)
    if model_path.suffix == ".pth":
        state_dict = state_dict_from_pth(model_path, renderer)
    elif model_path.suffix == ".ckpt":
        state_dict = params_from_jax(load_msgpack_params(model_path))
    else:
        raise ValueError(f"{model_path.name}: expected a .ckpt or .pth checkpoint")
    renderer.load_state_dict(state_dict, strict=True)


#: the checkpoint entries that ``load_checkpoint`` needs (``torch_rng`` is
#: optional: the JAX package's checkpoints do not have it)
STATE_KEYS = ("params", "opt_state", "iteration", "camera_deltas", "opt_state_cam")


def _owned(tree: Any) -> Any:
    """A copy of a tree whose arrays share no memory with live tensors."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class NeRFTrainer:
    """Trainer of every field family (reference: nerf_trainer.py,
    base_trainer.py): Adam over all of the renderer's parameters (both
    networks of a NeRF config, NeuS's ``variance``)."""

    def __init__(
        self,
        global_config: Dict[str, Any],
        device: str = "cuda:0",
        batch_size: int = 1024,
        chunk: int = 1024,
        epoch_max: int = 2000,
        epoch_save_fields: int = 2,
        epoch_test_rendering: int = 10,
        epoch_save_model: int = 100,
        scheduler_lr: float = 0.99815,
        optimizer_lr: float = 0.0005,
        optimizer_weight_decay: float = 0.0,
        seed: int = 3408,
        debug_nans: bool = False,
        profile_trace_start: int = -1,
        profile_trace_steps: int = 5,
        log_interval: int = 1,
        optimize_camera: bool = False,
        camera_optimizer_lr: float = 1e-4,
        async_checkpoint: bool = False,
        grad_accum: int = 1,
        mesh: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.config = global_config
        # the mesh: the world of this process's group, or None (one
        # process); the batch checks first, with the JAX messages
        data, self.n_model = mesh_shape(mesh)
        n_data = data or max(1, (dist.get_world_size() if dist.is_initialized() else 1)
                             // self.n_model)
        local_batch = check_world_batch(batch_size, n_data)
        if grad_accum < 1 or local_batch % grad_accum:
            raise ValueError(
                f"grad_accum={grad_accum} must divide the per-device batch "
                f"{local_batch} (batch_size={batch_size} / data={n_data})"
            )
        self.world = group_world(mesh)
        self.rank = 0
        if self.world is None:
            self.device = resolve_device(device)
        else:
            self.rank = dist.get_rank()
            self.device = local_device(device_type(device))
            # eval-render chunks split evenly over the ranks
            chunk = -(-chunk // self.world) * self.world
        if self.device.type == "cuda":
            # the kernels launch on the current device
            torch.cuda.set_device(self.device)
            # f32 matmuls (the heads, f32 trunks) stay f32, as in JAX on the CPU
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.batch_size = batch_size
        self.chunk = chunk
        self.epoch_max = epoch_max
        self.epoch_save_fields = epoch_save_fields
        self.epoch_test_rendering = epoch_test_rendering
        self.epoch_save_model = epoch_save_model
        self.scheduler_lr = scheduler_lr
        self.optimizer_lr = optimizer_lr
        self.optimizer_weight_decay = optimizer_weight_decay
        self.seed = seed
        self.log_interval = max(1, int(log_interval))
        self.grad_accum = int(grad_accum)
        self.optimize_camera = bool(optimize_camera)
        self.debug_nans = bool(debug_nans)
        # rays/s counts the global batch; only rank 0 traces and writes
        self.profiler = StepProfiler(
            rays_per_step=batch_size,
            trace_dir="log/profile" if profile_trace_start >= 0 and self.rank == 0 else None,
            trace_start=profile_trace_start,
            trace_steps=profile_trace_steps,
        )
        self._async_ckpt = AsyncCheckpointer() if async_checkpoint and self.rank == 0 else None

        self.dataset = config_lib.instantiate(self.config["dataset"])
        self.calib = PinholeCalib(
            torch.tensor(self.dataset.camera_calib_params, dtype=torch.float32,
                         device=self.device)
        )
        self.camera_initials = torch.tensor(
            self.dataset.camera_params, dtype=torch.float32, device=self.device
        )
        # the pose deltas: a leaf that only the camera optimizer steps
        self.camera_deltas = torch.zeros_like(self.camera_initials).requires_grad_(
            self.optimize_camera)
        self.camera_optimizer = RowSparseAdam([self.camera_deltas], lr=camera_optimizer_lr)
        self.rgb_images = torch.as_tensor(
            self.dataset.rgb_images, dtype=torch.float32, device=self.device)
        self.mask_images = torch.as_tensor(
            self.dataset.mask_images, dtype=torch.float32, device=self.device)

        self.loss_functions = [
            config_lib.instantiate(fn) for fn in self.config["loss"]["functions"]
        ]
        self.loss_types = [fn.key_target for fn in self.loss_functions]
        check_target_keys(self.loss_types)

        self.neural_render = build_renderer(self.config, seed, self.device)
        self.sharded_grads = self.render_fn = self.mesh = None
        # the parameters held as width shards (tensor parallelism)
        self.shard_names: set = set()
        if self.world is not None:
            broadcast_parameters(self.neural_render)
            self.mesh = make_mesh(self.n_model)
            shards = []
            if self.n_model > 1:
                self.shard_names = tp_shard_names(self.neural_render, self.n_model)
                shard_parameters(self.neural_render, self.mesh, self.shard_names)
                tp_renderer(self.neural_render, self.mesh.model_group)
                shards = [p for n, p in self.neural_render.named_parameters()
                          if n in self.shard_names]
            self.sharded_grads = make_sharded_grads(
                self.mesh if self.n_model > 1 else None, batch_size, self.grad_accum, shards)
            self.render_fn = make_sharded_render(self.mesh.data_group)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = torch.optim.Adam(
            self.neural_render.parameters(), lr=optimizer_lr, eps=1e-8,
            weight_decay=optimizer_weight_decay,
        )
        self.iteration = 0
        self.history: List[Dict[str, Any]] = []
        self.log_path: Optional[Path] = None
        self.logger: Optional[NeRFTBLogger] = None
        self._pending: List[Tuple[Tensor, List[str], float]] = []
        self.eval_ray_cull: Optional[OccupancyGrid] = None

    # ------------------------------------------------------------ train step
    def learning_rate(self, iteration: int) -> float:
        """Per-epoch staircase: lr0 * scheduler_lr ** (iteration // frames)."""
        frames = max(len(self.dataset), 1)
        return self.optimizer_lr * self.scheduler_lr ** (iteration // frames)

    def local_grads(
        self, camera_id: int, us: Tensor, vs: Tensor, u_strat: Tensor, u_pdf: Tensor,
        rows: slice = slice(None),
    ) -> Tuple[Tensor, Dict[str, Tensor], Tensor]:
        """The step's math on the rows ``rows`` of the given draws of the
        whole batch (``step.py::accumulate_grads``): adds their gradients
        to ``.grad`` and returns their (loss, loss dict, mse)."""
        uv = torch.stack([us, vs], dim=1)
        targets = construct_targets(self.loss_types, self.rgb_images[camera_id],
                                    self.mask_images[camera_id], us, vs)
        sanitizer, check_loss = contextlib.nullcontext(), None
        if self.debug_nans:
            sanitizer = enable_nan_debugging(True)
            check_loss = lambda loss: raise_if_nonfinite([("loss", loss)])  # noqa: E731
        with sanitizer:
            return accumulate_grads(
                self.neural_render, self.loss_functions, self.calib,
                lambda: self.camera_pose(camera_id), uv, targets, u_strat, u_pdf,
                self.iteration, self.grad_accum, check_loss, rows,
            )

    def step_grads(
        self, camera_id: int, us: Tensor, vs: Tensor, u_strat: Tensor, u_pdf: Tensor
    ) -> Tuple[Tensor, Dict[str, Tensor], Tensor]:
        """Loss of one step on the given draws (all ``batch_size`` rays),
        with its gradients left in the parameters' ``.grad`` and, under
        ``optimize_camera``, in ``camera_deltas.grad``; returns (loss,
        loss dict, mse), each the mean over the ``grad_accum``
        microbatches. Over a world of ranks (``sharded_grads``) this rank
        runs its rows and the results are the means over the ranks."""
        self.optimizer.zero_grad(set_to_none=True)
        self.camera_optimizer.zero_grad(set_to_none=True)

        def local(rows: slice = slice(None)):
            return self.local_grads(camera_id, us, vs, u_strat, u_pdf, rows)

        if self.sharded_grads is None:
            loss, loss_dict, mse = local()
        else:
            loss, loss_dict, mse = self.sharded_grads(
                local, list(self.neural_render.parameters()),
                self.camera_deltas if self.optimize_camera else None)
        if self.debug_nans:
            raise_if_nonfinite(
                [(f"the gradient of {name}", p.grad)
                 for name, p in self.neural_render.named_parameters()]
                + [("the gradient of camera_deltas", self.camera_deltas.grad)])
        return loss, loss_dict, mse

    def run_train_step(self, camera_id: int) -> float:
        """One optimizer step on ``batch_size`` pixels of ``camera_id``.

        Metrics are fetched from the device every ``log_interval`` steps
        (and returned then; between fetches the last fetched loss)."""
        self.profiler.step_begin()
        start = time.perf_counter()
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate(self.iteration)
        us, vs = draw_pixel_batch(self.generator, self.batch_size,
                                  self.dataset.image_width, self.dataset.image_height)
        render = self.neural_render
        u_strat = torch.rand((self.batch_size, render.sample_coarse + 1),
                             generator=self.generator, device=self.device)
        u_pdf = torch.rand((self.batch_size, render.sample_fine + 1),
                           generator=self.generator, device=self.device)
        loss, loss_dict, mse = self.step_grads(camera_id, us, vs, u_strat, u_pdf)
        self.optimizer.step()
        if self.optimize_camera:
            self.camera_optimizer.step()
        self.iteration += 1
        metrics = torch.stack([loss, mse, *loss_dict.values()])
        self._pending.append((metrics, list(loss_dict), time.perf_counter() - start))
        if len(self._pending) >= self.log_interval:
            self.flush_logs()
        self.profiler.step_end()
        return self.history[-1]["loss"] if self.history else float("nan")

    def flush_logs(self) -> None:
        """Fetch the pending steps' metrics (one device sync) and record
        them; the fetch's wall time is spread evenly over those steps."""
        if not self._pending:
            return
        start = time.perf_counter()
        values = torch.stack([m for m, _, _ in self._pending]).cpu().numpy()
        wait = (time.perf_counter() - start) / len(self._pending)
        if self.logger is not None:
            self.logger.write_batchend()
        first = self.iteration - len(self._pending)
        for i, (row, (_, names, secs)) in enumerate(zip(values, self._pending)):
            mse = float(row[1])
            record = {
                "iteration": first + i, "loss": float(row[0]), "mse": mse,
                "psnr": 10.0 * math.log10(1.0 / max(mse, 1e-12)),
                "losses": {k: float(v) for k, v in zip(names, row[2:])},
                "seconds": secs + wait,
            }
            self.history.append(record)
            if self.log_path is not None:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            if self.logger is not None:
                self.logger.write(record["loss"], record["psnr"], record["losses"],
                                  rays_per_sec=self.profiler.rays_per_sec(),
                                  duration=record["seconds"])
                self.logger.next()
        self._pending = []

    def run_train(self) -> None:
        """Train for ``epoch_max + 1`` epochs in the current directory
        (``models/``, ``render/``, ``log/`` and ``train_log.jsonl`` are
        written there), from the epoch that ``iteration`` has reached."""
        writer = self.rank == 0
        render_dir = Path("render")
        frame_length = len(self.dataset)
        start_epoch = self.iteration // max(frame_length, 1)
        if writer:
            Path("models").mkdir(parents=True, exist_ok=True)
            self.log_path = Path("train_log.jsonl")
            if self.iteration:
                _drop_records_from(self.log_path, self.iteration)
            self.logger = NeRFTBLogger("log")
            self.logger.niter = self.iteration
        rng = np.random.default_rng(self.seed)
        try:
            for epoch in range(self.epoch_max + 1):
                # completed epochs still draw their permutation
                camera_ids = rng.permutation(frame_length)
                if epoch < start_epoch:
                    continue
                self.print_rank0("epoch: ", epoch)
                for camera_id in camera_ids:
                    self.run_train_step(int(camera_id))
                self.flush_logs()
                if self.logger is not None:
                    self.logger.flush()
                if epoch % self.epoch_save_fields == 0 and (writer or self.shard_names):
                    self.render_field_slices(render_dir / "fields", epoch)
                if epoch % self.epoch_test_rendering == 0:
                    # every rank renders: the draws keep the generators in lockstep
                    self.print_rank0("test rendering...")
                    self.render_test(render_dir / f"{epoch:04}", int(camera_ids[0]), 3)
                if epoch % self.epoch_save_model == 0:
                    self.save_checkpoint(Path("models") / f"model_{epoch:05}.ckpt")
        finally:
            self.profiler.close()
            if self.logger is not None:
                self.logger.close()
            self.logger = None
            self.finalize_checkpoints()

    def print_rank0(self, *args: Any) -> None:
        """``print`` on rank 0 only."""
        if self.rank == 0:
            print(*args)

    def full_state(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """A map of this rank's parameter-shaped tensors with the width
        shards gathered (every rank of the model group calls it); the map
        itself outside tensor parallelism."""
        if not self.shard_names:
            return state
        return gather_state(state, self.mesh, self.shard_names)

    def local_state(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """This rank's shards of a map of full parameter-shaped tensors."""
        return {k: shard_tensor(v, self.mesh) if k in self.shard_names else v
                for k, v in state.items()}

    def full_renderer(self) -> Any:
        """The renderer with whole parameters: itself, or under tensor
        parallelism a copy with the gathered ones and no model group (the
        JAX trainer gathers to the host for the ray-cull grid and the
        field slices, ``neddf_tpu/training/trainer.py:341-356, 411-421``);
        every rank calls it."""
        if not self.shard_names:
            return self.neural_render
        full = self.full_state(dict(self.neural_render.named_parameters()))
        copy = build_renderer(self.config, self.seed, self.device)
        copy.load_state_dict(full, strict=True)
        return copy

    def render_field_slices(self, output_field_dir: "str | Path", epoch: int = 0) -> None:
        """Write ``field_{name}_{epoch:04}.png`` XY slices of the fields
        (rank 0; under tensor parallelism every rank calls it)."""
        renderer = self.full_renderer()
        if self.rank != 0:
            return
        output_field_dir = Path(output_field_dir)
        output_field_dir.mkdir(parents=True, exist_ok=True)
        for name, img in renderer.render_field_slice().items():
            # the images are BGR; the PNG writer takes RGB
            write_png(output_field_dir / f"field_{name}_{epoch:04}.png", img[:, :, ::-1])

    def checkpoint_state(self) -> Dict[str, Any]:
        """The training state as a map of host arrays (a copy, so training
        may go on): the JAX trainer's ``_state_dict`` layout without its
        ``key``, and this trainer's generator state."""
        named = list(self.neural_render.named_parameters())
        count, mu, nu = adam_moments(self.optimizer, named)
        return _owned({
            "params": params_to_jax(self.full_state(self.neural_render.state_dict())),
            "opt_state": optax_adam_tree(count, self.full_state(mu), self.full_state(nu),
                                         self.optimizer_weight_decay != 0),
            "iteration": int(self.iteration),
            "camera_deltas": self.camera_deltas.detach().cpu().numpy(),
            "opt_state_cam": row_sparse_to_tree(
                self.camera_optimizer.state_of(self.camera_deltas)),
            "torch_rng": {"state": self.generator.get_state().numpy(),
                          "device": self.device.type},
        })

    def save_checkpoint(self, path: "str | Path") -> None:
        """Write the full training state to ``path`` (atomically; from a
        thread under ``async_checkpoint``, see ``finalize_checkpoints``).
        Over a world of ranks rank 0 writes (every rank holds the same
        state; under tensor parallelism every rank gathers its shards for
        it) and the others wait for it."""
        state = self.checkpoint_state() if self.rank == 0 or self.shard_names else None
        if self.rank == 0:
            path = Path(path)
            path.parent.mkdir(parents=True, exist_ok=True)
            if self._async_ckpt is not None:
                self._async_ckpt.save(path, state)
            else:
                save_msgpack(path, state)
        if self.world is not None:
            dist.barrier()

    def finalize_checkpoints(self) -> None:
        """Block until every checkpoint write is on disk."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def load_checkpoint(self, path: "str | Path") -> None:
        """Restore a full training state written by this trainer or by the
        JAX package's. Parameters that do not match this trainer's, and a
        missing entry, raise. Without a generator state for this device
        type (a JAX checkpoint, or one from another device) the generator
        is seeded from (seed, iteration)."""
        path = Path(path)
        state = load_msgpack(path)
        missing = [k for k in STATE_KEYS if k not in state]
        if missing:
            raise ValueError(f"{path}: not a full training state, missing {missing} "
                             "(load_pretrained_model reads params-only checkpoints)")
        self.neural_render.load_state_dict(self.local_state(params_from_jax(state["params"])),
                                           strict=True)
        adam_from_optax(state["opt_state"], self.optimizer,
                        list(self.neural_render.named_parameters()), self.local_state)
        deltas = torch.from_numpy(np.array(state["camera_deltas"], np.float32))
        if deltas.shape != self.camera_deltas.shape:
            raise ValueError(f"{path}: camera_deltas {tuple(deltas.shape)}, "
                             f"expected {tuple(self.camera_deltas.shape)}")
        with torch.no_grad():
            self.camera_deltas.copy_(deltas)
        self.camera_optimizer.state[self.camera_deltas] = row_sparse_from_tree(
            state["opt_state_cam"], self.camera_deltas)
        self.iteration = int(state["iteration"])
        rng = state.get("torch_rng")
        if rng is not None and rng["device"] == self.device.type:
            self.generator.set_state(torch.from_numpy(np.array(rng["state"], np.uint8)))
        else:
            seed = (self.seed * 1_000_003 + self.iteration) % 2**63
            self.generator.manual_seed(seed)
            self.print_rank0(f"[checkpoint] {path.name} holds no {self.device.type} "
                             "generator state: seeded the generator from (seed, iteration) "
                             f"= ({self.seed}, {self.iteration})")

    def camera_pose(self, camera_id: int):
        return camera_pose(self.camera_initials[camera_id], self.camera_deltas[camera_id])

    def load_pretrained_model(self, model_path: "str | Path") -> None:
        """Load the parameters of a flax msgpack checkpoint (``.ckpt``) or
        of a reference-layout ``.pth``; every parameter must match (under
        tensor parallelism this rank keeps its shards)."""
        if not self.shard_names:
            load_renderer_weights(self.neural_render, model_path)
            return
        full = self.full_renderer()
        load_renderer_weights(full, model_path)
        self.neural_render.load_state_dict(self.local_state(full.state_dict()), strict=True)

    def enable_ray_cull(self, resolution: int = 64, threshold: float = 0.01) -> None:
        """Skip background rays in eval renders: an occupancy grid of the
        current fine field (four jittered updates, drawn from a generator
        seeded with ``seed``, not from the trainer's own). Refuses an NDC
        renderer (``render.ndc=true``): the grid is a world-space one."""
        self.neural_render.refuse_ndc("ray culling (trainer.enable_ray_cull, run_eval --ray-cull)")
        self.eval_ray_cull = self.full_renderer().build_occupancy(
            torch.Generator(device=self.device).manual_seed(self.seed),
            resolution=resolution, threshold=threshold,
        )

    def render_test(
        self,
        output_dir: "str | Path",
        camera_id: int,
        downsampling: int = 1,
        draws: Optional[Draws] = None,
    ) -> np.ndarray:
        """Render one test view, write ``{id}_rgb.png``, ``{id}_rgb_gt.png``
        and ``{id}_depth.png``, print PSNR/SSIM at full resolution, and
        return the rendered image (uint8, BGR like the dataset). Over a
        world of ranks every rank renders its share of each chunk and
        returns the whole image; rank 0 writes and prints."""
        rgb_gt = np.asarray(self.dataset[camera_id]["rgb_images"]).astype(np.uint8)
        h, w = rgb_gt.shape[:2]
        with torch.no_grad():
            r, t = self.camera_pose(camera_id)
        images = self.neural_render.render_image(
            self.calib, r, t, w, h, ["color", "depth"], downsampling, self.chunk,
            generator=self.generator, draws=draws, ray_cull=self.eval_ray_cull,
            render_fn=self.render_fn,
        )
        rgb_np = np.clip(images["color"] * 255, 0, 255).astype(np.uint8)
        depth_np = np.clip(
            (images["depth"][:, :, 0] - 2.0) / 4.0 * 50000 / 256, 0, 255
        ).astype(np.uint8)
        if self.rank != 0:
            return rgb_np

        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        # the images are BGR; the PNG writer takes RGB
        write_png(output_dir / f"{camera_id:03}_rgb.png", rgb_np[:, :, ::-1])
        write_png(output_dir / f"{camera_id:03}_rgb_gt.png", rgb_gt[:, :, ::-1])
        write_png(output_dir / f"{camera_id:03}_depth.png", depth_np)

        if downsampling == 1:
            psnr = peak_signal_noise_ratio(rgb_np, rgb_gt)
            ssim = structural_similarity(rgb_np, rgb_gt, channel_axis=2)
            print(f"psnr: {psnr}, ssim: {ssim}")
        return rgb_np

    def render_all(self, output_dir: "str | Path") -> None:
        for camera_id in range(len(self.dataset)):
            self.print_rank0(f"rendering from camera {camera_id}")
            self.render_test(output_dir, camera_id, 1)


def _drop_records_from(log_path: Path, iteration: int) -> None:
    """Keep only the records of steps before ``iteration`` in a run's
    ``train_log.jsonl`` (a resumed run logs the later steps again)."""
    if not log_path.exists():
        return
    lines = log_path.read_text().splitlines()
    kept = [x for x in lines if x and json.loads(x)["iteration"] < iteration]
    tmp = log_path.with_name(log_path.name + ".tmp")
    tmp.write_text("".join(x + "\n" for x in kept))
    tmp.replace(log_path)
