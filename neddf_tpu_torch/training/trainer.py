"""Trainer: dataset on the device, the train step, epoch hooks, eval.

Counterpart of ``neddf_tpu/training/trainer.py``:

* the dataset's images, intrinsics and poses are staged on the device
  once; each step gathers its pixels there (``training/step.py``);
* ``run_train_step`` draws the pixel batch and the sample uniforms from
  a ``torch.Generator`` seeded with ``seed``, renders with the training
  path, sums the losses, runs the backward pass (hand-written kernels
  and their backwards) and steps ``torch.optim.Adam(eps=1e-8,
  weight_decay=...)``: torch's weight decay adds ``wd * param`` to the
  gradient, as ``optax.add_decayed_weights`` before ``scale_by_adam``
  does. The learning rate before step n is ``lr0 * scheduler_lr **
  (n // len(dataset))``, optax's per-epoch staircase (``:444-460``);
* ``run_train`` (``:643-667``): per epoch a camera permutation from
  ``np.random.default_rng(seed)``, one step per camera, then the field
  slice, test render and checkpoint hooks; every step's loss, loss dict,
  PSNR and wall time go to ``train_log.jsonl`` in the run directory;
* ``save_checkpoint`` writes ``{"params", "iteration", "camera_deltas"}``
  in the flax msgpack layout, which ``neddf_tpu``'s
  ``load_pretrained_model`` and this trainer's both load; the optimizer
  state is not saved yet (no ``--resume``);
* ``load_pretrained_model``, ``render_test``, ``render_all`` for eval.

Not ported: ``grad_accum > 1``, ``optimize_camera``, width-sharded meshes
(each raises), the logger, profiling, async checkpoints.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.geometry.se3 import camera_pose
from neddf_tpu_torch.render.renderer import Draws
from neddf_tpu_torch.training.checkpoint import (
    load_msgpack_params,
    params_from_jax,
    params_to_jax,
)
from neddf_tpu_torch.training.metrics import (
    peak_signal_noise_ratio,
    structural_similarity,
)
from neddf_tpu_torch.training.step import (
    check_target_keys,
    construct_targets,
    draw_pixel_batch,
    train_loss,
)
from neddf_tpu_torch.utils.msgpack import save_msgpack
from neddf_tpu_torch.utils.png import write_png

Tensor = torch.Tensor


def resolve_device(device: str) -> torch.device:
    """Map a config device string to a torch device.

    ``cpu`` is the CPU; ``cuda``, ``cuda:N``, ``gpu`` and ``tpu`` (the
    JAX snapshots' value) are a CUDA card. Asking for CUDA without one
    raises: there is no fallback to the CPU.
    """
    if device == "cpu":
        return torch.device("cpu")
    if device in ("cuda", "gpu", "tpu") or device.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} asks for CUDA, which is not available")
        index = int(device.split(":")[1]) if ":" in device else torch.cuda.current_device()
        return torch.device("cuda", index)
    raise ValueError(f"unknown device {device!r}")


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
        log_interval: int = 1,
        mesh: Optional[Dict[str, Any]] = None,
        optimize_camera: bool = False,
        grad_accum: int = 1,
    ) -> None:
        self.config = global_config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 matmuls (the heads, f32 trunks) stay f32, as in JAX on the CPU
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if mesh and int(mesh.get("model", 1)) > 1:
            raise NotImplementedError("width-sharded (model > 1) meshes are not ported")
        if optimize_camera:
            raise NotImplementedError("optimize_camera (pose refinement) is not ported")
        if grad_accum != 1:
            raise NotImplementedError("grad_accum > 1 is not ported")
        self.batch_size = batch_size
        self.chunk = chunk
        self.epoch_max = epoch_max
        self.epoch_save_fields = epoch_save_fields
        self.epoch_test_rendering = epoch_test_rendering
        self.epoch_save_model = epoch_save_model
        self.scheduler_lr = scheduler_lr
        self.optimizer_lr = optimizer_lr
        self.seed = seed
        self.log_interval = max(1, int(log_interval))

        self.dataset = config_lib.instantiate(self.config["dataset"])
        self.calib = PinholeCalib(
            torch.tensor(self.dataset.camera_calib_params, dtype=torch.float32,
                         device=self.device)
        )
        self.camera_initials = torch.tensor(
            self.dataset.camera_params, dtype=torch.float32, device=self.device
        )
        self.camera_deltas = torch.zeros_like(self.camera_initials)
        self.rgb_images = torch.as_tensor(
            self.dataset.rgb_images, dtype=torch.float32, device=self.device)
        self.mask_images = torch.as_tensor(
            self.dataset.mask_images, dtype=torch.float32, device=self.device)

        self.loss_functions = [
            config_lib.instantiate(fn) for fn in self.config["loss"]["functions"]
        ]
        self.loss_types = [fn.key_target for fn in self.loss_functions]
        check_target_keys(self.loss_types)

        init_generator = torch.Generator().manual_seed(seed)
        self.neural_render = config_lib.instantiate(
            self.config["render"], network_config=self.config["network"],
            generator=init_generator,
        ).to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.optimizer = torch.optim.Adam(
            self.neural_render.parameters(), lr=optimizer_lr, eps=1e-8,
            weight_decay=optimizer_weight_decay,
        )
        self.iteration = 0
        self.history: List[Dict[str, Any]] = []
        self.log_path: Optional[Path] = None
        self._pending: List[Tuple[Tensor, List[str], float]] = []

    # ------------------------------------------------------------ train step
    def learning_rate(self, iteration: int) -> float:
        """Per-epoch staircase: lr0 * scheduler_lr ** (iteration // frames)."""
        frames = max(len(self.dataset), 1)
        return self.optimizer_lr * self.scheduler_lr ** (iteration // frames)

    def step_grads(
        self, camera_id: int, us: Tensor, vs: Tensor, u_strat: Tensor, u_pdf: Tensor
    ) -> Tuple[Tensor, Dict[str, Tensor], Tensor]:
        """Loss of one step on the given draws, with its gradients left in
        the parameters' ``.grad``; returns (loss, loss dict, mse)."""
        uv = torch.stack([us, vs], dim=1)
        targets = construct_targets(self.loss_types, self.rgb_images[camera_id],
                                    self.mask_images[camera_id], us, vs)
        pose_r, pose_t = self.camera_pose(camera_id)
        self.optimizer.zero_grad(set_to_none=True)
        loss, loss_dict, mse = train_loss(
            self.neural_render, self.loss_functions, self.calib, pose_r, pose_t, uv,
            targets, u_strat, u_pdf, self.iteration,
        )
        loss.backward()
        return loss, loss_dict, mse

    def run_train_step(self, camera_id: int) -> float:
        """One optimizer step on ``batch_size`` pixels of ``camera_id``.

        Metrics are fetched from the device every ``log_interval`` steps
        (and returned then; between fetches the last fetched loss)."""
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
        self.iteration += 1
        metrics = torch.stack([loss.detach(), mse.detach(),
                               *[v.detach() for v in loss_dict.values()]])
        self._pending.append((metrics, list(loss_dict), time.perf_counter() - start))
        if len(self._pending) >= self.log_interval:
            self.flush_logs()
        return self.history[-1]["loss"] if self.history else float("nan")

    def flush_logs(self) -> None:
        """Fetch the pending steps' metrics (one device sync) and record
        them; the fetch's wall time is spread evenly over those steps."""
        if not self._pending:
            return
        start = time.perf_counter()
        values = torch.stack([m for m, _, _ in self._pending]).cpu().numpy()
        wait = (time.perf_counter() - start) / len(self._pending)
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
        self._pending = []

    def run_train(self) -> None:
        """Train for ``epoch_max + 1`` epochs in the current directory:
        ``models/``, ``render/`` and ``train_log.jsonl`` are written there."""
        Path("models").mkdir(parents=True, exist_ok=True)
        render_dir = Path("render")
        self.log_path = Path("train_log.jsonl")
        frame_length = len(self.dataset)
        rng = np.random.default_rng(self.seed)
        for epoch in range(self.epoch_max + 1):
            camera_ids = rng.permutation(frame_length)
            print("epoch: ", epoch)
            for camera_id in camera_ids:
                self.run_train_step(int(camera_id))
            self.flush_logs()
            if epoch % self.epoch_save_fields == 0:
                self.render_field_slices(render_dir / "fields", epoch)
            if epoch % self.epoch_test_rendering == 0:
                print("test rendering...")
                self.render_test(render_dir / f"{epoch:04}", int(camera_ids[0]), 3)
            if epoch % self.epoch_save_model == 0:
                self.save_checkpoint(Path("models") / f"model_{epoch:05}.ckpt")

    def render_field_slices(self, output_field_dir: "str | Path", epoch: int = 0) -> None:
        """Write ``field_{name}_{epoch:04}.png`` XY slices of the fields."""
        output_field_dir = Path(output_field_dir)
        output_field_dir.mkdir(parents=True, exist_ok=True)
        for name, img in self.neural_render.render_field_slice().items():
            # the images are BGR; the PNG writer takes RGB
            write_png(output_field_dir / f"field_{name}_{epoch:04}.png", img[:, :, ::-1])

    def save_checkpoint(self, path: "str | Path") -> None:
        """Params, iteration and camera deltas in the flax msgpack layout."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_msgpack(path, {
            "params": params_to_jax(self.neural_render.state_dict()),
            "iteration": int(self.iteration),
            "camera_deltas": self.camera_deltas.cpu().numpy(),
        })

    def camera_pose(self, camera_id: int):
        return camera_pose(self.camera_initials[camera_id], self.camera_deltas[camera_id])

    def load_pretrained_model(self, model_path: "str | Path") -> None:
        """Load a flax msgpack checkpoint; every parameter must match."""
        model_path = Path(model_path)
        if model_path.suffix != ".ckpt":
            raise NotImplementedError(f"{model_path.name}: only .ckpt (flax msgpack) loads")
        state_dict = params_from_jax(load_msgpack_params(model_path))
        self.neural_render.load_state_dict(state_dict, strict=True)

    def render_test(
        self,
        output_dir: "str | Path",
        camera_id: int,
        downsampling: int = 1,
        draws: Optional[Draws] = None,
    ) -> np.ndarray:
        """Render one test view, write ``{id}_rgb.png``, ``{id}_rgb_gt.png``
        and ``{id}_depth.png``, print PSNR/SSIM at full resolution, and
        return the rendered image (uint8, BGR like the dataset)."""
        rgb_gt = np.asarray(self.dataset[camera_id]["rgb_images"]).astype(np.uint8)
        h, w = rgb_gt.shape[:2]
        r, t = self.camera_pose(camera_id)
        images = self.neural_render.render_image(
            self.calib, r, t, w, h, ["color", "depth"], downsampling, self.chunk,
            generator=self.generator, draws=draws,
        )
        rgb_np = np.clip(images["color"] * 255, 0, 255).astype(np.uint8)
        depth_np = np.clip(
            (images["depth"][:, :, 0] - 2.0) / 4.0 * 50000 / 256, 0, 255
        ).astype(np.uint8)

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
            print(f"rendering from camera {camera_id}")
            self.render_test(output_dir, camera_id, 1)
