"""Trainer, cut down to what eval needs.

Counterpart of ``neddf_tpu/training/trainer.py``: the dataset, the
intrinsics and poses, ``load_pretrained_model``, ``render_test`` and
``render_all`` (``:311-409``). The training step, optimizer, logging and
checkpoint writing are not ported yet; their settings are accepted so
that the run snapshots instantiate unchanged.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.geometry.se3 import camera_pose
from neddf_tpu_torch.render.renderer import Draws
from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
from neddf_tpu_torch.training.metrics import (
    peak_signal_noise_ratio,
    structural_similarity,
)
from neddf_tpu_torch.utils.png import write_png


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
    """Eval-side trainer (reference: nerf_trainer.py, base_trainer.py)."""

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
    ) -> None:
        self.config = global_config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 matmuls (the heads, f32 trunks) stay f32, as in JAX on the CPU
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if mesh and int(mesh.get("model", 1)) > 1:
            raise NotImplementedError("width-sharded (model > 1) meshes are not ported")
        # training settings, accepted so run snapshots instantiate; the
        # train loop that reads them is not ported yet
        del batch_size, epoch_max, epoch_save_fields, epoch_test_rendering
        del epoch_save_model, scheduler_lr, optimizer_lr, optimizer_weight_decay
        del log_interval
        self.chunk = chunk

        self.dataset = config_lib.instantiate(self.config["dataset"])
        self.calib = PinholeCalib(
            torch.tensor(self.dataset.camera_calib_params, dtype=torch.float32,
                         device=self.device)
        )
        self.camera_initials = torch.tensor(
            self.dataset.camera_params, dtype=torch.float32, device=self.device
        )
        self.camera_deltas = torch.zeros_like(self.camera_initials)

        init_generator = torch.Generator().manual_seed(seed)
        self.neural_render = config_lib.instantiate(
            self.config["render"], network_config=self.config["network"],
            generator=init_generator,
        ).to(self.device)
        self.neural_render.eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

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
