"""Pinhole camera and ray generation.

Counterpart of ``neddf_tpu/geometry/camera.py``: frames are
Right-Up-Back, projection flips to Right-Down-Front via diag(1, -1, -1),
unprojected directions are L2-normalised, pixel centres sit at +0.5.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from neddf_tpu_torch.geometry.rays import Rays

Tensor = torch.Tensor


class PinholeCalib(NamedTuple):
    """Intrinsics [fx, fy, cx, cy]."""

    params: Tensor  # [4]


def unproject_local(calib: PinholeCalib, uv: Tensor) -> Tensor:
    """[B, 2] pixel coordinates -> [B, 3] unit camera-frame (RUB) dirs."""
    fx, fy, cx, cy = calib.params
    x = (uv[:, 0] - cx) / fx
    y = (uv[:, 1] - cy) / fy
    xyz_rub = torch.stack([x, -y, -torch.ones_like(x)], dim=1)
    return xyz_rub / torch.linalg.norm(xyz_rub, dim=1, keepdim=True)


def create_rays(calib: PinholeCalib, r: Tensor, t: Tensor, uv: Tensor) -> Rays:
    """Rays through the centres of integer pixels ``uv [B, 2]``."""
    uv_center = 0.5 + uv.to(torch.float32)
    ray_dir = unproject_local(calib, uv_center) @ r.T
    ray_orig = t[None, :].expand(uv.shape[0], 3)
    return Rays(ray_dir=ray_dir, ray_orig=ray_orig, uv=uv)
