"""Pinhole camera and ray generation.

Counterpart of ``neddf_tpu/geometry/camera.py``: frames are
Right-Up-Back, projection flips to Right-Down-Front via diag(1, -1, -1),
unprojected directions are L2-normalised, pixel centres sit at +0.5.
``ndc_rays`` warps rays into NDC for forward-facing captures.
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


def ndc_rays(calib: PinholeCalib, near: "Tensor | float", rays: Rays) -> Rays:
    """Warp world-space rays into NDC for forward-facing captures (NeRF,
    appendix C): each origin slides along its ray to the plane z = -near,
    then origin and direction map so that ``o' + t' d'`` for t' in [0, 1)
    sweeps the ray from that plane to infinity, uniform in disparity.

    The world frame must be the average camera's (looking along -z), as
    ``LLFFDataset(recenter=True)`` gives it. The NDC x span [-1, 1] covers
    W = 2 cx pixels (y likewise)."""
    fx, fy, cx, cy = calib.params
    o, d = rays.ray_orig, rays.ray_dir
    t_near = -(near + o[:, 2]) / d[:, 2]
    o = o + t_near[:, None] * d
    ax = -fx / cx  # -f / (W/2)
    ay = -fy / cy
    o_z = o[:, 2]
    o_ndc = torch.stack(
        [ax * o[:, 0] / o_z, ay * o[:, 1] / o_z, 1.0 + 2.0 * near / o_z], dim=1)
    d_ndc = torch.stack(
        [ax * (d[:, 0] / d[:, 2] - o[:, 0] / o_z),
         ay * (d[:, 1] / d[:, 2] - o[:, 1] / o_z),
         -2.0 * near / o_z], dim=1)
    return Rays(ray_dir=d_ndc, ray_orig=o_ndc, uv=rays.uv)
