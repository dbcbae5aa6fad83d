"""SE(3) pose from a rotation vector and translation (Rodrigues).

Counterpart of ``neddf_tpu/geometry/se3.py::rodrigues`` and
``camera_pose``, including the reference's V matrix and the small-angle
branch (theta^2 < 1e-20 -> R = V = I + skew(w)).
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def skew(v: Tensor) -> Tensor:
    """[3] -> [3, 3] cross-product matrix."""
    zero = torch.zeros_like(v[0])
    return torch.stack(
        [
            torch.stack([zero, -v[2], v[1]]),
            torch.stack([v[2], zero, -v[0]]),
            torch.stack([-v[1], v[0], zero]),
        ]
    )


def rodrigues(w_vec: Tensor) -> Tuple[Tensor, Tensor]:
    """Rotation R and the reference's V matrix from a rotation vector [3]."""
    eye = torch.eye(3, dtype=w_vec.dtype, device=w_vec.device)
    theta_sq = torch.sum(torch.square(w_vec))
    if float(theta_sq) < 1e-20:
        r_small = eye + skew(w_vec)
        return r_small, r_small
    theta = torch.sqrt(theta_sq)
    w_unit = skew(w_vec / theta)
    ww = w_unit @ w_unit
    c, s = torch.cos(theta), torch.sin(theta)
    theta_inv = 1.0 / theta
    r = eye + s * w_unit + (1.0 - c) * ww
    v = (
        eye
        + (1.0 - c) * theta_inv * theta_inv * w_unit
        + (theta - s) * theta_inv * theta_inv * theta_inv * ww
    )
    return r, v


def camera_pose(initial_param: Tensor, delta_param: Tensor) -> Tuple[Tensor, Tensor]:
    """World-from-camera (R [3,3], T [3]) from [rotvec, translation] and
    a pose delta of the same layout: R = Ri R0, T = Vi dt + Ri T0."""
    r0, _ = rodrigues(initial_param[:3])
    ri, vi = rodrigues(delta_param[:3])
    return ri @ r0, vi @ delta_param[3:6] + ri @ initial_param[3:6]
