"""Ray and Sampling records + point and mip-NeRF cone sampling.

Counterpart of ``neddf_tpu/geometry/rays.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Rays(NamedTuple):
    ray_dir: Tensor  # [B, 3]
    ray_orig: Tensor  # [B, 3]
    uv: Tensor  # [B, 2]


class Sampling(NamedTuple):
    sample_pos: Tensor  # [B, S, 3]
    sample_dir: Tensor  # [B, S, 3]
    diag_variance: Tensor  # [B, S, 3]


def get_sampling_points(rays: Rays, dists: Tensor) -> Sampling:
    """Point samples ``o + d * t`` with zero variance (so the mip PE
    weights are 1)."""
    sample_dir = rays.ray_dir[:, None, :].expand(*dists.shape, 3)
    sample_pos = rays.ray_orig[:, None, :] + rays.ray_dir[:, None, :] * dists[..., None]
    return Sampling(sample_pos, sample_dir, torch.zeros_like(sample_pos))


def get_sampling_cones(rays: Rays, dists: Tensor, ray_radius: float) -> Sampling:
    """Conical-frustum mean and diagonal covariance per interval
    [d_i, d_{i+1}] (the last interval extrapolated)."""
    dists_far = torch.cat([dists[:, 1:], 2.0 * dists[:, -1:] - dists[:, -2:-1]], dim=-1)
    d_mu = 0.5 * (dists + dists_far)
    d_sigma = 0.5 * (dists_far - dists)
    d_mu2 = torch.square(d_mu)
    d_sigma2 = torch.square(d_sigma)
    d_sigma4 = torch.square(d_sigma2)

    m_inv = 1.0 / (3.0 * d_mu2 + d_sigma2 + 1e-7)
    t_mu = d_mu + (2.0 * d_mu * d_sigma2) * m_inv
    t_var = (1.0 / 3.0) * d_sigma2 - (4.0 / 15.0) * d_sigma4 * (
        12.0 * d_mu2 - d_sigma2
    ) * torch.square(m_inv)
    r_var = (ray_radius * ray_radius) * (
        (1.0 / 4.0) * d_mu2 + (5.0 / 12.0) * d_sigma2 - (4.0 / 15.0) * d_sigma4 * m_inv
    )

    sample_dir = rays.ray_dir[:, None, :].expand(*dists.shape, 3)
    dir_sq = torch.square(sample_dir)
    diag_variance = t_var[..., None] * dir_sq + r_var[..., None] * (1.0 - dir_sq)
    sample_pos = rays.ray_orig[:, None, :] + rays.ray_dir[:, None, :] * t_mu[..., None]
    return Sampling(sample_pos, sample_dir, diag_variance)
