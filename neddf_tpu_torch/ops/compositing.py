"""Alpha-compositing volume-render integration.

Counterpart of ``neddf_tpu/ops/compositing.py``:

    alpha_i = 1 - exp(-sigma_i * (d_{i+1} - d_i))     (first S-1 samples)
    T_i     = prod_{j<i} (1 - alpha_j + 1e-7)
    w_i     = alpha_i * T_i
    depth   = sum w_i d_i + T_final * max_dist
    color   = sum w_i c_i
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def integrate_volume_render(
    dists: Tensor, densities: Tensor, colors: Tensor, max_dist: float
) -> Dict[str, Tensor]:
    """dists/densities [B, S], colors [B, S, 3] -> weight [B, S-1],
    depth [B], color [B, 3], transmittance [B]."""
    deltas = dists[:, 1:] - dists[:, :-1]
    alpha = 1.0 - torch.exp(-densities[:, :-1] * deltas)
    log_t = torch.cumsum(torch.log(1.0 - alpha + 1e-7), dim=-1)
    t = torch.cat([torch.ones_like(log_t[:, :1]), torch.exp(log_t)], dim=-1)
    w = alpha * t[:, :-1]
    return {
        "weight": w,
        "depth": torch.sum(w * dists[:, :-1], dim=-1) + t[:, -1] * max_dist,
        "color": torch.sum(w[:, :, None] * colors[:, :-1, :], dim=-2),
        "transmittance": t[:, -1],
    }
