"""Ray-distance samplers: stratified coarse + inverse-CDF fine.

Counterpart of ``neddf_tpu/ops/sampling.py``. The uniform draws are
arguments, so a caller chooses the generator (``torch.Generator`` in the
renderer, the JAX draws in the parity tests).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def stratified_dists(
    u: Tensor, sample_count: int, dist_near: float, dist_far: float
) -> Tensor:
    """[B, sample_count+1] linspace over [near, far] plus a jitter of
    ``u * (far - near) / sample_count``; ``u`` is [B, sample_count+1]
    in [0, 1)."""
    base = torch.linspace(
        dist_near, dist_far, sample_count + 1, device=u.device, dtype=u.dtype
    )
    return base[None, :] + u * ((dist_far - dist_near) / sample_count)


def sample_pdf(dists: Tensor, weights: Tensor, u: Tensor) -> Tensor:
    """Hierarchical inverse-CDF sampling of fine ray distances.

    Args:
        dists: [B, S] coarse distances (ascending).
        weights: [B, S-1] compositing weights of the coarse intervals.
        u: [B, N] uniforms in [0, 1).

    Returns:
        [B, N + S]: the new samples and the coarse distances, sorted per
        ray (the JAX package's ``cat_coarse=True``, its only use).

    Weights are sanitised (NaN and negatives to 0) and floored by +1e-2,
    so every CDF bin has mass; under that floor ``searchsorted`` plus a
    linear interpolation equals the JAX package's gather-free
    ``_inverse_cdf`` (``neddf_tpu/ops/sampling.py:79-84``).
    """
    w = torch.where(torch.isnan(weights) | (weights < 0.0), 0.0, weights) + 1e-2
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # [B, S]

    n_bins = dists.shape[-1] - 1
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    lo = torch.clamp(idx - 1, 0, n_bins - 1)
    c0 = torch.gather(cdf, 1, lo)
    c1 = torch.gather(cdf, 1, lo + 1)
    d0 = torch.gather(dists, 1, lo)
    d1 = torch.gather(dists, 1, lo + 1)
    t = torch.clamp((u - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0)
    samples = d0 + t * (d1 - d0)

    samples, _ = torch.sort(torch.cat([samples, dists], dim=-1), dim=-1)
    # NaN fallback: a uniform linspace over the ray's range
    ramp = torch.linspace(
        0.0, 1.0, samples.shape[-1], device=dists.device, dtype=dists.dtype
    )
    fallback = dists[:, :1] + ramp[None, :] * (dists[:, -1:] - dists[:, :1])
    return torch.where(torch.isnan(samples), fallback, samples)
