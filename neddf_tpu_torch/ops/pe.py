"""Positional encoding with lowpass window, grad equaliser and mip weights.

Counterpart of ``neddf_tpu/ops/pe.py`` (the default, unpacked layout):

* frequencies are ``2**t`` WITHOUT the pi factor;
* channel layout ``p[n, t*d + i] = freq[t] * x[n, i]`` and encoding
  ``[scale*sin(p), scale*cos(p)]`` -> ``[N, 2*d*R]``;
* the coarse-to-fine lowpass window, the ``1/(0.5*freq)`` Jacobian
  equaliser and the mip attenuation ``exp(-0.5 * freq^2 * var)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

Tensor = torch.Tensor


def pe_frequencies(
    rank: int, device: "torch.device | str", dtype: torch.dtype = torch.float32
) -> Tensor:
    """[rank] frequencies 2**t (no pi factor)."""
    return 2.0 ** torch.arange(rank, device=device, dtype=dtype)


def pe_lowpass_scale(
    rank: int, alpha: float, device: "torch.device | str", input_dim: int = 3
) -> Tensor:
    """[1, rank*input_dim] coarse-to-fine window in the (t, i) layout.

    Bands below floor(alpha) pass, band floor(alpha) gets the cosine ramp
    plus 1e-7, bands above get 1e-7; alpha >= rank gives all ones.
    """
    a = torch.tensor(alpha, dtype=torch.float32, device=device)
    t = torch.arange(rank, dtype=torch.float32, device=device)
    k = torch.floor(a)
    ramp = 0.5 * (1.0 - torch.cos(math.pi * (a - k))) + 1e-7
    scale = torch.where(
        t < k, torch.ones_like(t), torch.where(t == k, ramp, torch.full_like(t, 1e-7))
    )
    if alpha >= rank:
        scale = torch.ones_like(scale)
    return scale.repeat_interleave(input_dim)[None, :]


def pe_grad_scale(rank: int, device: "torch.device | str", input_dim: int = 3) -> Tensor:
    """[1, rank*input_dim] Jacobian-equalising scale 1/(0.5*freq)."""
    return (1.0 / (0.5 * pe_frequencies(rank, device))).repeat_interleave(input_dim)[None, :]


def pe_weights(diag_variance: Tensor, rank: int) -> Tensor:
    """[N, d] covariance diagonal -> [N, rank*d] weights exp(-0.5 f^2 var)."""
    d = diag_variance.shape[-1]
    fsq = torch.square(pe_frequencies(rank, diag_variance.device)).repeat_interleave(d)
    return torch.exp(-0.5 * fsq[None, :] * diag_variance.repeat(1, rank))


def _phase(x: Tensor, rank: int) -> Tensor:
    d = x.shape[-1]
    freq = pe_frequencies(rank, x.device, x.dtype).repeat_interleave(d)
    return freq[None, :] * x.repeat(1, rank)


def positional_encoding(x: Tensor, rank: int, scale: Optional[Tensor] = None) -> Tensor:
    """[N, d] -> [N, 2*d*rank] = [scale*sin(p), scale*cos(p)]."""
    p = _phase(x, rank)
    if scale is None:
        return torch.cat([torch.sin(p), torch.cos(p)], dim=-1)
    return torch.cat([scale * torch.sin(p), scale * torch.cos(p)], dim=-1)


def mip_scale(
    rank: int, var: Optional[Tensor], chan_scale: Optional[Tensor]
) -> Optional[Tensor]:
    """chan_scale * pe_weights(var, rank), either factor optional."""
    scale = chan_scale
    if var is not None:
        w = pe_weights(var, rank)
        scale = w if scale is None else scale * w
    return scale


def positional_encoding_mip(
    x: Tensor,
    rank: int,
    var: Optional[Tensor] = None,
    chan_scale: Optional[Tensor] = None,
) -> Tensor:
    """``positional_encoding(x, rank, chan_scale * pe_weights(var, rank))``."""
    return positional_encoding(x, rank, mip_scale(rank, var, chan_scale))
