"""Dual (value, tangent-plane) algebra in plane layout.

Counterpart of ``neddf_tpu/ops/dual.py`` in the layout the kernels use:
a value ``v [M, C]`` and K tangent planes ``j [K, M, C]``, where
``j[a] = d v / d x_a``. A dense layer maps the value with ``v W + b`` and
each plane with ``j[a] W``; an activation maps the value with ``f`` and
each plane with ``f'(z_value) * j[a]``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from neddf_tpu_torch.ops.pe import mip_scale, pe_frequencies

Tensor = torch.Tensor
Act = Callable[[Tensor], Tensor]


def linear_dual(
    v: Tensor, j: Tensor, w: Tensor, b: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Dense layer on a dual: (v W + b, j W)."""
    zv = v @ w
    if b is not None:
        zv = zv + b
    return zv, j @ w


def act_dual(zv: Tensor, zj: Tensor, f: Act, dfdx: Act) -> Tuple[Tensor, Tensor]:
    """Elementwise activation on a dual (chain rule on the planes)."""
    return f(zv), dfdx(zv)[None] * zj


def pe_dual_planes(
    x: Tensor, rank: int, scale: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Positional encoding with its exact spatial Jacobian, plane layout.

    Returns ``v [M, 2dR]`` and ``j [d, M, 2dR]``: each channel depends on
    one input axis, so plane ``a`` is non-zero only on the channels of
    axis ``a`` (``neddf_tpu/ops/dual.py::pe_dual_planes``).
    """
    _, d = x.shape
    freq = pe_frequencies(rank, x.device, x.dtype).repeat_interleave(d)[None, :]
    p = freq * x.repeat(1, rank)
    if scale is None:
        scale = torch.ones((1, rank * d), dtype=x.dtype, device=x.device)
    sin_p, cos_p = torch.sin(p), torch.cos(p)
    v = torch.cat([scale * sin_p, scale * cos_p], dim=-1)
    g_full = torch.cat([scale * freq * cos_p, -scale * freq * sin_p], dim=-1)
    mask = torch.eye(d, dtype=x.dtype, device=x.device).repeat(1, 2 * rank)  # [d, 2dR]
    return v, mask[:, None, :] * g_full[None, :, :]


def pe_dual_planes_mip(
    x: Tensor,
    rank: int,
    var: Optional[Tensor] = None,
    chan_scale: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """``pe_dual_planes(x, rank, chan_scale * pe_weights(var, rank))``."""
    return pe_dual_planes(x, rank, mip_scale(rank, var, chan_scale))


def pe_dual_directional_mip(
    x: Tensor,
    rank: int,
    direction: Tensor,
    var: Optional[Tensor] = None,
    chan_scale: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """PE value and its ONE directional tangent along ``direction [M, 3]``.

    Returns ``(val [M, 6R], tan [M, 6R])`` with
    ``tan = sum_a pe_dual_planes_mip(x, ...)[1][a] * direction[:, a]``:
    each channel depends on one input axis, so the contraction is a
    channel-wise multiply by the direction tiled ``rank`` times
    (``neddf_tpu/ops/dual.py::pe_dual_directional_mip``).
    """
    _, d = x.shape
    freq = pe_frequencies(rank, x.device, x.dtype).repeat_interleave(d)[None, :]
    p = freq * x.repeat(1, rank)
    scale = mip_scale(rank, var, chan_scale)
    if scale is None:
        scale = torch.ones((1, rank * d), dtype=x.dtype, device=x.device)
    sin_p, cos_p = torch.sin(p), torch.cos(p)
    val = torch.cat([scale * sin_p, scale * cos_p], dim=-1)
    v_rep = direction.to(x.dtype).repeat(1, rank)
    tan = torch.cat([scale * freq * cos_p * v_rep, -scale * freq * sin_p * v_rep], dim=-1)
    return val, tan
