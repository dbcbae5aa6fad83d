"""Field building blocks: the warmup schedule, a dense layer, the kernel switch.

Counterpart of ``neddf_tpu/fields/base.py``, with its lattice query
``voxelize``. Parameters keep the JAX
layout: a layer's weight ``w`` is ``[in, out]`` and its bias ``b`` is
``[out]``, so ``training/checkpoint.py::params_from_jax`` is a rename.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from neddf_tpu_torch.geometry.rays import Sampling


class Schedule(NamedTuple):
    """Warmup values at one iteration (``NeDDF.schedule``)."""

    lowpass_alpha: float
    aux_grad_scale: float
    distance_range_max: float


def reference_name(name: str) -> str:
    """A parameter's name in the PyTorch reference's module tree (its
    ``.pth`` keys): a layer's ``w`` and ``b`` are ``weight`` and ``bias``;
    any other leaf (NeuS's ``variance``) keeps its name."""
    *module, leaf = name.split(".")
    return ".".join(module + [{"w": "weight", "b": "bias"}.get(leaf, leaf)])


class Linear(nn.Module):
    """Dense layer ``x @ w + b``.

    ``init="xavier_normal"`` (NeDDF): Xavier-normal ``w``, zero ``b``
    (``neddf_tpu/fields/base.py::linear_init_xavier_normal``).
    ``init="torch_default"`` (NeRF, NeuS): ``w`` and ``b`` uniform in
    +-1/sqrt(fan_in), PyTorch's ``nn.Linear`` default
    (``linear_init_torch_default``). Both draw from ``generator``.
    """

    def __init__(
        self,
        fan_in: int,
        fan_out: int,
        generator: Optional[torch.Generator] = None,
        init: str = "xavier_normal",
    ) -> None:
        super().__init__()
        if init == "xavier_normal":
            std = math.sqrt(2.0 / (fan_in + fan_out))
            w = torch.empty(fan_in, fan_out).normal_(0.0, std, generator=generator)
            b = torch.zeros(fan_out)
        elif init == "torch_default":
            bound = 1.0 / math.sqrt(fan_in)
            w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
            b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
        else:
            raise ValueError(f"unknown init {init!r}")
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def apply_in(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x @ w + b`` with ``w``, ``b`` and ``x`` rounded to ``dtype``
        and the result in ``dtype`` (the JAX package's
        ``linear_apply(cast_p(layer), x)``: bf16 products in bf16)."""
        return x.to(dtype) @ self.w.to(dtype) + self.b.to(dtype)


def use_kernels(fused: str, device: torch.device, name: str) -> bool:
    """Whether a field runs its kernels: ``off`` never, ``auto`` on CUDA
    tensors, ``on`` on CUDA tensors and raises on others. On CUDA tensors
    a configuration the kernels do not take (an unknown activation, say)
    makes their wrappers raise NotImplementedError: nothing on the card
    falls back to the plain versions. The rule holds on both of a field's
    routes, the fused one and the per-layer one (``per_layer_route``)."""
    if fused == "off":
        return False
    if device.type == "cuda":
        return True
    if fused == "on":
        raise ValueError(f"{name}(fused='on') needs CUDA tensors, got {device}")
    return False


def per_layer_route(tp_group, *refusals: Optional[str]) -> bool:
    """Whether a field's trunks take the per-layer route of the kernels
    (``kernels/dual_mlp.py::dual_mlp_layers_walk``) rather than the fused
    one: under tensor parallelism (``tp_group``, the model group; None
    outside it), or where a fused kernel that the field runs refuses its
    configuration. ``refusals`` are those kernels' own predicates
    (``kernel_refusal`` of ``kernels/dual_mlp.py``, ``mlp.py`` or
    ``sdf_mlp.py``; None where the kernel takes it): a width over 512 or
    more layers than a fused kernel holds. The route takes any depth and
    any width; what it too refuses (an unknown activation) raises there."""
    return tp_group is not None or any(r is not None for r in refusals)


def check_fused(fused: "str | bool") -> str:
    """``fused`` as auto/on/off (YAML 1.1 reads a bare on/off as a bool)."""
    if isinstance(fused, bool):
        fused = "on" if fused else "off"
    if fused not in ("auto", "on", "off"):
        raise ValueError(f"fused must be auto/on/off, got {fused!r}")
    return fused


@torch.no_grad()
def voxelize(
    field: nn.Module,
    field_name: str = "density",
    cube_range: float = 1.1,
    cube_resolution: int = 64,
    chunk: int = 65536,
) -> np.ndarray:
    """One output of ``field`` (eval schedule) over a cubic lattice of
    ``cube_resolution``^3 points in [-cube_range, cube_range]^3, as a
    numpy f32 [R, R, R] volume.

    The lattice order is the JAX package's ``np.meshgrid(ids, ids, ids)``
    ('xy' indexing, ``neddf_tpu/fields/base.py::voxelize:121-163``):
    ``volume[i, j, k]`` is the field at ``(x, y, z) = (ids[k], ids[i],
    ids[j])``. Each chunk's positions are built on the field's device
    from their flat indices, and the volume is copied to the host once.
    The eval route (``need_aux=False``) runs unless the field asked for
    is a penalty."""
    device = next(field.parameters()).device
    r = cube_resolution
    ids = torch.as_tensor(
        np.linspace(-cube_range, cube_range, r).astype(np.float32), device=device)
    n = r ** 3
    sched = field.schedule(-1)
    need_aux = "penalty" in field_name
    direction = torch.tensor([1.0, 0.0, 0.0], device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for below in range(0, n, chunk):
        flat = torch.arange(below, min(n, below + chunk), device=device)
        pos = torch.stack([ids[flat % r], ids[flat // (r * r)], ids[(flat // r) % r]], dim=1)
        sampling = Sampling(pos[None], direction.expand_as(pos)[None], torch.zeros_like(pos)[None])
        out[below : below + pos.shape[0]] = field(
            sampling, sched, need_aux=need_aux)[field_name].reshape(-1).float()
    return out.cpu().numpy().reshape(r, r, r)
