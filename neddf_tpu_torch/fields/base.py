"""Field building blocks: the warmup schedule and a dense layer.

Counterpart of ``neddf_tpu/fields/base.py``. Parameters keep the JAX
layout: a layer's weight ``w`` is ``[in, out]`` and its bias ``b`` is
``[out]``, so ``training/checkpoint.py::params_from_jax`` is a rename.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn


class Schedule(NamedTuple):
    """Warmup values at one iteration (``NeDDF.schedule``)."""

    lowpass_alpha: float
    aux_grad_scale: float
    distance_range_max: float


class Linear(nn.Module):
    """Dense layer ``x @ w + b`` with Xavier-normal ``w`` and zero ``b``
    (``neddf_tpu/fields/base.py::linear_init_xavier_normal``)."""

    def __init__(
        self, fan_in: int, fan_out: int, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.empty(fan_in, fan_out).normal_(0.0, std, generator=generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(fan_out))
