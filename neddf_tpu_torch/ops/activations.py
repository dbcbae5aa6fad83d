"""Activation functions and their first derivatives, on tensors.

Counterpart of ``neddf_tpu/ops/activations.py``. The derivatives are
written out by hand (not taken from autograd), with the same thresholds:
tanhExp and softplus pass ``x`` through above 20, where the derivative
is exactly 1 (``neddf_tpu/kernels/dual_mlp.py::_act_fns``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Tensor = torch.Tensor

_THRESHOLD = 20.0


def tanh_exp(x: Tensor) -> Tensor:
    """x * tanh(exp(x)), linear for x > 20."""
    xs = torch.clamp(x, max=_THRESHOLD)
    return torch.where(x > _THRESHOLD, x, x * torch.tanh(torch.exp(xs)))


def tanh_exp_deriv(x: Tensor) -> Tensor:
    xs = torch.clamp(x, max=_THRESHOLD)
    ex = torch.exp(xs)
    tx = torch.tanh(ex)
    d = tx - x * ex * (tx * tx - 1.0)
    return torch.where(x > _THRESHOLD, torch.ones_like(x), d)


def relu(x: Tensor) -> Tensor:
    return torch.clamp(x, min=0.0)


def relu_deriv(x: Tensor) -> Tensor:
    return (x > 0.0).to(x.dtype)


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)), linear for x > 20."""
    return torch.where(
        x > _THRESHOLD, x, torch.log1p(torch.exp(torch.clamp(x, max=_THRESHOLD)))
    )


def softplus_deriv(x: Tensor) -> Tensor:
    return torch.where(x > _THRESHOLD, torch.ones_like(x), torch.sigmoid(x))


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def sigmoid_deriv(x: Tensor) -> Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 - s)


# name -> (f, df/dx); names match the configs' activation_type strings
ACTIVATIONS: Dict[str, Tuple[Callable[[Tensor], Tensor], Callable[[Tensor], Tensor]]] = {
    "ReLU": (relu, relu_deriv),
    "tanhExp": (tanh_exp, tanh_exp_deriv),
}
