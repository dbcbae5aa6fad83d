"""Activation functions and their first and second derivatives, on tensors.

Counterpart of ``neddf_tpu/ops/activations.py`` and of the kernels'
``(f, f', f'')`` triples (``neddf_tpu/kernels/dual_mlp.py::_act_fns``).
The derivatives are written out by hand (not taken from autograd), with
the same thresholds: tanhExp and softplus pass ``x`` through above 20,
where f' is exactly 1 and f'' exactly 0; ReLU has f' = 0 at 0, LeakyReLU
(slope 0.01) f' = 1 at 0 (``leaky_relu_deriv``: x >= 0), where torch's
autograd would give the slope.
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


def tanh_exp_deriv2(x: Tensor) -> Tensor:
    xs = torch.clamp(x, max=_THRESHOLD)
    ex = torch.exp(xs)
    tx = torch.tanh(ex)
    d2 = ex * (1.0 - tx * tx) * (2.0 + x - 2.0 * x * ex * tx)
    return torch.where(x > _THRESHOLD, torch.zeros_like(x), d2)


def relu(x: Tensor) -> Tensor:
    return torch.clamp(x, min=0.0)


def relu_deriv(x: Tensor) -> Tensor:
    return (x > 0.0).to(x.dtype)


_LEAKY_SLOPE = 0.01


def leaky_relu(x: Tensor) -> Tensor:
    return torch.where(x >= 0.0, x, _LEAKY_SLOPE * x)


def leaky_relu_deriv(x: Tensor) -> Tensor:
    return torch.where(x >= 0.0, torch.ones_like(x), torch.full_like(x, _LEAKY_SLOPE))


def zeros_deriv2(x: Tensor) -> Tensor:
    return torch.zeros_like(x)


def softplus(x: Tensor) -> Tensor:
    """log(1 + exp(x)), linear for x > 20."""
    return torch.where(
        x > _THRESHOLD, x, torch.log1p(torch.exp(torch.clamp(x, max=_THRESHOLD)))
    )


def softplus_deriv(x: Tensor) -> Tensor:
    return torch.where(x > _THRESHOLD, torch.ones_like(x), torch.sigmoid(x))


def softplus_deriv2(x: Tensor) -> Tensor:
    s = torch.sigmoid(x)
    return torch.where(x > _THRESHOLD, torch.zeros_like(x), s * (1.0 - s))


def sigmoid(x: Tensor) -> Tensor:
    return torch.sigmoid(x)


def sigmoid_deriv(x: Tensor) -> Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def sigmoid_deriv2(x: Tensor) -> Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 - s) * (1.0 - 2.0 * s)


Fn = Callable[[Tensor], Tensor]

# name -> (f, df/dx, d2f/dx2); names match the configs' activation_type strings
ACTIVATION_TRIPLES: Dict[str, Tuple[Fn, Fn, Fn]] = {
    "ReLU": (relu, relu_deriv, zeros_deriv2),
    "LeakyReLU": (leaky_relu, leaky_relu_deriv, zeros_deriv2),
    "tanhExp": (tanh_exp, tanh_exp_deriv, tanh_exp_deriv2),
    "Softplus": (softplus, softplus_deriv, softplus_deriv2),
    "Sigmoid": (sigmoid, sigmoid_deriv, sigmoid_deriv2),
}

# the activations whose f'' is identically zero: the backwards keep no
# plane for the f'' terms (kernels/sdf_mlp.py)
SECOND_DERIVATIVE_ZERO = frozenset({"ReLU", "LeakyReLU"})

# name -> (f, df/dx)
ACTIVATIONS: Dict[str, Tuple[Fn, Fn]] = {
    name: (f, df) for name, (f, df, _) in ACTIVATION_TRIPLES.items()
}
