"""Loss functions of the NeDDF configs.

Counterpart of ``neddf_tpu/training/losses.py``: each loss reads
``outputs[key_output]`` against ``targets[key_target]`` and returns
``{key_loss: weight * loss}``, plus ``{key_loss}_coarse`` on the coarse
pass's output when ``weight_coarse > 0``.
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


class BaseLoss:
    key_output: str
    key_target: str
    key_loss: str

    def __init__(self, weight: float = 1.0, weight_coarse: float = 0.1) -> None:
        self.weight = weight
        self.weight_coarse = weight_coarse

    def loss(self, output: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError()

    def __call__(self, outputs: Dict[str, Tensor], targets: Dict[str, Tensor]
                 ) -> Dict[str, Tensor]:
        out = {self.key_loss: self.weight * self.loss(
            outputs[self.key_output], targets[self.key_target])}
        if self.weight_coarse > 0.0:
            out[f"{self.key_loss}_coarse"] = self.weight_coarse * self.loss(
                outputs[f"{self.key_output}_coarse"], targets[self.key_target])
        return out


class ColorLoss(BaseLoss):
    """MSE on the rendered colour."""

    key_output = key_target = key_loss = "color"

    def loss(self, output: Tensor, target: Tensor) -> Tensor:
        return torch.mean(torch.square(output - target))


class MaskBCELoss(BaseLoss):
    """BCE of (1 - transmittance), clamped to [1e-6, 1 - 1e-6], on the mask."""

    key_output = "transmittance"
    key_target = "mask"
    key_loss = "mask"

    def loss(self, output: Tensor, target: Tensor) -> Tensor:
        mask_output = torch.clamp(1.0 - output, 1e-6, 1.0 - 1e-6)
        return -torch.mean(target * torch.log(mask_output)
                           + (1.0 - target) * torch.log(1.0 - mask_output))


class MaskMSELoss(BaseLoss):
    """MSE of (1 - transmittance), clamped, against the mask."""

    key_output = "transmittance"
    key_target = "mask"
    key_loss = "mask"

    def loss(self, output: Tensor, target: Tensor) -> Tensor:
        mask_output = torch.clamp(1.0 - output, 1e-6, 1.0 - 1e-6)
        return torch.mean(torch.square(mask_output - target))


class FieldsConstraintLoss(BaseLoss):
    """Mean of the integrated field-constraint penalty (the target is a
    zeros placeholder)."""

    key_output = key_target = key_loss = "fields_penalty"

    def loss(self, output: Tensor, target: Tensor) -> Tensor:
        del target
        return torch.mean(output)
