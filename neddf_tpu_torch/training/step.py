"""The train step's math: pixel draws, ground truth, render, losses.

Counterpart of ``neddf_tpu/training/step.py`` (``draw_pixel_batch:38``,
``construct_targets:64``, the loss of ``make_local_grads:83``) for
``grad_accum=1`` without camera gradients. The draws are arguments, so
the parity tests can feed the JAX package's pixel and sample draws.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from neddf_tpu_torch.geometry.camera import PinholeCalib

Tensor = torch.Tensor

#: target keys this step can construct (``step.py::KNOWN_TARGET_KEYS``)
KNOWN_TARGET_KEYS = ("color", "mask", "fields_penalty")


def draw_pixel_batch(
    generator: torch.Generator, batch_size: int, width: int, height: int
) -> Tuple[Tensor, Tensor]:
    """(us, vs) [B] int64 pixel columns and rows, uniform over
    [0, width-1) x [0, height-1) as the reference draws them."""
    device = generator.device
    u = torch.rand(batch_size, generator=generator, device=device)
    v = torch.rand(batch_size, generator=generator, device=device)
    return (torch.floor(u * (width - 1)).long(), torch.floor(v * (height - 1)).long())


def check_target_keys(target_keys: Sequence[str]) -> None:
    unknown = [k for k in target_keys if k not in KNOWN_TARGET_KEYS]
    if unknown:
        raise ValueError(f"loss key_target(s) {unknown} have no ground-truth constructor; "
                         f"known targets: {KNOWN_TARGET_KEYS}")


def construct_targets(
    target_keys: Sequence[str], rgb_cam: Tensor, mask_cam: Tensor, us: Tensor, vs: Tensor
) -> Dict[str, Tensor]:
    """Ground truth of the drawn pixels (colour and mask scaled by 1/256)."""
    targets: Dict[str, Tensor] = {}
    if "color" in target_keys:
        targets["color"] = (1.0 / 256.0) * rgb_cam[vs, us, :]
    if "mask" in target_keys:
        targets["mask"] = (1.0 / 256.0) * mask_cam[vs, us]
    if "fields_penalty" in target_keys:
        targets["fields_penalty"] = torch.zeros(us.shape, dtype=torch.float32,
                                                device=us.device)
    return targets


def train_loss(
    renderer: Any,
    loss_functions: Sequence[Any],
    calib: PinholeCalib,
    pose_r: Tensor,
    pose_t: Tensor,
    uv: Tensor,
    targets: Dict[str, Tensor],
    u_strat: Tensor,
    u_pdf: Tensor,
    iteration: int,
) -> Tuple[Tensor, Dict[str, Tensor], Tensor]:
    """Render ``uv`` with the training path and sum the losses.

    Returns (total loss, loss dict, colour mse), all scalars that keep
    their autograd graph (the caller runs ``total.backward()``).
    """
    result = renderer.render_rays(calib, pose_r, pose_t, uv, u_strat, u_pdf,
                                  iteration=iteration, need_aux=True)
    loss_dict: Dict[str, Tensor] = {}
    for fn in loss_functions:
        loss_dict.update(fn(result, targets))
    total = sum(loss_dict.values())
    mse = torch.mean(torch.square(result["color"] - targets["color"]))
    return total, loss_dict, mse
