"""The train step's math: pixel draws, ground truth, render, losses and
their gradients.

Counterpart of ``neddf_tpu/training/step.py`` (``draw_pixel_batch:38``,
``construct_targets:64``, ``make_local_grads:83``). The draws are
arguments, so the parity tests can feed the JAX package's pixel and
sample draws. ``accumulate_grads`` splits the drawn batch into
``grad_accum`` equal microbatches, as the JAX package's ``lax.scan``
does: the pixels and both sample uniforms are drawn for the whole batch
and then sliced, so every ray sees the same draws whatever the split.
The camera-delta gradient comes through the pose, which the caller
recomputes for each microbatch.

Data parallelism slices the same way (the JAX package's ``ray_slice``,
``neddf_tpu/training/step.py:126-138``): every rank draws the whole
global batch from the same generator state and keeps its contiguous rows
(``rank_rows``), which ``accumulate_grads`` then splits into its
microbatches; ``parallel/mesh.py::make_sharded_grads`` averages the
ranks' results.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
        raise ValueError(
            f"loss key_target(s) {unknown} have no ground-truth "
            f"constructor; known targets: {KNOWN_TARGET_KEYS} "
            "(training/step.py::construct_targets)"
        )


def check_grad_accum(grad_accum: int, batch_size: int) -> None:
    """``grad_accum`` must split the batch into equal microbatches."""
    if grad_accum < 1 or batch_size % grad_accum:
        raise ValueError(f"grad_accum={grad_accum} must divide {batch_size}")


def check_local_grad_accum(grad_accum: int, local_batch: int, batch_size: int) -> None:
    """``grad_accum`` must split each rank's batch into equal microbatches
    (the JAX step's check and text: the global batch dividing does not
    make each rank's divide, e.g. batch 8 / data 4 / accum 8)."""
    if grad_accum < 1 or local_batch % grad_accum:
        raise ValueError(
            f"grad_accum={grad_accum} must divide the per-device batch {local_batch} "
            f"(global batch {batch_size})")


def rank_rows(batch_size: int, rank: int, world: int) -> slice:
    """The rows of data rank ``rank`` of ``world`` data ranks in the global
    batch: [r B/n, (r + 1) B/n); the model ranks of one data rank (tensor
    parallelism) take the same rows."""
    local = batch_size // world
    return slice(rank * local, (rank + 1) * local)


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


def accumulate_grads(
    renderer: Any,
    loss_functions: Sequence[Any],
    calib: PinholeCalib,
    pose: Callable[[], Tuple[Tensor, Tensor]],
    uv: Tensor,
    targets: Dict[str, Tensor],
    u_strat: Tensor,
    u_pdf: Tensor,
    iteration: int,
    grad_accum: int = 1,
    check_loss: Optional[Callable[[Tensor], None]] = None,
    rows: slice = slice(None),
) -> Tuple[Tensor, Dict[str, Tensor], Tensor]:
    """Loss and gradients of one step over ``grad_accum`` microbatches of
    the rows ``rows`` of the drawn batch (all of it by default; a rank's
    ``rank_rows`` under data parallelism).

    Microbatch i takes rows [i * B/n, (i + 1) * B/n) of those rows;
    its backward adds 1/n of its gradient to ``.grad`` (of the parameters
    and, through ``pose()``, of the camera deltas). Returns the means over
    the microbatches of the total loss, the loss dict and the colour mse,
    detached. ``check_loss`` sees each microbatch's loss before its
    backward (``debug_nans``).
    """
    uv, u_strat, u_pdf = uv[rows], u_strat[rows], u_pdf[rows]
    targets = {k: v[rows] for k, v in targets.items()}
    check_grad_accum(grad_accum, uv.shape[0])
    micro = uv.shape[0] // grad_accum
    sums: Optional[Tuple[Tensor, Dict[str, Tensor], Tensor]] = None
    for i in range(grad_accum):
        mb = slice(i * micro, (i + 1) * micro)
        pose_r, pose_t = pose()
        loss, loss_dict, mse = train_loss(
            renderer, loss_functions, calib, pose_r, pose_t, uv[mb],
            {k: v[mb] for k, v in targets.items()}, u_strat[mb], u_pdf[mb], iteration,
        )
        if check_loss is not None:
            check_loss(loss)
        if grad_accum == 1:
            loss.backward()
            return loss.detach(), {k: v.detach() for k, v in loss_dict.items()}, mse.detach()
        (loss / grad_accum).backward()
        if sums is None:
            sums = (loss.detach().clone(), {k: v.detach().clone() for k, v in loss_dict.items()},
                    mse.detach().clone())
        else:
            sums[0].add_(loss.detach())
            for k, v in loss_dict.items():
                sums[1][k].add_(v.detach())
            sums[2].add_(mse.detach())
    total, total_dict, total_mse = sums
    return (total / grad_accum, {k: v / grad_accum for k, v in total_dict.items()},
            total_mse / grad_accum)
