"""Dual-MLP trunk forward: CUDA kernel wrapper and its plain version.

``dual_mlp_trunk`` is the port of ``neddf_tpu/kernels/dual_mlp.py::
dual_mlp_seg`` in its trunk configuration (K tangent planes, one input
segment, a post-skip layer consuming ``[seg0, h]``), forward only. For a
CUDA tensor it launches ``csrc/dual_mlp_fwd.cu``; for a CPU tensor it
runs ``dual_mlp_trunk_plain``, which does the same arithmetic with torch
ops. There is no fallback from one to the other.

Numerics of both: operands in the input dtype (bf16 or f32), products
summed in f32, the f32 bias on the value rows, activations in f32 and
rounded to the input dtype between layers and at the output.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.ops.activations import ACTIVATIONS
from neddf_tpu_torch.ops.dual import act_dual, linear_dual

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_N_TAN = (3,)
_KERNEL_WIDTHS = (256,)
_KERNEL_MAX_LAYERS = 8


def dual_mlp_trunk_plain(
    v0: Tensor,
    j0: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the trunk kernel (same signature).

    Args:
        v0: [M, C0] input values; j0: [K, M, C0] input tangent planes.
        weights: per layer [fan_in, C] in v0's dtype; biases: [C] f32.
        layout: per layer, True if it consumes ``[seg0, h]`` (post-skip).
        act_name: activation of every layer.

    Returns:
        (v [M, C], j [K, M, C]) in v0's dtype.
    """
    dual_mlp_trunk_plain.calls += 1
    f, df = ACTIVATIONS[act_name]
    dtype = v0.dtype
    hv, hj = v0, j0
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li > 0 and layout[li]:
            hv, hj = torch.cat([v0, hv], dim=-1), torch.cat([j0, hj], dim=-1)
        zv, zj = linear_dual(hv.float(), hj.float(), w.float(), b.float())
        av, aj = act_dual(zv, zj, f, df)
        hv, hj = av.to(dtype), aj.to(dtype)
    return hv, hj


dual_mlp_trunk_plain.calls = 0


def _check_kernel_args(v0, j0, weights, biases, layout, act_name) -> None:
    if act_name != "tanhExp":
        raise NotImplementedError(f"CUDA trunk kernel: activation {act_name!r}")
    if v0.dtype not in _KERNEL_DTYPES or j0.dtype != v0.dtype:
        raise TypeError(f"CUDA trunk kernel: dtypes {v0.dtype}/{j0.dtype}")
    if v0.dim() != 2 or j0.dim() != 3 or j0.shape[1:] != v0.shape:
        raise ValueError(f"CUDA trunk kernel: shapes {tuple(v0.shape)} / {tuple(j0.shape)}")
    if j0.shape[0] not in _KERNEL_N_TAN:
        raise NotImplementedError(f"CUDA trunk kernel: K={j0.shape[0]}")
    if not 1 <= len(weights) <= _KERNEL_MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"CUDA trunk kernel: {len(weights)} layers")
    if len(layout) != len(weights) or layout[0]:
        raise ValueError(f"CUDA trunk kernel: layout {tuple(layout)}")
    c0 = v0.shape[1]
    width = weights[0].shape[1]
    if width not in _KERNEL_WIDTHS:
        raise NotImplementedError(f"CUDA trunk kernel: width {width}")
    for li, (w, b) in enumerate(zip(weights, biases)):
        fan_in = c0 if li == 0 else (c0 + width if layout[li] else width)
        if tuple(w.shape) != (fan_in, width) or tuple(b.shape) != (width,):
            raise ValueError(
                f"CUDA trunk kernel: layer {li} w {tuple(w.shape)} b {tuple(b.shape)}, "
                f"expected ({fan_in}, {width})"
            )
        if w.dtype != v0.dtype or b.dtype != torch.float32:
            raise TypeError(f"CUDA trunk kernel: layer {li} dtypes {w.dtype}/{b.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"CUDA trunk kernel: layer {li} weight not 16-byte aligned")
    for t in (v0, j0, *weights, *biases):
        if t.device != v0.device:
            raise ValueError("CUDA trunk kernel: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("CUDA trunk kernel: non-contiguous input")


def dual_mlp_trunk(
    v0: Tensor,
    j0: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
) -> Tuple[Tensor, Tensor]:
    """Trunk forward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see ``dual_mlp_trunk_plain`` for the arguments)."""
    if v0.device.type == "cpu":
        return dual_mlp_trunk_plain(v0, j0, weights, biases, layout, act_name)
    if v0.device.type != "cuda":
        raise ValueError(f"dual_mlp_trunk: unsupported device {v0.device}")
    _check_kernel_args(v0, j0, weights, biases, layout, act_name)
    m = v0.shape[0]
    n_tan = j0.shape[0]
    width = weights[0].shape[1]
    v_out = torch.empty((m, width), dtype=v0.dtype, device=v0.device)
    j_out = torch.empty((n_tan, m, width), dtype=v0.dtype, device=v0.device)
    if m == 0:
        return v_out, j_out
    lib = _build.library()
    with torch.cuda.device(v0.device):
        code = lib.neddf_dual_mlp_fwd(
            _KERNEL_DTYPES[v0.dtype], n_tan, width, m, 1,
            _build.pointers([v0]), _build.pointers([j0]), _build.ints([v0.shape[1]]),
            len(weights), _build.pointers(weights), _build.pointers(biases),
            _build.ints(layout), v_out.data_ptr(), j_out.data_ptr(),
            torch.cuda.current_stream(v0.device).cuda_stream,
        )
    _build.check(code, "dual_mlp_trunk")
    dual_mlp_trunk.launches += 1
    return v_out, j_out


dual_mlp_trunk.launches = 0
