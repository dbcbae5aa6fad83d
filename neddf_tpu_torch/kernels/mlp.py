"""Multi-segment value-only MLP forward: CUDA kernel wrapper and plain version.

``mlp_seg`` is the port of ``neddf_tpu/kernels/mlp.py::mlp_seg``, forward
only: layer 0 consumes ``concat(vs)`` as split weight rows, every layer is
dense + activation. For a CUDA tensor it launches ``csrc/mlp_fwd.cu``; for
a CPU tensor it runs ``mlp_seg_plain`` (concat, matmul, activation). Same
numerics as ``kernels/dual_mlp.py``: operands in the input dtype, f32
sums, f32 bias and activations, rounded to the input dtype per layer.

A post-skip layer (NeRF's ``[h, seg0]`` order) is implemented in the
plain version only; the CUDA wrapper refuses it.
"""
from __future__ import annotations

from typing import Sequence

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.ops.activations import ACTIVATIONS

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_WIDTHS = (256,)
_KERNEL_MAX_SEGMENTS = 4
_KERNEL_MAX_LAYERS = 8


def mlp_seg_plain(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
) -> Tensor:
    """Plain PyTorch version of the kernel (same signature).

    Args:
        vs: input segments, each [M, w_i], one dtype (bf16 or f32).
        weights: per layer [fan_in, C] in that dtype; biases: [C] f32.
        layout: per layer, True if it consumes ``[h, seg0]`` (post-skip).
        act_name: activation of every layer.

    Returns:
        [M, C] in the inputs' dtype.
    """
    mlp_seg_plain.calls += 1
    f, _ = ACTIVATIONS[act_name]
    dtype = vs[0].dtype
    h = torch.cat(list(vs), dim=-1)
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li > 0 and layout[li]:
            h = torch.cat([h, vs[0]], dim=-1)
        h = f(h.float() @ w.float() + b.float()).to(dtype)
    return h


mlp_seg_plain.calls = 0


def _check_kernel_args(vs, weights, biases, layout, act_name) -> None:
    if act_name != "tanhExp":
        raise NotImplementedError(f"CUDA mlp_seg kernel: activation {act_name!r}")
    if any(layout):
        raise NotImplementedError("CUDA mlp_seg kernel: post-skip layers ([h, seg0])")
    if not 1 <= len(vs) <= _KERNEL_MAX_SEGMENTS:
        raise ValueError(f"CUDA mlp_seg kernel: {len(vs)} segments")
    if not 1 <= len(weights) <= _KERNEL_MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"CUDA mlp_seg kernel: {len(weights)} layers")
    if len(layout) != len(weights):
        raise ValueError(f"CUDA mlp_seg kernel: layout {tuple(layout)}")
    dtype, m = vs[0].dtype, vs[0].shape[0]
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"CUDA mlp_seg kernel: dtype {dtype}")
    for v in vs:
        if v.dim() != 2 or v.shape[0] != m or v.dtype != dtype:
            raise ValueError(f"CUDA mlp_seg kernel: segment {tuple(v.shape)} {v.dtype}")
    width = weights[0].shape[1]
    if width not in _KERNEL_WIDTHS:
        raise NotImplementedError(f"CUDA mlp_seg kernel: width {width}")
    fan_in = sum(v.shape[1] for v in vs)
    for li, (w, b) in enumerate(zip(weights, biases)):
        if tuple(w.shape) != (fan_in, width) or tuple(b.shape) != (width,):
            raise ValueError(
                f"CUDA mlp_seg kernel: layer {li} w {tuple(w.shape)} b {tuple(b.shape)}, "
                f"expected ({fan_in}, {width})"
            )
        if w.dtype != dtype or b.dtype != torch.float32:
            raise TypeError(f"CUDA mlp_seg kernel: layer {li} dtypes {w.dtype}/{b.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"CUDA mlp_seg kernel: layer {li} weight not 16-byte aligned")
        fan_in = width
    for t in (*vs, *weights, *biases):
        if t.device != vs[0].device:
            raise ValueError("CUDA mlp_seg kernel: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("CUDA mlp_seg kernel: non-contiguous input")


def mlp_seg(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
) -> Tensor:
    """MLP forward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see ``mlp_seg_plain`` for the arguments)."""
    device = vs[0].device
    if device.type == "cpu":
        return mlp_seg_plain(vs, weights, biases, layout, act_name)
    if device.type != "cuda":
        raise ValueError(f"mlp_seg: unsupported device {device}")
    _check_kernel_args(vs, weights, biases, layout, act_name)
    m = vs[0].shape[0]
    width = weights[0].shape[1]
    out = torch.empty((m, width), dtype=vs[0].dtype, device=device)
    if m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(device):
        code = lib.neddf_mlp_seg_fwd(
            _KERNEL_DTYPES[vs[0].dtype], width, m, len(vs),
            _build.pointers(vs), _build.ints([v.shape[1] for v in vs]),
            len(weights), _build.pointers(weights), _build.pointers(biases),
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(code, "mlp_seg")
    mlp_seg.launches += 1
    return out


mlp_seg.launches = 0
