"""NeRF radiance field: a plain MLP trunk, a density head, a colour head.

Counterpart of ``neddf_tpu/fields/nerf.py``:

* the trunk runs on ``PE_mip(pos) * lowpass`` (the mip weights are 1 for
  point samples) through ``layer_count`` dense ReLU layers; layer ``li``
  consumes ``[h, embed]`` when ``li - 1`` is a skip (the reference's
  ``[hx, embed_pos]`` order). It is ``kernels/mlp.py``'s ``mlp_seg`` with
  its hand-written backward: the CUDA kernels on CUDA tensors, their plain
  versions on CPU tensors or with ``fused="off"``;
* density = relu(h @ w_d + b_d); colour = (relu([h, PE(dir)] @ W0 + b0))
  @ W1 + b1, no sigmoid. The heads are rounded as the JAX package's
  ``linear_apply(cast_p(...))`` rounds them: in the compute dtype, so
  bf16 products in bf16; density and colour are returned in f32;
* ``schedule``: lowpass alpha = offset + rate * iteration, and the full
  band (``embed_pos_rank``) for iteration < 0.

``compute_dtype`` is the trunk's operand and storage dtype (bf16 in
``config/network/nerf.yaml``). Parameters are initialised like PyTorch's
``nn.Linear`` from ``generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from neddf_tpu_torch.fields.base import (
    Linear,
    Schedule,
    check_fused,
    reference_name,
    use_kernels,
)
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.kernels.mlp import mlp_apply, mlp_seg, mlp_seg_plain
from neddf_tpu_torch.ops.activations import ACTIVATIONS, relu
from neddf_tpu_torch.ops.pe import pe_lowpass_scale, positional_encoding_mip

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class NeRF(nn.Module):
    # the reference's .pth layout (nn.Linear: weight [out, in])
    pth_linear_transposed = True

    @staticmethod
    def pth_name(name: str) -> str:
        """``name``'s ``.pth`` key: the colour head is the reference's
        Sequential(Linear, ReLU, Linear), module indices 0 and 2."""
        parts = name.split(".")
        if parts[0] == "outL_color":
            parts[1] = {"0": "0", "1": "2"}[parts[1]]
        return reference_name(".".join(parts))

    def __init__(
        self,
        embed_pos_rank: int = 10,
        embed_dir_rank: int = 4,
        layer_count: int = 8,
        layer_width: int = 256,
        activation_type: str = "ReLU",
        density_activation_type: str = "ReLU",
        lowpass_alpha_offset: float = 10.0,
        lowpass_alpha_rate: float = 0.001,
        skips: Sequence[int] = (4,),
        compute_dtype: str = "float32",
        fused: "str | bool" = "auto",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.embed_pos_rank = embed_pos_rank
        self.embed_dir_rank = embed_dir_rank
        self.activation_type = activation_type
        self.density_activation_type = density_activation_type
        self.lowpass_alpha_offset = lowpass_alpha_offset
        self.lowpass_alpha_rate = lowpass_alpha_rate
        self.skips = tuple(skips)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.fused = check_fused(fused)

        pe_dim, dir_dim, w = embed_pos_rank * 6, embed_dir_rank * 6, layer_width
        init = dict(generator=generator, init="torch_default")
        layers = [Linear(pe_dim, w, **init)]
        for layer_id in range(layer_count - 1):
            layers.append(Linear(w + pe_dim if layer_id in self.skips else w, w, **init))
        self.layers = nn.ModuleList(layers)
        self.outL_density = Linear(w, 1, **init)
        self.outL_color = nn.ModuleList([Linear(w + dir_dim, w // 2, **init),
                                         Linear(w // 2, 3, **init)])
        # layer li consumes [h, embed] when a skip follows layer li-1
        self.trunk_layout = tuple((li - 1) in self.skips for li in range(len(layers)))

    def schedule(self, iteration: int) -> Schedule:
        """Warmups at ``iteration``; a negative one selects eval values."""
        if iteration < 0:
            alpha = float(self.embed_pos_rank)
        else:
            alpha = self.lowpass_alpha_offset + self.lowpass_alpha_rate * iteration
        return Schedule(alpha, 1.0, 2.0)

    def forward(
        self, sampling: Sampling, sched: Schedule, *, need_aux: bool = False
    ) -> Dict[str, Tensor]:
        """The JAX package's ``NeRF.apply``: ``density`` [B, S] and
        ``color`` [B, S, 3] (``need_aux`` changes nothing)."""
        del need_aux
        batch_size, sampling_size = sampling.sample_pos.shape[:2]
        cd = self.compute_dtype
        pos = sampling.sample_pos.reshape(-1, 3)
        direction = sampling.sample_dir.reshape(-1, 3)
        var = sampling.diag_variance.reshape(-1, 3)
        kernels = use_kernels(self.fused, pos.device, "NeRF")

        lowpass = pe_lowpass_scale(self.embed_pos_rank, sched.lowpass_alpha, pos.device)
        embed_pos = positional_encoding_mip(pos, self.embed_pos_rank, var=var,
                                            chan_scale=lowpass).to(cd).contiguous()
        embed_dir = positional_encoding_mip(direction, self.embed_dir_rank)
        ws = [layer.w for layer in self.layers]
        bs = [layer.b for layer in self.layers]
        if torch.is_grad_enabled():
            hx = mlp_apply([embed_pos], ws, bs, self.trunk_layout, self.activation_type, cd,
                           kernels)
        else:
            trunk = mlp_seg if kernels else mlp_seg_plain
            hx = trunk([embed_pos], [w.to(cd).contiguous() for w in ws],
                       [b.float().contiguous() for b in bs], self.trunk_layout,
                       self.activation_type)

        density_act = ACTIVATIONS[self.density_activation_type][0]
        density = density_act(self.outL_density.apply_in(hx, cd).float())
        h = relu(self.outL_color[0].apply_in(torch.cat([hx, embed_dir.to(cd)], dim=1), cd))
        color = self.outL_color[1].apply_in(h, cd).float()
        return {
            "density": density.reshape(batch_size, sampling_size),
            "color": color.reshape(batch_size, sampling_size, 3),
        }
