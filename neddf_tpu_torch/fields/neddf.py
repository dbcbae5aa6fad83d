"""NeDDF field, eval path: distance trunk with spatial Jacobian, density
from the distance gradient, value-only colour trunk.

Counterpart of ``neddf_tpu/fields/neddf.py`` for ``need_aux=False``
(``:496-655``). The training path (``need_aux=True``: penalties, the
directional colour tangent, gradients) is not ported yet.

Per sample, with the eval schedule:

* the DDF trunk runs on the PE-with-Jacobian of the position, scaled by
  grad_scale * lowpass * mip weights, as K=3 tangent planes
  (``kernels/dual_mlp.py``); layer s+1 consumes ``[embed, h]`` for each
  skip s;
* D = softplus(h_d) + d_near and its gradient, aux = s * sigmoid(h_a),
  density = relu((1/D) * (1 - sqrt(|grad D|^2 + aux^2))), and the normal
  grad D / (|grad D| + 1e-7);
* the colour trunk runs on ``[PE_mip(pos) * lowpass, PE(dir), normal,
  trunk features]`` (``kernels/mlp.py``), then the colour head.

``compute_dtype`` sets the trunks' operand and storage dtype (bf16 in
the shipped configs); the heads and the density run in f32. ``fused``
selects the trunk implementation: ``auto`` runs the CUDA kernels on CUDA
tensors and their plain versions on CPU tensors, ``on`` requires CUDA
tensors, ``off`` always runs the plain versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from neddf_tpu_torch.fields.base import Linear, Schedule
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_trunk, dual_mlp_trunk_plain
from neddf_tpu_torch.kernels.mlp import mlp_seg, mlp_seg_plain
from neddf_tpu_torch.ops.activations import (
    ACTIVATIONS,
    sigmoid,
    softplus,
    softplus_deriv,
)
from neddf_tpu_torch.ops.dual import pe_dual_planes_mip
from neddf_tpu_torch.ops.pe import (
    pe_grad_scale,
    pe_lowpass_scale,
    positional_encoding_mip,
)

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class NeDDF(nn.Module):
    def __init__(
        self,
        embed_pos_rank: int = 10,
        embed_dir_rank: int = 4,
        ddf_layer_count: int = 8,
        ddf_layer_width: int = 256,
        col_layer_count: int = 8,
        col_layer_width: int = 256,
        activation_type: str = "tanhExp",
        density_activation_type: str = "ReLU",
        d_near: float = 0.01,
        lowpass_alpha_offset: float = 10.0,
        lowpass_alpha_rate: float = 0.001,
        skips: Sequence[int] = (4,),
        penalty_weight: Optional[Dict[str, float]] = None,
        compute_dtype: str = "float32",
        fused: "str | bool" = "auto",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if isinstance(fused, bool):  # YAML 1.1 reads a bare on/off as a bool
            fused = "on" if fused else "off"
        if fused not in ("auto", "on", "off"):
            raise ValueError(f"fused must be auto/on/off, got {fused!r}")
        self.embed_pos_rank = embed_pos_rank
        self.embed_dir_rank = embed_dir_rank
        self.activation_type = activation_type
        self.density_activation_type = density_activation_type
        self.d_near = d_near
        self.lowpass_alpha_offset = lowpass_alpha_offset
        self.lowpass_alpha_rate = lowpass_alpha_rate
        self.skips = tuple(skips)
        # training-only (the penalties); kept so snapshots instantiate
        self.penalty_weight = dict(penalty_weight or {})
        self.compute_dtype = _DTYPES[compute_dtype]
        self.fused = fused

        pe_dim = embed_pos_rank * 6
        w, cw = ddf_layer_width, col_layer_width
        ddf = [Linear(pe_dim, w, generator)]
        for layer_id in range(ddf_layer_count - 2):
            fan_in = w + pe_dim if layer_id in self.skips else w
            ddf.append(Linear(fan_in, w, generator))
        col_in = (embed_pos_rank + embed_dir_rank) * 6 + 3 + w
        col = [Linear(col_in, cw, generator)]
        for _ in range(col_layer_count - 2):
            col.append(Linear(cw, cw, generator))
        self.layers_ddf = nn.ModuleList(ddf)
        self.layers_col = nn.ModuleList(col)
        self.layer_ddf_out = Linear(w, 1, generator)
        self.layer_aux_out = Linear(w, 1, generator)
        self.layer_col_out = Linear(cw, 3, generator)
        # layer li consumes [embed, h] when a skip follows layer li-1
        self.trunk_layout = tuple((li - 1) in self.skips for li in range(len(ddf)))

    def schedule(self, iteration: int) -> Schedule:
        """Warmups at ``iteration``; a negative iteration selects the
        eval values (``neddf_tpu/fields/neddf.py::schedule``)."""
        if iteration < 0:
            return Schedule(float(self.embed_pos_rank), 1.1, 2.0)
        return Schedule(
            self.lowpass_alpha_offset + self.lowpass_alpha_rate * iteration,
            min(max(0.0001 * iteration, 0.01), 1.1),
            min(2.0, 2.0 + 0.0001 * iteration),
        )

    def _use_kernels(self, device: torch.device) -> bool:
        if self.fused == "off":
            return False
        if device.type == "cuda":
            return True
        if self.fused == "on":
            raise ValueError(f"NeDDF(fused='on') needs CUDA tensors, got {device}")
        return False

    def _trunk_params(self, layers: nn.ModuleList):
        cd = self.compute_dtype
        return (
            [layer.w.detach().to(cd).contiguous() for layer in layers],
            [layer.b.detach().float().contiguous() for layer in layers],
        )

    def _head(self, layer: Linear) -> "tuple[Tensor, Tensor]":
        """Head weight and bias rounded to the compute dtype, as f32."""
        cd = self.compute_dtype
        return layer.w.detach().to(cd).float(), layer.b.detach().to(cd).float()

    def forward(
        self, sampling: Sampling, sched: Schedule, *, need_aux: bool = False
    ) -> Dict[str, Tensor]:
        """The JAX package's ``NeDDF.apply``; outputs are [B, S] tensors
        (``color`` [B, S, 3]) and ``fields_penalty`` is zeros."""
        if need_aux:
            raise NotImplementedError("NeDDF training path (need_aux=True) is not ported")
        batch_size, sampling_size = sampling.sample_pos.shape[:2]
        act = self.activation_type
        density_act, _ = ACTIVATIONS[self.density_activation_type]
        cd = self.compute_dtype
        pos = sampling.sample_pos.reshape(-1, 3)
        direction = sampling.sample_dir.reshape(-1, 3)
        var = sampling.diag_variance.reshape(-1, 3)
        device = pos.device
        use_kernels = self._use_kernels(device)
        trunk = dual_mlp_trunk if use_kernels else dual_mlp_trunk_plain
        col_mlp = mlp_seg if use_kernels else mlp_seg_plain

        rank = self.embed_pos_rank
        lowpass = pe_lowpass_scale(rank, sched.lowpass_alpha, device)
        emb_v, emb_j = pe_dual_planes_mip(
            pos, rank, var=var, chan_scale=pe_grad_scale(rank, device) * lowpass
        )
        w_ddf, b_ddf = self._trunk_params(self.layers_ddf)
        v_feat, j_feat = trunk(
            emb_v.to(cd).contiguous(), emb_j.to(cd).contiguous(),
            w_ddf, b_ddf, self.trunk_layout, act,
        )

        # both 1-wide heads in one [C, 2] matmul, in f32
        wd, bd = self._head(self.layer_ddf_out)
        wa, ba = self._head(self.layer_aux_out)
        w2, b2 = torch.cat([wd, wa], dim=1), torch.cat([bd, ba])
        hv2 = v_feat.float() @ w2 + b2  # [M, 2]
        ddf_out, aux_out = hv2[:, :1], hv2[:, 1:]
        ddf_jac_p = j_feat.float() @ wd[:, 0]  # [3, M]

        distance = softplus(ddf_out) + self.d_near  # [M, 1]
        distance_grad_p = softplus_deriv(ddf_out)[:, 0][None] * ddf_jac_p  # [3, M]
        aux_grad = sched.aux_grad_scale * sigmoid(aux_out)  # [M, 1]
        grad_sq = torch.sum(torch.square(distance_grad_p), dim=0)
        d_ddt = torch.sqrt(grad_sq + torch.square(aux_grad[:, 0]))
        density = density_act((1.0 / distance[:, 0]) * (1.0 - d_ddt))
        norm_dir = (distance_grad_p / (torch.sqrt(grad_sq)[None] + 1e-7)).T

        embed_dir = positional_encoding_mip(direction, self.embed_dir_rank)
        ep_val = positional_encoding_mip(pos, rank, var=var, chan_scale=lowpass)
        segs = [
            ep_val.to(cd).contiguous(),
            embed_dir.to(cd).contiguous(),
            norm_dir.to(cd).contiguous(),
            v_feat,
        ]
        w_col, b_col = self._trunk_params(self.layers_col)
        hc = col_mlp(segs, w_col, b_col, (False,) * len(w_col), act)
        w_co, b_co = self._head(self.layer_col_out)
        color = hc.float() @ w_co + b_co  # [M, 3]
        return {
            "distance": distance.reshape(batch_size, sampling_size),
            "density": density.reshape(batch_size, sampling_size),
            "color": color.reshape(batch_size, sampling_size, 3),
            "fields_penalty": torch.zeros(
                (batch_size, sampling_size), dtype=torch.float32, device=device
            ),
            "aux_grad": aux_grad.reshape(batch_size, sampling_size),
        }
