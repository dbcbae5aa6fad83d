"""NeDDF field: distance trunk with spatial Jacobian, density from the
distance gradient, colour trunk; the eval path and the training path.

Counterpart of ``neddf_tpu/fields/neddf.py``.

Per sample, both paths:

* the DDF trunk runs on the PE-with-Jacobian of the position, scaled by
  grad_scale * lowpass * mip weights, as K=3 tangent planes
  (``kernels/dual_mlp.py``); layer s+1 consumes ``[embed, h]`` for each
  skip s;
* D = softplus(h_d) + d_near and its gradient, aux = s * sigmoid(h_a),
  density = relu((1/D) * (1 - sqrt(|grad D|^2 + aux^2))), and the normal
  grad D / (|grad D| + 1e-7).

Eval (``need_aux=False``, ``:596-655``): the heads run in f32 here and the
colour trunk runs value-only on ``[PE_mip(pos) * lowpass, PE(dir),
normal, trunk features]`` (``kernels/mlp.py``), then the colour head;
``fields_penalty`` is zeros.

Training (``need_aux=True``, the JAX package's fused-epilogue path
``_apply_fused_epilogue:397-486``): the trunk and ``kernels/
neddf_epilogue.py`` (heads, density, the four trunk penalties and the
colour tangent seed t_feat) in one autograd op (``DDFTrunkEpilogue``),
then the colour trunk as a K=1 dual MLP on
``[PE dual(pos) along sg(grad D), PE(dir), sg(normal), features]`` with
``has_j=(T, F, F, T)`` (``_directional_color:356-395``), the colour head
on value and tangent, and the range_color / constraints_color
penalties. Every stage is an autograd op with a hand-written backward;
the weights stay attached to autograd on this path.

Penalty weights: ``penalty_weight=None`` means the JAX package's
defaults (``_DEFAULT_PENALTY_WEIGHT``); a penalty missing from a given
map enters the sum unweighted (the reference's quirk, ``:743-745``).

``compute_dtype`` sets the trunks' operand and storage dtype (bf16 in
the shipped configs); heads, density and penalties run in f32. ``fused``
selects the trunk implementation: ``auto`` runs the CUDA kernels on CUDA
tensors and their plain versions on CPU tensors, ``on`` requires CUDA
tensors, ``off`` always runs the plain versions.
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
from neddf_tpu_torch.kernels.dual_mlp import (
    dual_mlp_apply,
    dual_mlp_trunk,
    dual_mlp_trunk_plain,
)
from neddf_tpu_torch.kernels.mlp import mlp_seg, mlp_seg_plain
from neddf_tpu_torch.kernels.neddf_epilogue import DDFTrunkEpilogue
from neddf_tpu_torch.ops.activations import (
    ACTIVATIONS,
    relu,
    sigmoid,
    softplus,
    softplus_deriv,
)
from neddf_tpu_torch.ops.dual import pe_dual_directional_mip, pe_dual_planes_mip
from neddf_tpu_torch.ops.pe import (
    pe_grad_scale,
    pe_lowpass_scale,
    positional_encoding_mip,
)

Tensor = torch.Tensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# neddf_tpu/fields/neddf.py::_DEFAULT_PENALTY_WEIGHT (penalty_weight=None)
_DEFAULT_PENALTY_WEIGHT = {
    "constraints_aux_grad": 0.05,
    "constraints_dDdt": 0.05,
    "constraints_color": 0.01,
    "range_distance": 1.0,
    "range_aux_grad": 1.0,
}


class NeDDF(nn.Module):
    # the reference's .pth layout (LinearGradLayer: weight [in, out])
    pth_linear_transposed = False
    pth_name = staticmethod(reference_name)

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
        fused = check_fused(fused)
        self.embed_pos_rank = embed_pos_rank
        self.embed_dir_rank = embed_dir_rank
        self.activation_type = activation_type
        self.density_activation_type = density_activation_type
        self.d_near = d_near
        self.lowpass_alpha_offset = lowpass_alpha_offset
        self.lowpass_alpha_rate = lowpass_alpha_rate
        self.skips = tuple(skips)
        self.penalty_weight = dict(
            _DEFAULT_PENALTY_WEIGHT if penalty_weight is None else penalty_weight
        )
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
        return use_kernels(self.fused, device, "NeDDF")

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
        (``color`` [B, S, 3]). ``need_aux=True`` is the training path;
        without it ``fields_penalty`` is zeros."""
        if need_aux:
            return self._forward_train(sampling, sched)
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

    def _forward_train(self, sampling: Sampling, sched: Schedule) -> Dict[str, Tensor]:
        """Training path (``_apply_fused_epilogue`` + ``_directional_color``)."""
        if self.density_activation_type != "ReLU":
            raise NotImplementedError("the epilogue computes a ReLU density")
        batch_size, sampling_size = sampling.sample_pos.shape[:2]
        act = self.activation_type
        cd = self.compute_dtype
        pos = sampling.sample_pos.reshape(-1, 3)
        direction = sampling.sample_dir.reshape(-1, 3)
        var = sampling.diag_variance.reshape(-1, 3)
        device = pos.device
        use_kernels = self._use_kernels(device)
        rank = self.embed_pos_rank
        wm = self.penalty_weight

        lowpass = pe_lowpass_scale(rank, sched.lowpass_alpha, device)
        emb_v, emb_j = pe_dual_planes_mip(
            pos, rank, var=var, chan_scale=pe_grad_scale(rank, device) * lowpass
        )
        b2 = torch.cat([self.layer_ddf_out.b, self.layer_aux_out.b])
        scal = torch.tensor(
            [self.d_near, sched.aux_grad_scale, sched.distance_range_max,
             wm.get("constraints_aux_grad", 1.0), wm.get("constraints_dDdt", 1.0),
             wm.get("range_distance", 1.0), wm.get("range_aux_grad", 1.0), 0.0],
            dtype=torch.float32, device=device,
        )
        # the trunk and the epilogue in one op: its backward finishes the
        # trunk's top layer in the epilogue's kernel
        v_feat, out, t_feat = DDFTrunkEpilogue.apply(
            (self.trunk_layout, act, cd, use_kernels),
            emb_v.to(cd).contiguous(), emb_j.to(cd).contiguous(),
            self.layer_ddf_out.w[:, 0], self.layer_aux_out.w[:, 0], b2, scal,
            *[layer.w for layer in self.layers_ddf], *[layer.b for layer in self.layers_ddf],
        )
        density, distance, aux_grad, pen4 = out[0], out[1], out[2], out[9]
        norm_dir = out[3:6].T.detach()  # [M, 3]
        t_dir = out[6:9].T.detach()  # [M, 3], the tangent direction sg(grad D)

        # ---- K=1 directional colour branch
        embed_dir = positional_encoding_mip(direction, self.embed_dir_rank)
        ep_v, ep_t = pe_dual_directional_mip(pos, rank, t_dir, var=var, chan_scale=lowpass)
        hc_v, hc_t = dual_mlp_apply(
            [ep_v.to(cd).contiguous(), embed_dir.to(cd).contiguous(),
             norm_dir.to(cd).contiguous(), v_feat],
            [ep_t.to(cd)[None].contiguous(), t_feat[None]],
            [layer.w for layer in self.layers_col], [layer.b for layer in self.layers_col],
            (False,) * len(self.layers_col), act, (True, False, False, True), 1, cd,
            use_kernels,
        )
        w_co = self.layer_col_out.w.to(cd).float()
        b_co = self.layer_col_out.b.to(cd).float()
        color = hc_v.float() @ w_co + b_co  # [M, 3]
        color_t = hc_t[0].float() @ w_co  # [M, 3], the directional derivative

        p_range_color = torch.sum(torch.square(relu(-color) + relu(color - 1.0)), dim=1)
        p_constraints_color = torch.sum(torch.square(color_t), dim=1)
        fields_penalty = (
            pen4
            + wm.get("range_color", 1.0) * p_range_color
            + wm.get("constraints_color", 1.0) * p_constraints_color
        )
        shape = (batch_size, sampling_size)
        return {
            "distance": distance.reshape(shape),
            "density": density.reshape(shape),
            "color": color.reshape(*shape, 3),
            "fields_penalty": fields_penalty.reshape(shape),
            "aux_grad": aux_grad.reshape(shape),
        }
