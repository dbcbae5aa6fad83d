"""NeuS: an SDF trunk with its spatial gradient, a colour trunk, and the
logistic density.

Counterpart of ``neddf_tpu/fields/neus.py`` on its sweep route
(``normals="sweep"``, ``_trunk_sweep:114``), in f32:

* the SDF trunk runs on ``e = PE(pos)`` (rank 6, no lowpass, no mip
  weights) through ``sdf_layer_count`` dense layers, layer ``li``
  consuming ``[h, e]`` when ``li - 1`` is a skip; the same pass gives
  ``gE = d h[:, 0] / d e`` by an explicit reverse sweep, and
  ``ops/sdf_grad.py::pe_chain_to_pos`` chains it to the positions: the
  normals. This is ``kernels/sdf_mlp.py``'s ``sdf_mlp`` with its
  hand-written second-order backward, so the loss differentiates through
  the normals: the CUDA kernels on CUDA tensors, their plain versions on
  CPU tensors or with ``fused="off"``;
* ``sdf`` is channel 0 of the ACTIVATED trunk features;
* the colour trunk is ``kernels/mlp.py``'s ``mlp_seg`` on the segments
  ``[pos, PE(dir), grad sdf, features]`` (3/24/3/256), ``col_layer_count``
  layers of ``col_layer_width`` and a last one of 3, the activation after
  every layer, the last included;
* density = 10 s e / (1 + e)^2 with e = exp(-10 s sdf) and the trainable
  scalar s (``variance``).

``normals`` ``auto``, ``sweep`` and ``reverse`` all take the sweep: it is
the reverse-mode gradient written out, equal to it in exact arithmetic;
``dual`` (forward mode, measured slower on the TPU) is not ported.
NeuS has no warmups: ``schedule`` returns the JAX package's defaults.
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
from neddf_tpu_torch.kernels.sdf_mlp import sdf_apply, sdf_mlp
from neddf_tpu_torch.ops.pe import positional_encoding_mip
from neddf_tpu_torch.ops.sdf_grad import pe_chain_to_pos, sdf_trunk_with_grad

Tensor = torch.Tensor


class NeuS(nn.Module):
    # the reference's .pth layout (nn.Linear: weight [out, in])
    pth_linear_transposed = True
    pth_name = staticmethod(reference_name)

    def __init__(
        self,
        embed_pos_rank: int = 6,
        embed_dir_rank: int = 4,
        sdf_layer_count: int = 8,
        sdf_layer_width: int = 256,
        col_layer_count: int = 8,
        col_layer_width: int = 256,
        activation_type: str = "ReLU",
        init_variance: float = 0.3,
        skips: Sequence[int] = (4,),
        fused: "str | bool" = "auto",
        normals: str = "auto",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if normals == "dual":
            raise NotImplementedError("NeuS normals='dual' (forward mode) is not ported")
        if normals not in ("auto", "sweep", "reverse"):
            raise ValueError(f"unknown normals mode {normals!r}")
        self.embed_pos_rank = embed_pos_rank
        self.embed_dir_rank = embed_dir_rank
        self.activation_type = activation_type
        self.skips = tuple(skips)
        self.fused = check_fused(fused)

        pe_dim, w, cw = embed_pos_rank * 6, sdf_layer_width, col_layer_width
        init = dict(generator=generator, init="torch_default")
        sdf = [Linear(pe_dim, w, **init)]
        for layer_id in range(sdf_layer_count - 1):
            sdf.append(Linear(w + pe_dim if layer_id in self.skips else w, w, **init))
        col = [Linear(6 + embed_dir_rank * 6 + w, cw, **init)]
        for _ in range(col_layer_count - 1):
            col.append(Linear(cw, cw, **init))
        col.append(Linear(cw, 3, **init))
        self.layers_sdf = nn.ModuleList(sdf)
        self.layers_col = nn.ModuleList(col)
        self.variance = nn.Parameter(torch.tensor(float(init_variance)))
        # layer li consumes [h, e] when a skip follows layer li-1
        self.sdf_layout = tuple((li - 1) in self.skips for li in range(len(sdf)))

    def schedule(self, iteration: int) -> Schedule:
        """No warmups (``neddf_tpu/fields/base.py::BaseField.schedule``)."""
        del iteration
        return Schedule(1e9, 1.0, 2.0)

    def forward(
        self, sampling: Sampling, sched: Schedule, *, need_aux: bool = False
    ) -> Dict[str, Tensor]:
        """The JAX package's ``NeuS.apply``: ``sdf`` and ``density`` [B, S]
        and ``color`` [B, S, 3] (``sched`` and ``need_aux`` change
        nothing)."""
        del sched, need_aux
        batch_size, sampling_size = sampling.sample_pos.shape[:2]
        act = self.activation_type
        pos = sampling.sample_pos.reshape(-1, 3).float()
        direction = sampling.sample_dir.reshape(-1, 3)
        kernels = use_kernels(self.fused, pos.device, "NeuS")

        e = positional_encoding_mip(pos, self.embed_pos_rank).contiguous()
        ws = [layer.w for layer in self.layers_sdf]
        bs = [layer.b for layer in self.layers_sdf]
        grad = torch.is_grad_enabled()
        if grad:
            feature, g_e = sdf_apply(e, ws, bs, self.sdf_layout, act, kernels)
        else:
            trunk = sdf_mlp if kernels else sdf_trunk_with_grad
            feature, g_e = trunk(e, [w.contiguous() for w in ws], [b.contiguous() for b in bs],
                                 self.sdf_layout, act)
        gradients = pe_chain_to_pos(g_e, pos, self.embed_pos_rank)
        sdf = feature[:, :1]

        embed_dir = positional_encoding_mip(direction, self.embed_dir_rank)
        segs = [pos.contiguous(), embed_dir.contiguous(), gradients.contiguous(), feature]
        cws = [layer.w for layer in self.layers_col]
        cbs = [layer.b for layer in self.layers_col]
        layout = (False,) * len(cws)
        if grad:
            color = mlp_apply(segs, cws, cbs, layout, act, torch.float32, kernels)
        else:
            col_mlp = mlp_seg if kernels else mlp_seg_plain
            color = col_mlp(segs, [w.contiguous() for w in cws], [b.contiguous() for b in cbs],
                            layout, act)

        s10 = self.variance * 10.0
        ex = torch.exp(-s10 * sdf)
        density = s10 * ex / torch.square(1.0 + ex)
        shape = (batch_size, sampling_size)
        return {
            "sdf": sdf.reshape(shape),
            "density": density.reshape(shape),
            "color": color.reshape(*shape, 3),
        }
