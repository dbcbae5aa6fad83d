"""Volume renderer: stratified coarse + inverse-CDF fine.

Counterpart of ``neddf_tpu/render/renderer.py::render_rays:113-201``,
``render_image`` and ``render_field_slice`` (without NDC, occupancy
culling or ray culling). Per ray, the coarse pass takes ``sample_coarse +
1`` stratified distances, the fine pass ``sample_fine + 1`` inverse-CDF
draws sorted together with the coarse distances. Samples are points
(``sampling_type="point"``, zero variance) or cone frustums (``"cone"``,
radius 1/1111/sqrt(12)). ``use_coarse_network=True`` gives the coarse
pass a network of its own (``network_coarse``, the NeRF configs);
otherwise the fine network serves both passes (the NeDDF and NeuS
configs). Every field output whose key contains ``penalty`` is
integrated over the interval lengths (``:171-175``). As in the JAX
package (``:168-192``) the fine distances and both passes' interval
lengths carry no gradient: no gradient flows from the fine pass back
through the inverse CDF into the coarse weights.

The uniform draws come from a ``torch.Generator`` unless the caller
passes ``draws(uv) -> (u_strat, u_pdf)``, which the parity tests use to
feed the JAX package's per-pixel draws.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.geometry.camera import PinholeCalib, create_rays
from neddf_tpu_torch.geometry.rays import (
    Rays,
    Sampling,
    get_sampling_cones,
    get_sampling_points,
)
from neddf_tpu_torch.ops.compositing import integrate_volume_render
from neddf_tpu_torch.ops.sampling import sample_pdf, stratified_dists
from neddf_tpu_torch.utils.colormap import apply_jet

Tensor = torch.Tensor
Draws = Callable[[Tensor], Tuple[Tensor, Tensor]]

# fixed-FOV cone radius for view angle 0.6911 rad
_CONE_RAY_RADIUS = 1.0 / 1111.0 / math.sqrt(12.0)


class NeRFRender(nn.Module):
    def __init__(
        self,
        network_config: Dict[str, Any],
        sample_coarse: int = 128,
        sample_fine: int = 128,
        dist_near: float = 2.0,
        dist_far: float = 6.0,
        max_dist: float = 6.0,
        use_coarse_network: bool = True,
        sampling_type: str = "point",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if sampling_type not in ("point", "cone"):
            raise ValueError(f"unknown sampling_type {sampling_type!r}")
        self.network_fine = config_lib.instantiate(network_config, generator=generator)
        self.use_coarse_network = bool(use_coarse_network)
        if self.use_coarse_network:
            self.network_coarse = config_lib.instantiate(network_config, generator=generator)
        self.sampling_type = sampling_type
        self.sample_coarse = sample_coarse
        self.sample_fine = sample_fine
        self.dist_near = dist_near
        self.dist_far = dist_far
        self.max_dist = max_dist

    def coarse_network(self) -> nn.Module:
        """The coarse pass's network: its own, or the fine one."""
        return self.network_coarse if self.use_coarse_network else self.network_fine

    def _make_sampling(self, rays: Rays, dists: Tensor) -> Sampling:
        if self.sampling_type == "point":
            return get_sampling_points(rays, dists)
        return get_sampling_cones(rays, dists, _CONE_RAY_RADIUS)

    def render_rays(
        self,
        calib: PinholeCalib,
        pose_r: Tensor,
        pose_t: Tensor,
        uv: Tensor,
        u_strat: Tensor,
        u_pdf: Tensor,
        iteration: int = -1,
        need_aux: bool = False,
    ) -> Dict[str, Tensor]:
        """Render rays through pixels ``uv [B, 2]``.

        ``u_strat [B, sample_coarse+1]`` jitters the coarse distances and
        ``u_pdf [B, sample_fine+1]`` drives the inverse CDF. Returns the
        fine pass's integrals plus ``*_coarse`` copies of the coarse ones.
        """
        rays = create_rays(calib, pose_r, pose_t, uv)

        def one_pass(net: nn.Module, dists: Tensor) -> Dict[str, Tensor]:
            values = net(self._make_sampling(rays, dists), net.schedule(iteration),
                         need_aux=need_aux)
            out = integrate_volume_render(
                dists, values["density"], values["color"], self.max_dist
            )
            delta = (dists[:, 1:] - dists[:, :-1]).detach()
            for k, v in values.items():
                if "penalty" in k:
                    out[k] = torch.sum(delta * v.reshape(uv.shape[0], -1)[:, :-1], dim=1)
            return out

        dists_coarse = stratified_dists(
            u_strat, self.sample_coarse, self.dist_near, self.dist_far
        )
        coarse = one_pass(self.coarse_network(), dists_coarse)
        # no gradient through the inverse CDF (stop_gradient in the JAX renderer)
        integrate = one_pass(self.network_fine, sample_pdf(
            dists_coarse.detach(), coarse["weight"].detach(), u_pdf))
        for k, v in coarse.items():
            integrate[f"{k}_coarse"] = v
        return integrate

    @torch.no_grad()
    def render_image(
        self,
        calib: PinholeCalib,
        pose_r: Tensor,
        pose_t: Tensor,
        width: int,
        height: int,
        target_types: Iterable[str] = ("color", "depth"),
        downsampling: int = 1,
        chunk: int = 512,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Draws] = None,
    ) -> Dict[str, np.ndarray]:
        """Chunked eval render of every ``downsampling``-th pixel.

        Returns numpy images ``[h, w, C]`` per requested target.
        """
        device = pose_r.device
        target_types = list(target_types)
        w, h = width // downsampling, height // downsampling
        us = np.tile(np.arange(w), h) * downsampling
        vs = np.repeat(np.arange(h), w) * downsampling
        uv_all = torch.as_tensor(np.stack([us, vs], axis=1), device=device)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)

            def draws(uv: Tensor) -> Tuple[Tensor, Tensor]:
                n = uv.shape[0]
                return (
                    torch.rand((n, self.sample_coarse + 1), generator=generator,
                               device=device),
                    torch.rand((n, self.sample_fine + 1), generator=generator,
                               device=device),
                )

        outs: Dict[str, list] = {k: [] for k in target_types}
        for below in range(0, uv_all.shape[0], chunk):
            uv = uv_all[below : below + chunk]
            u_strat, u_pdf = draws(uv)
            result = self.render_rays(calib, pose_r, pose_t, uv, u_strat, u_pdf)
            for k in target_types:
                outs[k].append(result[k])
        return {
            k: torch.cat(outs[k]).cpu().numpy().reshape(h, w, -1) for k in target_types
        }

    @torch.no_grad()
    def render_field_slice(
        self,
        slice_t: float = 0.0,
        render_size: float = 1.1,
        render_resolution: int = 128,
    ) -> Dict[str, np.ndarray]:
        """XY slice images of the fine field at z = ``slice_t`` (eval
        schedule): per-field scales, a mid-gray offset for the signed
        ``sdf``, JET for one-channel fields
        (``neddf_tpu/render/renderer.py::render_field_slice:514-560``).
        Returns uint8 BGR images [res, res, 3] by field name."""
        device = next(self.network_fine.parameters()).device
        res = render_resolution
        line = np.linspace(-render_size, render_size, res, dtype=np.float32)
        pos = np.stack([np.broadcast_to(line[None, :], (res, res)),
                        np.broadcast_to(-line[:, None], (res, res)),
                        np.full((res, res), slice_t, np.float32)], axis=2)
        direction = np.zeros((res, res, 3), np.float32)
        direction[:, :, 2] = 1.0
        sampling = Sampling(
            torch.as_tensor(pos, device=device), torch.as_tensor(direction, device=device),
            torch.zeros((res, res, 3), dtype=torch.float32, device=device),
        )
        net = self.network_fine
        values = net(sampling, net.schedule(-1), need_aux=False)
        scales = {"distance": 256.0, "density": 12.8, "color": 256.0, "aux_grad": 256.0}
        offsets = {"sdf": (128.0, 128.0)}  # signed: around mid-gray
        fields: Dict[str, np.ndarray] = {}
        for name, value in values.items():
            if name not in scales and name not in offsets:
                continue
            off, scale = offsets.get(name, (0.0, scales.get(name)))
            img = off + scale * value.float().cpu().numpy().reshape(res, res, -1)
            img = img.clip(0, 255).astype(np.uint8)
            fields[name] = apply_jet(img[:, :, 0]) if img.shape[2] == 1 else img
        return fields
