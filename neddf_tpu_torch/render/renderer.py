"""Volume renderer: stratified coarse + inverse-CDF fine.

Counterpart of ``neddf_tpu/render/renderer.py::render_rays:113-201``,
``build_occupancy``, ``render_rays_accel``, ``render_image`` and
``render_field_slice``. Per ray, the coarse pass takes ``sample_coarse +
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

Eval renders can skip empty space with an occupancy grid
(``ops/occupancy.py``, built by ``build_occupancy``): per sample
(``render_image(occupancy=grid)``: the field runs on each ray's first
``budget`` occupied samples, ``render_rays_accel``) or per ray
(``render_image(ray_cull=grid)``: only the rays that cross occupied
space are rendered).

``ndc=True`` (forward-facing captures; point samples only) warps the
rays into NDC (``geometry/camera.py::ndc_rays``, near plane at
``ndc_near``) and renders over t' in [0, 1]: ``dist_near``, ``dist_far``
and ``max_dist`` become 0, 1 and 1. The samples' directions stay the
unit world directions, so the view-dependent colour, and NeDDF's colour
tangent, see no warp. The occupancy grid is built over the world-space
cube, so ``build_occupancy``, ``render_rays_accel``, ``rays_active`` and
``render_image(occupancy=, ray_cull=)`` refuse ``ndc=True``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.geometry.camera import PinholeCalib, create_rays, ndc_rays
from neddf_tpu_torch.geometry.rays import (
    Rays,
    Sampling,
    get_sampling_cones,
    get_sampling_points,
)
from neddf_tpu_torch.ops.compositing import integrate_volume_render
from neddf_tpu_torch.ops.occupancy import (
    OccupancyGrid,
    coarsen_grid,
    lookup,
    make_grid,
    ray_active,
    select_samples,
    update_grid,
)
from neddf_tpu_torch.ops.sampling import sample_pdf, stratified_dists
from neddf_tpu_torch.utils.colormap import apply_jet

Tensor = torch.Tensor
Draws = Callable[[Tensor], Tuple[Tensor, Tensor]]
ChunkRender = Callable[[Tensor, Tensor, Tensor], Dict[str, Tensor]]

# fixed-FOV cone radius for view angle 0.6911 rad
_CONE_RAY_RADIUS = 1.0 / 1111.0 / math.sqrt(12.0)


def pack_active_rays(active: Tensor, chunk: int) -> Tensor:
    """The pixels a culled render renders, in its order, from the bool [N]
    ``active`` of a dense render in chunks of ``chunk``: every active ray
    lands as in the dense render, in a chunk of the dense render's size
    (a product's order of sums may change with its row count) and at a
    row of the same residue modulo ``gcd(chunk, 8)`` (torch's row
    reductions group a row's sums by its address modulo 16 or 32 bytes),
    so its result is bitwise the dense render's. The full chunks' active
    rays are packed that way, topped up with culled ones; the last,
    shorter chunk comes whole if it has an active ray. Reading the counts
    is the one host sync."""
    n = active.shape[0]
    n_full = n - n % chunk
    g = math.gcd(chunk, 8)
    by_row = active[:n_full].reshape(-1, g).T  # [g, n_full / g]: pixels i * g + c
    *counts, n_tail = torch.cat([by_row.sum(1), active[n_full:].sum()[None]]).tolist()
    width = min(-(-max(counts) * g // chunk) * chunk, n_full) // g
    order = torch.argsort((~by_row).to(torch.uint8), dim=1, stable=True)[:, :width]
    keep = (order * g + torch.arange(g, device=active.device)[:, None]).T.reshape(-1)
    if n_tail:
        keep = torch.cat([keep, torch.arange(n_full, n, device=active.device)])
    if not len(keep):  # nothing active: one chunk tells each target's channels
        keep = torch.arange(min(chunk, n), device=active.device)
    return keep


def tp_renderer(renderer: "NeRFRender", group: Any) -> "NeRFRender":
    """The JAX package's ``parallel/mesh.py::tp_renderer`` in place: every
    network of ``renderer``, the coarse and the fine one (a network shared
    by both passes stays one), runs its layers over the width shards of
    the model group ``group`` (the fields' per-layer route)."""
    nets = [renderer.network_fine]
    if renderer.use_coarse_network:
        nets.append(renderer.network_coarse)
    for net in nets:
        net.tp_group = group
    return renderer


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
        ndc: bool = False,
        ndc_near: float = 1.0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if sampling_type not in ("point", "cone"):
            raise ValueError(f"unknown sampling_type {sampling_type!r}")
        self.ndc = bool(ndc)
        self.ndc_near = float(ndc_near)
        if self.ndc:
            if sampling_type != "point":
                raise ValueError(
                    "render.ndc=true requires sampling_type='point' (cone frustum moments "
                    "are taken in world space and do not carry through the NDC warp)")
            dist_near, dist_far, max_dist = 0.0, 1.0, 1.0
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

    def _make_sampling(self, rays: Rays, dists: Tensor,
                       shade_dir: Optional[Tensor] = None) -> Sampling:
        if self.sampling_type == "point":
            sampling = get_sampling_points(rays, dists)
        else:
            sampling = get_sampling_cones(rays, dists, _CONE_RAY_RADIUS)
        if shade_dir is not None:
            # NDC: the positions are warped, the directions the fields see are not
            sampling = sampling._replace(
                sample_dir=shade_dir[:, None, :].expand(*dists.shape, 3))
        return sampling

    def refuse_ndc(self, what: str) -> None:
        """Raise where ``what`` would need a world-space grid under NDC."""
        if self.ndc:
            raise ValueError(f"{what} does not support ndc=true (the occupancy grid is built "
                             "over the world-space cube, not the NDC window)")

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
        shade_dir = None
        if self.ndc:
            shade_dir = rays.ray_dir  # unit world directions for the fields
            rays = ndc_rays(calib, self.ndc_near, rays)

        def one_pass(net: nn.Module, dists: Tensor) -> Dict[str, Tensor]:
            values = net(self._make_sampling(rays, dists, shade_dir), net.schedule(iteration),
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
    def build_occupancy(
        self,
        generator: Optional[torch.Generator] = None,
        resolution: int = 64,
        threshold: float = 0.01,
        n_updates: int = 4,
        cube_range: float = 1.1,
        jitters: Optional[Sequence[Tensor]] = None,
    ) -> OccupancyGrid:
        """An occupancy grid of the fine network (eval schedule):
        ``n_updates`` EMA-max updates, each on a lattice jittered by
        uniforms from ``generator`` (or by ``jitters[i]``, [R^3, 3])."""
        self.refuse_ndc("build_occupancy")
        net = self.network_fine
        device = next(net.parameters()).device
        if generator is None and jitters is None:
            generator = torch.Generator(device=device).manual_seed(0)
        grid = make_grid(resolution, cube_range, threshold, device)
        sched = net.schedule(-1)
        for i in range(n_updates):
            u = None if jitters is None else jitters[i]
            grid = update_grid(grid, net, sched, u=u, generator=generator)
        return grid

    def render_rays_accel(
        self,
        calib: PinholeCalib,
        pose_r: Tensor,
        pose_t: Tensor,
        uv: Tensor,
        u_strat: Tensor,
        u_pdf: Tensor,
        grid: OccupancyGrid,
        budget_coarse: int = 16,
        budget_fine: int = 64,
    ) -> Dict[str, Tensor]:
        """``render_rays`` at eval (iteration -1, ``need_aux=False``) with
        the field run on each ray's first ``budget`` occupied samples only.
        Each pass composites over its kept samples with each one's own
        dense interval (the gaps between kept samples are culled empty
        space; a kept last sample reuses the last dense interval). A kept
        sample's cone spans the gap to the next kept one, as in the JAX
        package (``renderer.py:300``). The fine pass draws its inverse CDF
        over the kept coarse samples."""
        self.refuse_ndc("render_rays_accel")
        rays = create_rays(calib, pose_r, pose_t, uv)

        def culled_pass(net: nn.Module, dists: Tensor, budget: int):
            pos = rays.ray_orig[:, None, :] + rays.ray_dir[:, None, :] * dists[..., None]
            sel_dists, sel_idx = select_samples(dists, lookup(grid, pos), budget)
            dense_deltas = dists[:, 1:] - dists[:, :-1]
            sel_deltas = torch.gather(
                dense_deltas, 1, torch.clamp(sel_idx[:, :-1], max=dense_deltas.shape[-1] - 1))
            values = net(self._make_sampling(rays, sel_dists), net.schedule(-1),
                         need_aux=False)
            out = integrate_volume_render(sel_dists, values["density"], values["color"],
                                          self.max_dist, deltas=sel_deltas)
            return out, sel_dists

        dists_coarse = stratified_dists(
            u_strat, self.sample_coarse, self.dist_near, self.dist_far
        )
        coarse, sel_coarse = culled_pass(self.coarse_network(), dists_coarse,
                                         min(budget_coarse, dists_coarse.shape[-1]))
        dists_fine = sample_pdf(sel_coarse, coarse["weight"], u_pdf)
        integrate, _ = culled_pass(self.network_fine, dists_fine,
                                   min(budget_fine, dists_fine.shape[-1]))
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
        occupancy: Optional[OccupancyGrid] = None,
        budget_coarse: int = 16,
        budget_fine: int = 64,
        ray_cull: Optional[OccupancyGrid] = None,
        ray_cull_factor: int = 4,
        ray_cull_probes: int = 128,
        render_fn: Optional[Callable[[ChunkRender], ChunkRender]] = None,
    ) -> Dict[str, np.ndarray]:
        """Chunked eval render of every ``downsampling``-th pixel.

        With ``occupancy`` the field runs on each ray's top-``budget``
        occupied samples (``render_rays_accel``). With ``ray_cull`` the
        rays are probed against ``coarsen_grid(ray_cull,
        ray_cull_factor)`` at ``ray_cull_probes`` points, only the active
        ones are rendered (re-packed into chunks of the dense render's
        shapes), and the culled pixels get the empty composite: colour 0,
        depth ``max_dist``, transmittance 1. The draws of every dense
        chunk are taken in the dense order all the same, so an active
        pixel gets the draws, and the result, it gets in the dense render
        of the same call, and the generator ends in the same state; the
        active-ray counts are the one host sync.
        ``render_fn`` wraps the per-chunk program ``render(uv, u_strat,
        u_pdf)`` (the dense or the re-packed chunks alike): the trainer
        passes ``parallel/mesh.py::make_sharded_render``'s, which splits
        each chunk over the ranks and all-gathers the tiles, as the JAX
        package's ``render_fn`` does (``neddf_tpu/render/renderer.py:404``).
        Returns numpy images ``[h, w, C]`` per requested target.
        """
        device = pose_r.device
        target_types = list(target_types)
        w, h = width // downsampling, height // downsampling
        us = np.tile(np.arange(w), h) * downsampling
        vs = np.repeat(np.arange(h), w) * downsampling
        uv_all = torch.as_tensor(np.stack([us, vs], axis=1), device=device)
        n = uv_all.shape[0]
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

        def render(uv: Tensor, u_strat: Tensor, u_pdf: Tensor) -> Dict[str, Tensor]:
            if occupancy is not None:
                out = self.render_rays_accel(calib, pose_r, pose_t, uv, u_strat, u_pdf,
                                             occupancy, budget_coarse, budget_fine)
            else:
                out = self.render_rays(calib, pose_r, pose_t, uv, u_strat, u_pdf)
            return {k: out[k] for k in target_types}

        if render_fn is not None:
            render = render_fn(render)

        # lazily: the dense render draws each chunk's uniforms just before it renders it
        dense = ((below, *draws(uv_all[below : below + chunk])) for below in range(0, n, chunk))
        keep = active = None
        if ray_cull is not None:
            grid = coarsen_grid(ray_cull, ray_cull_factor) if ray_cull_factor > 1 else ray_cull
            active = torch.cat([
                self.rays_active(grid, calib, pose_r, pose_t, uv_all[below : below + 65536],
                                 ray_cull_probes)
                for below in range(0, n, 65536)])
            keep = pack_active_rays(active, chunk)
            dense = list(dense)
            u_strat = torch.cat([d[1] for d in dense])[keep]
            u_pdf = torch.cat([d[2] for d in dense])[keep]
            uv_all = uv_all[keep]
            dense = [(below, u_strat[below : below + chunk], u_pdf[below : below + chunk])
                     for below in range(0, len(keep), chunk)]

        outs: Dict[str, list] = {k: [] for k in target_types}
        for below, u_strat, u_pdf in dense:
            result = render(uv_all[below : below + chunk], u_strat, u_pdf)
            for k in target_types:
                outs[k].append(result[k])
        flat = {k: torch.cat(outs[k]).reshape(uv_all.shape[0], -1) for k in target_types}
        if keep is not None:
            # culled rays (the rendered top-up ones too) get the empty composite
            background = {"depth": self.max_dist, "transmittance": 1.0}
            for k, v in flat.items():
                full = torch.zeros((n, v.shape[1]), dtype=v.dtype, device=device)
                full[keep] = v
                flat[k] = torch.where(active[:, None], full, background.get(k, 0.0))
        return {k: v.cpu().numpy().reshape(h, w, -1) for k, v in flat.items()}

    def rays_active(self, grid: OccupancyGrid, calib: PinholeCalib, pose_r: Tensor,
                    pose_t: Tensor, uv: Tensor, n_probe: int) -> Tensor:
        """bool [B]: whether the ray through each pixel ``uv`` crosses an
        occupied cell of ``grid`` on [dist_near, dist_far]."""
        self.refuse_ndc("ray culling (rays_active)")
        rays = create_rays(calib, pose_r, pose_t, uv)
        return ray_active(grid, rays.ray_orig, rays.ray_dir, self.dist_near, self.dist_far,
                          n_probe)

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
