"""Occupancy grids: per-sample and whole-ray culling of empty space.

Counterpart of ``neddf_tpu/ops/occupancy.py``:

* ``OccupancyGrid``: a dense [R, R, R] grid over the cube
  [-cube_range, cube_range]^3 (a tensor on the field's device), updated
  as an exponential moving max of the field's density on a jittered
  lattice (``update_grid``); a cell is occupied above ``threshold``;
* ``lookup``: nearest-cell occupancy flags of sample positions;
* ``select_samples``: each ray's first ``budget`` occupied samples (then
  its first empty ones), so the field runs on [B, K] instead of [B, S]
  (``render/renderer.py::render_rays_accel``);
* ``coarsen_grid`` / ``ray_active``: a pooled and dilated copy of the
  grid, probed along each ray, marks the rays that never cross occupied
  space (``render_image(ray_cull=...)`` skips them);
* ``scatter_outputs``: culled per-sample values back on the dense axis.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from neddf_tpu_torch.geometry.rays import Sampling

Tensor = torch.Tensor


class OccupancyGrid(NamedTuple):
    values: Tensor  # [R, R, R] f32: EMA of the max density per cell
    cube_range: float  # the grid spans [-cube_range, cube_range]^3
    threshold: float  # density above which a cell counts as occupied

    @property
    def resolution(self) -> int:
        return self.values.shape[0]


def make_grid(
    resolution: int = 64,
    cube_range: float = 1.1,
    threshold: float = 0.01,
    device: Optional[torch.device] = None,
) -> OccupancyGrid:
    """A fresh grid, every cell occupied (+inf) until its first update."""
    values = torch.full((resolution,) * 3, float("inf"), dtype=torch.float32, device=device)
    return OccupancyGrid(values, cube_range, threshold)


def _cell_ids(grid: OccupancyGrid, pos: Tensor) -> Tensor:
    """[..., 3] world positions -> [...] flat cell index (clamped)."""
    r = grid.resolution
    x = (pos + grid.cube_range) / (2.0 * grid.cube_range) * r
    ids = torch.clamp(torch.floor(x).to(torch.int64), 0, r - 1)
    return (ids[..., 0] * r + ids[..., 1]) * r + ids[..., 2]


def lookup(grid: OccupancyGrid, pos: Tensor) -> Tensor:
    """Occupancy flags (0/1 f32) of positions [..., 3]; 0 outside the cube."""
    occ = grid.values.reshape(-1)[_cell_ids(grid, pos)]
    inside = torch.all(torch.abs(pos) <= grid.cube_range, dim=-1)
    return torch.where(inside, (occ > grid.threshold).float(), 0.0)


def _lattice_centers(resolution: int, cube_range: float, device=None) -> Tensor:
    """[R^3, 3] cell centres, x slowest (the flat order of ``_cell_ids``)."""
    cell = 2.0 * cube_range / resolution
    line = (torch.arange(resolution, dtype=torch.float32, device=device) + 0.5) * cell
    line = line - cube_range
    xs, ys, zs = torch.meshgrid(line, line, line, indexing="ij")
    return torch.stack([xs, ys, zs], dim=-1).reshape(-1, 3)


@torch.no_grad()
def update_grid(
    grid: OccupancyGrid,
    field: torch.nn.Module,
    sched: object,
    u: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    decay: float = 0.95,
    chunk: int = 65536,
) -> OccupancyGrid:
    """EMA-max update of the grid from ``field``: every cell is probed at
    its centre plus a jitter ``(u - 0.5) * cell``, and
    ``new = max(decay * old, density)`` (the first update takes the
    density). ``u`` [R^3, 3] in [0, 1) is drawn from ``generator`` when
    not given. The field runs its training forward (``need_aux=True``),
    the route the JAX package's ``field.apply`` takes by default."""
    r = grid.resolution
    device = grid.values.device
    centers = _lattice_centers(r, grid.cube_range, device)
    if u is None:
        u = torch.rand(centers.shape, generator=generator, device=device)
    cell = 2.0 * grid.cube_range / r
    pos = centers + (u.to(device) - 0.5) * cell

    n = pos.shape[0]
    direction = torch.tensor([1.0, 0.0, 0.0], device=device).expand(n, 3)
    density = torch.empty(n, dtype=torch.float32, device=device)
    for below in range(0, n, chunk):
        p = pos[below : below + chunk][None]
        sampling = Sampling(p, direction[below : below + chunk][None], torch.zeros_like(p))
        density[below : below + chunk] = field(sampling, sched, need_aux=True)["density"][0]
    density = density.reshape(r, r, r)

    old = torch.where(torch.isinf(grid.values), density, grid.values)
    return OccupancyGrid(torch.maximum(decay * old, density), grid.cube_range, grid.threshold)


def select_samples(dists: Tensor, occ: Tensor, budget: int) -> Tuple[Tensor, Tensor]:
    """Each ray's first ``budget`` occupied samples, then its first empty
    ones: (sel_dists [B, K] ascending, sel_idx [B, K] into the S axis).
    The key ``order + (1 - occ) * S`` has no ties, so the kept set is
    unique."""
    s = dists.shape[-1]
    order = torch.arange(s, dtype=torch.float32, device=dists.device)[None, :]
    key = order + (1.0 - occ) * s
    sel_idx = torch.topk(key, budget, dim=-1, largest=False, sorted=False).indices
    sel_idx = torch.sort(sel_idx, dim=-1).values
    return torch.gather(dists, -1, sel_idx), sel_idx


def coarsen_grid(grid: OccupancyGrid, factor: int = 4, dilate: int = 1) -> OccupancyGrid:
    """A conservative low-resolution grid for whole-ray culling: the max
    of the binary occupancy over ``factor``^3 blocks, dilated ``dilate``
    times by a 3^3 max filter, as 0/1 flags with threshold 0.5. A coarse
    cell is occupied iff a fine cell in or next to its block is."""
    r = grid.resolution
    assert r % factor == 0, (r, factor)
    c = r // factor
    occ = (grid.values > grid.threshold).float()
    occ = occ.reshape(c, factor, c, factor, c, factor).amax(dim=(1, 3, 5))
    for _ in range(dilate):
        # -inf padding: the edge copies of an edge-padded max lie in the window already
        occ = F.max_pool3d(occ[None, None], 3, stride=1, padding=1)[0, 0]
    return OccupancyGrid(occ, grid.cube_range, 0.5)


def _linspace(start: float, stop: float, num: int, device=None) -> Tensor:
    """f32 ``jnp.linspace``: ``start * (1 - s) + stop * s`` for s = i / (num-1),
    the last point ``stop`` itself."""
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def ray_active(
    grid: OccupancyGrid,
    ray_orig: Tensor,
    ray_dir: Tensor,
    dist_near: float,
    dist_far: float,
    n_probe: int,
) -> Tensor:
    """bool [B]: does the ray cross an occupied cell at one of ``n_probe``
    evenly spaced points on [near, far]? Pair with ``coarsen_grid``, so
    that the probe step stays below the dilated cell size."""
    ts = _linspace(dist_near, dist_far, n_probe, ray_orig.device)
    pos = ray_orig[:, None, :] + ray_dir[:, None, :] * ts[None, :, None]
    return torch.amax(lookup(grid, pos), dim=-1) > 0.5


def scatter_outputs(values: Tensor, sel_idx: Tensor, s: int, fill: float = 0.0) -> Tensor:
    """Per-selected-sample values [B, K(, C)] back to [B, S(, C)]; the
    culled slots get ``fill``."""
    b = sel_idx.shape[0]
    out = torch.full((b, s) + tuple(values.shape[2:]), fill, dtype=values.dtype,
                     device=values.device)
    out[torch.arange(b, device=values.device)[:, None], sel_idx] = values
    return out
