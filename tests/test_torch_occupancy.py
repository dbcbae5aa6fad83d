"""The port's occupancy grids and culled renders against the JAX package
on the CPU (``neddf_tpu/ops/occupancy.py``, ``render/renderer.py::
build_occupancy``, ``render_rays_accel`` and ``render_image``'s
``occupancy=`` / ``ray_cull=``): same weights (``params_from_jax``), the
JAX package's own jitter and per-pixel draws fed to the port.

Tolerances: ``lookup``, ``select_samples``, ``coarsen_grid``,
``ray_active`` and ``scatter_outputs`` are exact; the grid's densities
and the culled renders are f32 sums in another order, within 1e-5.
``render_image(ray_cull=...)`` is held against the port's own dense
render of the same call: its active pixels bitwise, its culled pixels
exactly the empty composite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu.geometry.camera import PinholeCalib as JCalib
from neddf_tpu.ops import occupancy as jocc
from neddf_tpu.ops.sampling import _per_ray_uniform
from neddf_tpu.render.renderer import NeRFRender as JRender
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.ops import occupancy as occ
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.training.checkpoint import params_from_jax
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NETWORK = {
    "_target_": "neddf_tpu.fields.NeDDF",
    "embed_pos_rank": 4, "embed_dir_rank": 2,
    "ddf_layer_count": 4, "ddf_layer_width": 16,
    "col_layer_count": 3, "col_layer_width": 16,
    "skips": (1,), "d_near": 0.001, "compute_dtype": "float32",
}
TOL = 1e-5


def _grid_pair(values: np.ndarray, cube_range=1.1, threshold=0.5):
    return (jocc.OccupancyGrid(jnp.asarray(values), cube_range, threshold),
            occ.OccupancyGrid(torch.from_numpy(values), cube_range, threshold))


def _sphere_values(resolution=32, radius=0.5, cube_range=1.1):
    line = (np.arange(resolution) + 0.5) / resolution * 2 * cube_range - cube_range
    xs, ys, zs = np.meshgrid(line, line, line, indexing="ij")
    return ((xs**2 + ys**2 + zs**2) < radius**2).astype(np.float32)


def test_lookup_matches_jax_exactly():
    rng = np.random.default_rng(0)
    values = rng.uniform(0.0, 1.0, size=(16, 16, 16)).astype(np.float32)
    jgrid, grid = _grid_pair(values, threshold=0.6)
    # positions inside, outside and on the cube's faces and cell walls
    pos = rng.uniform(-1.4, 1.4, size=(64, 33, 3)).astype(np.float32)
    pos[:, :4] = np.float32(1.1) * np.sign(pos[:, :4])
    pos[:, 4:8] = np.round(pos[:, 4:8] * 16 / 2.2) * np.float32(2.2 / 16)
    got = occ.lookup(grid, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jocc.lookup(jgrid, jnp.asarray(pos))))
    assert 0 < got.sum() < got.size
    fresh = occ.make_grid(8, 1.1, 0.01)
    assert bool(torch.all(occ.lookup(fresh, torch.zeros(2, 5, 3)) == 1.0))


@pytest.mark.parametrize("budget", [1, 5, 12, 24])
def test_select_samples_matches_jax_exactly(budget):
    rng = np.random.default_rng(budget)
    dists = np.sort(rng.uniform(2.0, 6.0, size=(40, 24)), axis=1).astype(np.float32)
    flags = (rng.uniform(size=(40, 24)) < 0.3).astype(np.float32)
    flags[0] = 0.0  # a ray with no occupied sample
    flags[1] = 1.0  # and one with all of them occupied
    jd, ji = jocc.select_samples(jnp.asarray(dists), jnp.asarray(flags), budget)
    d, i = occ.select_samples(torch.from_numpy(dists), torch.from_numpy(flags), budget)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("factor,dilate", [(4, 0), (4, 1), (2, 2), (1, 1)])
def test_coarsen_grid_matches_jax_exactly(factor, dilate):
    rng = np.random.default_rng(factor * 10 + dilate)
    values = np.where(rng.uniform(size=(16, 16, 16)) < 0.01, 1.0, 0.0).astype(np.float32)
    values[5, 9, 2] = values[0, 15, 0] = 1.0  # a block on the cube's edge
    jgrid, grid = _grid_pair(values)
    want = jocc.coarsen_grid(jgrid, factor, dilate)
    got = occ.coarsen_grid(grid, factor, dilate)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert (got.resolution, got.threshold) == (want.resolution, want.threshold)
    with pytest.raises(AssertionError):
        occ.coarsen_grid(grid, 3)


def test_ray_active_matches_jax_exactly():
    rng = np.random.default_rng(1)
    values = _sphere_values(32, 0.4)
    jgrid, grid = _grid_pair(values)
    jcoarse, coarse = jocc.coarsen_grid(jgrid, 4), occ.coarsen_grid(grid, 4)
    orig = rng.normal(size=(256, 3)).astype(np.float32)
    orig = 4.0 * orig / np.linalg.norm(orig, axis=1, keepdims=True)
    target = rng.uniform(-1.6, 1.6, size=(256, 3)).astype(np.float32)
    dirs = target - orig
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    for jg, g in ((jgrid, grid), (jcoarse, coarse)):
        for n_probe in (64, 128):
            want = np.asarray(jocc.ray_active(jg, jnp.asarray(orig), jnp.asarray(dirs),
                                              2.0, 6.0, n_probe))
            got = occ.ray_active(g, torch.from_numpy(orig), torch.from_numpy(dirs),
                                 2.0, 6.0, n_probe).numpy()
            np.testing.assert_array_equal(got, want)
            assert 0 < got.sum() < got.size


def test_scatter_outputs_matches_jax_exactly():
    rng = np.random.default_rng(2)
    idx = np.sort(np.stack([rng.permutation(9)[:4] for _ in range(6)]), axis=1)
    for shape in ((6, 4), (6, 4, 3)):
        vals = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(jocc.scatter_outputs(jnp.asarray(vals), jnp.asarray(idx), 9, 0.5))
        got = occ.scatter_outputs(torch.from_numpy(vals), torch.from_numpy(idx), 9, 0.5)
        np.testing.assert_array_equal(got.numpy(), want)


def _renderers(sampling_type="point", seed=0):
    cfg = dict(network_config=dict(NETWORK), sample_coarse=8, sample_fine=16,
               use_coarse_network=False, sampling_type=sampling_type)
    jrender = JRender(**cfg)
    params = jrender.init(jax.random.PRNGKey(seed))
    render = NeRFRender(**cfg)
    render.load_state_dict(params_from_jax(params), strict=True)
    return jrender, params, render


def test_update_grid_matches_jax_with_its_jitter():
    jrender, params, render = _renderers()
    jfield, field = jrender.network_fine, render.network_fine
    jsched, sched = jfield.schedule(-1), field.schedule(-1)
    jgrid, grid = jocc.make_grid(8, 1.1, 1e-6), occ.make_grid(8, 1.1, 1e-6)
    for seed, decay in ((1, 0.95), (2, 0.5)):
        key = jax.random.PRNGKey(seed)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (8**3, 3))))
        jgrid = jax.jit(lambda g, p, k, d=decay: jocc.update_grid(g, jfield, p, jsched, k, d))(
            jgrid, params["network_fine"], key)
        grid = occ.update_grid(grid, field, sched, u=u, decay=decay, chunk=200)  # ragged chunks
        want = np.asarray(jgrid.values)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(grid.values.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())


def test_build_occupancy_matches_jax():
    jrender, params, render = _renderers(seed=3)
    key = jax.random.PRNGKey(7)
    want = jrender.build_occupancy(params, key, resolution=8, threshold=0.05)
    jitters, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        jitters.append(torch.from_numpy(np.array(jax.random.uniform(sub, (8**3, 3)))))
    got = render.build_occupancy(resolution=8, threshold=0.05, jitters=jitters)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(want.values)).max())
    assert got.threshold == 0.05 and got.cube_range == 1.1
    # the generator's draws give a grid of the same law
    torch_grid = render.build_occupancy(torch.Generator().manual_seed(0), resolution=8)
    assert torch.isfinite(torch_grid.values).all()


def _jax_draws(key, n_coarse, n_fine):
    k_strat, k_pdf = jax.random.split(key)

    def draws(uv):
        pids = jnp.asarray(uv[:, 0].numpy() * 65536 + uv[:, 1].numpy())
        return (torch.from_numpy(np.array(_per_ray_uniform(k_strat, pids, n_coarse))),
                torch.from_numpy(np.array(_per_ray_uniform(k_pdf, pids, n_fine))))

    return draws


def _camera():
    calib = np.array([300.0, 300.0, 128.0, 112.0], np.float32)
    return calib, np.eye(3, dtype=np.float32), np.array([0.0, 0.0, 4.0], np.float32)


def _uv(n=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 2)).astype(np.int32)


def _accel_pair(jrender, params, render, grid_values, cube_range, threshold, budgets, uv,
                key):
    calib, r, t = _camera()
    jgrid = jocc.OccupancyGrid(jnp.asarray(grid_values), cube_range, threshold)
    grid = occ.OccupancyGrid(torch.from_numpy(grid_values), cube_range, threshold)
    accel = jax.jit(jrender.render_rays_accel, static_argnums=(7, 8))
    want = accel(params, JCalib(jnp.asarray(calib)), jnp.asarray(r), jnp.asarray(t),
                 jnp.asarray(uv), key, jgrid, *budgets)
    u_strat, u_pdf = _jax_draws(key, 9, 17)(torch.from_numpy(uv))
    with torch.no_grad():
        got = render.render_rays_accel(PinholeCalib(torch.from_numpy(calib)),
                                       torch.from_numpy(r), torch.from_numpy(t),
                                       torch.from_numpy(uv).long(), u_strat, u_pdf, grid,
                                       *budgets)
        dense = render.render_rays(PinholeCalib(torch.from_numpy(calib)), torch.from_numpy(r),
                                   torch.from_numpy(t), torch.from_numpy(uv).long(),
                                   u_strat, u_pdf)
    return want, got, dense


@pytest.mark.parametrize("sampling_type", ["point", "cone"])
def test_render_rays_accel_with_a_full_grid_equals_dense(sampling_type):
    """All cells occupied and budget = S: the culled render is the dense
    one (and the JAX package's culled render)."""
    jrender, params, render = _renderers(sampling_type)
    values = np.full((16, 16, 16), np.inf, np.float32)
    want, got, dense = _accel_pair(jrender, params, render, values, 6.0, 0.0, (9, 26), _uv(),
                                   jax.random.PRNGKey(4))
    for k in ("color", "depth", "transmittance", "color_coarse", "depth_coarse"):
        np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("sampling_type,budgets", [("point", (4, 8)), ("cone", (4, 8)),
                                                   ("cone", (6, 12))])
def test_render_rays_accel_at_tight_budgets_matches_jax(sampling_type, budgets):
    jrender, params, render = _renderers(sampling_type, seed=1)
    values = _sphere_values(16, 0.6)
    want, got, dense = _accel_pair(jrender, params, render, values, 1.1, 0.5, budgets, _uv(),
                                   jax.random.PRNGKey(5))
    assert got["weight"].shape == (40, budgets[1] - 1)
    for k in ("color", "depth", "transmittance", "weight", "color_coarse", "weight_coarse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert not np.allclose(got["depth"].numpy(), dense["depth"].numpy())


def _ray_cull_case(render, grid, draws=None, occupancy=None, generator_seed=3, chunk=8):
    calib, r, t = _camera()
    kwargs = dict(target_types=["color", "depth", "transmittance"], downsampling=32,
                  chunk=chunk, occupancy=occupancy, budget_coarse=4, budget_fine=8)
    args = (PinholeCalib(torch.from_numpy(calib)), torch.from_numpy(r), torch.from_numpy(t),
            300, 260)
    gen_d = torch.Generator().manual_seed(generator_seed)
    gen_c = torch.Generator().manual_seed(generator_seed)
    dense = render.render_image(*args, generator=gen_d, draws=draws, **kwargs)
    culled = render.render_image(*args, generator=gen_c, draws=draws, ray_cull=grid,
                                 ray_cull_factor=4, ray_cull_probes=64, **kwargs)
    assert torch.equal(gen_d.get_state(), gen_c.get_state())
    h, w = dense["color"].shape[:2]
    uv = np.stack([np.tile(np.arange(w), h) * 32, np.repeat(np.arange(h), w) * 32], 1)
    active = render.rays_active(occ.coarsen_grid(grid, 4), *args[:3], torch.from_numpy(uv),
                                64).numpy().reshape(h, w)
    return dense, culled, active


@pytest.mark.parametrize("accel,chunk,radius", [(False, 8, 0.4), (True, 8, 0.4),
                                                (False, 7, 0.4), (True, 40, 0.4),
                                                (False, 5, 0.0)])
def test_render_image_ray_cull_equals_its_dense_render(accel, chunk, radius):
    """The centred calib puts the central rays through the sphere and the
    corner rays past the dilated cube: both classes are exercised (an
    empty grid culls every ray). Active pixels are bitwise the dense
    render's; culled ones the empty composite. 72 pixels: chunks of 7 or
    40 leave a shorter last chunk (with active rays at 40)."""
    _, _, render = _renderers(seed=2)
    grid = occ.OccupancyGrid(torch.from_numpy(_sphere_values(32, radius)), 1.1, 0.5)
    dense, culled, active = _ray_cull_case(render, grid, occupancy=grid if accel else None,
                                           chunk=chunk)
    assert 0 < active.sum() < active.size if radius else active.sum() == 0
    for k in ("color", "depth", "transmittance"):
        np.testing.assert_array_equal(culled[k][active], dense[k][active], err_msg=k)
    background = {"color": 0.0, "depth": render.max_dist, "transmittance": 1.0}
    for k, v in background.items():
        np.testing.assert_array_equal(culled[k][~active], np.full_like(culled[k][~active], v))


def test_render_image_ray_cull_matches_jax_with_its_draws():
    jrender, params, render = _renderers(seed=2)
    values = _sphere_values(32, 0.4)
    calib, r, t = _camera()
    key = jax.random.PRNGKey(3)
    want = jrender.render_image(
        params, JCalib(jnp.asarray(calib)), jnp.asarray(r), jnp.asarray(t), 300, 260,
        ["color", "depth", "transmittance"], 32, 8, key=key,
        ray_cull=jocc.OccupancyGrid(jnp.asarray(values), 1.1, 0.5), ray_cull_probes=64)
    _, sub = jax.random.split(key)  # render_image's chunk key
    grid = occ.OccupancyGrid(torch.from_numpy(values), 1.1, 0.5)
    _, culled, active = _ray_cull_case(render, grid, draws=_jax_draws(sub, 9, 17))
    assert 0 < active.sum() < active.size
    for k in ("color", "depth", "transmittance"):
        np.testing.assert_allclose(culled[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("n,chunk,share", [(1000, 64, 0.3), (1000, 64, 0.0), (1000, 64, 1.0),
                                           (1003, 40, 0.5), (70, 12, 0.2), (30, 64, 0.5),
                                           (100, 7, 0.4)])
def test_pack_active_rays_keeps_the_dense_chunk_shapes_and_row_residues(n, chunk, share):
    from neddf_tpu_torch.render.renderer import pack_active_rays

    active = torch.from_numpy(np.random.default_rng(n + chunk).uniform(size=n) < share)
    keep = pack_active_rays(active, chunk).numpy()
    n_full, g = n - n % chunk, np.gcd(chunk, 8)
    assert len(set(keep)) == len(keep)
    assert set(np.nonzero(active.numpy())[0]) <= set(keep)
    main = keep[keep < n_full]
    assert np.array_equal(keep[: len(main)], main)  # the full chunks come first, whole
    assert len(main) % chunk == 0 or not active.any()
    assert np.all(main % g == np.arange(len(main)) % g)  # each ray's row residue
    tail = keep[len(main):]
    if active[n_full:].any():
        np.testing.assert_array_equal(tail, np.arange(n_full, n))
    elif active.any():
        assert len(tail) == 0
    # as few chunks as the busiest row residue needs
    per_residue = max(int(active[:n_full][c::g].sum()) for c in range(g)) if n_full else 0
    assert len(main) == min(-(-per_residue * g // chunk) * chunk, n_full) or not active.any()
