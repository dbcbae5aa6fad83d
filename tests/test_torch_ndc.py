"""The port's NDC rays and NDC render against the JAX package on the CPU
(``geometry/camera.py::ndc_rays``, ``render/renderer.py`` with
``ndc=true``), and the renderer's refusals of NDC where a world-space
occupancy grid would be used.

Tolerances: ``ndc_rays`` is the same f32 arithmetic in the same order,
within 1e-6 of each component's magnitude; the NDC render on the JAX
package's per-pixel draws (same weights) is f32 sums in another order,
within 1e-5; the shading directions are the world directions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu.geometry import PinholeCalib as JCalib
from neddf_tpu.geometry import camera_pose as jcamera_pose
from neddf_tpu.geometry.camera import create_rays as jcreate_rays
from neddf_tpu.geometry.camera import ndc_rays as jndc_rays
from neddf_tpu.ops.sampling import _per_ray_uniform
from neddf_tpu.render.renderer import NeRFRender as JRender
from neddf_tpu_torch.geometry.camera import PinholeCalib, create_rays, ndc_rays
from neddf_tpu_torch.ops import occupancy as occ
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.training.checkpoint import params_from_jax
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

# tests/render/test_ndc.py's rig: a camera near the origin looking along -z
CALIB = np.array([120.0, 120.0, 64.0, 48.0], np.float32)
POSE = np.array([0.0, 0.0, 0.0, 0.1, -0.05, 0.2], np.float32)
NETWORKS = {
    "nerf": ({"_target_": "neddf_tpu.fields.NeRF", "embed_pos_rank": 4, "embed_dir_rank": 2,
              "layer_count": 3, "layer_width": 16, "skips": (1,),
              "compute_dtype": "float32"}, True),
    "neddf": ({"_target_": "neddf_tpu.fields.NeDDF", "embed_pos_rank": 4,
               "embed_dir_rank": 2, "ddf_layer_count": 4, "ddf_layer_width": 16,
               "col_layer_count": 3, "col_layer_width": 16, "skips": (1,), "d_near": 0.001,
               "compute_dtype": "float32"}, False),
}
TOL = 1e-5


def _rig():
    r, t = jcamera_pose(jnp.asarray(POSE), jnp.zeros(6))
    return JCalib(jnp.asarray(CALIB)), r, t


def _grid_uv(n=5, w=128, h=96):
    u = np.linspace(4, w - 4, n).astype(np.int32)
    v = np.linspace(4, h - 4, n).astype(np.int32)
    uu, vv = np.meshgrid(u, v)
    return np.stack([uu.ravel(), vv.ravel()], axis=1)


def _port_rays(uv):
    jcalib, r, t = _rig()
    return create_rays(PinholeCalib(torch.from_numpy(CALIB)), torch.from_numpy(np.array(r)),
                       torch.from_numpy(np.array(t)), torch.from_numpy(uv).long())


@pytest.mark.parametrize("near", [1.0, 2.5])
def test_ndc_rays_match_jax(near):
    jcalib, r, t = _rig()
    uv = _grid_uv(7)
    want = jndc_rays(jcalib, near, jcreate_rays(jcalib, r, t, jnp.asarray(uv)))
    got = ndc_rays(PinholeCalib(torch.from_numpy(CALIB)), near, _port_rays(uv))
    for name in ("ray_orig", "ray_dir"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)
    np.testing.assert_array_equal(got.uv.numpy(), uv)
    # t' = 0 on the near plane (z_ndc = -1), t' -> 1 at infinity (z_ndc -> 1)
    np.testing.assert_allclose(got.ray_orig[:, 2].numpy(), -1.0, atol=1e-5)
    np.testing.assert_allclose((got.ray_orig[:, 2] + got.ray_dir[:, 2]).numpy(), 1.0,
                               atol=1e-5)


def test_ndc_rays_take_a_tensor_near_and_any_direction_scale():
    uv = _grid_uv(4)
    calib = PinholeCalib(torch.from_numpy(CALIB))
    rays = _port_rays(uv)
    a = ndc_rays(calib, torch.tensor(1.5), rays)
    b = ndc_rays(calib, 1.5, rays._replace(ray_dir=2.5 * rays.ray_dir))
    np.testing.assert_allclose(a.ray_orig.numpy(), b.ray_orig.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.ray_dir.numpy(), b.ray_dir.numpy(), atol=1e-5)


def _renderers(family, seed=0, **kw):
    network, coarse = NETWORKS[family]
    cfg = dict(network_config=dict(network), sample_coarse=8, sample_fine=16,
               use_coarse_network=coarse, sampling_type="point", ndc=True, ndc_near=1.0, **kw)
    jrender = JRender(**cfg)
    params = jrender.init(jax.random.PRNGKey(seed))
    render = NeRFRender(**cfg)
    render.load_state_dict(params_from_jax(params), strict=True)
    return jrender, params, render


@pytest.mark.parametrize("iteration", [0, -1], ids=["train", "eval"])
@pytest.mark.parametrize("family", list(NETWORKS))
def test_ndc_render_rays_match_jax_on_its_draws(family, iteration):
    jrender, params, render = _renderers(family, seed=1)
    assert (render.dist_near, render.dist_far, render.max_dist) == (0.0, 1.0, 1.0)
    jcalib, r, t = _rig()
    uv = _grid_uv(6)
    key = jax.random.PRNGKey(5)
    need_aux = iteration >= 0
    want = jrender.render_rays(params, jcalib, r, t, jnp.asarray(uv), key, iteration,
                               need_aux=need_aux)
    k_strat, k_pdf = jax.random.split(key)
    pids = jnp.asarray(uv[:, 0] * 65536 + uv[:, 1])
    u_strat = torch.from_numpy(np.array(_per_ray_uniform(k_strat, pids, 9)))
    u_pdf = torch.from_numpy(np.array(_per_ray_uniform(k_pdf, pids, 17)))
    with torch.no_grad():
        got = render.render_rays(PinholeCalib(torch.from_numpy(CALIB)),
                                 torch.from_numpy(np.array(r)), torch.from_numpy(np.array(t)),
                                 torch.from_numpy(uv).long(), u_strat, u_pdf, iteration,
                                 need_aux=need_aux)
    assert set(got) == set(want)
    if need_aux and family == "neddf":
        assert any("penalty" in k for k in got)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL,
                                   atol=TOL * max(np.abs(w).max(), 1.0), err_msg=k)
    depth = got["depth"].numpy()
    assert (depth >= 0.0).all() and (depth <= 1.0 + 1e-5).all()


@pytest.mark.parametrize("family", list(NETWORKS))
def test_ndc_fields_see_unit_world_directions(family, monkeypatch):
    """The Sampling the field is called with carries the world directions
    (NeDDF's colour tangent reads them too), its positions the warp."""
    _, _, render = _renderers(family)
    seen = []
    for net in {render.network_fine, render.coarse_network()}:
        forward = net.forward

        def spy(sampling, *args, forward=forward, **kwargs):
            seen.append(sampling)
            return forward(sampling, *args, **kwargs)

        monkeypatch.setattr(net, "forward", spy)
    uv = _grid_uv(3)
    rays = _port_rays(uv)
    with torch.no_grad():
        render.render_rays(PinholeCalib(torch.from_numpy(CALIB)), *_rig_port(),
                           torch.from_numpy(uv).long(), torch.rand(9, 9), torch.rand(9, 17))
    assert len(seen) == 2
    for sampling in seen:
        dirs = sampling.sample_dir
        np.testing.assert_array_equal(
            dirs.numpy(), rays.ray_dir[:, None, :].expand_as(dirs).numpy())
        pos = sampling.sample_pos.numpy()
        assert np.isfinite(pos).all() and (pos[..., 2] >= -1.0 - 1e-5).all()  # t' >= 0


def _rig_port():
    _, r, t = _rig()
    return torch.from_numpy(np.array(r)), torch.from_numpy(np.array(t))


def test_ndc_refuses_cone_samples():
    network, _ = NETWORKS["nerf"]
    with pytest.raises(ValueError, match="sampling_type"):
        NeRFRender(dict(network), ndc=True, sampling_type="cone")
    # without ndc, the cone renderer keeps its world window
    render = NeRFRender(dict(network), sampling_type="cone", dist_near=2.0, dist_far=6.0)
    assert (render.ndc, render.dist_near, render.dist_far) == (False, 2.0, 6.0)


def test_ndc_refuses_the_occupancy_paths():
    _, _, render = _renderers("neddf")
    calib = PinholeCalib(torch.from_numpy(CALIB))
    r, t = _rig_port()
    grid = occ.make_grid(8, 1.1, 0.01)
    uv = torch.from_numpy(_grid_uv(2)).long()
    with pytest.raises(ValueError, match="build_occupancy does not support ndc=true"):
        render.build_occupancy(torch.Generator().manual_seed(0), resolution=8)
    with pytest.raises(ValueError, match="render_rays_accel does not support ndc=true"):
        render.render_rays_accel(calib, r, t, uv, torch.rand(4, 9), torch.rand(4, 17), grid)
    with pytest.raises(ValueError, match="rays_active.*does not support ndc=true"):
        render.rays_active(grid, calib, r, t, uv, 16)
    with pytest.raises(ValueError, match="ndc=true"):
        render.render_image(calib, r, t, 8, 6, ray_cull=grid)
    with pytest.raises(ValueError, match="ndc=true"):
        render.render_image(calib, r, t, 8, 6, occupancy=grid)
    # the dense render of the same renderer stands
    images = render.render_image(calib, r, t, 8, 6, chunk=16)
    assert images["color"].shape == (6, 8, 3) and np.isfinite(images["color"]).all()
