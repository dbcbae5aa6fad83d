"""Elementwise parity of the PyTorch port's math and geometry with the
JAX package, on the CPU, fed the same numpy inputs (and, for the
samplers, the JAX package's own per-pixel uniform draws).

Tolerances: both sides compute in f32 with the same formulas, so most
results agree to a few ulps (rtol 1e-6). Sums taken in another order
(matmuls, cumulative sums) and sin/cos of phases up to 2^9 rad get
1e-5; the inverse CDF, which the port computes by searchsorted + lerp
and the JAX package by a gather-free sum over bins, gets 1e-4 of the
ray's depth range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu.geometry import camera as jcam
from neddf_tpu.geometry import rays as jrays
from neddf_tpu.geometry import se3 as jse3
from neddf_tpu.ops import activations as jact
from neddf_tpu.ops import compositing as jcomp
from neddf_tpu.ops import dual as jdual
from neddf_tpu.ops import pe as jpe
from neddf_tpu.ops import sampling as jsamp
from neddf_tpu_torch.geometry import camera as tcam
from neddf_tpu_torch.geometry import rays as trays
from neddf_tpu_torch.geometry import se3 as tse3
from neddf_tpu_torch.ops import activations as tact
from neddf_tpu_torch.ops import compositing as tcomp
from neddf_tpu_torch.ops import dual as tdual
from neddf_tpu_torch.ops import pe as tpe
from neddf_tpu_torch.ops import sampling as tsamp

CONE_RADIUS = 1.0 / 1111.0 / np.sqrt(12.0)


def t(x):
    return torch.from_numpy(np.array(x))  # a writable copy of a JAX array


def close(got, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


ACT_X = np.concatenate([
    np.array([0.0, 20.0, -20.0, 20.0 - 1e-3, 20.0 + 1e-3, 19.999998, 20.000002,
              -1e-7, 1e-7, 50.0, -50.0], np.float32),
    np.random.default_rng(0).normal(scale=8.0, size=200).astype(np.float32),
])


@pytest.mark.parametrize(
    "name,jf,tf",
    [
        ("tanh_exp", jact.tanh_exp, tact.tanh_exp),
        ("tanh_exp_deriv", jact.tanh_exp_deriv, tact.tanh_exp_deriv),
        ("softplus", jact.softplus, tact.softplus),
        ("softplus_deriv", jact.softplus_deriv, tact.softplus_deriv),
        ("relu", jact.relu, tact.relu),
        ("relu_deriv", jact.relu_deriv, tact.relu_deriv),
        ("sigmoid", jact.sigmoid, tact.sigmoid),
        ("sigmoid_deriv", jact.sigmoid_deriv, tact.sigmoid_deriv),
    ],
)
def test_activations(name, jf, tf):
    # f32 exp/tanh from two libraries differ by an ulp; tanhExp's
    # derivative x*e^x*(tanh^2 - 1) turns that into up to ~4e-6
    close(tf(t(ACT_X)), jf(jnp.asarray(ACT_X)), rtol=1e-5, atol=1e-5)


def test_tanh_exp_passthrough_above_20():
    x = torch.tensor([20.0, 20.5, 1e4])
    assert torch.equal(tact.tanh_exp(x)[1:], x[1:])
    assert torch.equal(tact.tanh_exp_deriv(x)[1:], torch.ones(2))


@pytest.mark.parametrize("alpha", [0.0, 3.3, 7.5, 9.99, 10.0, 12.0])
def test_pe_lowpass_scale(alpha):
    close(tpe.pe_lowpass_scale(10, alpha, "cpu"), jpe.pe_lowpass_scale(10, alpha))


def test_pe_grad_scale_and_frequencies():
    close(tpe.pe_grad_scale(10, "cpu"), jpe.pe_grad_scale(10))
    close(tpe.pe_frequencies(4, "cpu"), jpe.pe_frequencies(4))


def _geometry_inputs(n=257, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    var = (rng.uniform(0, 1e-4, size=(n, 3))).astype(np.float32)
    return pos, var


@pytest.mark.parametrize("rank,use_var,use_scale", [
    (10, True, True), (10, False, False), (4, False, False), (10, True, False),
])
def test_positional_encoding_mip(rank, use_var, use_scale):
    pos, var = _geometry_inputs()
    scale = np.asarray(jpe.pe_lowpass_scale(rank, 6.4)) if use_scale else None
    ref = jpe.positional_encoding_mip(
        jnp.asarray(pos), rank, var=jnp.asarray(var) if use_var else None,
        chan_scale=None if scale is None else jnp.asarray(scale),
    )
    got = tpe.positional_encoding_mip(
        t(pos), rank, var=t(var) if use_var else None,
        chan_scale=None if scale is None else t(scale),
    )
    # sin/cos of phases up to 2^9 * 1.2 rad: argument reduction differs
    close(got, ref, rtol=1e-5, atol=1e-5)


def test_pe_dual_planes_mip():
    pos, var = _geometry_inputs()
    crow = np.asarray(jpe.pe_grad_scale(10) * jpe.pe_lowpass_scale(10, 10.0))
    jv, jj = jdual.pe_dual_planes_mip(jnp.asarray(pos), 10, var=jnp.asarray(var),
                                      chan_scale=jnp.asarray(crow))
    tv, tj = tdual.pe_dual_planes_mip(t(pos), 10, var=t(var), chan_scale=t(crow))
    assert tuple(tj.shape) == (3, pos.shape[0], 60)
    close(tv, jv, rtol=1e-5, atol=1e-5)
    close(tj, jj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rotvec", [
    [0.3, -1.2, 2.0], [1e-12, 0.0, -1e-12], [0.0, 0.0, 0.0], [2.5, 0.1, -0.4],
])
@pytest.mark.parametrize("delta", [[0.0] * 6, [1e-3, -2e-3, 5e-4, 0.01, -0.02, 0.03]])
def test_camera_pose(rotvec, delta):
    init = np.array(rotvec + [0.5, -3.0, 2.0], np.float32)
    dl = np.array(delta, np.float32)
    rj, tj = jse3.camera_pose(jnp.asarray(init), jnp.asarray(dl))
    rt, tt = tse3.camera_pose(t(init), t(dl))
    close(rt, rj, rtol=1e-5, atol=1e-6)
    close(tt, tj, rtol=1e-5, atol=1e-6)


def _rays(n=64, seed=2):
    rng = np.random.default_rng(seed)
    calib = np.array([555.5, 555.5, 250.0, 250.0], np.float32)
    init = np.array([0.4, -1.1, 0.7, 0.3, -3.5, 2.2], np.float32)
    uv = rng.integers(0, 500, size=(n, 2)).astype(np.int32)
    rj, tj = jse3.camera_pose(jnp.asarray(init), jnp.zeros(6, jnp.float32))
    return calib, np.asarray(rj), np.asarray(tj), uv


def test_create_rays():
    calib, r, tr, uv = _rays()
    ref = jcam.create_rays(jcam.PinholeCalib(jnp.asarray(calib)), jnp.asarray(r),
                           jnp.asarray(tr), jnp.asarray(uv))
    got = tcam.create_rays(tcam.PinholeCalib(t(calib)), t(r), t(tr), t(uv).long())
    close(got.ray_dir, ref.ray_dir, rtol=1e-5, atol=1e-6)
    close(got.ray_orig, ref.ray_orig)


def test_get_sampling_cones():
    calib, r, tr, uv = _rays()
    rng = np.random.default_rng(3)
    dists = np.sort(rng.uniform(2.0, 6.0, size=(uv.shape[0], 20)), axis=1).astype(np.float32)
    rays_j = jcam.create_rays(jcam.PinholeCalib(jnp.asarray(calib)), jnp.asarray(r),
                              jnp.asarray(tr), jnp.asarray(uv))
    ref = jrays.get_sampling_cones(rays_j, jnp.asarray(dists), CONE_RADIUS)
    rays_t = trays.Rays(t(rays_j.ray_dir), t(rays_j.ray_orig), t(uv))
    got = trays.get_sampling_cones(rays_t, t(dists), CONE_RADIUS)
    close(got.sample_pos, ref.sample_pos, rtol=1e-5, atol=1e-5)
    close(got.sample_dir, ref.sample_dir)
    close(got.diag_variance, ref.diag_variance, rtol=1e-4, atol=1e-12)


def _jax_draws(n_rays, n, seed=5):
    key = jax.random.PRNGKey(seed)
    uv = np.random.default_rng(seed).integers(0, 500, size=(n_rays, 2)).astype(np.int32)
    pids = jnp.asarray(uv[:, 0] * 65536 + uv[:, 1])
    return key, pids, np.asarray(jsamp._per_ray_uniform(key, pids, n))


def test_stratified_dists_with_jax_draws():
    key, pids, u = _jax_draws(50, 65)
    ref = jsamp.stratified_dists(key, 50, 64, 2.0, 6.0, pixel_ids=pids)
    close(tsamp.stratified_dists(t(u), 64, 2.0, 6.0), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("weights_kind", ["peaked", "flat", "with_nan_and_negative"])
def test_sample_pdf_with_jax_draws(weights_kind):
    key, pids, u = _jax_draws(40, 129, seed=7)
    rng = np.random.default_rng(8)
    dists = np.asarray(
        jsamp.stratified_dists(key, 40, 64, 2.0, 6.0, pixel_ids=pids), np.float32
    )
    if weights_kind == "peaked":
        w = np.exp(-0.5 * ((dists[:, :-1] - 4.0) / 0.1) ** 2).astype(np.float32)
    elif weights_kind == "flat":
        w = np.full((40, 64), 1.0 / 64, np.float32)
    else:
        w = rng.uniform(0, 1, size=(40, 64)).astype(np.float32)
        w[0, 3] = np.nan
        w[1, :5] = -0.5
    ref = jsamp.sample_pdf(key, jnp.asarray(dists), jnp.asarray(w), 129, pixel_ids=pids)
    got = tsamp.sample_pdf(t(dists), t(w), t(u))
    assert tuple(got.shape) == (40, 194)
    # searchsorted + lerp vs the gather-free bin sum: 1e-4 of the 4.0 range
    close(got, ref, rtol=0, atol=4e-4)


def test_integrate_volume_render():
    rng = np.random.default_rng(9)
    dists = np.sort(rng.uniform(2.0, 6.0, size=(30, 40)), axis=1).astype(np.float32)
    dens = rng.uniform(0, 30, size=(30, 40)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(30, 40, 3)).astype(np.float32)
    ref = jcomp.integrate_volume_render(jnp.asarray(dists), jnp.asarray(dens),
                                        jnp.asarray(cols), 6.0)
    got = tcomp.integrate_volume_render(t(dists), t(dens), t(cols), 6.0)
    for k in ("weight", "depth", "color", "transmittance"):
        # cumulative sum of logs in another order: 1e-5
        close(got[k], ref[k], rtol=1e-5, atol=1e-6)
