"""The PyTorch port's training-path field and renderer against the JAX
package on the CPU, at narrow widths: the field with ``need_aux=True``
(outputs and every parameter gradient, against ``fused="off"``), the
default and partial penalty weights, ``render_rays`` with the JAX
package's draws, and the stop-gradient on the fine sampler.

Tolerances (f32 on both sides): outputs at rtol/atol 1e-5, the density
and penalties, which go through 1/D and second derivatives, at 1e-4;
every parameter gradient within 1e-4 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu.fields.neddf import NeDDF as JNeDDF
from neddf_tpu.geometry.camera import PinholeCalib as JCalib
from neddf_tpu.geometry.rays import Sampling as JSampling
from neddf_tpu.ops.sampling import _per_ray_uniform
from neddf_tpu.render.renderer import NeRFRender as JRender
from neddf_tpu_torch.fields.neddf import NeDDF
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.training.checkpoint import params_from_jax
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

FIELD = dict(embed_pos_rank=6, embed_dir_rank=2, ddf_layer_count=5, ddf_layer_width=32,
             col_layer_count=4, col_layer_width=32, d_near=0.001, skips=(1,),
             lowpass_alpha_offset=4, activation_type="tanhExp",
             density_activation_type="ReLU", compute_dtype="float32")
PENALTY = {"constraints_aux_grad": 0.05, "constraints_dDdt": 1.0,
           "constraints_color": 0.0001, "range_distance": 1.0, "range_aux_grad": 1.0,
           "range_color": 0.1}
KEYS = ("distance", "density", "color", "fields_penalty", "aux_grad")
TOL = {"distance": 1e-5, "color": 1e-5, "aux_grad": 1e-5, "density": 1e-4,
       "fields_penalty": 1e-4}


def _close(got, ref, bound, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= bound * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


def _flat_grads(jgrads, prefix=""):
    """JAX grad tree -> {state_dict name: numpy}."""
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads)).items()}


def _sampling(b=6, s=24, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=(b, s, 3)).astype(np.float32)
    d = rng.normal(size=(b, 1, 3)).astype(np.float32)
    d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (b, s, 3)).copy()
    var = rng.uniform(0, 1e-4, size=(b, s, 3)).astype(np.float32)
    return pos, d, var


def _field_pair(penalty, seed=0):
    jfield = JNeDDF(**FIELD, penalty_weight=penalty, fused="off")
    params = jfield.init(jax.random.PRNGKey(seed))
    field = NeDDF(**FIELD, penalty_weight=penalty)
    field.load_state_dict(params_from_jax(params), strict=True)
    return jfield, params, field


def _train_outputs(jfield, params, field, iteration, seed=0):
    pos, d, var = _sampling(seed=seed)
    jsamp = JSampling(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(var))
    ref = jax.jit(lambda p: jfield.apply(p, jsamp, jfield.schedule(iteration),
                                         need_aux=True))(params)
    sampling = Sampling(*map(torch.from_numpy, (pos, d, var)))
    got = field(sampling, field.schedule(iteration), need_aux=True)
    return jsamp, ref, got


@pytest.mark.parametrize(
    "penalty", [None, {"range_color": 0.5, "constraints_dDdt": 0.3}],
    ids=["default", "partial_map"])
def test_penalty_weights_default_and_partial_match_jax(penalty):
    """penalty_weight=None means the JAX package's default weights; a key
    missing from a given map enters the sum unweighted."""
    jfield, params, field = _field_pair(penalty)
    _, ref, got = _train_outputs(jfield, params, field, 20000)
    assert field.penalty_weight == dict(jfield.penalty_weight)
    _close(got["fields_penalty"].detach().numpy(), ref["fields_penalty"], 1e-4)


@pytest.mark.parametrize("iteration", [0, 20000])
def test_training_field_outputs_and_grads_match_jax(iteration):
    jfield, params, field = _field_pair(PENALTY, seed=1)
    jsamp, ref, got = _train_outputs(jfield, params, field, iteration, seed=1)
    for k in KEYS:
        _close(got[k].detach().numpy(), ref[k], TOL[k], k)
    rng = np.random.default_rng(2)
    weights = {k: rng.normal(size=np.shape(ref[k])).astype(np.float32) for k in KEYS}

    def jloss(p):
        out = jfield.apply(p, jsamp, jfield.schedule(iteration), need_aux=True)
        return sum(jnp.sum(out[k] * weights[k]) for k in KEYS)

    jgrads = _flat_grads(jax.jit(jax.grad(jloss))(params))
    loss = sum(torch.sum(got[k] * torch.from_numpy(weights[k])) for k in KEYS)
    loss.backward()
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


RENDER = dict(sample_coarse=12, sample_fine=16, dist_near=2.0, dist_far=6.0,
              max_dist=6.0, use_coarse_network=False, sampling_type="cone")


def _camera():
    from neddf_tpu.geometry.se3 import camera_pose as jcamera_pose

    calib = np.array([22.0, 22.0, 8.0, 6.0], np.float32)
    init = np.array([0.9, -0.4, 0.3, 0.2, -3.8, 1.4], np.float32)
    r, t = jcamera_pose(jnp.asarray(init), jnp.zeros(6, jnp.float32))
    return calib, np.array(r), np.array(t)


def _render_pair(seed=0):
    network = {"_target_": "neddf_tpu.fields.NeDDF", **FIELD, "penalty_weight": PENALTY}
    jrender = JRender(network_config=dict(network), **RENDER)
    params = jrender.init(jax.random.PRNGKey(seed))
    render = NeRFRender(network_config=dict(network), **RENDER)
    render.load_state_dict(params_from_jax(params), strict=True)
    return jrender, params, render


def _render_inputs():
    calib, r, t = _camera()
    uv = np.random.default_rng(3).integers(0, 16, size=(20, 2)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    k_strat, k_pdf = jax.random.split(key)
    pids = jnp.asarray(uv[:, 0] * 65536 + uv[:, 1])
    u_strat = np.array(_per_ray_uniform(k_strat, pids, RENDER["sample_coarse"] + 1))
    u_pdf = np.array(_per_ray_uniform(k_pdf, pids, RENDER["sample_fine"] + 1))
    return calib, r, t, uv, key, u_strat, u_pdf


def _port_render(render, calib, r, t, uv, u_strat, u_pdf, iteration):
    return render.render_rays(
        PinholeCalib(torch.from_numpy(calib)), torch.from_numpy(r), torch.from_numpy(t),
        torch.from_numpy(uv).long(), torch.from_numpy(u_strat), torch.from_numpy(u_pdf),
        iteration=iteration, need_aux=True)


def test_render_rays_training_outputs_match_jax():
    jrender, params, render = _render_pair()
    calib, r, t, uv, key, u_strat, u_pdf = _render_inputs()
    ref = jax.jit(lambda p: jrender.render_rays(
        p, JCalib(jnp.asarray(calib)), jnp.asarray(r), jnp.asarray(t), jnp.asarray(uv),
        key, 300, need_aux=True))(params)
    got = _port_render(render, calib, r, t, uv, u_strat, u_pdf, 300)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k].detach().numpy(), ref[k], 1e-4, k)


def test_fine_sampler_passes_no_gradient_to_the_coarse_pass():
    """A loss on the fine colour alone: the fine distances are
    stop-gradiented in the JAX renderer, so the parameter gradients
    equal JAX's only if the port detaches them too."""
    jrender, params, render = _render_pair(1)
    calib, r, t, uv, key, u_strat, u_pdf = _render_inputs()
    target = np.random.default_rng(4).uniform(size=(uv.shape[0], 3)).astype(np.float32)

    def jloss(p):
        out = jrender.render_rays(p, JCalib(jnp.asarray(calib)), jnp.asarray(r),
                                  jnp.asarray(t), jnp.asarray(uv), key, 300,
                                  need_aux=True)
        return jnp.sum(jnp.square(out["color"] - target))

    jgrads = _flat_grads(jax.jit(jax.grad(jloss))(params))
    out = _port_render(render, calib, r, t, uv, u_strat, u_pdf, 300)
    torch.sum(torch.square(out["color"] - torch.from_numpy(target))).backward()
    for name, p in render.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)
