"""``optimize_camera`` and ``grad_accum`` in the port, against the JAX
package on the CPU.

* The camera-delta gradient of one step (``make_local_grads(...,
  optimize_camera=True)`` on the JAX package's draws, f32, ``fused="off"``)
  for NeDDF, NeRF and NeuS at narrow widths, at a zero delta and at a
  delta of 0.29 rad (both sides of ``rodrigues``' small-angle select).
* The same through the kernels' walks of the backwards on the CPU
  (``dual_mlp_seg_bwd_route`` over ``DualProductsPlain``, the NeDDF
  trunk's and colour trunk's layer-0 input cotangents included;
  ``mlp_seg_bwd_route`` and ``sdf_mlp_bwd_route`` for NeRF and NeuS).
* ``rodrigues``: R, V and the gradient against the JAX package at |w| =
  0, 1e-12, 1e-3 and 1, and no Python branch on a tensor value (it traces
  with ``torch.fx``).
* ``RowSparseAdam`` moves only the trained camera's row; the camera state
  survives a checkpoint (``tests/training/test_camera_optimization.py``).
* ``grad_accum`` 2 and 4 against 1 on the same draws, with and without
  ``optimize_camera``; the validation errors of
  ``tests/training/test_grad_accum.py::test_grad_accum_validation`` with
  the JAX package's texts.

Tolerances (f32): the camera gradient within 1e-4 of its norm (the pose
enters every ray; sums in another order); rodrigues 1e-6; ``grad_accum``
losses and every parameter's gradient within 1e-6 of their largest
magnitude (the microbatch sums in another order), the camera-delta
gradient within ``CAMERA_ACCUM_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu.geometry import se3 as jse3
from neddf_tpu.training.step import make_local_grads
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.geometry import se3 as tse3
from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.training.step import check_grad_accum, check_target_keys
from tests.test_torch_nerf_neus_step import tiny_config as family_config
from tests.test_torch_train_step import (  # noqa: F401  (scene is a fixture)
    _jax_draws,
    _jax_grads,
    _trainers,
    scene,
    tiny_config,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

# a pose delta of 0.29 rad: there the reference's V coefficients, (theta -
# sin theta) / theta^3 and (1 - cos theta) / theta^2, keep f32 precision
# (at a few milliradians theta - sin theta cancels to ~1e-8 and each
# package's sin rounds it differently)
DELTA = np.array([0.2, -0.1, 0.18, 0.01, 0.02, -0.02], np.float32)
# the camera-delta gradient sums every sample's contribution through the
# pose, and those terms cancel: a microbatch split moves it by ~2e-6 of
# its largest entry in f32 (1e-6 holds for every parameter's gradient)
CAMERA_ACCUM_TOL = 1e-5


def _config(scene, family, **trainer):
    if family == "neddf":
        cfg = tiny_config(scene, **trainer)
    else:
        cfg = family_config(scene, family, **trainer)
    cfg["network"]["fused"] = "off"
    return cfg


_JAX = {}


def _both(cfg, family):
    """(JAX trainer, its jitted grads, a port trainer with its params); the
    JAX side is built once per family (every caller passes the same
    optimize_camera, fused="off" config)."""
    if family not in _JAX:
        jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
        _JAX[family] = (jtr, jax.jit(jtr._local_grads, static_argnums=(8, 9)))
    jtr, grads_fn = _JAX[family]
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict(params_from_jax(jtr.params), strict=True)
    return jtr, grads_fn, ttr


def _rel_to_norm(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


def _route_walks(monkeypatch):
    """Send the plain backwards through the kernels' walks over the plain
    launchers (what ``DualProducts``, ``MLPProducts`` and ``SDFProducts``
    do on the card)."""
    def dual(vs, js, weights, layout, act, has_j, pres, gv, gj, top=None):
        return tdm.dual_mlp_seg_bwd_route(vs, js, weights, layout, act, has_j, pres, gv, gj,
                                          tdm.DualProductsPlain(vs[0].dtype), top=top)

    def mlp(vs, weights, layout, act, pres, g):
        return tmlp.mlp_seg_bwd_route(vs, weights, layout, act, pres, g,
                                      tmlp.MLPProductsPlain(vs[0].dtype))

    def sdf(e, weights, layout, act, pres, ch, cg):
        return tsdf.sdf_mlp_bwd_route(e, weights, layout, act, pres, ch, cg,
                                      tsdf.SDFProductsPlain(torch.float32))

    calls = {"dual": 0, "mlp": 0, "sdf": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tepi, "dual_mlp_seg_bwd_plain", counted("dual", dual))
    monkeypatch.setattr(tdm, "dual_mlp_seg_bwd_plain", counted("dual", dual))
    monkeypatch.setattr(tmlp, "mlp_seg_bwd_plain", counted("mlp", mlp))
    monkeypatch.setattr(tsdf, "sdf_trunk_with_grad_vjp", counted("sdf", sdf))
    return calls


@pytest.mark.parametrize("walk", ["plain", "route"])
@pytest.mark.parametrize("delta", ["zero", "small"])
@pytest.mark.parametrize("family", ["neddf", "nerf", "neus"])
def test_camera_gradient_matches_jax(scene, monkeypatch, family, delta, walk):
    jtr, grads_fn, ttr = _both(_config(scene, family, optimize_camera=True), family)
    cam = 1
    deltas = np.zeros(tuple(ttr.camera_deltas.shape), np.float32)
    if delta == "small":
        deltas[cam] = DELTA
    jtr.camera_deltas = jnp.asarray(deltas)
    with torch.no_grad():
        ttr.camera_deltas.copy_(torch.from_numpy(deltas))
    calls = _route_walks(monkeypatch) if walk == "route" else None
    key = jax.random.PRNGKey(7)
    loss, _, _, _, grads_cam = _jax_grads(jtr, grads_fn, key, cam, 3)
    ttr.iteration = 3
    us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
    tloss, _, _ = ttr.step_grads(cam, us.long(), vs.long(), u_strat, u_pdf)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
    want = np.asarray(grads_cam)
    got = ttr.camera_deltas.grad.numpy()
    assert np.abs(want[cam]).max() > 0
    assert _rel_to_norm(got[cam], want[cam]) <= 1e-4, (got[cam], want[cam])
    assert np.all(np.delete(got, cam, axis=0) == 0.0)
    if calls is not None:
        want_calls = {"neddf": {"dual": 4, "mlp": 0, "sdf": 0},
                      "nerf": {"dual": 0, "mlp": 2, "sdf": 0},
                      "neus": {"dual": 0, "mlp": 2, "sdf": 2}}[family]
        assert calls == want_calls


@pytest.mark.parametrize("norm", [0.0, 1e-12, 1e-3, 1.0])
def test_rodrigues_matches_jax_on_both_sides_of_the_small_angle_select(norm):
    rng = np.random.default_rng(3)
    w = rng.normal(size=3).astype(np.float32)
    w = (w / np.linalg.norm(w) * norm).astype(np.float32)
    jr, jv = jse3.rodrigues(jnp.asarray(w))
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    tr, tv = tse3.rodrigues(tw)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    cot = rng.normal(size=(2, 3, 3)).astype(np.float32)

    def jloss(x):
        r, v = jse3.rodrigues(x)
        return jnp.sum(r * cot[0]) + jnp.sum(v * cot[1])

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(w)))
    (torch.sum(tr * torch.from_numpy(cot[0])) + torch.sum(tv * torch.from_numpy(cot[1]))
     ).backward()
    assert np.all(np.isfinite(tw.grad.numpy()))
    np.testing.assert_allclose(tw.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_rodrigues_reads_no_tensor_value_on_the_host():
    """``torch.fx`` refuses a Python branch on a traced value, so tracing
    shows that ``rodrigues`` and ``camera_pose`` make no host sync."""
    traced = torch.fx.symbolic_trace(tse3.rodrigues)
    pose = torch.fx.symbolic_trace(tse3.camera_pose)
    w = torch.tensor([0.0, 1e-3, -2e-3])
    for got, want in zip(traced(w), tse3.rodrigues(w)):
        assert torch.equal(got, want)
    init = torch.tensor([0.1, 0.2, -0.3, 1.0, 2.0, 3.0])
    for got, want in zip(pose(init, torch.zeros(6)), tse3.camera_pose(init, torch.zeros(6))):
        assert torch.equal(got, want)


def test_only_the_trained_camera_moves_and_its_state_survives_a_checkpoint(scene, tmp_path):
    cfg = tiny_config(scene, optimize_camera=True, camera_optimizer_lr=0.001)
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    assert trainer.camera_deltas.requires_grad and trainer.camera_deltas.is_leaf
    assert all(trainer.camera_deltas is not p for p in trainer.optimizer.param_groups[0]["params"])
    trainer.run_train_step(0)
    trainer.run_train_step(0)
    after = trainer.camera_deltas.detach().numpy().copy()
    assert np.abs(after[0]).max() > 0.0
    assert np.all(after[1:] == 0.0)
    assert trainer.camera_optimizer.state[trainer.camera_deltas]["t"].tolist() == [2, 0]

    trainer.save_checkpoint(tmp_path / "m.ckpt")
    fresh = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    fresh.load_checkpoint(tmp_path / "m.ckpt")
    np.testing.assert_array_equal(fresh.camera_deltas.detach().numpy(), after)
    for k in ("m", "v", "t"):
        assert torch.equal(fresh.camera_optimizer.state[fresh.camera_deltas][k],
                           trainer.camera_optimizer.state[trainer.camera_deltas][k])


@pytest.mark.parametrize("camera", [False, True], ids=["params", "params+camera"])
@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_one_microbatch(scene, accum, camera):
    cfg = tiny_config(scene, optimize_camera=camera)
    jtr, _, ttr = _trainers(cfg)
    us, vs, u_strat, u_pdf = _jax_draws(jtr, jax.random.PRNGKey(9))

    def step(n):
        ttr.grad_accum = n
        loss, loss_dict, mse = ttr.step_grads(1, us.long(), vs.long(), u_strat, u_pdf)
        grads = {name: p.grad.clone() for name, p in ttr.neural_render.named_parameters()}
        if camera:
            grads["camera_deltas"] = ttr.camera_deltas.grad.clone()
        return loss, loss_dict, mse, grads

    one, many = step(1), step(accum)
    for a, b in [(one[0], many[0]), (one[2], many[2])] + [
            (one[1][k], many[1][k]) for k in one[1]]:
        np.testing.assert_allclose(b.item(), a.item(), rtol=1e-6, atol=1e-12)
    assert set(one[3]) == set(many[3])
    for name, g in one[3].items():
        err = (many[3][name] - g).abs().max().item()
        bar = CAMERA_ACCUM_TOL if name == "camera_deltas" else 1e-6
        assert err <= bar * max(g.abs().max().item(), 1e-12), (name, err)
    if camera:
        assert one[3]["camera_deltas"][1].abs().max() > 0


def test_grad_accum_validation_matches_jax(scene):
    cfg = tiny_config(scene, grad_accum=5)  # does not divide batch_size=16
    with pytest.raises(ValueError, match="grad_accum=5 must divide"):
        tconfig.instantiate(cfg["trainer"], global_config=cfg)
    jtr, _, ttr = _trainers(tiny_config(scene))
    with pytest.raises(ValueError) as jerr:
        make_local_grads(jtr.neural_render, jtr.loss_functions, jtr.calib, 16, 16, 16,
                         grad_accum=3)
    with pytest.raises(ValueError) as terr:
        check_grad_accum(3, 16)
    assert str(terr.value) == str(jerr.value)

    class Custom:
        key_target = "depth"

    with pytest.raises(ValueError) as jerr:
        make_local_grads(jtr.neural_render, [Custom()], jtr.calib, 16, 16, 16)
    with pytest.raises(ValueError) as terr:
        check_target_keys(["depth"])
    assert str(terr.value) == str(jerr.value)
