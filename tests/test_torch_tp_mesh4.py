"""The port's data and tensor parallelism together (``trainer.mesh`` data 2 x
model 2) on the CPU, over 4 gloo ranks, against the JAX package's 2 x 2
mesh: one NeDDF step with ``optimize_camera`` on the JAX package's draws
and weights. The camera-delta gradient is where the two axes meet (each
model rank's backward sees the paths through its own weight columns,
scaled by ``model``; the port averages it over every rank, the JAX
package pmeans it over ``data`` and ``model``), so it is held to the JAX
package's own bar for it (rtol 1e-3, atol 1e-9,
``tests/parallel/test_mesh_trainer.py:174-189``), the loss to 1e-4
relative (``:183``); and to the port's single-process step likewise.

One launch of the ranks (``tests/torch_parallel_ranks.py`` task
``tp_camera``), started in the background while the JAX reference
compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu.parallel.mesh import make_mesh
from neddf_tpu.parallel.mesh import make_sharded_grads as jmake_sharded_grads
from neddf_tpu.parallel.mesh import tp_renderer as jtp_renderer
from neddf_tpu.training.step import make_local_grads
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.training.checkpoint import params_from_jax
from tests.test_torch_parallel import (  # noqa: F401  (scene is a fixture)
    CAMERA,
    DELTA,
    ITERATION,
    family_config,
    scene,
    start_ranks,
)
from tests.test_torch_train_step import _jax_draws

MESH_2X2 = {"data": 2, "model": 2}


def test_2x2_camera_gradient_matches_the_jax_mesh_and_one_process(scene, tmp_path):
    key = jax.random.PRNGKey(5)
    cfg = family_config(scene, "neddf", optimize_camera=True)
    cfg["network"]["fused"] = "auto"
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    deltas = np.zeros(np.shape(jtr.camera_deltas), np.float32)
    deltas[CAMERA] = DELTA
    state = {k: v.numpy() for k, v in params_from_jax(jtr.params).items()}
    draws = [x.numpy() for x in _jax_draws(jtr, key)]
    draws[:2] = [x.astype(np.int64) for x in draws[:2]]
    case = {"cfg": {**cfg, "trainer": {**cfg["trainer"], "mesh": MESH_2X2}}, "state": state,
            "deltas": deltas, "iteration": ITERATION, "camera": CAMERA, "draws": draws}
    ranks, outputs = start_ranks("tp_camera", {"step": case}, tmp_path, world=4)
    try:
        local = make_local_grads(jtp_renderer(jtr.neural_render), jtr.loss_functions,
                                 jtr.calib, jtr.dataset.image_width,
                                 jtr.dataset.image_height, jtr.batch_size,
                                 optimize_camera=True)
        grads_fn = jax.jit(jmake_sharded_grads(make_mesh(4, model=2), local, jtr.batch_size))
        loss, _, _, _, grads_cam = grads_fn(*jax.device_get((
            jtr.params, deltas, jtr.rgb_images, jtr.mask_images, jtr.camera_initials, key,
            jnp.int32(CAMERA), jnp.int32(ITERATION))))
        ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
        ttr.neural_render.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        with torch.no_grad():
            ttr.camera_deltas.copy_(torch.from_numpy(deltas))
        ttr.iteration = ITERATION
        one_loss, _, _ = ttr.step_grads(CAMERA, *(torch.from_numpy(x) for x in draws))
        wants = {"jax 2x2": (float(loss), np.asarray(grads_cam)),
                 "one process": (one_loss.item(), ttr.camera_deltas.grad.numpy())}
        got = outputs()
    finally:
        ranks.stop()
    assert np.abs(wants["jax 2x2"][1][CAMERA]).max() > 0.0
    for rank, mine in enumerate(got):
        for what, (want_loss, want_cam) in wants.items():
            assert mine["loss"] == pytest.approx(want_loss, rel=1e-4), (rank, what)
            np.testing.assert_allclose(mine["camera"], want_cam, rtol=1e-3, atol=1e-9,
                                       err_msg=f"rank {rank} vs {what}")
        np.testing.assert_array_equal(mine["camera"], got[0]["camera"])
