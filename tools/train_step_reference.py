"""Reference numbers of one NeDDF train step, computed with the JAX package.

The constants that ``chip_smoke.py`` holds the PyTorch port's train step
against: one step of ``pretrained/machine_neddf`` (its ``.hydra`` config
on ``data/machine``, params from ``models/model_01000.ckpt``, iteration
100,000, camera 0) in float32 through the JAX package's jnp field path
(``network.fused=off``), on the pixel and sample draws of
``chip_smoke.py::machine_step_draws``. Prints one JSON object: the loss,
the colour mse, the loss dict and the L2 norm of every parameter's
gradient, keyed by the PyTorch port's parameter names; the gradient of
camera 0's pose delta (6 numbers, ``camera_grad``) and how far it moves,
by norm relative to its own, when the delta's translation is shifted by
+-``chip_smoke.py::FAMILY_SHIFT[3:]`` (``camera_grad_spread``). The
rotation stays 0: at |w| ~ 1e-7 the reference's V coefficients, (theta -
sin theta) / theta^3 and (1 - cos theta) / theta^2, are f32 noise, and
with a translation beside them their derivative moves the rotation part
of the gradient by ~20% (a shift of the translation alone or of the
rotation alone moves it by ~2e-5).

Usage (CPU, about 2 GB of memory and a minute):
    JAX_PLATFORMS=cpu python tools/train_step_reference.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import neddf_tpu.ops.sampling as jsampling  # noqa: E402
from chip_smoke import (  # noqa: E402
    FAMILY_SHIFT,
    MACHINE_CAMERA,
    MACHINE_ITERATION,
    machine_step_draws,
)
from neddf_tpu import config as config_lib  # noqa: E402
from neddf_tpu.geometry.se3 import camera_pose  # noqa: E402
from neddf_tpu.training.step import construct_targets  # noqa: E402

RUN = REPO / "pretrained" / "machine_neddf"


def main() -> None:
    cfg = config_lib.load_snapshot(RUN)
    cfg["dataset"]["dataset_dir"] = str(REPO / cfg["dataset"]["dataset_dir"])
    cfg["network"].update({"compute_dtype": "float32", "fused": "off"})
    cfg["trainer"].update({"device": "cpu", "mesh": None})
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.load_pretrained_model(RUN / "models" / "model_01000.ckpt")
    render = trainer.neural_render
    us, vs, u_strat, u_pdf = machine_step_draws(
        trainer.dataset.image_width, trainer.dataset.image_height,
        render.sample_coarse + 1, render.sample_fine + 1)

    # the renderer draws its uniforms per pixel from a key; hand it ours
    def uniforms(key, pixel_ids, n, dtype=jnp.float32):
        del key, pixel_ids, dtype
        return jnp.asarray({u_strat.shape[1]: u_strat, u_pdf.shape[1]: u_pdf}[n])

    jsampling._per_ray_uniform = uniforms
    cam = MACHINE_CAMERA
    targets = construct_targets(
        trainer.loss_types, trainer.rgb_images[cam], trainer.mask_images[cam],
        jnp.asarray(us), jnp.asarray(vs))
    uv = jnp.stack([jnp.asarray(us), jnp.asarray(vs)], axis=1)

    def loss_fn(params, delta):
        pose_r, pose_t = camera_pose(trainer.camera_initials[cam], delta)
        out = render.render_rays(params, trainer.calib, pose_r, pose_t, uv,
                                 jax.random.PRNGKey(0), MACHINE_ITERATION)
        loss_dict = {}
        for fn in trainer.loss_functions:
            loss_dict.update(fn(out, targets))
        mse = jnp.mean(jnp.square(out["color"] - targets["color"]))
        return sum(loss_dict.values()), (loss_dict, mse)

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    delta = trainer.camera_deltas[cam]
    (loss, (loss_dict, mse)), (grads, grad_cam) = step(trainer.params, delta)
    norms = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        norms[name] = float(jnp.linalg.norm(g))
    grad_cam = np.asarray(grad_cam, np.float64)
    shift = jnp.asarray((0.0, 0.0, 0.0, *FAMILY_SHIFT[3:]), jnp.float32)
    moved = [np.asarray(step(trainer.params, delta + sign * shift)[1][1], np.float64)
             for sign in (1.0, -1.0)]
    spread = max(np.linalg.norm(m - grad_cam) for m in moved) / np.linalg.norm(grad_cam)
    print(json.dumps({"loss": float(loss), "mse": float(mse),
                      "losses": {k: float(v) for k, v in loss_dict.items()},
                      "grad_norms": norms, "camera_grad": grad_cam.tolist(),
                      "camera_grad_spread": float(spread)}, indent=1))


if __name__ == "__main__":
    main()
