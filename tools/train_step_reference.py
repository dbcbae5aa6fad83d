"""Reference numbers of one NeDDF train step, computed with the JAX package.

The constants that ``chip_smoke.py`` holds the PyTorch port's train step
against: one step of ``pretrained/machine_neddf`` (its ``.hydra`` config
on ``data/machine``, params from ``models/model_01000.ckpt``, iteration
100,000, camera 0) in float32 through the JAX package's jnp field path
(``network.fused=off``), on the pixel and sample draws of
``chip_smoke.py::machine_step_draws``. Prints one JSON object: the loss,
the colour mse, the loss dict and the L2 norm of every parameter's
gradient, keyed by the PyTorch port's parameter names.

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
    pose_r, pose_t = camera_pose(trainer.camera_initials[cam],
                                 trainer.camera_deltas[cam])

    def loss_fn(params):
        out = render.render_rays(params, trainer.calib, pose_r, pose_t, uv,
                                 jax.random.PRNGKey(0), MACHINE_ITERATION)
        loss_dict = {}
        for fn in trainer.loss_functions:
            loss_dict.update(fn(out, targets))
        mse = jnp.mean(jnp.square(out["color"] - targets["color"]))
        return sum(loss_dict.values()), (loss_dict, mse)

    (loss, (loss_dict, mse)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(trainer.params)
    norms = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        norms[name] = float(jnp.linalg.norm(g))
    print(json.dumps({"loss": float(loss), "mse": float(mse),
                      "losses": {k: float(v) for k, v in loss_dict.items()},
                      "grad_norms": norms}, indent=1))


if __name__ == "__main__":
    main()
