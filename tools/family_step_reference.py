"""Reference numbers of one NeRF and one NeuS train step, computed with the
JAX package.

The constants that ``chip_smoke.py`` holds the PyTorch port's NeRF and
NeuS train steps against (``FAMILY_STEP``): for each family, its shipped
configuration (``chip_smoke.py::FAMILY_OVERRIDES``) on
``data/bunny_smoke``, at full width, in float32 through the JAX
package's jnp field path (``network.fused=off``; NeuS's normals by
``jax.grad``), with the seeded parameters of
``chip_smoke.py::family_params``, one step at iteration 0 on camera
``FAMILY_CAMERA`` with the pixel and sample draws of
``machine_step_draws(..., seed=FAMILY_DRAW_SEED, batch=FAMILY_BATCH)``.
Prints one JSON object per family: the loss, the colour mse, the loss
dict and the L2 norm of every parameter's gradient, keyed by the PyTorch
port's parameter names, and ``spread``: how far each of those numbers
moves, relative, when the camera is shifted by +-``FAMILY_SHIFT`` (an se3
delta of about 1e-7, the size of the f32 rounding by which two
implementations' rays differ). NeRF's top PE band is sin(2^9 x), so its
early layers' gradients move by about 1% under such a shift. Also the
gradient of the camera's pose delta (``camera_grad``) and its
``camera_grad_spread``, by norm relative to its own, under a shift of
the translation part alone (see ``tools/train_step_reference.py``).

Usage (CPU, about 2 GB of memory and a minute or two):
    JAX_PLATFORMS=cpu python tools/family_step_reference.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import serialization  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import neddf_tpu.ops.sampling as jsampling  # noqa: E402
from chip_smoke import (  # noqa: E402
    FAMILY_BATCH,
    FAMILY_CAMERA,
    FAMILY_DRAW_SEED,
    FAMILY_OVERRIDES,
    FAMILY_SHIFT,
    family_params,
    machine_step_draws,
)
from neddf_tpu import config as config_lib  # noqa: E402
from neddf_tpu.geometry.se3 import camera_pose  # noqa: E402
from neddf_tpu.training.step import construct_targets  # noqa: E402
from neddf_tpu_torch.training.checkpoint import params_from_jax, params_to_jax  # noqa: E402


def family_step(family: str) -> dict:
    cfg = config_lib.compose(REPO / "config", overrides=FAMILY_OVERRIDES[family])
    cfg["dataset"]["dataset_dir"] = str(REPO / cfg["dataset"]["dataset_dir"])
    cfg["network"].update({"fused": "off"})
    if "compute_dtype" in cfg["network"]:
        cfg["network"]["compute_dtype"] = "float32"
    cfg["trainer"].update({"device": "cpu", "mesh": None})
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    shapes = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.device_get(trainer.params)).items()}
    seeded = params_to_jax({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
    params = serialization.from_state_dict(trainer.params, seeded)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    render = trainer.neural_render
    us, vs, u_strat, u_pdf = machine_step_draws(
        trainer.dataset.image_width, trainer.dataset.image_height,
        render.sample_coarse + 1, render.sample_fine + 1, seed=FAMILY_DRAW_SEED,
        batch=FAMILY_BATCH)

    # the renderer draws its uniforms per pixel from a key; hand it ours
    def uniforms(key, pixel_ids, n, dtype=jnp.float32):
        del key, pixel_ids, dtype
        return jnp.asarray({u_strat.shape[1]: u_strat, u_pdf.shape[1]: u_pdf}[n])

    jsampling._per_ray_uniform = uniforms
    cam = FAMILY_CAMERA
    targets = construct_targets(
        trainer.loss_types, trainer.rgb_images[cam], trainer.mask_images[cam],
        jnp.asarray(us), jnp.asarray(vs))
    uv = jnp.stack([jnp.asarray(us), jnp.asarray(vs)], axis=1)

    def loss_fn(p, delta):
        pose_r, pose_t = camera_pose(trainer.camera_initials[cam], delta)
        out = render.render_rays(p, trainer.calib, pose_r, pose_t, uv,
                                 jax.random.PRNGKey(0), 0)
        loss_dict = {}
        for fn in trainer.loss_functions:
            loss_dict.update(fn(out, targets))
        mse = jnp.mean(jnp.square(out["color"] - targets["color"]))
        return sum(loss_dict.values()), (loss_dict, mse)

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))

    def numbers(delta):
        (loss, (loss_dict, mse)), (grads, grad_cam) = step(params,
                                                           jnp.asarray(delta, jnp.float32))
        norms = {name: float(g.norm()) for name, g in params_from_jax(
            jax.device_get(grads)).items()}
        return {"loss": float(loss), "mse": float(mse),
                "losses": {k: float(v) for k, v in loss_dict.items()},
                "grad_norms": dict(sorted(norms.items())),
                "camera_grad": np.asarray(grad_cam, np.float64).tolist()}

    out = numbers(trainer.camera_deltas[cam])
    shift = jnp.asarray(FAMILY_SHIFT, jnp.float32)
    moved = [numbers(trainer.camera_deltas[cam] + sign * shift) for sign in (1.0, -1.0)]

    def rel(key, pick):
        return max(abs(pick(out) - pick(m)) / max(abs(pick(out)), 1e-30) for m in moved)

    cam_shift = jnp.asarray((0.0, 0.0, 0.0, *FAMILY_SHIFT[3:]), jnp.float32)
    grad_cam = np.asarray(out["camera_grad"])
    out["camera_grad_spread"] = max(
        float(np.linalg.norm(np.asarray(numbers(trainer.camera_deltas[cam] + sign * cam_shift)[
            "camera_grad"]) - grad_cam) / np.linalg.norm(grad_cam)) for sign in (1.0, -1.0))
    out["spread"] = {
        **{k: rel(k, lambda d, k=k: d[k]) for k in ("loss", "mse")},
        **{f"loss {k}": rel(k, lambda d, k=k: d["losses"][k]) for k in out["losses"]},
        **{k: rel(k, lambda d, k=k: d["grad_norms"][k]) for k in out["grad_norms"]},
    }
    return out


def main() -> None:
    print(json.dumps({family: family_step(family) for family in FAMILY_OVERRIDES}, indent=1))


if __name__ == "__main__":
    main()
