"""Reference numbers of the forward-facing path (LLFF captures, NDC rays),
computed with the JAX package on the CPU.

Writes ``tools/llff_reference.npz``, which ``chip_smoke.py`` phase 19
holds the PyTorch port against:

* ``images``, ``poses_bounds``: the decoded frames (RGBA, as the PNG
  files hold them) and ``poses_bounds.npy`` of the JAX package's
  ``generate_forward_facing_dataset`` at ``chip_smoke.LLFF_SMALL``
  (9 images of 64x64);
* for ``recenter`` false and true (suffix ``_0`` / ``_1``): the JAX
  ``LLFFDataset``'s ``camera_params`` of the train and test splits
  (``cam_train_*``, ``cam_test_*``), its ``calib_*``, ``near_*``,
  ``far_*`` and the test split's image ids (``test_ids_*``);
* ``step``: a JSON object with one full-width f32 train step of each
  configuration of ``chip_smoke.LLFF_OVERRIDES`` (NeDDF and NeRF, NDC,
  ``render.ndc_near`` from ``chip_smoke.llff_ndc_near``) on the
  generator's capture at ``chip_smoke.LLFF_CAPTURE`` (24 images of
  400x400), through the JAX package's jnp field path
  (``network.fused=off``), from the seeded parameters of
  ``chip_smoke.family_params``, at iteration 0 on train camera
  ``LLFF_CAMERA`` with the pixel and sample draws of
  ``machine_step_draws(..., seed=LLFF_DRAW_SEED, batch=LLFF_BATCH)``:
  the loss, the colour mse, the loss dict, every parameter's gradient
  norm (by the port's parameter names) and ``spread``, how far each of
  those numbers moves, relative, under the larger of two perturbations
  of the size by which two f32 implementations differ:
  ``spread_camera``, a camera shift of +-``FAMILY_SHIFT`` (an se3 delta
  of about 1e-7), and ``spread_transmittance``, each ray's final
  transmittance moved by one f32 step (a factor 1 +- 2^-24). The mask
  loss's gradient 1 / (1 - T) amplifies the second where a ray is nearly
  transparent, as the coarse rays of a freshly initialised NeRF in the
  NDC window [0, 1] are: there the exp of two implementations, one f32
  step apart, moves the coarse network's gradient norms by about 1%.

Usage (CPU, a few minutes and a few GB of memory):
    JAX_PLATFORMS=cpu python tools/llff_step_reference.py [--capture DIR]

``--capture DIR`` keeps the 400x400 capture there (default: a temporary
directory).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
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
import neddf_tpu.render.renderer as jrenderer  # noqa: E402
from chip_smoke import (  # noqa: E402
    FAMILY_SHIFT,
    LLFF_BATCH,
    LLFF_CAMERA,
    LLFF_CAPTURE,
    LLFF_DRAW_SEED,
    LLFF_OVERRIDES,
    LLFF_REF,
    LLFF_SMALL,
    family_params,
    llff_overrides,
    machine_step_draws,
)
from neddf_tpu import config as config_lib  # noqa: E402
from neddf_tpu.data.llff import LLFFDataset, generate_forward_facing_dataset  # noqa: E402
from neddf_tpu.geometry.se3 import camera_pose  # noqa: E402
from neddf_tpu.training.step import construct_targets  # noqa: E402
from neddf_tpu_torch.training.checkpoint import params_from_jax, params_to_jax  # noqa: E402
from neddf_tpu_torch.utils.png import read_png  # noqa: E402


def capture_arrays(root: Path) -> dict:
    """The small capture's files and the JAX LLFFDataset's cameras."""
    scene = generate_forward_facing_dataset(root / "small", **LLFF_SMALL)
    out = {"images": np.stack([read_png(p) for p in sorted((scene / "images").iterdir())]),
           "poses_bounds": np.load(scene / "poses_bounds.npy")}
    for rc in (0, 1):
        train = LLFFDataset(str(scene), "train", factor=1, recenter=bool(rc))
        test = LLFFDataset(str(scene), "test", factor=1, recenter=bool(rc))
        out.update({f"cam_train_{rc}": train.camera_params, f"cam_test_{rc}": test.camera_params,
                    f"calib_{rc}": train.camera_calib_params, f"near_{rc}": train.near,
                    f"far_{rc}": train.far,
                    f"test_ids_{rc}": np.flatnonzero(np.arange(LLFF_SMALL["n_images"])
                                                     % test.hold_every == 0)})
    return out


def llff_step(family: str, capture: Path) -> dict:
    cfg = config_lib.compose(REPO / "config", overrides=llff_overrides(family, capture))
    cfg["network"].update({"fused": "off", "compute_dtype": "float32"})
    cfg["trainer"].update({"device": "cpu", "mesh": None})
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    shapes = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.device_get(trainer.params)).items()}
    seeded = params_to_jax({k: torch.from_numpy(v) for k, v in family_params(shapes).items()})
    params = serialization.from_state_dict(trainer.params, seeded)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    render = trainer.neural_render
    assert render.ndc and render.dist_far == 1.0
    us, vs, u_strat, u_pdf = machine_step_draws(
        trainer.dataset.image_width, trainer.dataset.image_height,
        render.sample_coarse + 1, render.sample_fine + 1, seed=LLFF_DRAW_SEED,
        batch=LLFF_BATCH)

    # the renderer draws its uniforms per pixel from a key; hand it ours
    def uniforms(key, pixel_ids, n, dtype=jnp.float32):
        del key, pixel_ids, dtype
        return jnp.asarray({u_strat.shape[1]: u_strat, u_pdf.shape[1]: u_pdf}[n])

    jsampling._per_ray_uniform = uniforms
    cam = LLFF_CAMERA
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

    integrate = jrenderer.integrate_volume_render

    def numbers(delta, t_scale=1.0):
        # each call traces its own program: t_scale is baked in
        def nudged(*args, **kwargs):
            out = integrate(*args, **kwargs)
            return {**out, "transmittance": out["transmittance"] * t_scale}

        jrenderer.integrate_volume_render = nudged
        try:
            step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
            (loss, (loss_dict, mse)), grads = step(params, jnp.asarray(delta, jnp.float32))
        finally:
            jrenderer.integrate_volume_render = integrate
        norms = {name: float(g.norm()) for name, g in params_from_jax(
            jax.device_get(grads)).items()}
        return {"loss": float(loss), "mse": float(mse),
                "losses": {k: float(v) for k, v in loss_dict.items()},
                "grad_norms": dict(sorted(norms.items()))}

    delta = trainer.camera_deltas[cam]
    out = numbers(delta)
    shift = jnp.asarray(FAMILY_SHIFT, jnp.float32)
    perturbed = {
        "spread_camera": [numbers(delta + sign * shift) for sign in (1.0, -1.0)],
        "spread_transmittance": [numbers(delta, 1.0 + sign * 2.0**-24) for sign in (1.0, -1.0)],
    }

    def rel(moved, pick):
        return max(abs(pick(out) - pick(m)) / max(abs(pick(out)), 1e-30) for m in moved)

    for name, moved in perturbed.items():
        out[name] = {
            **{k: rel(moved, lambda d, k=k: d[k]) for k in ("loss", "mse")},
            **{f"loss {k}": rel(moved, lambda d, k=k: d["losses"][k]) for k in out["losses"]},
            **{k: rel(moved, lambda d, k=k: d["grad_norms"][k]) for k in out["grad_norms"]},
        }
    out["spread"] = {k: max(out["spread_camera"][k], out["spread_transmittance"][k])
                     for k in out["spread_camera"]}
    out["ndc_near"] = render.ndc_near
    print(f"{family}: loss {out['loss']:.8g}, largest spread under the camera shift "
          f"{max(out['spread_camera'].values()):.3g}, under the transmittance step "
          f"{max(out['spread_transmittance'].values()):.3g}", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--capture", type=Path, default=None)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        arrays = capture_arrays(Path(tmp))
        capture = args.capture or Path(tmp) / "capture"
        generate_forward_facing_dataset(capture, **LLFF_CAPTURE)
        steps = {family: llff_step(family, capture) for family in LLFF_OVERRIDES}
    np.savez_compressed(LLFF_REF, step=np.array(json.dumps(steps)), **arrays)
    print(f"wrote {LLFF_REF} ({LLFF_REF.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
