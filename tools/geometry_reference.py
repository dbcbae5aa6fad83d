"""Reference volumes of ``pretrained/machine_neddf``, computed with the JAX package.

The numbers that ``chip_smoke.py`` phase 18a holds the PyTorch port's
``voxelize`` against: ``neddf_tpu.fields.base.voxelize`` of the fine
network at epoch 1000 over a 16^3 lattice of [-1.1, 1.1]^3, in float32
through the JAX package's jnp field path (``network.fused=off``), for the
``distance`` and ``density`` fields. Writes them to
``tools/geometry_reference.npz`` (``distance``, ``density``: float32 [16,
16, 16]) and prints each volume's largest magnitude and sum.

Usage (CPU, a few seconds):
    JAX_PLATFORMS=cpu python tools/geometry_reference.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from neddf_tpu import config as config_lib  # noqa: E402
from neddf_tpu.fields.base import voxelize  # noqa: E402
from neddf_tpu.training.checkpoint import load_pytree  # noqa: E402

RUN = REPO / "pretrained" / "machine_neddf"
RESOLUTION = 16
OUT = REPO / "tools" / "geometry_reference.npz"


def main() -> None:
    cfg = config_lib.load_snapshot(RUN)
    field = config_lib.instantiate(
        dict(cfg["network"], compute_dtype="float32", fused="off"))
    raw = load_pytree(RUN / "models" / "model_01000.ckpt", None)
    raw = raw["params"] if "params" in raw else raw
    params = serialization.from_state_dict(field.init(jax.random.PRNGKey(0)),
                                           raw["network_fine"])
    params = jax.tree_util.tree_map(jnp.asarray, params)
    volumes = {name: voxelize(field, params, name, cube_resolution=RESOLUTION,
                              chunk=RESOLUTION**3)
               for name in ("distance", "density")}
    np.savez(OUT, **volumes)
    for name, v in volumes.items():
        print(f"{name}: max |v| {np.abs(v).max():.9g}, sum {v.astype(np.float64).sum():.9g}")
    print(f"-> {OUT.relative_to(REPO)}")


if __name__ == "__main__":
    main()
