"""The port's ``fields/base.py::voxelize`` against the JAX package's on the
CPU at 12^3, f32 on both sides (the JAX fields on their jnp path,
``fused="off"``).

* ``pretrained/machine_neddf`` (epoch 1000, full width, its
  ``compute_dtype`` overridden to float32): ``distance`` and ``density``
  (the eval route), ``fields_penalty`` (the training route);
* a seeded narrow NeuS (``sdf``) and NeRF (``density``).

Tolerance: each volume within 1e-5 of its largest magnitude (f32 sums in
another order; the density, whose 1/D amplifies the trunk's rounding,
sits at ~2e-6 of it at 12^3 and 16^3). The lattice order is checked on
its own, exactly: the port's volume of a field that returns its sample
positions is the JAX package's ``np.meshgrid`` lattice.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from neddf_tpu import config as jconfig
from neddf_tpu.fields.base import voxelize as jvoxelize
from neddf_tpu.fields.nerf import NeRF as JNeRF
from neddf_tpu.fields.neus import NeuS as JNeuS
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.fields.base import Schedule, voxelize
from neddf_tpu_torch.fields.nerf import NeRF
from neddf_tpu_torch.fields.neus import NeuS
from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
RUN = REPO / "pretrained" / "machine_neddf"
RES = 12
TOL = 1e-5


def _close(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert got.shape == want.shape == (RES, RES, RES) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all(), name
    err = np.abs(got - want).max()
    assert err <= TOL * scale, (name, err, scale)


@pytest.fixture(scope="module")
def machine_fields():
    network = dict(tconfig.load_snapshot(RUN)["network"], compute_dtype="float32")
    raw = load_msgpack_params(RUN / "models" / "model_01000.ckpt")["network_fine"]
    jfield = jconfig.instantiate(dict(network, fused="off"))
    params = serialization.from_state_dict(jfield.init(jax.random.PRNGKey(0)), raw)
    field = tconfig.instantiate(network)
    field.load_state_dict(params_from_jax(raw), strict=True)
    return jfield, jax.tree_util.tree_map(jnp.asarray, params), field


@pytest.mark.parametrize("name", ["distance", "density", "fields_penalty"])
def test_machine_neddf_volume_matches_jax(machine_fields, name):
    jfield, params, field = machine_fields
    want = jvoxelize(jfield, params, name, cube_resolution=RES, chunk=RES**3)
    # ragged chunks on the port's side
    _close(voxelize(field, name, cube_resolution=RES, chunk=500), want, name)


NERF = dict(embed_pos_rank=6, embed_dir_rank=2, layer_count=4, layer_width=32, skips=(1,),
            activation_type="ReLU", density_activation_type="ReLU", compute_dtype="float32")
NEUS = dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=4, sdf_layer_width=32,
            col_layer_count=3, col_layer_width=32, skips=(1,), activation_type="ReLU",
            init_variance=0.3)


@pytest.mark.parametrize("family,name", [("NeuS", "sdf"), ("NeRF", "density")])
def test_seeded_family_volume_matches_jax(family, name):
    jcls, cls, kwargs = {"NeuS": (JNeuS, NeuS, NEUS), "NeRF": (JNeRF, NeRF, NERF)}[family]
    jfield = jcls(**kwargs, fused="off")
    params = jfield.init(jax.random.PRNGKey(11))
    field = cls(**kwargs)
    field.load_state_dict(params_from_jax(params), strict=True)
    want = jvoxelize(jfield, params, name, cube_range=0.9, cube_resolution=RES, chunk=RES**3)
    _close(voxelize(field, name, cube_range=0.9, cube_resolution=RES), want, name)


class _Probe(torch.nn.Module):
    """A field whose outputs are its sample positions and need_aux."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.need_aux = []

    def schedule(self, iteration):
        return Schedule(1e9, 1.0, 2.0)

    def forward(self, sampling, sched, *, need_aux=False):
        self.need_aux.append(need_aux)
        pos = sampling.sample_pos
        return {"x": pos[..., 0], "y": pos[..., 1], "z": pos[..., 2],
                "fields_penalty": pos[..., 0] * 0}


def test_lattice_order_and_route_match_jax():
    ids = np.linspace(-1.1, 1.1, 7)
    zs, ys, xs = np.meshgrid(ids, ids, ids)
    probe = _Probe()
    for axis, want in (("x", xs), ("y", ys), ("z", zs)):
        got = voxelize(probe, axis, cube_resolution=7, chunk=100)
        np.testing.assert_array_equal(got, want.astype(np.float32))
    assert set(probe.need_aux) == {False}
    voxelize(probe, "fields_penalty", cube_resolution=7)
    assert probe.need_aux[-1] is True
