"""The reference-layout ``.pth`` in the port against the JAX package's
``import_torch_state_dict`` / ``export_torch_state_dict``, on the CPU.

For NeDDF (one shared network), NeRF (its own coarse network) and NeuS
at narrow widths:

* a ``.pth`` written by the JAX exporter loads into the port
  (``checkpoint.state_dict_from_pth``) bitwise equal to the JAX
  parameters (``params_from_jax``);
* the port's ``export_pth`` writes the JAX exporter's file: the same
  keys, shapes, dtypes and values;
* a missing or an extra key raises;
* ``python -m neddf_tpu_torch.scripts.export_pth`` on a run directory
  writes ``models/model_00000.pth``, which the port's
  ``load_pretrained_model`` and the JAX importer read back equal to the
  checkpoint.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neddf_tpu.render import NeRFRender as JaxRender
from neddf_tpu.training.checkpoint import export_torch_state_dict, import_torch_state_dict
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.scripts import export_pth as texport
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.training.checkpoint import (
    export_pth,
    load_msgpack_params,
    params_from_jax,
    state_dict_from_pth,
)
from tests.test_torch_train_field import FIELD
from tests.test_torch_train_step import scene  # noqa: F401  (a fixture)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
NETWORKS = {
    "neddf": ("network=neddf", {**FIELD, "skips": [1]}, False),
    "nerf": ("network=nerf", dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=4,
                                  layer_width=16, skips=[1]), True),
    "neus": ("network=neus", dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=4,
                                  sdf_layer_width=16, col_layer_count=3, col_layer_width=16,
                                  skips=[1]), False),
}


def _renderers(family):
    group, narrow, coarse = NETWORKS[family]
    net = tconfig.compose(REPO / "config", overrides=[group])["network"]
    net.update(narrow)
    jr = JaxRender(network_config=net, sample_coarse=8, sample_fine=8,
                   use_coarse_network=coarse)
    tr = NeRFRender(network_config=net, sample_coarse=8, sample_fine=8,
                    use_coarse_network=coarse, generator=torch.Generator().manual_seed(0))
    return jr, jr.init(jax.random.PRNGKey(1)), tr


@pytest.mark.parametrize("family", list(NETWORKS))
def test_jax_pth_loads_bitwise_and_the_port_writes_the_same_file(family, tmp_path):
    jr, params, tr = _renderers(family)
    jax_pth = tmp_path / "jax.pth"
    export_torch_state_dict(params, jr, jax_pth)
    want = params_from_jax(jax.device_get(params))
    got = state_dict_from_pth(jax_pth, tr)
    assert set(got) == set(want) == set(tr.state_dict())
    for name in want:
        assert torch.equal(got[name], want[name]), name
    tr.load_state_dict(got, strict=True)

    port_pth = tmp_path / "port.pth"
    export_pth(tr, port_pth)
    mine = torch.load(port_pth, weights_only=True)
    theirs = torch.load(jax_pth, weights_only=True)
    assert set(mine) == set(theirs)
    for key in theirs:
        assert mine[key].dtype == theirs[key].dtype, key
        if key.endswith(".variance"):
            # the JAX exporter's np.ascontiguousarray makes NeuS's 0-d
            # variance [1]; the port keeps the module's 0-d shape
            assert mine[key].shape == () and theirs[key].shape == (1,)
            assert torch.equal(mine[key].reshape(1), theirs[key])
            continue
        assert mine[key].shape == theirs[key].shape, key
        assert torch.equal(mine[key], theirs[key]), key
    assert any(k.startswith("network_coarse.") for k in mine)  # shared: under both prefixes


def test_a_missing_or_extra_key_raises(tmp_path):
    jr, params, tr = _renderers("neddf")
    export_torch_state_dict(params, jr, tmp_path / "m.pth")
    sd = torch.load(tmp_path / "m.pth", weights_only=True)
    missing = dict(sd)
    del missing["network_coarse.layer_col_out.bias"]
    torch.save(missing, tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="missing \\['network_coarse.layer_col_out.bias'\\]"):
        state_dict_from_pth(tmp_path / "missing.pth", tr)
    torch.save({**sd, "network_fine.extra.weight": torch.zeros(1)}, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="extra \\['network_fine.extra.weight'\\]"):
        state_dict_from_pth(tmp_path / "extra.pth", tr)


def test_export_pth_cli_on_a_run_directory(scene, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    trun.main(["dataset=test", "trainer=test", f"dataset.dataset_dir={scene}",
               "trainer.epoch_max=0", "trainer.batch_size=16", "trainer.chunk=64",
               "render.sample_coarse=8", "render.sample_fine=8",
               *[f"network.{k}={v}" for k, v in FIELD.items() if k != "skips"],
               "network.skips=[1]", f"hydra.run.dir={run}"])
    out = texport.main([str(run)])
    assert out == run / "models" / "model_00000.pth" and out.exists()
    want = params_from_jax(load_msgpack_params(run / "models" / "model_00000.ckpt"))
    cfg = tconfig.load_snapshot(run)
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    trainer.load_pretrained_model(out)
    for name, value in trainer.neural_render.state_dict().items():
        assert torch.equal(value, want[name]), name
    jr, _, _ = _renderers("neddf")
    for name, value in params_from_jax(jax.device_get(import_torch_state_dict(out, jr))).items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
