"""Full-state checkpoints and ``--resume`` of the port, on the CPU at test
size.

* N steps, a checkpoint, a new trainer that loads it, M more steps:
  bitwise equal to N + M steps of one trainer (parameters, both
  optimizers' state, camera deltas, iteration, the generator's state,
  the losses), with the default options and with ``optimize_camera``,
  weight decay and ``grad_accum``.
* ``scripts/run.py --resume`` on a run directory whose last checkpoint
  was lost: the same checkpoint bytes and logged losses as the
  uninterrupted run.
* ``run_train`` skips the completed epochs and still draws their camera
  permutations (``tests/training/test_resume.py``).
* Parameters that do not match, and a checkpoint that holds no full
  state, raise; a generator state of another device type seeds the
  generator from (seed, iteration).
* A full-state checkpoint of the JAX package loads into the port (its
  params, optimizer state, iteration, camera deltas and camera optimizer
  state; the generator is seeded from (seed, iteration)); a port
  checkpoint loads into the JAX package through its legacy path (params,
  optimizer state, iteration, camera deltas; its key is reset).
* An ``async_checkpoint`` save writes the bytes a synchronous save does.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.utils.msgpack import load_msgpack, packb
from tests.test_torch_train_field import FIELD, _flat_grads
from tests.test_torch_train_step import (  # noqa: F401  (scene is a fixture)
    _jax_grads,
    _trainers,
    scene,
    tiny_config,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

CAMS = (0, 1, 1, 0, 1)


def _trainer(cfg):
    return tconfig.instantiate(cfg["trainer"], global_config=cfg)


@pytest.mark.parametrize("options", [
    {},
    {"optimize_camera": True, "optimizer_weight_decay": 1e-3, "grad_accum": 2},
], ids=["default", "camera-decay-accum"])
def test_resumed_steps_equal_uninterrupted_steps(scene, tmp_path, options):
    cfg = tiny_config(scene, log_interval=2, **options)
    n = 2
    whole = _trainer(cfg)
    for cam in CAMS:
        whole.run_train_step(cam)
    whole.flush_logs()

    first = _trainer(cfg)
    for cam in CAMS[:n]:
        first.run_train_step(cam)
    first.flush_logs()
    first.save_checkpoint(tmp_path / "model.ckpt")
    resumed = _trainer(cfg)
    resumed.load_checkpoint(tmp_path / "model.ckpt")
    assert resumed.iteration == n
    for cam in CAMS[n:]:
        resumed.run_train_step(cam)
    resumed.flush_logs()

    assert packb(resumed.checkpoint_state()) == packb(whole.checkpoint_state())
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in whole.history[n:]]
    if options.get("optimize_camera"):
        deltas = whole.camera_deltas.detach().numpy()
        assert np.all(deltas[:2] != 0.0) and np.all(np.isfinite(deltas))


def _run_overrides(scene, run):
    return ["dataset=test", "trainer=test", f"dataset.dataset_dir={scene}",
            "trainer.epoch_max=1", "trainer.epoch_save_model=1", "trainer.batch_size=16",
            "trainer.chunk=64", "render.sample_coarse=8", "render.sample_fine=8",
            *[f"network.{k}={v}" for k, v in FIELD.items() if k != "skips"],
            "network.skips=[1]", f"hydra.run.dir={run}"]


def _log(run):
    return [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]


def test_run_script_resume_continues_a_run(scene, tmp_path, monkeypatch):
    """Two runs of two epochs; the second loses its epoch-1 checkpoint, as
    if killed before it, and resumes from the epoch-0 one."""
    monkeypatch.chdir(tmp_path)
    whole = trun.main(_run_overrides(scene, tmp_path / "a"))
    cut = tmp_path / "b"
    trun.main(_run_overrides(scene, cut))
    (cut / "models" / "model_00001.ckpt").unlink()
    resumed = trun.main(["--resume", str(cut)])
    assert resumed.iteration == whole.iteration == 4
    a = (tmp_path / "a" / "models" / "model_00001.ckpt").read_bytes()
    assert (cut / "models" / "model_00001.ckpt").read_bytes() == a
    # the resumed run logs epoch 1 once, with the uninterrupted run's losses
    assert [r["iteration"] for r in _log(cut)] == [0, 1, 2, 3]
    assert [r["loss"] for r in _log(cut)] == [r["loss"] for r in _log(tmp_path / "a")]
    assert (cut / "log").is_dir()


def test_resume_skips_completed_epochs(scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = _trainer(tiny_config(scene, epoch_max=3))
    frames = len(trainer.dataset)

    def stub(order):
        trainer.run_train_step = lambda cid: order.append(cid) or 0.0
        trainer.render_field_slices = lambda *a, **k: None
        trainer.render_test = lambda *a, **k: None
        trainer.save_checkpoint = lambda *a, **k: None

    full_order = []
    stub(full_order)
    trainer.run_train()
    assert len(full_order) == 4 * frames  # epochs 0..3
    resumed_order = []
    stub(resumed_order)
    trainer.iteration = 2 * frames  # as if loaded at the start of epoch 2
    trainer.run_train()
    assert resumed_order == full_order[2 * frames:]


def test_mismatched_or_partial_checkpoints_raise(scene, tmp_path):
    narrow = _trainer(tiny_config(scene))
    narrow.save_checkpoint(tmp_path / "narrow.ckpt")
    wide_cfg = tiny_config(scene)
    wide_cfg["network"]["ddf_layer_width"] = 16
    with pytest.raises(RuntimeError, match="size mismatch"):
        _trainer(wide_cfg).load_checkpoint(tmp_path / "narrow.ckpt")
    state = load_msgpack(tmp_path / "narrow.ckpt")
    del state["opt_state"]
    (tmp_path / "params_only.ckpt").write_bytes(packb(state))
    with pytest.raises(ValueError, match="opt_state"):
        narrow.load_checkpoint(tmp_path / "params_only.ckpt")


def test_generator_state_of_another_device_type_seeds_the_generator(scene, tmp_path, capsys):
    trainer = _trainer(tiny_config(scene))
    trainer.run_train_step(0)
    state = trainer.checkpoint_state()
    state["torch_rng"]["device"] = "cuda"
    (tmp_path / "card.ckpt").write_bytes(packb(state))
    resumed = _trainer(tiny_config(scene))
    resumed.load_checkpoint(tmp_path / "card.ckpt")
    assert "holds no cpu generator state" in capsys.readouterr().out
    again = _trainer(tiny_config(scene))
    again.load_checkpoint(tmp_path / "card.ckpt")
    # seeded from (seed, iteration): the same stream on every load
    assert torch.equal(resumed.generator.get_state(), again.generator.get_state())
    assert not torch.equal(resumed.generator.get_state(), trainer.generator.get_state())


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path, capsys):
    cfg = tiny_config(scene, optimize_camera=True)
    jtr, grads_fn, ttr = _trainers(cfg)
    key = jax.random.PRNGKey(5)
    _, _, _, grads, grads_cam = _jax_grads(jtr, grads_fn, key, 1, 0)
    updates, jtr.opt_state = jtr.tx.update(grads, jtr.tx.init(jtr.params), jtr.params)
    jtr.params = optax.apply_updates(jtr.params, updates)
    cam_updates, jtr.opt_state_cam = jtr.tx_cam.update(grads_cam, jtr.opt_state_cam)
    jtr.camera_deltas = optax.apply_updates(jtr.camera_deltas, cam_updates)
    jtr.iteration = 1
    jtr.save_checkpoint(tmp_path / "jax.ckpt")

    ttr.load_checkpoint(tmp_path / "jax.ckpt")
    assert "seeded the generator from (seed, iteration)" in capsys.readouterr().out
    assert ttr.iteration == 1
    want = _flat_grads(jtr.params)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name], err_msg=name)
        state = ttr.optimizer.state[p]
        assert float(state["step"]) == 1.0
    adam = jtr.opt_state[0]
    mu, nu = _flat_grads(adam.mu), _flat_grads(adam.nu)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_array_equal(ttr.optimizer.state[p]["exp_avg"].numpy(), mu[name])
        np.testing.assert_array_equal(ttr.optimizer.state[p]["exp_avg_sq"].numpy(), nu[name])
    np.testing.assert_array_equal(ttr.camera_deltas.detach().numpy(),
                                  np.asarray(jtr.camera_deltas))
    assert np.abs(ttr.camera_deltas.detach().numpy()[1]).max() > 0
    cam_state = ttr.camera_optimizer.state[ttr.camera_deltas]
    for k in ("m", "v", "t"):
        np.testing.assert_array_equal(cam_state[k].numpy(), np.asarray(getattr(
            jtr.opt_state_cam, k)))
    ttr.run_train_step(0)  # and training goes on from there
    assert np.isfinite(ttr.history[-1]["loss"])


def test_port_checkpoint_loads_in_the_jax_package(scene, tmp_path, capsys):
    cfg = tiny_config(scene)
    ttr = _trainer(cfg)
    for cam in (0, 1, 0):
        ttr.run_train_step(cam)
    ttr.save_checkpoint(tmp_path / "port.ckpt")
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    jtr.load_checkpoint(tmp_path / "port.ckpt")
    out = capsys.readouterr().out
    assert "restored ['params', 'opt_state', 'iteration', 'camera_deltas']" in out
    assert "reset to fresh: ['key', 'opt_state_cam']" in out
    assert jtr.iteration == 3
    want = {k: v.detach().numpy() for k, v in ttr.neural_render.state_dict().items()}
    for name, value in _flat_grads(jtr.params).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)
    adam = jtr.opt_state[0]
    assert int(adam.count) == 3 and int(jtr.opt_state[1].count) == 3
    mu = _flat_grads(adam.mu)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_array_equal(mu[name], ttr.optimizer.state[p]["exp_avg"].numpy())
    # the restored optimizer state steps on in optax
    updates, _ = jtr.tx.update(jax.tree_util.tree_map(jnp.zeros_like, jtr.params),
                               jtr.opt_state, jtr.params)
    assert all(np.isfinite(np.asarray(u)).all() for u in jax.tree_util.tree_leaves(updates))


def test_async_checkpoint_writes_the_synchronous_bytes(scene, tmp_path):
    sync = _trainer(tiny_config(scene))
    asyn = _trainer(tiny_config(scene, async_checkpoint=True))
    for tr in (sync, asyn):
        tr.run_train_step(1)
    sync.save_checkpoint(tmp_path / "sync.ckpt")
    asyn.save_checkpoint(tmp_path / "async.ckpt")
    asyn.run_train_step(0)  # training goes on while the write is pending
    asyn.finalize_checkpoints()
    assert (tmp_path / "async.ckpt").read_bytes() == (tmp_path / "sync.ckpt").read_bytes()
    state = params_from_jax(load_msgpack(tmp_path / "async.ckpt")["params"])
    assert not torch.equal(state["network_fine.layers_ddf.0.w"],
                           asyn.neural_render.network_fine.layers_ddf[0].w.detach())
