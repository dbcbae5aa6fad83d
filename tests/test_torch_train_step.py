"""One train step of the PyTorch port against the JAX package on the CPU,
at narrow widths on a generated scene: the loss, loss dict and every
gradient on the JAX package's own pixel and sample draws, three Adam
steps against optax (and the per-epoch staircase learning rate), and
``scripts/run.py`` end to end with its checkpoint loaded by both
packages and its field slice in the JET colour map.

Tolerances (f32 on both sides): losses at rtol 1e-5, every parameter
gradient within 1e-4 of its largest magnitude, parameters after three
Adam steps within 1e-6 (a step moves a weight by about lr = 5e-4).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu.data.synthetic import generate_sphere_dataset
from neddf_tpu.ops.sampling import _per_ray_uniform
from neddf_tpu.training.step import draw_pixel_batch as jdraw_pixel_batch
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.scripts.run_eval import evaluate
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.utils.colormap import JET_BGR, apply_jet
from neddf_tpu_torch.utils.png import read_png
from tests.test_torch_train_field import FIELD, _close, _flat_grads

REPO = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------- the step
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_sphere_dataset(tmp_path_factory.mktemp("scene"), n_train=2,
                                   n_test=1, image_size=16)


def tiny_config(scene, **trainer):
    cfg = tconfig.compose(REPO / "config", overrides=["dataset=test", "trainer=test"])
    cfg["dataset"]["dataset_dir"] = str(scene)
    cfg["network"].update({**FIELD, "compute_dtype": "float32"})
    cfg["network"]["skips"] = list(FIELD["skips"])
    cfg["render"].update({"sample_coarse": 8, "sample_fine": 8})
    cfg["trainer"].update({"batch_size": 16, "chunk": 64, **trainer})
    return cfg


_JAX_TRAINERS = {}


def _trainers(cfg):
    """(JAX trainer, port trainer with the same parameters). The JAX
    trainer and its jitted loss/gradient function are built once per
    trainer config: the tests read them and never step them."""
    key = json.dumps(cfg["trainer"], sort_keys=True, default=str)
    if key not in _JAX_TRAINERS:
        jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
        _JAX_TRAINERS[key] = (jtr, jax.jit(jtr._local_grads, static_argnums=(8, 9)))
    jtr, grads_fn = _JAX_TRAINERS[key]
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict(params_from_jax(jtr.params), strict=True)
    return jtr, grads_fn, ttr


def _jax_draws(jtr, key):
    """The JAX step's pixel and sample draws for ``key``."""
    render = jtr.neural_render
    us, vs, k_render = jdraw_pixel_batch(key, jtr.batch_size, jtr.dataset.image_width,
                                         jtr.dataset.image_height)
    k_strat, k_pdf = jax.random.split(k_render)
    pids = us * 65536 + vs
    draws = (us, vs, _per_ray_uniform(k_strat, pids, render.sample_coarse + 1),
             _per_ray_uniform(k_pdf, pids, render.sample_fine + 1))
    return [torch.from_numpy(np.array(x)) for x in draws]


def _jax_grads(jtr, grads_fn, key, camera_id, iteration, params=None):
    return grads_fn(
        jtr.params if params is None else params, jtr.camera_deltas, jtr.rgb_images,
        jtr.mask_images, jtr.camera_initials, key, jnp.int32(camera_id),
        jnp.int32(iteration), 0, jtr.batch_size)


def test_one_train_step_matches_jax_on_its_draws(scene):
    jtr, grads_fn, ttr = _trainers(tiny_config(scene))
    key = jax.random.PRNGKey(11)
    loss, loss_dict, mse, grads, _ = _jax_grads(jtr, grads_fn, key, 1, 5)
    ttr.iteration = 5
    us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
    tloss, tdict, tmse = ttr.step_grads(1, us.long(), vs.long(), u_strat, u_pdf)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tmse.item(), float(mse), rtol=1e-5)
    assert set(tdict) == set(loss_dict)  # (jax returns the dict sorted)
    for k in loss_dict:
        np.testing.assert_allclose(tdict[k].item(), float(loss_dict[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    jgrads = _flat_grads(grads)
    for name, p in ttr.neural_render.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


@pytest.mark.parametrize("scheduler_lr", [0.99815, 0.5], ids=["default", "staircase"])
def test_three_adam_steps_match_optax(scene, scheduler_lr):
    """Adam over three steps on the JAX draws; with two training views
    the third step is in epoch 1, so scheduler_lr=0.5 halves its lr."""
    jtr, grads_fn, ttr = _trainers(tiny_config(scene, scheduler_lr=scheduler_lr))
    assert len(ttr.dataset) == 2
    params, opt_state = jtr.params, jtr.tx.init(jtr.params)
    for step, cam in enumerate((0, 1, 0)):
        key = jax.random.PRNGKey(100 + step)
        _, _, _, grads, _ = _jax_grads(jtr, grads_fn, key, cam, step, params)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        for group in ttr.optimizer.param_groups:
            group["lr"] = ttr.learning_rate(ttr.iteration)
        us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
        ttr.step_grads(cam, us.long(), vs.long(), u_strat, u_pdf)
        ttr.optimizer.step()
        ttr.iteration += 1
    assert ttr.learning_rate(2) == pytest.approx(5e-4 * scheduler_lr, rel=1e-12)
    ref = _flat_grads(params)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_learning_rate_is_optax_staircase(scene):
    cfg = tiny_config(scene, scheduler_lr=0.9, optimizer_lr=1e-3)
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    sched = optax.exponential_decay(1e-3, transition_steps=2, decay_rate=0.9,
                                    staircase=True)
    for n in range(7):
        assert ttr.learning_rate(n) == pytest.approx(float(sched(n)), rel=1e-6)
    for ported in ({"grad_accum": 2}, {"optimize_camera": True}):
        tconfig.instantiate({**cfg["trainer"], **ported}, global_config=cfg)
    # data and (NeDDF's) tensor parallelism need the ranks' process group
    with pytest.raises(RuntimeError, match="process group"):
        tconfig.instantiate({**cfg["trainer"], "mesh": {"data": 2, "model": 1}},
                            global_config=cfg)
    with pytest.raises(RuntimeError, match="process group"):
        tconfig.instantiate({**cfg["trainer"], "mesh": {"data": "auto", "model": 2}},
                            global_config=cfg)


def test_jet_table_equals_opencv():
    cv2 = pytest.importorskip("cv2")
    gray = np.arange(256, dtype=np.uint8)[None, :]
    want = cv2.applyColorMap(gray, cv2.COLORMAP_JET)
    np.testing.assert_array_equal(apply_jet(gray), want)
    assert JET_BGR.shape == (256, 3)


def test_run_script_trains_and_its_checkpoint_loads_in_both_packages(
        scene, tmp_path, monkeypatch):
    run = tmp_path / "run"
    monkeypatch.chdir(tmp_path)
    overrides = ["dataset=test", "trainer=test", f"dataset.dataset_dir={scene}",
                 "trainer.epoch_max=0", "trainer.batch_size=16", "trainer.chunk=64",
                 "render.sample_coarse=8", "render.sample_fine=8",
                 *[f"network.{k}={v}" for k, v in FIELD.items() if k != "skips"],
                 "network.skips=[1]", f"hydra.run.dir={run}"]
    trainer = trun.main(overrides)
    assert trainer.iteration == 2  # one epoch over two views
    log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert (run / ".hydra" / "config.yaml").exists()
    ckpt = run / "models" / "model_00000.ckpt"
    assert ckpt.exists()
    # the field slice: every pixel is a JET colour, as cv2 would map it
    img = read_png(run / "render" / "fields" / "field_distance_0000.png")[:, :, ::-1]
    assert img.shape == (128, 128, 3)
    jet = {tuple(c) for c in JET_BGR}
    assert all(tuple(px) in jet for px in img.reshape(-1, 3)[::97])
    assert (run / "render" / "0000" / "000_rgb.png").exists() or any(
        (run / "render" / "0000").glob("*_rgb.png"))

    # the checkpoint in the JAX package (its own loader, its own snapshot reader)
    jcfg = jconfig.load_snapshot(run)
    jtr = jconfig.instantiate(jcfg["trainer"], global_config=jcfg)
    jtr.load_pretrained_model(ckpt)
    state = trainer.neural_render.state_dict()
    want = {k: v.detach().numpy() for k, v in state.items()}
    for name, value in _flat_grads(jtr.params).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)
    # and in the port's run_eval
    evaluated = evaluate(run, 0, device="cpu", cameras=[0], downsampling=4)
    for name, value in evaluated.neural_render.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
    assert (run / "eval" / "000_rgb.png").exists()
