"""One train step of the NeRF and NeuS configurations in the PyTorch port
against the JAX package on the CPU, at narrow widths on a generated
scene: the loss, loss dict and every gradient on the JAX package's own
pixel and sample draws, three Adam steps against optax, and
``scripts/run.py`` + ``scripts/run_eval.py`` end to end with the
checkpoint loaded by both packages.

The configurations are the shipped ones with narrow layers:
``network=nerf render=nerf_render loss=nerf_loss`` (a separate coarse
network, point samples) and ``network=neus loss=nerf_loss`` (one shared
network, cone samples, trainable ``variance``), both in f32.

Tolerances (f32 on both sides, sums in another order): losses at rtol
1e-4, every parameter gradient within 1e-4 of its largest magnitude,
parameters after three Adam steps within 1e-6 (a step moves a weight by
about lr = 5e-4).
"""
import json
from pathlib import Path

import jax
import numpy as np
import optax
import pytest

from neddf_tpu import config as jconfig
from neddf_tpu.data.synthetic import generate_sphere_dataset
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.scripts.run_eval import evaluate
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.utils.png import read_png
from tests.test_torch_train_field import _close, _flat_grads
from tests.test_torch_train_step import _jax_draws, _jax_grads
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {
    "nerf": (["network=nerf", "render=nerf_render", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=4, layer_width=16,
                  skips=[1], compute_dtype="float32")),
    "neus": (["network=neus", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=4, sdf_layer_width=16,
                  col_layer_count=3, col_layer_width=16, skips=[1])),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_sphere_dataset(tmp_path_factory.mktemp("scene"), n_train=2,
                                   n_test=1, image_size=16)


def tiny_config(scene, family, **trainer):
    overrides, network = FAMILIES[family]
    cfg = tconfig.compose(REPO / "config",
                          overrides=["dataset=test", "trainer=test", *overrides])
    cfg["dataset"]["dataset_dir"] = str(scene)
    cfg["network"].update(network)
    cfg["render"].update({"sample_coarse": 8, "sample_fine": 8})
    cfg["trainer"].update({"batch_size": 16, "chunk": 64, **trainer})
    return cfg


def _pair(cfg):
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    grads_fn = jax.jit(jtr._local_grads, static_argnums=(8, 9))
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict(params_from_jax(jtr.params), strict=True)
    return jtr, grads_fn, ttr


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_and_three_adam_steps_match_jax(scene, family):
    jtr, grads_fn, ttr = _pair(tiny_config(scene, family))
    names = {n.split(".")[0] for n, _ in ttr.neural_render.named_parameters()}
    assert names == ({"network_fine", "network_coarse"} if family == "nerf"
                     else {"network_fine"})
    params, opt_state = jtr.params, jtr.tx.init(jtr.params)
    for step, cam in enumerate((1, 0, 1)):
        key = jax.random.PRNGKey(20 + step)
        loss, loss_dict, mse, grads, _ = _jax_grads(jtr, grads_fn, key, cam, step, params)
        updates, opt_state = jtr.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        for group in ttr.optimizer.param_groups:
            group["lr"] = ttr.learning_rate(ttr.iteration)
        us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
        tloss, tdict, tmse = ttr.step_grads(cam, us.long(), vs.long(), u_strat, u_pdf)
        if step == 0:  # the step itself, on the same parameters
            np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-4)
            np.testing.assert_allclose(tmse.item(), float(mse), rtol=1e-4)
            assert set(tdict) == set(loss_dict) == {"color", "color_coarse", "mask",
                                                     "mask_coarse"}
            for k in loss_dict:
                np.testing.assert_allclose(tdict[k].item(), float(loss_dict[k]), rtol=1e-4,
                                           err_msg=k)
            jgrads = _flat_grads(grads)
            for name, p in ttr.neural_render.named_parameters():
                _close(p.grad.numpy(), jgrads[name], 1e-4, name)
        ttr.optimizer.step()
        ttr.iteration += 1
    ref = _flat_grads(params)
    for name, p in ttr.neural_render.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_and_run_eval_and_the_checkpoint_in_both_packages(
        scene, tmp_path, monkeypatch, family):
    run = tmp_path / "run"
    monkeypatch.chdir(tmp_path)
    overrides, network = FAMILIES[family]
    network = {k: (f"[{','.join(map(str, v))}]" if isinstance(v, list) else v)
               for k, v in network.items()}
    trainer = trun.main([
        *overrides, "dataset=test", "trainer=test", f"dataset.dataset_dir={scene}",
        "trainer.epoch_max=0", "trainer.batch_size=16", "trainer.chunk=64",
        "render.sample_coarse=8", "render.sample_fine=8",
        *[f"network.{k}={v}" for k, v in network.items()], f"hydra.run.dir={run}"])
    assert trainer.iteration == 2  # one epoch over two views
    log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in log)
    fields = {p.name for p in (run / "render" / "fields").glob("*.png")}
    want = {"density", "color"} | ({"sdf"} if family == "neus" else set())
    assert fields == {f"field_{k}_0000.png" for k in want}
    ckpt = run / "models" / "model_00000.ckpt"

    # the checkpoint in the JAX package (its own loader, its own snapshot reader)
    jcfg = jconfig.load_snapshot(run)
    jtr = jconfig.instantiate(jcfg["trainer"], global_config=jcfg)
    jtr.load_pretrained_model(ckpt)
    want_params = {k: v.detach().numpy() for k, v in trainer.neural_render.state_dict().items()}
    got = _flat_grads(jtr.params)
    assert set(got) == set(want_params)
    for name, value in got.items():
        np.testing.assert_array_equal(value, want_params[name], err_msg=name)
    # and in the port's run_eval
    evaluated = evaluate(run, 0, device="cpu", cameras=[0], downsampling=4)
    for name, value in evaluated.neural_render.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want_params[name], err_msg=name)
    img = read_png(run / "eval" / "000_rgb.png")
    assert img.shape == (4, 4, 3)
