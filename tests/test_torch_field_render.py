"""The PyTorch port's NeDDF eval field, renderer and run_eval path against
the JAX package on the CPU: same weights (through ``params_from_jax``),
same per-pixel uniform draws (the JAX package's own, fed to the port).

Tolerances: the field is f32 on both sides with sums in another order;
distance, aux and colour agree to 1e-5, the density, which is
(1/D)(1 - |grad D|) and so amplifies the trunk's rounding through 1/D,
to 1e-4. Rendered images are compared after the uint8 quantisation of
the PNGs: at most one level per channel, and PSNR within 1e-3 dB.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from neddf_tpu import config as jconfig
from neddf_tpu.data.synthetic import generate_sphere_dataset
from neddf_tpu.fields.neddf import NeDDF as JNeDDF
from neddf_tpu.geometry.camera import PinholeCalib as JCalib
from neddf_tpu.geometry.rays import Sampling as JSampling
from neddf_tpu.geometry.se3 import camera_pose as jcamera_pose
from neddf_tpu.kernels.dual_mlp import matmul_dtype
from neddf_tpu.ops.sampling import _per_ray_uniform
from neddf_tpu.render.renderer import NeRFRender as JRender
from neddf_tpu.training.metrics import peak_signal_noise_ratio as jpsnr
from neddf_tpu_torch.fields.neddf import NeDDF
from neddf_tpu_torch.geometry.camera import PinholeCalib
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.scripts.run_eval import evaluate, load_trainer
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.training.metrics import (
    peak_signal_noise_ratio,
    structural_similarity,
)
from neddf_tpu_torch.utils.png import read_png
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]

NETWORK = {
    "_target_": "neddf_tpu.fields.NeDDF",
    "embed_pos_rank": 10, "embed_dir_rank": 4,
    "ddf_layer_count": 6, "ddf_layer_width": 32,
    "col_layer_count": 4, "col_layer_width": 32,
    "d_near": 0.001, "activation_type": "tanhExp",
    "density_activation_type": "ReLU", "lowpass_alpha_offset": 10,
    "skips": [2], "compute_dtype": "float32",
}
RENDER = {
    "_target_": "neddf_tpu.render.NeRFRender", "sample_coarse": 16,
    "sample_fine": 32, "dist_near": 2.0, "dist_far": 6.0, "max_dist": 6.0,
    "use_coarse_network": False, "sampling_type": "cone",
}


def _field_kwargs(**over):
    kw = {k: v for k, v in NETWORK.items() if k != "_target_"}
    kw.update(over)
    return kw


def _sampling(b=4, s=40, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, size=(b, s, 3)).astype(np.float32)
    d = rng.normal(size=(b, 1, 3)).astype(np.float32)
    d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (b, s, 3)).copy()
    var = rng.uniform(0, 1e-4, size=(b, s, 3)).astype(np.float32)
    return pos, d, var


@pytest.mark.parametrize("jax_fused", ["off", "on"])
def test_neddf_eval_field_matches_jax(jax_fused):
    jfield = JNeDDF(**_field_kwargs(skips=(2,), fused=jax_fused))
    params = jfield.init(jax.random.PRNGKey(0))
    pos, d, var = _sampling()
    with matmul_dtype(jnp.float32):  # Pallas kernels (fused=on) in exact f32
        ref = jfield.apply(params, JSampling(jnp.asarray(pos), jnp.asarray(d),
                                             jnp.asarray(var)),
                           jfield.schedule(-1), need_aux=False)
    field = NeDDF(**_field_kwargs())
    field.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = field(Sampling(*map(torch.from_numpy, (pos, d, var))),
                    field.schedule(-1), need_aux=False)
    for key, tol in (("distance", 1e-5), ("aux_grad", 1e-5), ("color", 1e-5),
                     ("density", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=tol, atol=tol, err_msg=key)
    assert torch.all(got["fields_penalty"] == 0)


def test_neddf_eval_field_bf16_tracks_jax_kernels():
    """bf16 compute: the port's trunks round like the Pallas kernels; its
    heads run in f32 where the JAX package rounds them to bf16, so the
    bar is a bf16-sized one (2^-6 of each output's range)."""
    jfield = JNeDDF(**_field_kwargs(skips=(2,), fused="on", compute_dtype="bfloat16"))
    params = jfield.init(jax.random.PRNGKey(1))
    pos, d, var = _sampling(seed=1)
    ref = jfield.apply(params, JSampling(jnp.asarray(pos), jnp.asarray(d),
                                         jnp.asarray(var)),
                       jfield.schedule(-1), need_aux=False)
    field = NeDDF(**_field_kwargs(compute_dtype="bfloat16"))
    field.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = field(Sampling(*map(torch.from_numpy, (pos, d, var))), field.schedule(-1))
    for key in ("distance", "color", "aux_grad"):
        r = np.asarray(ref[key], np.float32)
        err = np.abs(got[key].numpy() - r).max()
        assert err <= 2.0**-6 * max(np.abs(r).max(), 1e-3), (key, err)


@pytest.mark.parametrize("iteration", [-1, 0, 1, 5000, 20000])
def test_schedule_matches_jax(iteration):
    ref = JNeDDF(**_field_kwargs(skips=(2,))).schedule(iteration)
    got = NeDDF(**_field_kwargs()).schedule(iteration)
    np.testing.assert_allclose(np.array(got, np.float32),
                               np.array([float(x) for x in ref], np.float32), rtol=1e-6)


def _renderers(seed=0):
    jrender = JRender(network_config=dict(NETWORK), **{
        k: v for k, v in RENDER.items() if k != "_target_"})
    params = jrender.init(jax.random.PRNGKey(seed))
    render = NeRFRender(network_config=dict(NETWORK), **{
        k: v for k, v in RENDER.items() if k != "_target_"})
    render.load_state_dict(params_from_jax(params), strict=True)
    return jrender, params, render


def _camera():
    calib = np.array([22.0, 22.0, 8.0, 6.0], np.float32)
    init = np.array([0.9, -0.4, 0.3, 0.2, -3.8, 1.4], np.float32)
    r, t = jcamera_pose(jnp.asarray(init), jnp.zeros(6, jnp.float32))
    return calib, np.array(r), np.array(t)  # writable copies


def _jax_draws(key, n_coarse, n_fine):
    """The JAX renderer's per-pixel draws for ``key`` as a port callable."""
    k_strat, k_pdf = jax.random.split(key)

    def draws(uv):
        pids = jnp.asarray(uv[:, 0].numpy() * 65536 + uv[:, 1].numpy())
        return (torch.from_numpy(np.array(_per_ray_uniform(k_strat, pids, n_coarse))),
                torch.from_numpy(np.array(_per_ray_uniform(k_pdf, pids, n_fine))))

    return draws


def test_render_rays_matches_jax_with_its_draws():
    jrender, params, render = _renderers()
    calib, r, t = _camera()
    uv = np.random.default_rng(2).integers(0, 16, size=(48, 2)).astype(np.int32)
    key = jax.random.PRNGKey(5)
    ref = jrender.render_rays(params, JCalib(jnp.asarray(calib)), jnp.asarray(r),
                              jnp.asarray(t), jnp.asarray(uv), key, -1, need_aux=False)
    u_strat, u_pdf = _jax_draws(key, 17, 33)(torch.from_numpy(uv))
    with torch.no_grad():
        got = render.render_rays(PinholeCalib(torch.from_numpy(calib)), torch.from_numpy(r),
                                 torch.from_numpy(t), torch.from_numpy(uv).long(),
                                 u_strat, u_pdf)
    for k in ("color", "depth", "transmittance", "color_coarse", "depth_coarse",
              "weight_coarse"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_render_image_matches_jax_with_its_draws():
    jrender, params, render = _renderers(1)
    calib, r, t = _camera()
    ref = jrender.render_image(params, JCalib(jnp.asarray(calib)), jnp.asarray(r),
                               jnp.asarray(t), 16, 12, chunk=40)
    _, sub = jax.random.split(jax.random.PRNGKey(0))  # render_image's own key
    got = render.render_image(PinholeCalib(torch.from_numpy(calib)), torch.from_numpy(r),
                              torch.from_numpy(t), 16, 12, chunk=40,
                              draws=_jax_draws(sub, 17, 33))
    for k in ("color", "depth"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_eval_slice_matches_jax_render_test(tmp_path, capsys):
    """The whole slice: a random narrow NeDDF checkpoint on a generated
    scene, rendered by the JAX trainer's render_test and by the port's
    run_eval path; same images and the same PSNR."""
    scene = generate_sphere_dataset(tmp_path / "scene", n_train=1, n_test=2, image_size=16)
    loss = yaml.safe_load((REPO / "config" / "loss" / "neddf_loss.yaml").read_text())
    cfg = {
        "dataset": {"_target_": "neddf_tpu.data.NeRFSyntheticDataset",
                    "dataset_dir": str(scene), "data_split": "train",
                    "use_depth": False, "use_mask": True},
        "render": dict(RENDER), "network": dict(NETWORK),
        "trainer": {"_target_": "neddf_tpu.training.NeRFTrainer", "device": "cpu",
                    "batch_size": 32, "chunk": 64, "epoch_max": 1,
                    "log_interval": 1, "mesh": None},
        "loss": loss,
    }
    run = tmp_path / "run"
    (run / ".hydra").mkdir(parents=True)
    (run / ".hydra" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))

    jcfg = jconfig.load_snapshot(run)
    jcfg["dataset"]["data_split"] = "test"
    jtrainer = jconfig.instantiate(jcfg["trainer"], global_config=jcfg)
    (run / "models").mkdir()
    ckpt = run / "models" / "model_00001.ckpt"
    ckpt.write_bytes(serialization.to_bytes({"params": jtrainer.params}))
    jtrainer.load_pretrained_model(ckpt)
    for cam in (0, 1):
        jtrainer.render_test(tmp_path / "jax_eval", cam, 1)

    _, sub = jax.random.split(jax.random.PRNGKey(0))
    evaluate(run, 1, device="cpu", draws=_jax_draws(sub, 17, 33))
    for cam in (0, 1):
        gt = read_png(run / "eval" / f"{cam:03}_rgb_gt.png")
        np.testing.assert_array_equal(gt, read_png(tmp_path / "jax_eval" / f"{cam:03}_rgb_gt.png"))
        ours = read_png(run / "eval" / f"{cam:03}_rgb.png")
        theirs = read_png(tmp_path / "jax_eval" / f"{cam:03}_rgb.png")
        assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
        assert abs(peak_signal_noise_ratio(ours, gt) - jpsnr(theirs, gt)) < 1e-3
    assert "psnr:" in capsys.readouterr().out


def test_pretrained_artifact_through_the_port_on_cpu(tmp_path):
    """The real checkpoint, full width, bf16, on the CPU at downsampling
    25; the same bar as tests/training/test_pretrained_artifact.py
    (an untrained field scores ~8-10 dB)."""
    trainer = load_trainer(REPO / "pretrained" / "machine_neddf", 1000, device="cpu")
    ds = 25
    rgb = trainer.render_test(tmp_path, 0, ds)
    gt = trainer.dataset[0]["rgb_images"].astype(np.uint8)[::ds, ::ds]
    assert rgb.shape == gt.shape == (20, 20, 3)
    psnr = peak_signal_noise_ratio(rgb, gt)
    ssim = structural_similarity(rgb, gt, channel_axis=2)
    assert psnr > 27.5, f"PSNR {psnr:.2f} dB"
    assert ssim > 0.94, f"SSIM {ssim:.4f}"
