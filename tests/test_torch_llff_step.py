"""One train step of the forward-facing configurations in the PyTorch port
against the JAX package on the CPU, at narrow widths on a capture the
JAX generator writes: NeDDF-NDC (``dataset=llff dataset.recenter=true
render.ndc=true render.sampling_type=point loss=nerf_loss``) and
NeRF-NDC (the same with ``network=nerf render=nerf_render``), and
NeDDF on the same capture without NDC (cone samples over the world
window), in f32, on the JAX package's own pixel and sample draws: the
loss, the loss dict and every parameter's gradient.

Tolerances (f32 on both sides, sums in another order): losses at rtol
1e-5, every parameter gradient within 1e-4 of its largest magnitude.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

from neddf_tpu import config as jconfig
from neddf_tpu.data.llff import generate_forward_facing_dataset
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.training.checkpoint import params_from_jax
from tests.test_torch_train_field import _close, _flat_grads
from tests.test_torch_train_step import _jax_draws, _jax_grads
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
NDC = ["dataset.recenter=true", "render.ndc=true", "render.ndc_near=2.0",
       "render.sampling_type=point"]
CONFIGS = {
    "neddf_ndc": (NDC, dict(embed_pos_rank=4, embed_dir_rank=2, ddf_layer_count=4,
                            ddf_layer_width=16, col_layer_count=3, col_layer_width=16,
                            skips=[1])),
    "nerf_ndc": (["network=nerf", "render=nerf_render", *NDC],
                 dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=4, layer_width=16,
                      skips=[1])),
    "neddf": ([], dict(embed_pos_rank=4, embed_dir_rank=2, ddf_layer_count=4,
                       ddf_layer_width=16, col_layer_count=3, col_layer_width=16, skips=[1])),
}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return generate_forward_facing_dataset(tmp_path_factory.mktemp("llff") / "scene",
                                           n_images=9, image_size=24)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_llff_step_matches_jax_on_its_draws(capture, config):
    overrides, network = CONFIGS[config]
    cfg = tconfig.compose(REPO / "config", overrides=[
        "dataset=llff", "loss=nerf_loss", "trainer=test", f"dataset.dataset_dir={capture}",
        "dataset.factor=1", *overrides])
    cfg["network"].update({**network, "compute_dtype": "float32"})
    cfg["render"].update({"sample_coarse": 8, "sample_fine": 8})
    cfg["trainer"].update({"batch_size": 16, "chunk": 64})
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    grads_fn = jax.jit(jtr._local_grads, static_argnums=(8, 9))
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict(params_from_jax(jtr.params), strict=True)
    ndc = config.endswith("_ndc")
    assert ttr.neural_render.ndc == jtr.neural_render.ndc == ndc
    assert ttr.neural_render.dist_far == jtr.neural_render.dist_far == (1.0 if ndc else 6.0)
    np.testing.assert_array_equal(ttr.camera_initials.numpy(), np.asarray(jtr.camera_initials))

    key = jax.random.PRNGKey(17)
    loss, loss_dict, mse, grads, _ = _jax_grads(jtr, grads_fn, key, 2, 3)
    ttr.iteration = 3
    us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
    tloss, tdict, tmse = ttr.step_grads(2, us.long(), vs.long(), u_strat, u_pdf)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tmse.item(), float(mse), rtol=1e-5)
    assert set(tdict) == set(loss_dict) == {"color", "color_coarse", "mask", "mask_coarse"}
    for k in loss_dict:
        np.testing.assert_allclose(tdict[k].item(), float(loss_dict[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    jgrads = _flat_grads(grads)
    for name, p in ttr.neural_render.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)
