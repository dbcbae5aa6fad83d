"""The PyTorch port's NeRF and NeuS fields and the renderer's NeRF
configuration (a separate coarse network, point sampling) against the
JAX package on the CPU, at narrow widths; and the upstream reference's
``neddf.network.NeRF`` / ``NeuS`` targets in a snapshot.

* NeRF against ``NeRF(fused="off")`` (the jnp path): outputs and every
  parameter gradient in f32 and bf16, at iteration -1 (eval: the full PE
  band) and 500 (a partial lowpass window).
* NeuS against ``NeuS(fused="off", normals="reverse")`` (jax.grad
  through the jnp trunk) and against ``normals="sweep", fused="on"`` (the
  Pallas ``sdf_mlp`` and ``mlp_seg`` kernels in interpret mode, f32
  products): sdf, density, colour, and every gradient, ``variance``
  included.

Tolerances: f32 on both sides differs in summation order only: outputs
within 1e-5 of their largest magnitude, gradients within 1e-4 (the
normals and the sweep's second-order terms go through more sums). In
bf16 the JAX jnp path rounds each product AND the bias sum to bf16 where
the port's kernels add the f32 bias before rounding once, so a value may
sit one bf16 step (2^-8) apart and carry on: outputs within 2^-5,
gradients within 2^-3 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neddf_tpu.fields.nerf import NeRF as JNeRF
from neddf_tpu.fields.neus import NeuS as JNeuS
from neddf_tpu.geometry.camera import PinholeCalib as JCalib
from neddf_tpu.geometry.rays import Sampling as JSampling
from neddf_tpu.kernels.dual_mlp import matmul_dtype
from neddf_tpu.render.renderer import NeRFRender as JRender
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.fields.nerf import NeRF
from neddf_tpu_torch.fields.neus import NeuS
from neddf_tpu_torch.geometry.rays import Sampling
from neddf_tpu_torch.render.renderer import NeRFRender
from neddf_tpu_torch.training.checkpoint import params_from_jax
from neddf_tpu_torch.utils import yaml_subset
from tests.test_torch_train_field import (
    _close,
    _flat_grads,
    _port_render,
    _render_inputs,
    _sampling,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NERF = dict(embed_pos_rank=6, embed_dir_rank=2, layer_count=4, layer_width=32, skips=(1,),
            lowpass_alpha_offset=4, activation_type="ReLU", density_activation_type="ReLU")
NEUS = dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=4, sdf_layer_width=32,
            col_layer_count=3, col_layer_width=32, skips=(1,), activation_type="ReLU",
            init_variance=0.3)
BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (2.0**-5, 2.0**-3)}


def _outputs_and_grads(jfield, params, field, iteration, keys, seed=0, point=False):
    """Outputs of both packages on one sampling and the parameter
    gradients of sum(out[k] * weight[k]) over ``keys``."""
    pos, d, var = _sampling(seed=seed)
    if point:
        var = np.zeros_like(var)
    jsamp = JSampling(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(var))
    rng = np.random.default_rng(seed + 1)

    def jout(p):
        return jfield.apply(p, jsamp, jfield.schedule(iteration), need_aux=True)

    ref = jax.jit(jout)(params)
    weights = {k: rng.normal(size=np.shape(ref[k])).astype(np.float32) for k in keys}

    def jloss(p):
        out = jout(p)
        return sum(jnp.sum(out[k].astype(jnp.float32) * weights[k]) for k in keys)

    jgrads = _flat_grads(jax.jit(jax.grad(jloss))(params))
    got = field(Sampling(*map(torch.from_numpy, (pos, d, var))), field.schedule(iteration),
                need_aux=True)
    loss = sum(torch.sum(got[k].float() * torch.from_numpy(weights[k])) for k in keys)
    loss.backward()
    return ref, got, jgrads


@pytest.mark.parametrize("iteration", [-1, 500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerf_field_outputs_and_grads_match_jax(dtype, iteration):
    jfield = JNeRF(**NERF, compute_dtype=dtype, fused="off")
    params = jfield.init(jax.random.PRNGKey(3))
    field = NeRF(**NERF, compute_dtype=dtype)
    field.load_state_dict(params_from_jax(params), strict=True)
    assert field.schedule(iteration) == tuple(float(x) for x in jfield.schedule(iteration))
    ref, got, jgrads = _outputs_and_grads(jfield, params, field, iteration,
                                          ("density", "color"), point=iteration < 0)
    out_tol, grad_tol = BOUNDS[dtype]
    for k in ("density", "color"):
        assert got[k].dtype == torch.float32
        _close(got[k].detach().numpy(), ref[k], out_tol, k)
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], grad_tol, name)


@pytest.mark.parametrize("reference", ["reverse", "sweep_pallas", "dual"])
def test_neus_field_outputs_and_grads_match_jax(reference):
    if reference == "reverse":
        jfield = JNeuS(**NEUS, fused="off", normals="reverse")
    elif reference == "dual":
        # forward-mode normals through the JAX package's dual trunk kernel
        # (interpret mode), against the port's ``normals="dual"``
        jfield = JNeuS(**NEUS, fused="off", normals="dual")
    else:
        jfield = JNeuS(**NEUS, fused="on", normals="sweep")
    params = jfield.init(jax.random.PRNGKey(5))
    field = NeuS(**NEUS, normals="dual" if reference == "dual" else "auto")
    field.load_state_dict(params_from_jax(params), strict=True)
    assert tuple(field.variance.shape) == ()
    with matmul_dtype(jnp.float32):
        ref, got, jgrads = _outputs_and_grads(jfield, params, field, 0,
                                              ("sdf", "density", "color"), seed=2)
    for k in ("sdf", "density", "color"):
        _close(got[k].detach().numpy(), ref[k], 1e-5, k)
    names = [name for name, _ in field.named_parameters()]
    assert "variance" in names
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


def test_neus_dual_normals_equal_the_sweep_and_unknown_modes_raise():
    """``normals="dual"`` is taken (the same normals by the sweep, equal to
    the JAX package's dual mode: test above); only an unknown mode is
    refused."""
    torch.manual_seed(0)
    field = NeuS(**NEUS, normals="dual")
    auto = NeuS(**NEUS)
    auto.load_state_dict(field.state_dict())
    samp = Sampling(*map(torch.from_numpy, _sampling(seed=4)))
    got, want = field(samp, field.schedule(0)), auto(samp, auto.schedule(0))
    for k in ("sdf", "density", "color"):
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError):
        NeuS(**NEUS, normals="forward")


def test_nerf_render_with_coarse_network_and_points_matches_jax():
    """render_rays of the NeRF configuration: the coarse pass through its
    own network, point samples, no penalty key; outputs and gradients."""
    render_cfg = dict(sample_coarse=12, sample_fine=16, dist_near=2.0, dist_far=6.0,
                      max_dist=6.0, use_coarse_network=True, sampling_type="point")
    network = {"_target_": "neddf_tpu.fields.NeRF", **NERF, "compute_dtype": "float32"}
    jrender = JRender(network_config=dict(network), **render_cfg)
    params = jrender.init(jax.random.PRNGKey(9))
    render = NeRFRender(network_config=dict(network), **render_cfg)
    render.load_state_dict(params_from_jax(params), strict=True)
    assert render.coarse_network() is render.network_coarse
    calib, r, t, uv, key, u_strat, u_pdf = _render_inputs()
    target = np.random.default_rng(4).uniform(size=(uv.shape[0], 3)).astype(np.float32)

    def jrun(p):
        return jrender.render_rays(p, JCalib(jnp.asarray(calib)), jnp.asarray(r),
                                   jnp.asarray(t), jnp.asarray(uv), key, 300, need_aux=True)

    def jloss(p):
        out = jrun(p)
        return (jnp.sum(jnp.square(out["color"] - target))
                + jnp.sum(jnp.square(out["color_coarse"] - target)))

    ref = jax.jit(jrun)(params)
    jgrads = _flat_grads(jax.jit(jax.grad(jloss))(params))
    got = _port_render(render, calib, r, t, uv, u_strat, u_pdf, 300)
    assert set(got) == set(ref) and not any("penalty" in k for k in got)
    for k in ref:
        _close(got[k].detach().numpy(), ref[k], 1e-4, k)
    target_t = torch.from_numpy(target)
    (torch.sum(torch.square(got["color"] - target_t))
     + torch.sum(torch.square(got["color_coarse"] - target_t))).backward()
    assert {n.split(".")[0] for n, _ in render.named_parameters()} == {
        "network_fine", "network_coarse"}
    for name, p in render.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


@pytest.mark.parametrize("family", ["NeRF", "NeuS"])
def test_reference_network_targets_resolve(tmp_path, family):
    """A snapshot naming the upstream ``neddf.network.NeRF`` / ``NeuS``
    composes and instantiates into the port's field."""
    small = NERF if family == "NeRF" else NEUS
    cfg = {"network": {"_target_": f"neddf.network.{family}",
                       **{k: list(v) if isinstance(v, tuple) else v for k, v in small.items()}}}
    (tmp_path / ".hydra").mkdir()
    (tmp_path / ".hydra" / "config.yaml").write_text(yaml_subset.dumps(cfg))
    net = tconfig.instantiate(tconfig.load_snapshot(tmp_path)["network"])
    assert type(net) is {"NeRF": NeRF, "NeuS": NeuS}[family]
