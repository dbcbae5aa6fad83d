"""Trunks of any depth and widths over 2048: the fields take the kernels'
per-layer route wherever a fused kernel refuses their configuration, and
the NeDDF epilogue takes any width.

On the CPU (the route's plain launchers; the JAX package on its jnp path,
``fused="off"``):

* The routing (``fields/base.py::per_layer_route``): the three shipped
  configurations keep the fused route; each depth the fused kernels do
  not hold takes the per-layer one (NeDDF ``ddf_layer_count=10`` or
  ``col_layer_count=10``, NeRF ``layer_count=13``, NeuS
  ``sdf_layer_count=13`` or ``col_layer_count=12``) and one layer fewer
  does not; the deep configurations of ``chip_smoke.py`` take it.
* NeDDF, NeRF and NeuS with deep trunks and several post-skip layers
  (the skips of ``chip_smoke.py::DEEP_OVERRIDES``) at width 16, f32: one
  train step (field, renderer, losses) on the JAX package's parameters
  and draws, against the JAX package's step; the route's walk ran and no
  fused plain version did.
* NeDDF with a 2056-wide distance trunk (past the epilogue's staged
  classes): the training field's outputs and every gradient against the
  JAX package; the plain epilogue forward and backward at width 2056
  against the Pallas epilogue in interpret mode and its VJP.

On the card (marked ``cuda``, skipped here): the epilogue forward (#5)
and its standalone backward (#6; past 2048 its column-chunked kernel) at
widths 2056, 3072, 4096 and 8200 against their plain versions, dwd, dwa
and db2 bitwise over two runs; each deep family's route against its
plain version at width 256.

Tolerances: the step as ``tests/test_torch_train_step.py`` holds the
NeDDF step (losses rtol 1e-5, every gradient within 1e-4 of its largest
magnitude); the field as ``tests/test_torch_train_field.py`` (outputs
1e-5, density and penalties 1e-4, gradients 1e-4); the epilogue as
``tests/test_torch_tp_kernels.py`` (1e-5, its VJP 1e-4). On the card:
f32 1e-4 and bf16 2^-5 of the largest element (the outputs of the
epilogue in the compute dtype), the fields f32 1e-4 (outputs) and 1e-3
(gradients, the second-order normals' among them).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import sdf_grad as tgrad
from tests.test_torch_widths_acts import (  # noqa: F401  (jx is a fixture)
    DTYPES,
    ROWS_JAX,
    M,
    _epi_inputs,
    _pad,
    _rel,
    jx,
)
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
FAMILY = {"neddf": [], "nerf": ["network=nerf"], "neus": ["network=neus"]}
# (family, overrides, per_layer): the shipped configurations, each depth
# threshold of the fused kernels and one layer below it, and the deep
# configurations of chip_smoke.py
ROUTING = [
    ("neddf", [], False), ("nerf", [], False), ("neus", [], False),
    ("neddf", ["network.ddf_layer_count=10"], True),
    ("neddf", ["network.ddf_layer_count=9"], False),
    ("neddf", ["network.col_layer_count=10"], True),
    ("neddf", ["network.col_layer_count=9"], False),
    ("nerf", ["network.layer_count=13"], True),
    ("nerf", ["network.layer_count=12"], False),
    ("neus", ["network.sdf_layer_count=13"], True),
    ("neus", ["network.sdf_layer_count=12"], False),
    ("neus", ["network.col_layer_count=12"], True),
    ("neus", ["network.col_layer_count=11"], False),
    ("neddf", ["network.ddf_layer_count=12", "network.col_layer_count=10",
               "network.skips=[4,8]"], True),
    ("nerf", ["network.layer_count=16", "network.skips=[4,8,12]"], True),
    ("neus", ["network.sdf_layer_count=16", "network.col_layer_count=12",
              "network.skips=[4,8,12]"], True),
]
# the deep configurations at width 16 (the skips of DEEP_OVERRIDES)
DEEP = {
    "neddf": ([], dict(embed_pos_rank=4, embed_dir_rank=2, ddf_layer_count=12,
                       ddf_layer_width=16, col_layer_count=10, col_layer_width=16,
                       skips=[4, 8], compute_dtype="float32")),
    "nerf": (["network=nerf", "render=nerf_render", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=16, layer_width=16,
                  skips=[4, 8, 12], compute_dtype="float32")),
    "neus": (["network=neus", "loss=nerf_loss"],
             dict(embed_pos_rank=4, embed_dir_rank=2, sdf_layer_count=16, sdf_layer_width=16,
                  col_layer_count=12, col_layer_width=16, skips=[4, 8, 12])),
}
WIDE_FIELD = dict(embed_pos_rank=4, embed_dir_rank=2, ddf_layer_count=4, ddf_layer_width=2056,
                  col_layer_count=3, col_layer_width=16, d_near=0.001, skips=(1,),
                  lowpass_alpha_offset=4, activation_type="tanhExp",
                  density_activation_type="ReLU", compute_dtype="float32")
KEYS = ("distance", "density", "color", "fields_penalty", "aux_grad")
TOL = {"distance": 1e-5, "color": 1e-5, "aux_grad": 1e-5, "density": 1e-4,
       "fields_penalty": 1e-4}


def _close(got, ref, bound, what=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= bound * max(np.abs(ref).max(), 1e-6), (what, err, np.abs(ref).max())


def _nets(renderer):
    nets = [renderer.network_fine]
    if getattr(renderer, "use_coarse_network", False):
        nets.append(renderer.network_coarse)
    return nets


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("family, overrides, per_layer", ROUTING,
                         ids=[f"{f}-{'-'.join(o) or 'shipped'}" for f, o, _ in ROUTING])
def test_routing_follows_the_fused_kernels_refusals(family, overrides, per_layer):
    cfg = tconfig.compose(REPO / "config", overrides=[*FAMILY[family], *overrides])
    field = tconfig.instantiate(cfg["network"])
    assert field.tp_group is None
    assert field.per_layer is per_layer


# -------------------------------------------------------- the deep steps
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    pytest.importorskip("jax")
    from neddf_tpu.data.synthetic import generate_sphere_dataset

    return generate_sphere_dataset(tmp_path_factory.mktemp("scene"), n_train=2, n_test=1,
                                   image_size=16)


@pytest.mark.parametrize("family", list(DEEP))
def test_deep_step_takes_the_route_and_matches_jax(scene, monkeypatch, family):
    import jax

    from neddf_tpu import config as jconfig
    from neddf_tpu_torch.training.checkpoint import params_from_jax
    from tests.test_torch_train_field import _flat_grads
    from tests.test_torch_train_step import _jax_draws, _jax_grads

    overrides, network = DEEP[family]
    cfg = tconfig.compose(REPO / "config", overrides=["dataset=test", "trainer=test", *overrides])
    cfg["dataset"]["dataset_dir"] = str(scene)
    cfg["network"].update(network)
    cfg["network"]["fused"] = "off"
    cfg["render"].update({"sample_coarse": 8, "sample_fine": 8})
    cfg["trainer"].update({"batch_size": 16, "chunk": 64})
    jtr = jconfig.instantiate(cfg["trainer"], global_config=cfg)
    grads_fn = jax.jit(jtr._local_grads, static_argnums=(8, 9))
    ttr = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    ttr.neural_render.load_state_dict(params_from_jax(jtr.params), strict=True)
    nets = _nets(ttr.neural_render)
    assert all(net.per_layer and net.tp_group is None for net in nets)

    key = jax.random.PRNGKey(11)
    loss, loss_dict, mse, grads, _ = _jax_grads(jtr, grads_fn, key, 1, 5)
    ttr.iteration = 5
    us, vs, u_strat, u_pdf = _jax_draws(jtr, key)
    layers = []
    layer_fwd = tdm.ProductsPlain.layer_fwd

    def counted(self, xs, w, b, act_name, stash):
        layers.append(w.shape[1])
        return layer_fwd(self, xs, w, b, act_name, stash)

    monkeypatch.setattr(tdm.ProductsPlain, "layer_fwd", counted)
    fused = (tdm.dual_mlp_trunk_plain, tdm.dual_mlp_seg_plain, tmlp.mlp_seg_plain,
             tgrad.sdf_trunk_with_grad)
    before = [fn.calls for fn in fused]
    tloss, tdict, tmse = ttr.step_grads(1, us.long(), vs.long(), u_strat, u_pdf)
    # the route's walk ran every layer of every trunk, the fused route never
    trunk_layers = sum(len(getattr(net, name)) for net in nets
                       for name in ("layers_ddf", "layers_col", "layers", "layers_sdf")
                       if hasattr(net, name))
    assert len(layers) >= trunk_layers
    assert [fn.calls for fn in fused] == before

    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tmse.item(), float(mse), rtol=1e-5)
    assert set(tdict) == set(loss_dict)
    for k in loss_dict:
        np.testing.assert_allclose(tdict[k].item(), float(loss_dict[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    jgrads = _flat_grads(grads)
    for name, p in ttr.neural_render.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


# ------------------------------------------------------------ width 2056
def test_neddf_2056_field_matches_jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from neddf_tpu.fields.neddf import NeDDF as JNeDDF
    from neddf_tpu.geometry.rays import Sampling as JSampling
    from neddf_tpu_torch.fields.neddf import NeDDF
    from neddf_tpu_torch.geometry.rays import Sampling
    from neddf_tpu_torch.training.checkpoint import params_from_jax
    from tests.test_torch_train_field import _flat_grads, _sampling

    jfield = JNeDDF(**WIDE_FIELD, fused="off")
    params = jfield.init(jax.random.PRNGKey(4))
    field = NeDDF(**WIDE_FIELD)
    field.load_state_dict(params_from_jax(params), strict=True)
    assert field.per_layer
    pos, d, var = _sampling(b=2, s=6, seed=3)
    jsamp = JSampling(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(var))
    sched = 2000
    ref = jfield.apply(params, jsamp, jfield.schedule(sched), need_aux=True)
    walks = tepi.neddf_epilogue_plain.calls, tepi.neddf_epilogue_bwd_plain.calls
    got = field(Sampling(*map(torch.from_numpy, (pos, d, var))), field.schedule(sched),
                need_aux=True)
    for k in KEYS:
        _close(got[k].detach().numpy(), ref[k], TOL[k], k)
    rng = np.random.default_rng(5)
    weights = {k: rng.normal(size=np.shape(ref[k])).astype(np.float32) for k in KEYS}

    def jloss(p):
        out = jfield.apply(p, jsamp, jfield.schedule(sched), need_aux=True)
        return sum(jnp.sum(out[k] * weights[k]) for k in KEYS)

    jgrads = _flat_grads(jax.grad(jloss)(params))
    sum(torch.sum(got[k] * torch.from_numpy(weights[k])) for k in KEYS).backward()
    # the epilogue on its own (the per-layer route's), forward and backward
    assert (tepi.neddf_epilogue_plain.calls, tepi.neddf_epilogue_bwd_plain.calls) == (
        walks[0] + 1, walks[1] + 1)
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


def test_epilogue_at_2056_matches_the_pallas_epilogue(jx):
    width = 2056
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(width, M, seed=11)
    g_out[3:9] = 0.0
    jnp = jx.jnp
    out, t_feat = tepi.neddf_epilogue(v, j, wd, wa, b2, scal, "ReLU")
    got = tepi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")

    def f(v_, j_, wd_, wa_, b2_):
        return jx.epi.neddf_epilogue(v_, j_, wd_[:, None], wa_[:, None], b2_,
                                     jnp.asarray(scal.numpy()), "float32", True)

    with jx.dm.matmul_dtype(jnp.float32):
        (packed, tf), vjp = jx.jax.vjp(
            f, jnp.asarray(_pad(v.numpy(), ROWS_JAX)), jnp.asarray(_pad(j.numpy(), ROWS_JAX, 1)),
            *(jnp.asarray(x.numpy()) for x in (wd, wa, b2)))
        g_packed = np.zeros(packed.shape, np.float32)
        g_packed[:M, :10] = g_out.numpy().T
        ref = vjp((jnp.asarray(g_packed), jnp.asarray(_pad(g_t.numpy(), ROWS_JAX))))
    np.testing.assert_allclose(out.numpy().T, np.asarray(packed)[:M, :10], rtol=1e-5, atol=1e-5)
    assert _rel(t_feat, np.asarray(tf)[:M]) <= 1e-5
    for name, g, r in zip(("dv", "dj", "dwd", "dwa", "db2"), got, ref):
        r = np.asarray(r, np.float32)
        r = r[:M] if name == "dv" else r[:, :M] if name == "dj" else r
        assert _rel(g, r) <= 1e-4, name


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


CARD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", [2056, 3072, 4096, 8200])
def test_cuda_epilogue_past_2048_matches_plain(width, dtype):
    dev = _card()
    cd = DTYPES[dtype]
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(width, 3001, seed=width, dtype=cd,
                                                     device=dev)
    out, t_feat = tepi.neddf_epilogue(v, j, wd, wa, b2, scal, "ReLU")
    pout, pt = tepi.neddf_epilogue_plain(v, j, wd, wa, b2, scal, "ReLU")
    assert _rel(out.cpu(), pout.cpu()) <= 1e-4
    assert _rel(t_feat.cpu(), pt.cpu()) <= CARD_TOL[dtype]
    args = (v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    got = tepi.neddf_epilogue_bwd(*args)
    want = tepi.neddf_epilogue_bwd_plain(*args)
    for name, a, b in zip(("dv", "dj", "dwd", "dwa", "db2"), got, want):
        assert _rel(a.cpu(), b.cpu()) <= (CARD_TOL[dtype] if name in ("dv", "dj") else 1e-4), name
    again = tepi.neddf_epilogue_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got[2:], again[2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(DEEP))
def test_cuda_deep_field_takes_the_route_and_matches_plain(family):
    """The deep configurations at width 256 on the card (f32, tanhExp: no
    kink) run the route's kernels, no fused wrapper, and match their plain
    versions (``fused="off"``)."""
    from neddf_tpu_torch.fields.neddf import NeDDF
    from neddf_tpu_torch.fields.nerf import NeRF
    from neddf_tpu_torch.fields.neus import NeuS
    from neddf_tpu_torch.geometry.rays import Sampling

    dev = _card()
    torch.manual_seed(0)
    if family == "neddf":
        field = NeDDF(ddf_layer_count=12, col_layer_count=10, skips=(4, 8)).to(dev)
        keys = KEYS
        route = (tdm.dual_mlp_layers, tepi.neddf_epilogue_bwd)
        fused = (tdm.dual_mlp_trunk, tdm.dual_mlp_seg, tepi.neddf_epilogue_gstack)
    elif family == "nerf":
        field = NeRF(layer_count=16, skips=(4, 8, 12), activation_type="tanhExp").to(dev)
        keys, route, fused = ("density", "color"), (tmlp.mlp_seg_layers,), (tmlp.mlp_seg,)
    else:
        field = NeuS(sdf_layer_count=16, col_layer_count=12, skips=(4, 8, 12),
                     activation_type="tanhExp").to(dev)
        keys = ("sdf", "density", "color")
        route, fused = (tmlp.mlp_seg_layers, tsdf.sdf_mlp_layers), (tmlp.mlp_seg, tsdf.sdf_mlp)
    assert field.per_layer
    g = torch.Generator(device=dev).manual_seed(2)
    pos = torch.rand((8, 37, 3), generator=g, device=dev) - 0.5
    dirs = torch.randn((8, 37, 3), generator=g, device=dev)
    sampling = Sampling(pos, dirs / dirs.norm(dim=-1, keepdim=True),
                        torch.rand((8, 37, 3), generator=g, device=dev) * 1e-5)

    def step():
        field.zero_grad(set_to_none=True)
        out = field(sampling, field.schedule(0), need_aux=True)
        w = torch.Generator(device=dev).manual_seed(1)
        sum(torch.sum(out[k].float() * torch.randn(out[k].shape, generator=w, device=dev))
            for k in keys).backward()
        return ({k: out[k].detach().float().cpu() for k in keys},
                {n: p.grad.detach().cpu() for n, p in field.named_parameters()})

    for fn in route + fused:
        fn.launches = 0
    got = step()
    assert all(fn.launches > 0 for fn in route) and not any(fn.launches for fn in fused)
    field.fused = "off"
    want = step()
    for k in keys:
        assert torch.isfinite(got[0][k]).all() and _rel(got[0][k], want[0][k]) <= 1e-4, k
    for name, grad in want[1].items():
        assert _rel(got[1][name], grad) <= 1e-3, name
