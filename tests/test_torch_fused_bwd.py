"""The backwards of ``sdf_mlp`` and ``mlp_seg`` as their kernels walk them,
with the elementwise passes folded into the products' epilogues and
prologues, and the two repairs that came with them: LeakyReLU, and
``fused="auto"`` on the card where the kernels refuse a configuration.

* The walks (``sdf_mlp.sdf_mlp_bwd_route``, ``mlp.mlp_seg_bwd_route``)
  over the plain launchers ``sdf_mlp.SDFProductsPlain`` /
  ``mlp.MLPProductsPlain`` (the same methods as the card's
  ``SDFProducts`` / ``MLPProducts``, in PyTorch) against the plain versions
  (``sdf_trunk_with_grad_vjp``, ``mlp_seg_bwd_plain``) and the JAX
  package's Pallas kernels in interpret mode, with a post-skip layer, a
  3-wide last layer and ragged rows (the Pallas kernels take whole tiles:
  their inputs get zero rows with zero cotangents, which add nothing).
  Under an activation whose f'' is zero the sweep's walk writes no q or
  zs plane.
* LeakyReLU: f, f', f'' against ``neddf_tpu.ops.activations`` and the
  Pallas kernels' ``_act_fns``, at 0 too; a NeuS and a NeDDF field with
  it against the JAX package. The kernels take it (and ReLU on the dual
  trunks), so every field with it runs its kernels on the card.
* ``fields.base.use_kernels`` on a CUDA device (no tensor needed) sends
  every configuration to the kernels; the kernel modules' refusal
  predicates, which their wrappers raise NotImplementedError on, take
  every width up to 512 and every activation of the configs, and refuse
  a width over 512, K=1 on the trunk and more layers than the kernels
  hold. No plain version runs on the card.
* On the card (marked ``cuda``): the fused routes against their plain
  versions, their launch counts, the dual kernels under ReLU and
  LeakyReLU, and the parallel db sum bitwise equal across two runs.

Tolerances: f32, sums in another order: 1e-4 of the largest magnitude
for the sweep (as ``test_torch_sdf_mlp.py``), 1e-5 for ``mlp_seg`` (as
``test_torch_mlp_seg.py``); bf16 2^-5 for the gradients (a value on a
rounding boundary may round the other way and carry one bf16 step).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.fields.base import use_kernels
from neddf_tpu_torch.fields.neddf import NeDDF
from neddf_tpu_torch.fields.nerf import NeRF
from neddf_tpu_torch.fields.neus import NeuS
from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import activations as tact
from neddf_tpu_torch.ops import sdf_grad as tgrad
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

L, C, E = 4, 24, 30
SDF_LAYOUT = (False, False, True, False)
SDF_TOL = 1e-4
MLP_C = 32
MLP_CONFIGS = {
    # NeRF-like: one segment, [h, seg0] after layer 1
    "skip": dict(widths=(24,), layout=(False, False, True, False), out=MLP_C, act="ReLU"),
    # NeuS-colour-like: four segments, a 3-wide last layer
    "narrow": dict(widths=(3, 12, 3, MLP_C), layout=(False,) * 4, out=3, act="ReLU"),
    "tanhexp": dict(widths=(16, 8), layout=(False, True, False), out=3, act="tanhExp"),
    "leaky": dict(widths=(24,), layout=(False, False, True, False), out=MLP_C, act="LeakyReLU"),
}
MLP_TOL = {"float32": 1e-5, "bfloat16": 2.0**-5}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.mlp as jmlp
    import neddf_tpu.kernels.sdf_mlp as jsdf
    import neddf_tpu.ops.activations as jact

    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, mlp=jmlp, sdf=jsdf, act=jact)


def _rel(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref.float() if isinstance(ref, torch.Tensor) else ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _pad(a, rows):
    return np.concatenate([a, np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)])


# ------------------------------------------------------------ sdf_mlp walk
def _sdf_inputs(m, seed):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(m, E)).astype(np.float32)
    ws, bs = [], []
    for li in range(L):
        fan = E if li == 0 else C + E * SDF_LAYOUT[li]
        ws.append((rng.normal(size=(fan, C)) * 0.4).astype(np.float32))
        bs.append((rng.normal(size=C) * 0.1).astype(np.float32))
    return e, ws, bs, rng.normal(size=(m, C)).astype(np.float32), rng.normal(
        size=(m, E)).astype(np.float32)


def _sdf_route(e, ws, bs, ch, cg, act):
    te, tws, tbs = torch.from_numpy(e), list(map(torch.from_numpy, ws)), list(
        map(torch.from_numpy, bs))
    _, _, pres = tgrad.sdf_trunk_with_grad(te, tws, tbs, SDF_LAYOUT, act, stash=True)
    args = (te, tws, SDF_LAYOUT, act, pres, torch.from_numpy(ch), torch.from_numpy(cg))
    launcher = tsdf.SDFProductsPlain(torch.float32)
    return tsdf.sdf_mlp_bwd_route(*args, launcher), tgrad.sdf_trunk_with_grad_vjp(*args), \
        launcher


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU", "tanhExp"])
def test_sdf_route_matches_plain_and_pallas(jx, act, tiles):
    m = 512 * tiles - 45  # ragged: the Pallas kernel gets zero rows to 512 * tiles
    e, ws, bs, ch, cg = _sdf_inputs(m, seed=10 + tiles)
    got, plain, _ = _sdf_route(e, ws, bs, ch, cg, act)
    jnp = jx.jnp
    rows = 512 * tiles
    pch, pcg = jnp.asarray(_pad(ch, rows)), jnp.asarray(_pad(cg, rows))

    def loss(e_, w_, b_):
        h, g_e = jx.sdf.sdf_mlp(e_, w_, b_, SDF_LAYOUT, act, "float32", True)
        return jnp.sum(h * pch) + jnp.sum(g_e * pcg)

    with jx.dm.matmul_dtype(jnp.float32):
        jde, jdw, jdb = jx.jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(_pad(e, rows)), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    for ref in (plain, (np.asarray(jde)[:m], jdw, jdb)):
        assert _rel(got[0], ref[0]) <= SDF_TOL
        for i in range(L):
            assert _rel(got[1][i], ref[1][i]) <= SDF_TOL, ("dW", i)
            assert _rel(got[2][i], ref[2][i]) <= SDF_TOL, ("db", i)


@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU", "tanhExp"])
def test_sdf_route_keeps_no_q_or_zs_where_f2_is_zero(act):
    e, ws, bs, ch, cg = _sdf_inputs(200, seed=3)
    got, plain, launcher = _sdf_route(e, ws, bs, ch, cg, act)
    for g, r in zip([got[0], *got[1], *got[2]], [plain[0], *plain[1], *plain[2]]):
        assert _rel(g, r) <= SDF_TOL
    kept = {name: launcher.planes.count(name) for name in ("q", "zs", "p", "gpre")}
    if act == "tanhExp":
        # q_1 .. q_{L-1} kept, zs for every layer (the top's from onehot0)
        assert kept == {"q": L - 1, "zs": L, "p": 1, "gpre": 1}
    else:
        assert kept == {"q": 0, "zs": 0, "p": 1, "gpre": 1}


# ------------------------------------------------------------ mlp_seg walk
def _mlp_inputs(cfg, m, seed):
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in cfg["widths"]]
    ws, bs = [], []
    n = len(cfg["layout"])
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else MLP_C + cfg["widths"][0] * split
        out = cfg["out"] if li == n - 1 else MLP_C
        ws.append(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=out).astype(np.float32))
    return vs, ws, bs, rng.normal(size=(m, cfg["out"])).astype(np.float32)


@pytest.mark.parametrize("dtype, tiles", [("float32", 1), ("float32", 2), ("bfloat16", 1)])
@pytest.mark.parametrize("name", list(MLP_CONFIGS))
def test_mlp_route_matches_plain_and_pallas(jx, name, dtype, tiles):
    cfg = MLP_CONFIGS[name]
    rows = jx.mlp.TILE_M * tiles
    m = rows - 37
    vs, ws, bs, g = _mlp_inputs(cfg, m, seed=tiles)
    cd = getattr(torch, dtype)
    tvs = [torch.from_numpy(v).to(cd) for v in vs]
    tws = [torch.from_numpy(w).to(cd) for w in ws]
    tbs = list(map(torch.from_numpy, bs))
    _, pres = tmlp.mlp_seg_plain(tvs, tws, tbs, cfg["layout"], cfg["act"], stash=True)
    args = (tvs, tws, cfg["layout"], cfg["act"], pres, torch.from_numpy(g).to(cd))
    got = tmlp.mlp_seg_bwd_route(*args, tmlp.MLPProductsPlain(cd))
    plain = tmlp.mlp_seg_bwd_plain(*args)

    jnp = jx.jnp
    pg = jnp.asarray(_pad(np.asarray(torch.from_numpy(g).to(cd).float()), rows))

    def loss(v_, w_, b_):
        out = jx.mlp.mlp_seg(v_, w_, b_, cfg["layout"], cfg["act"], dtype, True)
        return jnp.sum(out.astype(jnp.float32) * pg)

    jvs = tuple(jnp.asarray(_pad(v, rows), dtype) for v in vs)
    with jx.dm.matmul_dtype(jnp.dtype(dtype)), jx.mlp.mlp_stash(True):
        jgrads = jx.jax.grad(loss, argnums=(0, 1, 2))(jvs, tuple(map(jnp.asarray, ws)),
                                                      tuple(map(jnp.asarray, bs)))
    tol = MLP_TOL[dtype]
    for ref in (plain, ([np.asarray(d, np.float32)[:m] for d in jgrads[0]], *jgrads[1:])):
        for kind, tt, rr in zip(("dv", "dW", "db"), got, ref):
            for i, (t, r) in enumerate(zip(tt, rr)):
                assert _rel(t, r) <= tol, (kind, i)


# ---------------------------------------------------------------- LeakyReLU
def test_leaky_relu_triple_matches_jax(jx):
    x = np.concatenate([np.linspace(-3, 3, 61), [0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7]])
    x = x.astype(np.float32)
    f, df, ddf = tact.ACTIVATION_TRIPLES["LeakyReLU"]
    tx = torch.from_numpy(x)
    jf, jdf, jddf = jx.dm._act_fns("LeakyReLU")
    jxx = jx.jnp.asarray(x)
    for got, refs in ((f(tx), (jx.act.leaky_relu(jxx), jf(jxx))),
                      (df(tx), (jx.act.leaky_relu_deriv(jxx), jdf(jxx))),
                      (ddf(tx), (np.zeros_like(x), jddf(jxx)))):
        for ref in refs:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))
    assert df(torch.zeros(1)).item() == 1.0  # x >= 0: not the slope autograd gives
    assert "LeakyReLU" in tact.SECOND_DERIVATIVE_ZERO


def test_leaky_relu_neus_field_matches_jax(jx):
    from tests.test_torch_nerf_neus_field import NEUS, JNeuS, _outputs_and_grads
    from tests.test_torch_train_field import _close
    from neddf_tpu_torch.training.checkpoint import params_from_jax

    cfg = dict(NEUS, activation_type="LeakyReLU")
    jfield = JNeuS(**cfg, fused="off", normals="reverse")
    params = jfield.init(jx.jax.random.PRNGKey(5))
    field = NeuS(**cfg)
    field.load_state_dict(params_from_jax(params), strict=True)
    with jx.dm.matmul_dtype(jx.jnp.float32):
        ref, got, jgrads = _outputs_and_grads(jfield, params, field, 0,
                                              ("sdf", "density", "color"), seed=2)
    for k in ("sdf", "density", "color"):
        _close(got[k].detach().numpy(), ref[k], 1e-5, k)
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


def test_leaky_relu_neddf_field_matches_jax(jx):
    from tests.test_torch_train_field import FIELD, KEYS, TOL, JNeDDF, _close, _flat_grads, \
        _train_outputs
    from neddf_tpu_torch.training.checkpoint import params_from_jax

    cfg = dict(FIELD, activation_type="LeakyReLU")
    jfield = JNeDDF(**cfg, fused="off")
    params = jfield.init(jx.jax.random.PRNGKey(1))
    field = NeDDF(**cfg)
    field.load_state_dict(params_from_jax(params), strict=True)
    jsamp, ref, got = _train_outputs(jfield, params, field, 20000, seed=1)
    for k in KEYS:
        _close(got[k].detach().numpy(), ref[k], TOL[k], k)
    weights = {k: np.random.default_rng(2).normal(size=np.shape(ref[k])).astype(np.float32)
               for k in KEYS}

    def jloss(p):
        out = jfield.apply(p, jsamp, jfield.schedule(20000), need_aux=True)
        return sum(jx.jnp.sum(out[k] * weights[k]) for k in KEYS)

    jgrads = _flat_grads(jx.jax.jit(jx.jax.grad(jloss))(params))
    sum(torch.sum(got[k] * torch.from_numpy(weights[k])) for k in KEYS).backward()
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


# ------------------------------------------------------------ fused="auto"
CUDA = torch.device("cuda")  # a device object only: no tensor is made on it


def _refusal(net):
    """What the kernels that ``net`` runs refuse of its configuration, by
    the kernel modules' own predicates (None: they take it all)."""
    act = net.activation_type
    if isinstance(net, NeDDF):
        col = (net.layers_col[0].w.shape[1], len(net.layers_col))
        return (tdm.kernel_refusal(act, net.layers_ddf[0].w.shape[1], len(net.layers_ddf), 3)
                or tdm.kernel_refusal(act, *col, 1, trunk=False)
                or tmlp.kernel_refusal(act, *col, 4))
    if isinstance(net, NeuS):
        return (tsdf.kernel_refusal(act, net.layers_sdf[0].w.shape[1], len(net.layers_sdf))
                or tmlp.kernel_refusal(act, net.layers_col[0].w.shape[1], len(net.layers_col), 4))
    return tmlp.kernel_refusal(act, net.layers[0].w.shape[1], len(net.layers))


@pytest.mark.parametrize("field, refusal", [
    (lambda: NeDDF(ddf_layer_width=576), "width 576 > 512"),
    (lambda: NeDDF(activation_type="ReLU"), None),
    (lambda: NeDDF(activation_type="LeakyReLU"), None),
    (lambda: NeRF(activation_type="LeakyReLU"), None),
    (lambda: NeuS(activation_type="LeakyReLU"), None),
    (lambda: NeuS(col_layer_width=128), None),
    (lambda: NeDDF(ddf_layer_width=128), None),
    (lambda: NeDDF(ddf_layer_width=512, col_layer_width=512, activation_type="Softplus",
                   density_activation_type="LeakyReLU"), None),
    (lambda: NeuS(sdf_layer_width=128, col_layer_width=128, activation_type="Softplus"), None),
    (lambda: NeRF(layer_width=200, activation_type="Sigmoid"), None),
    (lambda: NeRF(layer_width=576), "width 576 > 512"),
], ids=["neddf_width", "neddf_relu", "neddf_leaky", "nerf_leaky", "neus_leaky",
        "neus_col_width", "neddf_width_128", "neddf_wide_softplus", "neus_narrow_softplus",
        "nerf_200_sigmoid", "nerf_width_576"])
def test_auto_sends_every_configuration_to_the_kernels_on_the_card(field, refusal):
    net = field()
    name = type(net).__name__
    assert use_kernels("auto", CUDA, name) and use_kernels("on", CUDA, name)
    assert not use_kernels("auto", torch.device("cpu"), name)
    assert not use_kernels("off", CUDA, name)
    assert _refusal(net) == refusal


@pytest.mark.parametrize("field", [NeDDF, NeRF, NeuS])
def test_shipped_configurations_take_the_kernels(field):
    net = field()
    assert _refusal(net) is None
    assert use_kernels("auto", CUDA, field.__name__)
    assert use_kernels("on", CUDA, field.__name__)


def test_kernel_checks_raise_on_what_the_predicate_refuses():
    e = torch.zeros((10, 36))
    ws = [torch.zeros((36, 576))] + [torch.zeros((576, 576))] * 3
    bs = [torch.zeros(576)] * 4
    with pytest.raises(NotImplementedError, match="width 576 > 512"):
        tsdf._check_kernel_args(e, ws, bs, (False,) * 4, "ReLU")
    # width 128 and Softplus: taken since the kernels have width classes
    # and the Softplus / Sigmoid activations
    tsdf._check_kernel_args(e, [torch.zeros((36, 128))] + [torch.zeros((128, 128))] * 3,
                            [torch.zeros(128)] * 4, (False,) * 4, "Softplus")
    with pytest.raises(NotImplementedError, match="13 layers"):
        tmlp._check_kernel_args([torch.zeros((10, 36))], [torch.zeros((36, 256))] * 13,
                                [torch.zeros(256)] * 13, (False,) * 13, "Softplus")
    tmlp._check_kernel_args([torch.zeros((10, 36))], [torch.zeros((36, 256))],
                            [torch.zeros(256)], (False,), "Softplus")
    tmlp._check_kernel_args([torch.zeros((10, 36))], [torch.zeros((36, 256))],
                            [torch.zeros(256)], (False,), "LeakyReLU")
    assert tdm.kernel_refusal("tanhExp", 256, 8, 3) is None
    assert tdm.kernel_refusal("tanhExp", 256, 8, 1) == "K=1"
    assert tdm.kernel_refusal("tanhExp", 256, 8, 1, trunk=False) is None
    assert tmlp.kernel_refusal("ReLU", 256, 13) == "13 layers"


@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU", "tanhExp", "Softplus", "Sigmoid"])
def test_dual_kernel_checks_take_every_activation_of_the_configs(act):
    layout = tuple(li == 5 for li in range(8))
    ws = [torch.zeros((60, 256))] + [torch.zeros((316 if s else 256, 256)) for s in layout[1:]]
    bs = [torch.zeros(256)] * 8
    tdm._check_kernel_args(torch.zeros((10, 60)), torch.zeros((3, 10, 60)), ws, bs, layout,
                           act)
    wide = [torch.zeros((60, 576))] + [torch.zeros((636 if s else 576, 576))
                                       for s in layout[1:]]
    with pytest.raises(NotImplementedError, match="width 576 > 512"):
        tdm._check_kernel_args(torch.zeros((10, 60)), torch.zeros((3, 10, 60)), wide,
                               [torch.zeros(576)] * 8, layout, act)


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU", "tanhExp"])
def test_cuda_fused_sdf_backward_matches_plain(act):
    dev = _card()
    rng = np.random.default_rng(1)
    m, e_dim = 2 * 128 + 77, 36
    layout = tuple(li == 5 for li in range(8))
    e = torch.tensor(rng.uniform(-1, 1, size=(m, e_dim)), dtype=torch.float32, device=dev)
    ws, bs = [], []
    for li, split in enumerate(layout):
        fan = e_dim if li == 0 else 256 + e_dim * split
        ws.append(torch.tensor(rng.uniform(-1, 1, size=(fan, 256)) / fan ** 0.5,
                               dtype=torch.float32, device=dev))
        bs.append(torch.tensor(rng.uniform(-1, 1, size=256) / fan ** 0.5,
                               dtype=torch.float32, device=dev))
    _, _, pres = tgrad.sdf_trunk_with_grad(e, ws, bs, layout, act, stash=True)
    ch = torch.tensor(rng.normal(size=(m, 256)), dtype=torch.float32, device=dev)
    cg = torch.tensor(rng.normal(size=(m, e_dim)), dtype=torch.float32, device=dev)
    args = (e, ws, layout, act, pres, ch, cg)
    passes = (tsdf.PASS_LAUNCHES["sdf_top"], tmlp.PASS_LAUNCHES["gpre"])
    kern = tsdf.sdf_mlp_bwd(*args)
    torch.cuda.synchronize()
    assert (tsdf.PASS_LAUNCHES["sdf_top"], tmlp.PASS_LAUNCHES["gpre"]) == (passes[0] + 1,
                                                                           passes[1] + 1)
    plain = tgrad.sdf_trunk_with_grad_vjp(*args)
    for g, r in zip([kern[0], *kern[1], *kern[2]], [plain[0], *plain[1], *plain[2]]):
        assert _rel(g.cpu(), r.cpu()) <= SDF_TOL
    again = tsdf.sdf_mlp_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(kern[1] + kern[2], again[1] + again[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["nerf", "neus_color"])
def test_cuda_fused_mlp_backward_matches_plain(name, dtype, act):
    dev = _card()
    cd = getattr(torch, dtype)
    rng = np.random.default_rng(2)
    m = 3 * 128 + 5
    if name == "nerf":
        widths, layout = (60,), tuple(li == 5 for li in range(8))
        fans, outs = [60] + [316 if li == 5 else 256 for li in range(1, 8)], [256] * 8
    else:
        widths, layout = (3, 24, 3, 256), (False,) * 9
        fans, outs = [286] + [256] * 8, [256] * 8 + [3]
    vs = [torch.tensor(rng.uniform(-1, 1, size=(m, w)), device=dev).to(cd) for w in widths]
    ws = [torch.tensor(rng.uniform(-1, 1, size=(f, o)) / f ** 0.5, device=dev).to(cd)
          for f, o in zip(fans, outs)]
    bs = [torch.tensor(rng.uniform(-0.1, 0.1, size=o), dtype=torch.float32, device=dev)
          for o in outs]
    _, pres = tmlp.mlp_seg_plain(vs, ws, bs, layout, act, stash=True)
    g = (torch.tensor(rng.normal(size=(m, outs[-1])), device=dev) * 0.01).to(cd)
    args = (vs, ws, layout, act, pres, g)
    counts = (tmlp.PASS_LAUNCHES["gpre"], *tdm.folded_launches().values())
    kern = tmlp.mlp_seg_bwd(*args)
    torch.cuda.synchronize()
    n_l = len(ws)
    assert (tmlp.PASS_LAUNCHES["gpre"], *tdm.folded_launches().values()) == (
        counts[0] + 1, counts[1] + n_l - 1, counts[2] + n_l - 1)
    plain = tmlp.mlp_seg_bwd_plain(*args)
    tol = MLP_TOL[dtype] if dtype == "bfloat16" else 1e-4
    for g_, r in zip(sum(kern, []), sum(plain, [])):
        assert _rel(g_.cpu(), r.cpu()) <= tol
    again = tmlp.mlp_seg_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(kern[1] + kern[2], again[1] + again[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 1552, 3104])
def test_cuda_db_sum_is_parallel_and_repeatable(rows):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows)
    parts = torch.randn((rows, 256), generator=gen, device=dev)
    k = tdm.Products(torch.float32, dev)
    first, second = k.sum_rows(parts), k.sum_rows(parts)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ref = parts.double().sum(dim=0)
    assert ((first.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU"])
def test_cuda_dual_kernels_take_relu_and_leaky_relu(act, dtype):
    """The K=3 trunk forward's value stream and stash (the tangents follow
    f', a step at 0: chip_smoke.py phase 6 holds them layer by layer) and
    the backward on the plain stash, against the plain versions."""
    dev = _card()
    cd = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    m = 2 * 128 + 33
    layout = tuple(li == 5 for li in range(8))
    fans = [60] + [316 if s else 256 for s in layout[1:]]
    v0 = torch.tensor(rng.uniform(-1, 1, size=(m, 60)), device=dev).to(cd)
    j0 = torch.tensor(rng.uniform(-0.1, 0.1, size=(3, m, 60)), device=dev).to(cd)
    ws = [torch.tensor(rng.uniform(-1, 1, size=(f, 256)) / f ** 0.5, device=dev).to(cd)
          for f in fans]
    bs = [torch.tensor(rng.uniform(-0.1, 0.1, size=256), dtype=torch.float32, device=dev)
          for _ in fans]
    fk = tdm.dual_mlp_trunk(v0, j0, ws, bs, layout, act, stash=True)
    fp = tdm.dual_mlp_seg_plain([v0], [j0], ws, bs, layout, act, (True,), 3, stash=True)
    tol = MLP_TOL[dtype] if dtype == "bfloat16" else 1e-4
    for got, ref in [(fk[0], fp[0])] + [(a[0], b[0]) for a, b in zip(fk[2], fp[2])]:
        assert _rel(got.cpu(), ref.cpu()) <= tol
    gv = torch.tensor(rng.normal(size=(m, 256)) * 0.01, device=dev).to(cd)
    gj = torch.tensor(rng.normal(size=(3, m, 256)) * 0.01, device=dev).to(cd)
    args = ([v0], [j0], ws, layout, act, (True,), fp[2], gv, gj)
    kern = tdm.dual_mlp_seg_bwd(*args)
    plain = tdm.dual_mlp_seg_bwd_plain(*args)
    for g, r in zip(sum(kern, []), sum(plain, [])):
        assert _rel(g.cpu(), r.cpu()) <= tol
