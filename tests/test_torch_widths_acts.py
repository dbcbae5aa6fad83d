"""The port's kernels at every width up to 512 and with the Softplus and
Sigmoid activations, and NeDDF's density activation on the training path.

On the CPU, at narrow widths (48 and 96: not a multiple of 64 or of any
width class, so on the card they run on a padded class):

* Softplus and Sigmoid: f, f' and f'' against the Pallas kernels'
  ``_act_fns`` and ``neddf_tpu.ops.activations``, at 0 and around the
  threshold of 20.
* The kernels' walks over their plain launchers (``DualProductsPlain``,
  ``MLPProductsPlain``, ``SDFProductsPlain`` through ``*_bwd_route``) with
  the two activations, against the plain versions and the JAX package's
  Pallas kernels in interpret mode (both f'' routes: the dual backward's
  coupling, the sweep's q and zs planes).
* The epilogue's plain versions with each density activation: the
  hand-written backward against autograd of the plain forward, and under
  ReLU against the Pallas epilogue's VJP.
* NeDDF's training forward and every parameter gradient with
  ``density_activation_type`` LeakyReLU, Softplus and Sigmoid against the
  JAX package at ``fused="off"`` (the jnp path applies the configured
  activation; the port's training path raised before).
* ``kernel_refusal`` of every kernel module takes every width from 1 to
  512 under each of the five activations and refuses 513 and up with a
  message that names the width.

On the card (marked ``cuda``, skipped here): each kernel against its
plain version at the widths 45, 64, 96, 128, 200 and 512 under Softplus
and Sigmoid (and the density activations), forward and backward, f32 and
bf16, with ragged rows; dW bitwise equal over two runs; the dual
backward's tangent stash read under both activations (a NaN there shows).

Also on the card, ReLU and LeakyReLU at the widths 96, 200 and 512, f32
and bf16, through ``chip_smoke.grid_case`` (phase 21's check of every
route): there a pre-activation within a rounding of 0 may take the other
side of the kink in the kernel than in the plain pass, so the forwards
are held layer by layer over the kernel's own stash, and a direct
disagreement is allowed only where such a flip happened.

Tolerances. The dual walk against its plain version as
``test_torch_dual_fold.py`` (f32 1e-6, bf16 2^-8, db 1e-6); the walks
against the Pallas kernels, and the mlp and sdf walks, as
``test_torch_dual_fold.py`` and ``test_torch_fused_bwd.py``: f32 1e-4 of
the largest magnitude (1e-5 for ``mlp_seg``), bf16 2^-4 against the
Pallas VJP (2^-5 for ``mlp_seg``); the epilogue's backward against
autograd 1e-5; the field against the JAX package as
``test_torch_train_field.py`` (outputs 1e-5, density and penalties 1e-4,
gradients 1e-4 of their largest magnitude). On the card: f32 1e-4, bf16
2^-4 on gradients (a value on a rounding boundary may round the other
way and carry one bf16 step through the layers below).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import activations as tact
from neddf_tpu_torch.ops import sdf_grad as tgrad

NEW_ACTS = ("Softplus", "Sigmoid")
ALL_ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")
DENSITY_ACTS = ("ReLU", "LeakyReLU", "Softplus", "Sigmoid")
ROWS_JAX = 512  # one row tile of the Pallas kernels
M = ROWS_JAX - 45  # ragged
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_TOL = {"float32": 1e-4, "bfloat16": 2.0**-4}
# the dual walk against its plain version (test_torch_dual_fold.py's bars;
# db 1e-6): the same math in another order
PLAIN_TOL = {"float32": 1e-6, "bfloat16": 2.0**-8}
MLP_TOL = {"float32": 1e-5, "bfloat16": 2.0**-5}
# (width, activation, dtype) of the walks: each width with each activation
# once, f32 and bf16 both
WALKS = [(48, "Softplus", "float32"), (96, "Sigmoid", "float32"),
         (48, "Sigmoid", "bfloat16"), (96, "Softplus", "bfloat16")]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.mlp as jmlp
    import neddf_tpu.kernels.neddf_epilogue as jepi
    import neddf_tpu.kernels.sdf_mlp as jsdf
    import neddf_tpu.ops.activations as jact

    assert jdm.TILE_M == ROWS_JAX
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, mlp=jmlp, sdf=jsdf, epi=jepi, act=jact)


def _rel(got, ref):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref.detach().float() if isinstance(ref, torch.Tensor) else ref,
                     np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _pad(a, rows, axis=0):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, rows - a.shape[axis])
    return np.pad(a, pad)


# ------------------------------------------------------------ activations
@pytest.mark.parametrize("act", NEW_ACTS)
def test_softplus_sigmoid_triples_match_jax(jx, act):
    x = np.concatenate([np.linspace(-30, 30, 121), [0.0, -0.0, 19.9, 20.0, 20.0001, 20.5,
                                                    -20.5, 1e-7, -1e-7, 88.0, -88.0]])
    x = x.astype(np.float32)
    tx, jxx = torch.from_numpy(x), jx.jnp.asarray(x)
    got = [fn(tx).numpy() for fn in tact.ACTIVATION_TRIPLES[act]]
    kern = [np.asarray(fn(jxx), np.float32) for fn in jx.dm._act_fns(act)]
    ops = {"Softplus": (jx.act.softplus, jx.act.softplus_deriv),
           "Sigmoid": (jx.act.sigmoid, jx.act.sigmoid_deriv)}[act]
    for k, (g, r) in enumerate(zip(got, kern)):
        np.testing.assert_allclose(g, r, rtol=2e-6, atol=1e-7, err_msg=f"derivative {k}")
    for k, fn in enumerate(ops):
        np.testing.assert_allclose(got[k], np.asarray(fn(jxx), np.float32), rtol=2e-6,
                                   atol=1e-7)
    at0 = [g[x == 0][0] for g in got]
    want0 = {"Softplus": (np.log(2.0), 0.5, 0.25), "Sigmoid": (0.5, 0.25, 0.0)}[act]
    np.testing.assert_allclose(at0, want0, rtol=1e-6, atol=1e-7)
    if act == "Softplus":  # linear above 20: f = x, f' = 1, f'' = 0 exactly
        above = x > 20.0
        np.testing.assert_array_equal(got[0][above], x[above])
        assert (got[1][above] == 1.0).all() and (got[2][above] == 0.0).all()
    assert act not in tact.SECOND_DERIVATIVE_ZERO


# ------------------------------------------------------------- dual walk
def _dual_cfg(width):
    # the K=3 trunk with a post-skip layer, the K=1 colour trunk's segments
    return {"trunk": dict(widths=(24,), has_j=(True,), n_tan=3,
                          layout=(False, False, True, False)),
            "color": dict(widths=(24, 12, 3, width), has_j=(True, False, False, True),
                          n_tan=1, layout=(False, False, False))}


def _dual_inputs(cfg, width, dtype, act, seed):
    rng = np.random.default_rng(seed)
    k = cfg["n_tan"]

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=torch.float32).to(dt)

    vs = [t(rng.normal(size=(M, w))) for w in cfg["widths"]]
    js = [t(rng.normal(size=(k, M, w))) for w, h in zip(cfg["widths"], cfg["has_j"]) if h]
    ws, bs = [], []
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else width + cfg["widths"][0] * split
        ws.append(t(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, width))))
        bs.append(t(rng.normal(scale=0.1, size=width), torch.float32))
    _, _, pres = tdm.dual_mlp_seg_plain(vs, js, ws, bs, cfg["layout"], act, cfg["has_j"], k,
                                        stash=True)
    gv, gj = t(rng.normal(size=(M, width))), t(rng.normal(size=(k, M, width)))
    return (vs, js, ws, cfg["layout"], act, cfg["has_j"], pres, gv, gj), bs


@pytest.mark.parametrize("width, act, dtype", WALKS)
def test_dual_walk_matches_plain_and_pallas(jx, width, act, dtype):
    name = "trunk" if dtype == "float32" else "color"
    cfg = _dual_cfg(width)[name]
    cd = DTYPES[dtype]
    args, bs = _dual_inputs(cfg, width, cd, act, seed=width)
    got = tdm.dual_mlp_seg_bwd_route(*args, tdm.DualProductsPlain(cd))
    plain = tdm.dual_mlp_seg_bwd_plain(*args)
    vs, js, ws, layout, _, has_j, _, gv, gj = args
    jnp = jx.jnp

    def j(t, axis=0):
        return jnp.asarray(_pad(t.float().numpy(), ROWS_JAX, axis),
                           None if dtype == "float32" else jnp.bfloat16)

    def f(vs_, js_, ws_, bs_):
        return jx.dm.dual_mlp_seg(vs_, js_, ws_, bs_, layout, act, has_j, dtype, True)

    with jx.dm.matmul_dtype(jnp.dtype(dtype)):
        _, vjp = jx.jax.vjp(f, tuple(j(v) for v in vs), tuple(j(t, 1) for t in js),
                            tuple(jnp.asarray(w.float().numpy()) for w in ws),
                            tuple(jnp.asarray(b.numpy()) for b in bs))
        ref = vjp((j(gv), j(gj, 1)))
    for kind, gg, pp, rr in zip(("dv", "dj", "dW", "db"), got, plain, ref):
        for i, (g, p, r) in enumerate(zip(gg, pp, rr)):
            r = np.asarray(r, np.float32)
            r = r[:M] if kind == "dv" else r[:, :M] if kind == "dj" else r
            assert tuple(g.shape) == r.shape, (kind, i)
            assert _rel(g, p) <= (1e-6 if kind == "db" else PLAIN_TOL[dtype]), (kind, i)
            assert _rel(g, r) <= JAX_TOL[dtype], (kind, i)


# --------------------------------------------------------------- mlp walk
@pytest.mark.parametrize("width, act, dtype", WALKS[:2])
def test_mlp_walk_matches_plain_and_pallas(jx, width, act, dtype):
    rng = np.random.default_rng(width + 1)
    widths, layout, n_out = (24,), (False, False, True, False), 3  # [h, seg0] after layer 1
    vs = [rng.normal(size=(M, w)).astype(np.float32) for w in widths]
    ws, bs = [], []
    for li, split in enumerate(layout):
        fan = sum(widths) if li == 0 else width + widths[0] * split
        out = n_out if li == len(layout) - 1 else width
        ws.append(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=out).astype(np.float32))
    g = rng.normal(size=(M, n_out)).astype(np.float32)
    rows = jx.mlp.TILE_M  # the Pallas mlp's row tile (1024)
    tvs, tws, tbs = ([torch.from_numpy(a) for a in x] for x in (vs, ws, bs))
    _, pres = tmlp.mlp_seg_plain(tvs, tws, tbs, layout, act, stash=True)
    args = (tvs, tws, layout, act, pres, torch.from_numpy(g))
    got = tmlp.mlp_seg_bwd_route(*args, tmlp.MLPProductsPlain(torch.float32))
    plain = tmlp.mlp_seg_bwd_plain(*args)
    jnp = jx.jnp
    pg = jnp.asarray(_pad(g, rows))

    def loss(v_, w_, b_):
        return jnp.sum(jx.mlp.mlp_seg(v_, w_, b_, layout, act, dtype, True) * pg)

    with jx.dm.matmul_dtype(jnp.float32), jx.mlp.mlp_stash(True):
        jgrads = jx.jax.grad(loss, argnums=(0, 1, 2))(
            tuple(jnp.asarray(_pad(v, rows)) for v in vs), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)))
    ref = ([np.asarray(d)[:M] for d in jgrads[0]], *jgrads[1:])
    for kind, gg, pp, rr in zip(("dv", "dW", "db"), got, plain, ref):
        for i, (t, p, r) in enumerate(zip(gg, pp, rr)):
            assert _rel(t, p) <= MLP_TOL[dtype] and _rel(t, r) <= MLP_TOL[dtype], (kind, i)


# --------------------------------------------------------------- sdf walk
@pytest.mark.parametrize("width, act", [(w, a) for w, a, _ in WALKS[:2]])
def test_sdf_walk_matches_plain_and_pallas(jx, width, act):
    rng = np.random.default_rng(width + 2)
    e_dim, layout = 30, (False, False, True, False)
    e = rng.normal(size=(M, e_dim)).astype(np.float32)
    ws, bs = [], []
    for li in range(len(layout)):
        fan = e_dim if li == 0 else width + e_dim * layout[li]
        ws.append((rng.normal(size=(fan, width)) * 1.5 * fan ** -0.5).astype(np.float32))
        bs.append((rng.normal(size=width) * 0.1).astype(np.float32))
    ch = rng.normal(size=(M, width)).astype(np.float32)
    cg = rng.normal(size=(M, e_dim)).astype(np.float32)
    te, tws, tbs = torch.from_numpy(e), list(map(torch.from_numpy, ws)), list(
        map(torch.from_numpy, bs))
    _, _, pres = tgrad.sdf_trunk_with_grad(te, tws, tbs, layout, act, stash=True)
    args = (te, tws, layout, act, pres, torch.from_numpy(ch), torch.from_numpy(cg))
    launcher = tsdf.SDFProductsPlain(torch.float32)
    got = tsdf.sdf_mlp_bwd_route(*args, launcher)
    plain = tgrad.sdf_trunk_with_grad_vjp(*args)
    # the f'' route: q kept for every layer above 0, zs for every layer
    assert launcher.planes.count("q") == len(layout) - 1
    assert launcher.planes.count("zs") == len(layout)
    jnp = jx.jnp
    pch, pcg = jnp.asarray(_pad(ch, ROWS_JAX)), jnp.asarray(_pad(cg, ROWS_JAX))

    def loss(e_, w_, b_):
        h, g_e = jx.sdf.sdf_mlp(e_, w_, b_, layout, act, "float32", True)
        return jnp.sum(h * pch) + jnp.sum(g_e * pcg)

    with jx.dm.matmul_dtype(jnp.float32):
        jde, jdw, jdb = jx.jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(_pad(e, ROWS_JAX)), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)))
    for ref in (plain, (np.asarray(jde)[:M], jdw, jdb)):
        assert _rel(got[0], ref[0]) <= 1e-4
        for i in range(len(layout)):
            assert _rel(got[1][i], ref[1][i]) <= 1e-4, ("dW", i)
            assert _rel(got[2][i], ref[2][i]) <= 1e-4, ("db", i)


# ---------------------------------------------------------------- epilogue
SCAL = np.array([0.001, 0.8, 1.5, 0.5, 1.0, 1.0, 1.0, 0.0], np.float32)


def _epi_inputs(width, m, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dt)

    v = t(rng.normal(size=(m, width)) * 0.5, dtype)
    j = t(rng.normal(size=(3, m, width)) * 0.5, dtype)
    wd = t(rng.normal(scale=2.0 * width ** -0.5, size=width))
    wa = t(rng.normal(scale=2.0 * width ** -0.5, size=width))
    b2, scal = t([0.3, -0.2]), t(SCAL)
    g_out, g_t = t(rng.normal(size=(10, m))), t(rng.normal(size=(m, width)) * 0.1, dtype)
    return v, j, wd, wa, b2, scal, g_out, g_t


@pytest.mark.parametrize("dens", DENSITY_ACTS)
def test_epilogue_plain_backward_is_the_vjp_of_its_forward(dens):
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(48, 300, seed=7)
    # what the hand-written VJP stops the gradient of is left out: rows
    # 3:9 of out, the aux-grad penalty's scale (its weight 0) and grad D in
    # t_feat (no cotangent of t_feat; test_torch_epilogue_gstack.py holds
    # those against the Pallas VJP)
    g_out[3:9] = 0.0
    scal[3] = 0.0
    g_t = torch.zeros_like(g_t)
    leaves = [x.clone().requires_grad_() for x in (v, j, wd, wa, b2)]
    out, t_feat = tepi.neddf_epilogue_plain(*leaves, scal, dens)
    ref = torch.autograd.grad((out, t_feat), leaves, (g_out, g_t))
    got = tepi.neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_t, dens)
    for name, g, r in zip(("dv", "dj", "dwd", "dwa", "db2"), got, ref):
        assert _rel(g, r) <= 1e-5, name
    act = tact.ACTIVATION_TRIPLES[dens][0]
    relu_out, _ = tepi.neddf_epilogue_plain(v, j, wd, wa, b2, scal, "ReLU")
    # the density is the activation of the ReLU version's argument; the rest
    # does not depend on it
    m = tepi._math(v, j, wd, wa, b2, scal, dens)
    torch.testing.assert_close(out[0].detach(), act(m["dinv"] * (1.0 - m["d_ddt"])))
    torch.testing.assert_close(out[1:].detach(), relu_out[1:])


def test_epilogue_plain_relu_matches_the_pallas_vjp(jx):
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(48, M, seed=8)
    g_out[3:9] = 0.0
    jnp = jx.jnp
    out, t_feat = tepi.neddf_epilogue_plain(v, j, wd, wa, b2, scal, "ReLU")
    got = tepi.neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")

    def f(v_, j_, wd_, wa_, b2_):
        return jx.epi.neddf_epilogue(v_, j_, wd_[:, None], wa_[:, None], b2_,
                                     jnp.asarray(scal.numpy()), "float32", True)

    lanes = list(range(10))  # packed lanes 0-9: the rows of the port's out
    with jx.dm.matmul_dtype(jnp.float32):
        (packed, tf), vjp = jx.jax.vjp(
            f, jnp.asarray(_pad(v.numpy(), ROWS_JAX)), jnp.asarray(_pad(j.numpy(), ROWS_JAX, 1)),
            *(jnp.asarray(x.numpy()) for x in (wd, wa, b2)))
        g_packed = np.zeros(packed.shape, np.float32)
        g_packed[:M, lanes] = g_out.numpy().T
        ref = vjp((jnp.asarray(g_packed), jnp.asarray(_pad(g_t.numpy(), ROWS_JAX))))
    np.testing.assert_allclose(out.numpy().T, np.asarray(packed)[:M, :10], rtol=1e-5,
                               atol=1e-5)
    assert _rel(t_feat, np.asarray(tf)[:M]) <= 1e-5
    for name, g, r in zip(("dv", "dj", "dwd", "dwa", "db2"), got, ref):
        r = np.asarray(r, np.float32)
        r = r[:M] if name == "dv" else r[:, :M] if name == "dj" else r
        assert _rel(g, r) <= 1e-4, name


# ------------------------------------------------------------------- NeDDF
@pytest.mark.parametrize("dens", ["LeakyReLU", "Softplus", "Sigmoid"])
def test_neddf_trains_with_any_density_activation(jx, dens):
    """Forward and every parameter gradient of the training path against
    the JAX package's ``fused="off"`` (its jnp path), in f32."""
    from neddf_tpu_torch.fields.neddf import NeDDF
    from neddf_tpu_torch.training.checkpoint import params_from_jax
    from tests.test_torch_train_field import FIELD, KEYS, TOL, JNeDDF, _close, _flat_grads, \
        _train_outputs

    cfg = dict(FIELD, density_activation_type=dens, activation_type="Softplus")
    jfield = JNeDDF(**cfg, fused="off")
    params = jfield.init(jx.jax.random.PRNGKey(3))
    field = NeDDF(**cfg)
    field.load_state_dict(params_from_jax(params), strict=True)
    jsamp, ref, got = _train_outputs(jfield, params, field, 20000, seed=4)
    for k in KEYS:
        _close(got[k].detach().numpy(), ref[k], TOL[k], k)
    weights = {k: np.random.default_rng(5).normal(size=np.shape(ref[k])).astype(np.float32)
               for k in KEYS}

    def jloss(p):
        out = jfield.apply(p, jsamp, jfield.schedule(20000), need_aux=True)
        return sum(jx.jnp.sum(out[k] * weights[k]) for k in KEYS)

    jgrads = _flat_grads(jx.jax.jit(jx.jax.grad(jloss))(params))
    sum(torch.sum(got[k] * torch.from_numpy(weights[k])) for k in KEYS).backward()
    for name, p in field.named_parameters():
        _close(p.grad.numpy(), jgrads[name], 1e-4, name)


@pytest.mark.parametrize("width", [96, 512])
def test_jax_parameters_carry_across_at_other_widths(jx, width):
    """``params_from_jax`` / ``params_to_jax`` at widths 96 and 512: the
    JAX package's NeDDF and NeuS parameters load into the port's fields
    (strict) and come back bitwise."""
    from neddf_tpu.fields.neddf import NeDDF as JNeDDF
    from neddf_tpu.fields.neus import NeuS as JNeuS
    from neddf_tpu_torch.fields.neddf import NeDDF
    from neddf_tpu_torch.fields.neus import NeuS
    from neddf_tpu_torch.training.checkpoint import params_from_jax, params_to_jax

    for jcls, cls, cfg in (
            (JNeDDF, NeDDF, dict(ddf_layer_count=4, ddf_layer_width=width, col_layer_count=3,
                                 col_layer_width=width, skips=(1,))),
            (JNeuS, NeuS, dict(sdf_layer_count=4, sdf_layer_width=width, col_layer_count=3,
                               col_layer_width=width, skips=(1,)))):
        params = jx.jax.device_get(jcls(**cfg).init(jx.jax.random.PRNGKey(width)))
        sd = params_from_jax(params)
        field = cls(**cfg)
        field.load_state_dict(sd, strict=True)
        assert all(v.dim() < 2 or v.shape[-1] in (width, 1, 3) for v in sd.values())
        back = jx.jax.tree_util.tree_leaves(params_to_jax(sd))
        for a, b in zip(back, jx.jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- refusals
def test_every_width_up_to_512_and_every_activation_is_taken():
    for act in ALL_ACTS:
        for width in range(1, 513):
            assert tdm.kernel_refusal(act, width, 8, 3) is None, (act, width)
            assert tdm.kernel_refusal(act, width, 8, 1, trunk=False) is None, (act, width)
            assert tmlp.kernel_refusal(act, width, 8, 4) is None, (act, width)
            assert tsdf.kernel_refusal(act, width, 8) is None, (act, width)
        for width in (513, 576, 1024):
            for refusal in (tdm.kernel_refusal(act, width, 8, 3), tmlp.kernel_refusal(
                    act, width, 8), tsdf.kernel_refusal(act, width, 8)):
                assert refusal == f"width {width} > 512"
    # the epilogue's top mode finishes the fused trunk's top layer: its
    # widths; alone (the per-layer route's) it takes 576 too
    wide = (torch.zeros((4, 576)), torch.zeros((3, 4, 576)), torch.zeros(576),
            torch.zeros(576), torch.zeros(2), torch.zeros(8), "ReLU")
    with pytest.raises(NotImplementedError, match="width 576 > 512"):
        tepi._check_kernel_args(*wide, top=True)
    tepi._check_kernel_args(*wide)
    tepi._check_kernel_args(torch.zeros((4, 45)), torch.zeros((3, 4, 45)), torch.zeros(45),
                            torch.zeros(45), torch.zeros(2), torch.zeros(8), "Sigmoid")


# ------------------------------------------------------------------ on the card
CARD_WIDTHS = (45, 64, 96, 128, 200, 512)
M_CARD = 2048 + 77  # ragged against every row tile


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _card_cases():
    cases = [(w, a, "float32") for w in CARD_WIDTHS for a in NEW_ACTS]
    return cases + [(w, a, "bfloat16") for w in (45, 96, 200, 512) for a in NEW_ACTS]


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2.0**-4


@pytest.mark.cuda
@pytest.mark.parametrize("width, act, dtype", _card_cases())
def test_cuda_trunk_and_epilogue_match_plain(width, act, dtype):
    """DDFTrunkEpilogue (the K=3 trunk forward with its stash, the
    epilogue forward, the epilogue's top mode, the dual backward) through
    the kernels against its plain versions, the density through the
    activation under test too."""
    from tests.test_torch_epilogue_gstack import _leaves, _names, _params

    dev = _card()
    cd = DTYPES[dtype]
    layout = (False, False, False, True, False)
    p = _params(m=M_CARD, seed=width, c=width, c0=60, layout=layout)
    leaves, scal, cots = _leaves(p, cd, dev)
    x = leaves
    grads = []
    for kernels in (True, False, True):
        outs = tepi.DDFTrunkEpilogue.apply(
            (layout, act, cd, kernels, act), x["emb_v"], x["emb_j"], x["wd"], x["wa"],
            x["b2"], scal, *x["ws"], *x["bs"])
        grads.append((outs, torch.autograd.grad(outs, _grads_inputs(x), cots)))
    (ko, kg), (po, pg), (_, kg2) = grads
    for name, g, r in zip(("v_feat", "out", "t_feat"), ko, po):
        assert torch.isfinite(g).all(), name
        assert _rel(g.cpu(), r.cpu()) <= _tol(dtype), name
    for name, g, r, g2 in zip(_names(layout), kg, pg, kg2):
        assert _rel(g.cpu(), r.cpu()) <= _tol(dtype), name
        assert torch.equal(g, g2), ("not bitwise repeatable", name)


def _grads_inputs(x):
    return [x["emb_v"], x["emb_j"], *x["ws"], *x["bs"], x["wd"], x["wa"], x["b2"]]


@pytest.mark.cuda
@pytest.mark.parametrize("width, act, dtype", _card_cases())
def test_cuda_color_k1_and_mlp_seg_match_plain(width, act, dtype):
    """The K=1 colour trunk (four segments, the last ``width`` wide) and
    mlp_seg (a post-skip layer and a 3-wide last layer) through the
    kernels, forward and backward, against their plain versions."""
    dev = _card()
    cd = DTYPES[dtype]
    cfg = _dual_cfg(width)["color"]
    gen = torch.Generator(device=dev).manual_seed(width)

    def leaf(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt).requires_grad_()

    vs = [leaf(M_CARD, w, dt=cd) for w in cfg["widths"]]
    js = [leaf(1, M_CARD, w, dt=cd) for w, h in zip(cfg["widths"], cfg["has_j"]) if h]
    fans = [sum(cfg["widths"])] + [width] * (len(cfg["layout"]) - 1)
    ws = [leaf(f, width, scale=1.5 * f ** -0.5) for f in fans]
    bs = [leaf(width, scale=0.1) for _ in fans]
    cots = (torch.randn((M_CARD, width), generator=gen, device=dev).to(cd),
            torch.randn((1, M_CARD, width), generator=gen, device=dev).to(cd))
    res = {}
    for kernels in (True, False):
        outs = tdm.dual_mlp_apply(vs, js, ws, bs, cfg["layout"], act, cfg["has_j"], 1, cd,
                                  kernels)
        res[kernels] = (outs, torch.autograd.grad(outs, [*vs, *js, *ws, *bs], cots))
    for g, r in zip([*res[True][0], *res[True][1]], [*res[False][0], *res[False][1]]):
        assert _rel(g.detach().cpu(), r.detach().cpu()) <= _tol(dtype)

    layout = (False, False, True, False)
    segs = [leaf(M_CARD, 24, dt=cd)]
    fans = [24, width, width + 24, width]
    outs_w = [width, width, width, 3]
    ws = [leaf(f, o, scale=1.5 * f ** -0.5) for f, o in zip(fans, outs_w)]
    bs = [leaf(o, scale=0.1) for o in outs_w]
    cot = torch.randn((M_CARD, 3), generator=gen, device=dev).to(cd)
    res = {}
    for kernels in (True, False):
        out = tmlp.mlp_apply(segs, ws, bs, layout, act, cd, kernels)
        res[kernels] = (out, torch.autograd.grad(out, [*segs, *ws, *bs], cot))
    tol = {"float32": 1e-4, "bfloat16": 2.0**-4}[dtype]
    for g, r in zip([res[True][0], *res[True][1]], [res[False][0], *res[False][1]]):
        assert _rel(g.detach().cpu(), r.detach().cpu()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("width, act", [(w, a) for w in CARD_WIDTHS for a in NEW_ACTS])
def test_cuda_sdf_mlp_matches_plain(width, act):
    """sdf_mlp (the f32 trunk and the sweep) and its backward (the f''
    route: q and zs) through the kernels against the plain versions."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(width)
    e_dim, layout = 39, (False, False, True, False)
    e = torch.randn((M_CARD, e_dim), generator=gen, device=dev).requires_grad_()
    fans = [e_dim] + [width + e_dim * s for s in layout[1:]]
    ws = [(torch.randn((f, width), generator=gen, device=dev) * 1.5 * f ** -0.5)
          .requires_grad_() for f in fans]
    bs = [(torch.randn(width, generator=gen, device=dev) * 0.1).requires_grad_()
          for _ in fans]
    cots = (torch.randn((M_CARD, width), generator=gen, device=dev),
            torch.randn((M_CARD, e_dim), generator=gen, device=dev))
    res = {}
    for kernels in (True, False):
        outs = tsdf.sdf_apply(e, ws, bs, layout, act, kernels)
        res[kernels] = (outs, torch.autograd.grad(outs, [e, *ws, *bs], cots))
    for g, r in zip([*res[True][0], *res[True][1]], [*res[False][0], *res[False][1]]):
        assert _rel(g.detach().cpu(), r.detach().cpu()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("width", (45, 200))
@pytest.mark.parametrize("act", NEW_ACTS)
def test_cuda_stacked_cotangent_reads_the_tangent_stash(act, width):
    """Under Softplus and Sigmoid (f'' != 0) the top-layer and the grouped
    products' stacked cotangents read the tangent stash: a NaN there shows."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    m, s = 2048 + 77, 4
    z = torch.randn((s, m, width), generator=gen, device=dev)
    z[1:] = float("nan")
    gs = torch.randn((s, m, width), generator=gen, device=dev)
    w = torch.randn((width, width), generator=gen, device=dev) / 16
    k = tdm.DualProducts(torch.float32, dev)
    outs = [*k.gstack(gs[0], gs[1:], z, act), *k.nt_gstack(gs, w, z, act)]
    torch.cuda.synchronize()
    assert not any(bool(torch.isfinite(t).all()) for t in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("width", (96, 200, 512))
@pytest.mark.parametrize("act", ("ReLU", "LeakyReLU"))
def test_cuda_kink_activations_match_plain(act, width, dtype):
    """ReLU and LeakyReLU (f'' = 0, f' a step at 0) at padded and full
    widths: every route of phase 21 (``chip_smoke.grid_case``: the K=3
    trunk, the epilogue and its top mode, the dual backward, the K=1
    colour trunk, mlp_seg, sdf_mlp in f32) against its plain version on
    ragged rows; it exits non-zero on a disagreement."""
    import chip_smoke

    r = chip_smoke.grid_case(torch, _card(), width, act, DTYPES[dtype], M_CARD, False)
    assert r["tangent_stash_read"] is False
