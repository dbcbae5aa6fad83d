"""The NeDDF epilogue's backward with the K=3 trunk's top layer
(``kernels/neddf_epilogue.py``: ``neddf_epilogue_gstack`` and the
autograd op ``DDFTrunkEpilogue``) and the dual backward started from a
given stacked cotangent (``dual_mlp_seg_bwd_route`` / ``_plain`` with
``top``).

* ``neddf_epilogue_gstack_plain`` is the composition it replaces: the
  epilogue's VJP, the add of v_feat's other cotangent in the compute
  dtype, the top layer's ``gstack``; under ReLU and LeakyReLU it reads no
  tangent stash.
* The walk from a given top: the same launches as from gv / gj but the
  ``gstack``, and the plain backward from it equals the plain backward
  from gv / gj.
* ``DDFTrunkEpilogue``'s gradients (trunk weights and biases, wd, wa, b2,
  the embedding planes) against the two-op path it replaces
  (``DualMLPSeg`` then ``NeDDFEpilogue``, autograd adding v_feat's two
  cotangents), and against the JAX package's VJP of ``dual_mlp_seg`` then
  ``neddf_epilogue`` with the Pallas kernels in interpret mode; f32 and
  bf16, tanhExp, ReLU and LeakyReLU.
* On the card (marked ``cuda``): the top mode against its plain version
  at the fine pass's 99,328 rows and a ragged 33,287, both dtypes and all
  three activations; gs bitwise equal to the standalone kernel, torch's
  add and ``DualProducts.gstack``; two runs bitwise equal; no tangent
  stash read under f'' = 0.

Tolerances. Against the two-op path every gradient is bitwise equal but
the top layer's db, which is summed in 64-row blocks here and in one
``sum`` there: 1e-6 of its largest magnitude. Against the Pallas VJP, as
``test_torch_dual_fold.py``: f32 1e-4 (torch's and XLA's tanh differ by
an ulp near 1, which f'' multiplies), bf16 2^-4 (a value on a bf16
rounding boundary may round the other way and carry one bf16 step on).
On the card, the top mode against its plain version: ``chip_smoke.py``'s
BWD_REL_TOL (f32 1e-4, bf16 2^-5) of each output's largest magnitude.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.ops.activations import SECOND_DERIVATIVE_ZERO

C = 32
C0 = 24
LAYOUT = (False, False, True, False)  # layer 2 consumes [embed, h]
M = 512 - 45  # ragged
ROWS_JAX = 512  # one row tile of the Pallas kernels
ACTS = ("tanhExp", "ReLU", "LeakyReLU")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_TOL = {"float32": 1e-4, "bfloat16": 2.0**-4}
# d_near, aux_grad_scale, distance_range_max and penalty weights large
# enough that every penalty's gradient shows
SCAL = np.array([0.001, 0.8, 1.5, 0.5, 1.0, 1.0, 1.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.neddf_epilogue as jepi

    assert (jdm.TILE_M, jepi.TILE) == (ROWS_JAX, ROWS_JAX)
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, epi=jepi)


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _params(m=M, seed=0, c=C, c0=C0, layout=LAYOUT):
    """numpy f32 inputs of the op: the trunk's embedding planes, weights
    and biases, the heads, and the cotangents of (v_feat, out, t_feat)."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for li, split in enumerate(layout):
        fan = c0 if li == 0 else c + c0 * split
        ws.append(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, c)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=c).astype(np.float32))
    return dict(
        emb_v=rng.normal(size=(m, c0)).astype(np.float32),
        emb_j=(rng.normal(size=(3, m, c0)) * 0.5).astype(np.float32),
        ws=ws, bs=bs,
        wd=rng.normal(scale=2.0 * c ** -0.5, size=c).astype(np.float32),
        wa=rng.normal(scale=2.0 * c ** -0.5, size=c).astype(np.float32),
        b2=np.array([0.3, -0.2], np.float32), scal=SCAL,
        g_v=(rng.normal(size=(m, c)) * 0.1).astype(np.float32),
        g_out=rng.normal(size=(10, m)).astype(np.float32),
        g_t=(rng.normal(size=(m, c)) * 0.1).astype(np.float32))


def _leaves(p, cd, device="cpu"):
    """The op's differentiable inputs as torch leaves (embedding planes in
    the compute dtype, parameters f32) and its cotangents."""
    def t(a, dt=torch.float32):
        return torch.tensor(a, device=device).to(dt).requires_grad_()

    leaves = dict(emb_v=t(p["emb_v"], cd), emb_j=t(p["emb_j"], cd),
                  ws=[t(w) for w in p["ws"]], bs=[t(b) for b in p["bs"]],
                  wd=t(p["wd"]), wa=t(p["wa"]), b2=t(p["b2"]))
    scal = torch.tensor(p["scal"], device=device)
    cots = (torch.tensor(p["g_v"], device=device).to(cd),
            torch.tensor(p["g_out"], device=device),
            torch.tensor(p["g_t"], device=device).to(cd))
    return leaves, scal, cots


def _inputs(leaves):
    x = leaves
    return [x["emb_v"], x["emb_j"], *x["ws"], *x["bs"], x["wd"], x["wa"], x["b2"]]


def _grads_fused(leaves, scal, cots, act, cd, use_kernels=False, layout=LAYOUT):
    x = leaves
    outs = tepi.DDFTrunkEpilogue.apply(
        (layout, act, cd, use_kernels, "ReLU"), x["emb_v"], x["emb_j"], x["wd"], x["wa"],
        x["b2"], scal, *x["ws"], *x["bs"])
    return torch.autograd.grad(outs, _inputs(leaves), cots)


def _grads_two_ops(leaves, scal, cots, act, cd):
    x = leaves
    v, j = tdm.dual_mlp_apply([x["emb_v"]], [x["emb_j"]], x["ws"], x["bs"], LAYOUT, act,
                              (True,), 3, cd, False)
    out, t_feat = tepi.NeDDFEpilogue.apply((False, "ReLU"), v, j, x["wd"], x["wa"], x["b2"],
                                           scal)
    return torch.autograd.grad((v, out, t_feat), _inputs(leaves), cots)


def _names(layout=LAYOUT):
    n = len(layout)
    return (["emb_v", "emb_j"] + [f"w{i}" for i in range(n)] + [f"b{i}" for i in range(n)]
            + ["wd", "wa", "b2"])


def _epilogue_args(p, cd, act, device="cpu"):
    """Seeded trunk streams, the top stash and the cotangents of the top
    mode, from the plain trunk forward."""
    leaves, scal, (g_v, g_out, g_t) = _leaves(p, cd, device)
    with torch.no_grad():
        v, j, pres = tdm.dual_mlp_seg_plain(
            [leaves["emb_v"]], [leaves["emb_j"]], [w.to(cd) for w in leaves["ws"]],
            leaves["bs"], LAYOUT, act, (True,), 3, stash=True)
        return (v, j, leaves["wd"].detach(), leaves["wa"].detach(), leaves["b2"].detach(),
                scal, g_out, g_t, g_v, pres[-1], act, "ReLU")


# ------------------------------------------------- the plain top mode
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gstack_plain_is_the_epilogue_vjp_then_the_add_then_gstack(dtype, act):
    cd = DTYPES[dtype]
    args = _epilogue_args(_params(seed=1), cd, act)
    v, j, wd, wa, b2, scal, g_out, g_t, g_v, z, _, _ = args
    gs, dwd, dwa, db2, db = tepi.neddf_epilogue_gstack(*args)  # CPU: the plain version
    dv, dj, rwd, rwa, rb2 = tepi.neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_t,
                                                          "ReLU")
    gv = dv + g_v  # autograd's add of v_feat's two cotangents, in the compute dtype
    assert gv.dtype == cd
    ref = tdm.DualProductsPlain(cd).gstack(gv, dj, z, act)
    assert gs.dtype == cd and tuple(gs.shape) == (4, M, C)
    for got, want in zip((gs, dwd, dwa, db2, db), (ref[0], rwd, rwa, rb2, ref[1])):
        assert torch.equal(got, want)
    # the stacked cotangent as the plain dual backward forms it from g
    _, df, ddf = tdm.ACTIVATION_TRIPLES[act]
    zf, g = z.float(), torch.cat([gv[None], dj], dim=0).float()
    gpre = g[0] * df(zf[0]) + ddf(zf[0]) * torch.sum(g[1:] * zf[1:], dim=0)
    want = torch.cat([gpre[None], g[1:] * df(zf[0])], dim=0).to(cd)
    assert _rel(gs, want) <= (1e-6 if dtype == "float32" else 2.0**-8)


@pytest.mark.parametrize("act", ACTS)
def test_gstack_plain_reads_the_tangent_stash_only_where_f2_is_not_zero(act):
    args = list(_epilogue_args(_params(m=37, seed=2), torch.float32, act))
    args[9] = args[9].clone()
    args[9][1:] = float("nan")  # a read of the tangent stash shows in gs
    gs, _, _, _, db = tepi.neddf_epilogue_gstack_plain(*args)
    assert bool(torch.isfinite(gs).all() and torch.isfinite(db).all()) == (
        act in SECOND_DERIVATIVE_ZERO)


def test_gstack_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = _epilogue_args(_params(m=37, seed=3), torch.float32, "tanhExp")
    calls, launches = tepi.neddf_epilogue_gstack_plain.calls, tepi.neddf_epilogue_gstack.launches
    tepi.neddf_epilogue_gstack(*args)
    assert tepi.neddf_epilogue_gstack_plain.calls == calls + 1
    assert tepi.neddf_epilogue_gstack.launches == launches


# ------------------------------------------- the dual backward from a given top
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_walk_from_a_given_top_skips_gstack_and_matches_the_walk_from_g(dtype):
    cd = DTYPES[dtype]
    act = "tanhExp"
    p = _params(seed=4)
    vs, js = [torch.tensor(p["emb_v"]).to(cd)], [torch.tensor(p["emb_j"]).to(cd)]
    ws = [torch.tensor(w).to(cd) for w in p["ws"]]
    bs = [torch.tensor(b) for b in p["bs"]]
    _, _, pres = tdm.dual_mlp_seg_plain(vs, js, ws, bs, LAYOUT, act, (True,), 3, stash=True)
    gv = torch.tensor(p["g_v"]).to(cd)
    gj = torch.tensor(np.random.default_rng(5).normal(size=(3, M, C)) * 0.1,
                      dtype=torch.float32).to(cd)
    args = (vs, js, ws, LAYOUT, act, (True,), pres)
    top = tdm.DualProductsPlain(cd).gstack(gv, gj, pres[-1], act)
    from_g, from_top = tdm.DualProductsPlain(cd), tdm.DualProductsPlain(cd)
    ref = tdm.dual_mlp_seg_bwd_route(*args, gv, gj, from_g)
    got = tdm.dual_mlp_seg_bwd_route(*args, None, None, from_top, top=top)
    assert from_g.planes == ["gstack"] + from_top.planes
    for gg, rr in zip(got, ref):
        for g, r in zip(gg, rr):
            assert torch.equal(g, r)
    # the plain backward from the top: its db as given, all else as from
    # gv / gj (whose top db is one sum, the given one of 64-row blocks)
    plain_got = tdm.dual_mlp_seg_bwd_plain(*args, None, None, top=top)
    plain_ref = tdm.dual_mlp_seg_bwd_plain(*args, gv, gj)
    for kind, gg, rr in zip(("dv", "dj", "dW", "db"), plain_got, plain_ref):
        for i, (g, r) in enumerate(zip(gg, rr)):
            if kind == "db" and i == len(gg) - 1:
                assert g is top[1] and _rel(g, r) <= 1e-6
            else:
                assert torch.equal(g, r), (kind, i)


# --------------------------------------------------------- the autograd op
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_gradients_match_the_two_op_path(dtype, act):
    cd = DTYPES[dtype]
    p = _params(seed=6)
    leaves, scal, cots = _leaves(p, cd)
    got = _grads_fused(leaves, scal, cots, act, cd)
    ref = _grads_two_ops(leaves, scal, cots, act, cd)
    top_db = 2 + 2 * len(LAYOUT) - 1
    for i, (name, g, r) in enumerate(zip(_names(), got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if i == top_db:
            assert _rel(g, r) <= 1e-6, name
        else:
            assert torch.equal(g, r), name


def test_op_forward_outputs_match_the_two_op_path():
    cd = torch.bfloat16
    leaves, scal, _ = _leaves(_params(seed=7), cd)
    x = leaves
    with torch.no_grad():
        got = tepi.DDFTrunkEpilogue.apply((LAYOUT, "tanhExp", cd, True, "ReLU"), x["emb_v"],
                                          x["emb_j"], x["wd"], x["wa"], x["b2"], scal,
                                          *x["ws"], *x["bs"])
        v, j = tdm.dual_mlp_apply([x["emb_v"]], [x["emb_j"]], x["ws"], x["bs"], LAYOUT,
                                  "tanhExp", (True,), 3, cd, False)
        out, t_feat = tepi.NeDDFEpilogue.apply((False, "ReLU"), v, j, x["wd"], x["wa"], x["b2"],
                                           scal)
    for g, r in zip(got, (v, out, t_feat)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_op_gradients_match_the_pallas_vjp(jx, dtype, act):
    """The JAX package's VJP of ``dual_mlp_seg`` then ``neddf_epilogue``
    (interpret mode), v_feat's two cotangents added by JAX."""
    cd = DTYPES[dtype]
    p = _params(m=ROWS_JAX, seed=8)
    leaves, scal, cots = _leaves(p, cd)
    got = _grads_fused(leaves, scal, cots, act, cd, use_kernels=True)  # CPU: plain versions
    jnp = jx.jnp
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def f(emb_v, emb_j, ws, bs, wd, wa, b2):
        v, j = jx.dm.dual_mlp_seg((emb_v,), (emb_j,), ws, bs, LAYOUT, act, (True,), dtype,
                                  True)
        packed, t_feat = jx.epi.neddf_epilogue(v, j, wd[:, None], wa[:, None], b2,
                                               jnp.asarray(p["scal"]), dtype, True)
        return v, packed, t_feat

    with jx.dm.matmul_dtype(jnp.dtype(dtype)):
        primals = (jnp.asarray(p["emb_v"]).astype(jd), jnp.asarray(p["emb_j"]).astype(jd),
                   tuple(jnp.asarray(w) for w in p["ws"]), tuple(jnp.asarray(b) for b in p["bs"]),
                   jnp.asarray(p["wd"]), jnp.asarray(p["wa"]), jnp.asarray(p["b2"]))
        _, vjp = jx.jax.vjp(f, *primals)
        g_packed = jnp.zeros((ROWS_JAX, 16), jnp.float32).at[:, :10].set(
            jnp.asarray(p["g_out"].T))
        ref = vjp((jnp.asarray(p["g_v"]).astype(jd), g_packed,
                   jnp.asarray(p["g_t"]).astype(jd)))
    refs = [ref[0], ref[1], *ref[2], *ref[3], ref[4], ref[5], ref[6]]
    for name, g, r in zip(_names(), got, refs):
        r = torch.from_numpy(np.array(r, np.float32))
        assert tuple(g.shape) == tuple(r.shape), name
        assert _rel(g, r) <= JAX_TOL[dtype], name


# ------------------------------------------------------------------ on the card
M_FINE = 512 * 194  # the train step's fine pass
M_RAGGED = 512 * 65 + 7
BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _card_args(dtype, act, m, dev, seed=0):
    """The top mode's inputs at width 256 on the card: the trunk's streams
    and stash at a realistic scale, seeded cotangents."""
    cd = DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    v = randn(m, 256).to(cd)
    j = randn(3, m, 256, scale=0.3).to(cd)
    z = randn(4, m, 256).to(cd)
    wd, wa = randn(256, scale=1 / 16), randn(256, scale=1 / 16)
    b2 = torch.tensor([0.3, -0.2], device=dev)
    scal = torch.tensor(SCAL, device=dev)
    g_out = randn(10, m)
    g_t, g_v = randn(m, 256, scale=0.1).to(cd), randn(m, 256, scale=0.1).to(cd)
    return v, j, wd, wa, b2, scal, g_out, g_t, g_v, z, act, "ReLU"


@pytest.mark.cuda
@pytest.mark.parametrize("m", [M_FINE, M_RAGGED])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_top_mode_matches_plain_and_the_composition(dtype, act, m):
    dev = _card()
    args = _card_args(dtype, act, m, dev, seed=m)
    launches = tepi.neddf_epilogue_gstack.launches
    got = tepi.neddf_epilogue_gstack(*args)
    torch.cuda.synchronize()
    assert tepi.neddf_epilogue_gstack.launches == launches + 1
    ref = tepi.neddf_epilogue_gstack_plain(*args)
    for name, g, r in zip(("gs", "dwd", "dwa", "db2", "db"), got, ref):
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, r) <= BWD_REL_TOL[dtype], name
    # gs bitwise: the standalone kernel, torch's add, the top gstack
    v, j, wd, wa, b2, scal, g_out, g_t, g_v, z, _, _ = args
    dv, dj, *_ = tepi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    gs, _ = tdm.DualProducts(v.dtype, dev).gstack(dv + g_v, dj, z, act)
    assert torch.equal(got[0], gs)
    again = tepi.neddf_epilogue_gstack(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_standalone_mode_matches_plain_and_repeats(dtype):
    dev = _card()
    v, j, wd, wa, b2, scal, g_out, g_t, *_ = _card_args(dtype, "tanhExp", M_RAGGED, dev)
    got = tepi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    ref = tepi.neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    for g, r in zip(got, ref):
        assert _rel(g, r) <= BWD_REL_TOL[dtype]
    again = tepi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
def test_cuda_top_mode_reads_no_tangent_stash_where_f2_is_zero(act):
    dev = _card()
    args = list(_card_args("float32", act, 4096 + 77, dev))
    args[9][1:] = float("nan")
    gs, _, _, _, db = tepi.neddf_epilogue_gstack(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(gs).all() and torch.isfinite(db).all()) == (
        act in SECOND_DERIVATIVE_ZERO)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_op_gradients_match_the_plain_op(dtype):
    """DDFTrunkEpilogue through the kernels against its plain versions at
    width 256 (the trunk of 7 layers with the post-skip after layer 4)."""
    dev = _card()
    cd = DTYPES[dtype]
    layout = tuple(li == 5 for li in range(7))
    p = _params(m=4096 + 77, seed=9, c=256, c0=60, layout=layout)
    leaves, scal, cots = _leaves(p, cd, dev)
    got = _grads_fused(leaves, scal, cots, "tanhExp", cd, True, layout)
    ref = _grads_fused(leaves, scal, cots, "tanhExp", cd, False, layout)
    tol = 1e-4 if dtype == "float32" else 2.0**-4
    for name, g, r in zip(_names(layout), got, ref):
        assert _rel(g, r) <= tol, name
