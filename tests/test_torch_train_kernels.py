"""The training path's kernel routes: the plain PyTorch versions against
the Pallas kernels they port (interpret mode on the CPU, under
``matmul_dtype``), and the CUDA kernels against the plain versions on
the card (marked ``cuda``: they skip without one).

Routes: ``dual_mlp_seg`` forward with its pre-activation stash (K=1
colour configuration with ``has_j=(T, F, F, T)``, and K=3 with a
post-skip layer), its backward, and the ``neddf_epilogue`` forward and
backward.

Tolerances: in f32 both sides multiply the same operands and differ only
in summation order: 1e-5 relative and absolute on outputs. Gradients
that pass through f'' are held to 1e-4 of their largest magnitude: where
tanh(e^z) is within an ulp of 1, torch's and XLA's tanh round it
differently, and f'' = e^z (1 - tanh^2)(...) multiplies that ulp by
about 30 (the activation triples are held to the same 1e-4). In bf16
both round every layer's activations (and, in the backward, the stacked
cotangents) to bf16 and may round a value on a
rounding boundary differently, carrying one bf16 step (2^-8 relative)
on: 2^-5 of the output's largest magnitude forward, 2^-4 backward.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.ops import activations as tact
from neddf_tpu_torch.ops import dual as tdual
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

C = 32
M_JAX = 2 * 512  # two row tiles of the Pallas kernels (TILE_M = TILE = 512)
M_PORT = M_JAX + 37  # a ragged remainder on the port's side
COLOR = dict(widths=(24, 12, 3, C), has_j=(True, False, False, True), n_tan=1,
             layout=(False, False, False))
TRUNK = dict(widths=(24,), has_j=(True,), n_tan=3, layout=(False, False, True, False))
CONFIGS = {"color_k1": COLOR, "trunk_k3_skip": TRUNK}
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.neddf_epilogue as jepi
    from neddf_tpu.ops import dual as jdual

    assert (jdm.TILE_M, jepi.TILE) == (512, 512)
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, epi=jepi, dual=jdual)


def _mlp_inputs(cfg, m=M_PORT, seed=0):
    rng = np.random.default_rng(seed)
    k = cfg["n_tan"]
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in cfg["widths"]]
    js = [rng.normal(size=(k, m, w)).astype(np.float32)
          for w, h in zip(cfg["widths"], cfg["has_j"]) if h]
    c0, ws, bs = cfg["widths"][0], [], []
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else (c0 + C if split else C)
        w = rng.normal(scale=1.0 / np.sqrt(fan), size=(fan, C))
        ws.append(w.astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=(C,)).astype(np.float32))
    gv = rng.normal(size=(m, C)).astype(np.float32)
    gj = rng.normal(size=(k, m, C)).astype(np.float32)
    return vs, js, ws, bs, gv, gj


def _t(xs, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in xs]


def _j(jx, xs, rows=M_JAX, dtype=None, axis=0):
    out = []
    for x in xs:
        a = jx.jnp.asarray(x[:rows] if axis == 0 else x[:, :rows])
        out.append(a if dtype is None else a.astype(dtype))
    return tuple(out)


def _close(got, ref, bound):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    assert err <= bound * max(np.abs(ref).max(), 1e-6), (err, np.abs(ref).max())


@pytest.mark.parametrize("name", ["tanhExp", "ReLU", "Softplus", "Sigmoid"])
def test_activation_triples_match_the_kernels(jx, name):
    x = np.concatenate([np.linspace(-30, 30, 601), [0.0, 20.0, 20.001, -1e-8]])
    x = x.astype(np.float32)
    ref = jx.dm._act_fns(name)
    got = tact.ACTIVATION_TRIPLES[name]
    for fr, fg in zip(ref, got):
        _close(fg(torch.from_numpy(x)).numpy(), fr(jx.jnp.asarray(x)), 1e-4)


def test_pe_dual_directional_matches_jax(jx):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    var = rng.uniform(0, 1e-3, (50, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (1, 30)).astype(np.float32)
    rv, rt = jx.dual.pe_dual_directional_mip(jx.jnp.asarray(x), 10, jx.jnp.asarray(d),
                                             var=jx.jnp.asarray(var),
                                             chan_scale=jx.jnp.asarray(scale))
    gv, gt = tdual.pe_dual_directional_mip(*_t([x]), 10, *_t([d]), var=_t([var])[0],
                                           chan_scale=_t([scale])[0])
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **F32)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), **F32)
    # the contraction of the plane Jacobian along d
    pv, pj = tdual.pe_dual_planes_mip(*_t([x]), 10, var=_t([var])[0],
                                      chan_scale=_t([scale])[0])
    along = (pj * _t([d])[0].T[:, :, None]).sum(0)
    np.testing.assert_allclose(gt.numpy(), along.numpy(), **F32)


def _jax_fwd(jx, cfg, vs, js, ws, bs, dtype, stash):
    dt = None if dtype == "float32" else jx.jnp.bfloat16
    return jx.dm._run_forward(
        _j(jx, vs, dtype=dt), _j(jx, js, dtype=dt, axis=1), _j(jx, ws),
        _j(jx, bs, rows=None), cfg["layout"], "tanhExp", cfg["has_j"], dtype,
        interpret=True, stash_map=(True,) * len(ws) if stash else None,
        n_tan=cfg["n_tan"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seg_forward_and_stash_match_pallas_f32(jx, name):
    cfg = CONFIGS[name]
    vs, js, ws, bs, _, _ = _mlp_inputs(cfg)
    with jx.dm.matmul_dtype(jx.jnp.float32):
        jv, jj, jpres = _jax_fwd(jx, cfg, vs, js, ws, bs, "float32", True)
    tv, tj, tpres = tdm.dual_mlp_seg_plain(
        _t(vs), _t(js), _t(ws), _t(bs), cfg["layout"], "tanhExp", cfg["has_j"],
        cfg["n_tan"], stash=True)
    assert tuple(tj.shape) == (cfg["n_tan"], M_PORT, C)
    np.testing.assert_allclose(tv[:M_JAX].numpy(), np.asarray(jv), **F32)
    np.testing.assert_allclose(tj[:, :M_JAX].numpy(), np.asarray(jj), **F32)
    assert len(tpres) == len(jpres) == len(ws)
    for got, ref in zip(tpres, jpres):
        np.testing.assert_allclose(got[:, :M_JAX].numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seg_forward_bf16_tracks_pallas_bf16(jx, name):
    cfg = CONFIGS[name]
    vs, js, ws, bs, _, _ = _mlp_inputs(cfg, seed=2)
    with jx.dm.matmul_dtype(jx.jnp.bfloat16):
        jv, jj = _jax_fwd(jx, cfg, vs, js, ws, bs, "bfloat16", False)
    tb = torch.bfloat16
    tv, tj = tdm.dual_mlp_seg_plain(_t(vs, tb), _t(js, tb), _t(ws, tb), _t(bs),
                                    cfg["layout"], "tanhExp", cfg["has_j"],
                                    cfg["n_tan"])
    assert tv.dtype == tb
    _close(tv[:M_JAX].float().numpy(), jv.astype(jx.jnp.float32), 2.0**-5)
    _close(tj[:, :M_JAX].float().numpy(), jj.astype(jx.jnp.float32), 2.0**-5)


def _jax_vjp(jx, cfg, vs, js, ws, bs, gv, gj, dtype):
    dt = None if dtype == "float32" else jx.jnp.bfloat16

    def f(vs_, js_, ws_, bs_):
        return jx.dm.dual_mlp_seg(vs_, js_, ws_, bs_, cfg["layout"], "tanhExp",
                                  cfg["has_j"], dtype, True)

    _, vjp = jx.jax.vjp(f, _j(jx, vs, dtype=dt), _j(jx, js, dtype=dt, axis=1),
                        _j(jx, ws), _j(jx, bs, rows=None))
    gv_j = jx.jnp.asarray(gv[:M_JAX])
    gj_j = jx.jnp.asarray(gj[:, :M_JAX])
    if dt is not None:
        gv_j, gj_j = gv_j.astype(dt), gj_j.astype(dt)
    return vjp((gv_j, gj_j))


def _port_bwd(cfg, vs, js, ws, bs, gv, gj, dtype, m=M_JAX):
    vs_t = _t([v[:m] for v in vs], dtype)
    js_t = _t([j[:, :m] for j in js], dtype)
    ws_t = _t(ws, dtype)
    _, _, pres = tdm.dual_mlp_seg_plain(vs_t, js_t, ws_t, _t(bs), cfg["layout"],
                                        "tanhExp", cfg["has_j"], cfg["n_tan"],
                                        stash=True)
    grads = _t([gv[:m], gj[:, :m]], dtype)
    return tdm.dual_mlp_seg_bwd_plain(vs_t, js_t, ws_t, cfg["layout"], "tanhExp",
                                      cfg["has_j"], pres, *grads)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seg_backward_matches_pallas_vjp_f32(jx, name):
    cfg = CONFIGS[name]
    vs, js, ws, bs, gv, gj = _mlp_inputs(cfg, seed=3)
    with jx.dm.matmul_dtype(jx.jnp.float32):
        rdv, rdj, rdw, rdb = _jax_vjp(jx, cfg, vs, js, ws, bs, gv, gj, "float32")
    dvs, djs, dws, dbs = _port_bwd(cfg, vs, js, ws, bs, gv, gj, torch.float32)
    for got, ref in zip([*dvs, *djs, *dws, *dbs], [*rdv, *rdj, *rdw, *rdb]):
        assert tuple(got.shape) == tuple(ref.shape)
        _close(got.numpy(), ref, 1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seg_backward_bf16_tracks_pallas_bf16(jx, name):
    cfg = CONFIGS[name]
    vs, js, ws, bs, gv, gj = _mlp_inputs(cfg, seed=4)
    with jx.dm.matmul_dtype(jx.jnp.bfloat16):
        rdv, rdj, rdw, rdb = _jax_vjp(jx, cfg, vs, js, ws, bs, gv, gj, "bfloat16")
    dvs, djs, dws, dbs = _port_bwd(cfg, vs, js, ws, bs, gv, gj, torch.bfloat16)
    assert dvs[0].dtype == torch.bfloat16 and dws[0].dtype == torch.float32
    for got, ref in zip([*dvs, *djs, *dws, *dbs], [*rdv, *rdj, *rdw, *rdb]):
        _close(got.float().numpy(), ref.astype(jx.jnp.float32), 2.0**-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seg_plain_backward_matches_autograd_of_plain_forward(name):
    cfg = CONFIGS[name]
    vs, js, ws, bs, gv, gj = _mlp_inputs(cfg, seed=5)
    leaves = [t.requires_grad_() for t in _t(vs) + _t(js) + _t(ws) + _t(bs)]
    n_v, n_j, n_w = len(vs), len(js), len(ws)
    n_vj = n_v + n_j
    v, j, _ = tdm._forward_math(
        leaves[:n_v], leaves[n_v:n_vj], leaves[n_vj:n_vj + n_w], leaves[n_vj + n_w:],
        cfg["layout"], "tanhExp", cfg["has_j"], cfg["n_tan"], False)
    tgv, tgj = _t([gv, gj])
    ref = torch.autograd.grad((v * tgv).sum() + (j * tgj).sum(), leaves)
    dvs, djs, dws, dbs = _port_bwd(cfg, vs, js, ws, bs, gv, gj, torch.float32, m=M_PORT)
    for got, r in zip([*dvs, *djs, *dws, *dbs], ref):
        _close(got.numpy(), r.numpy(), 1e-5)


def test_autograd_op_casts_master_weights_and_returns_f32_grads():
    cfg = COLOR
    vs, js, ws, bs, gv, gj = _mlp_inputs(cfg, m=300, seed=6)
    tb = torch.bfloat16
    w_master = [t.requires_grad_() for t in _t(ws)]
    b_master = [t.requires_grad_() for t in _t(bs)]
    v, j = tdm.dual_mlp_apply(_t(vs, tb), _t(js, tb), w_master, b_master, cfg["layout"],
                              "tanhExp", cfg["has_j"], 1, tb, False)
    assert v.dtype == tb
    ((v.float() * _t([gv])[0]).sum() + (j.float() * _t([gj])[0]).sum()).backward()
    assert all(w.grad.dtype == torch.float32 for w in w_master + b_master)
    _, _, dws, dbs = _port_bwd(cfg, vs, js, ws, bs, gv, gj, tb, m=300)
    for w, ref in zip(w_master + b_master, dws + dbs):
        assert torch.equal(w.grad, ref)


def _epi_inputs(m=M_PORT, seed=7, dtype=torch.float32):
    """Trunk streams whose rows reach every kink: relu of the density,
    both relu arms of range_distance and range_aux_grad, dDdt > 1, and
    the softplus / sigmoid tails."""
    rng = np.random.default_rng(seed)
    wd = rng.normal(scale=1.0 / np.sqrt(C), size=(C,)).astype(np.float32)
    wa = rng.normal(scale=1.0 / np.sqrt(C), size=(C,)).astype(np.float32)
    row_scale = np.exp(rng.uniform(np.log(0.05), np.log(30.0), size=(m, 1)))
    v = (rng.normal(size=(m, C)) * row_scale).astype(np.float32)
    j_scale = np.exp(rng.uniform(-4, 1, size=(1, m, 1)))
    j = (rng.normal(size=(3, m, C)) * j_scale).astype(np.float32)
    b2 = np.array([0.3, -0.2], np.float32)
    scal = np.array([0.001, 0.8, 1.5, 0.05, 1.0, 1.0, 1.0, 0.0], np.float32)
    g_out = rng.normal(size=(10, m)).astype(np.float32)
    g_tfeat = rng.normal(size=(m, C)).astype(np.float32)
    return v, j, wd, wa, b2, scal, g_out, g_tfeat


def _jax_epi(jx, v, j, wd, wa, b2, scal, dtype):
    jnp = jx.jnp
    dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return (jnp.asarray(v[:M_JAX]).astype(dt), jnp.asarray(j[:, :M_JAX]).astype(dt),
            jnp.asarray(wd[:, None]), jnp.asarray(wa[:, None]), jnp.asarray(b2),
            jnp.asarray(scal))


def test_epilogue_inputs_reach_every_kink():
    v, j, wd, wa, b2, scal, _, _ = _epi_inputs()
    out, _ = tepi.neddf_epilogue_plain(*_t([v, j, wd, wa, b2, scal]), "ReLU")
    h = tepi._math(*_t([v, j, wd, wa, b2, scal]), "ReLU")
    ddf, aux = h["ddf_out"][:M_JAX], h["aux_out"][:M_JAX]
    dens = out[0][:M_JAX]
    for mask in (dens == 0, dens > 0, ddf < -4.6, ddf > 1.5, ddf > 20, aux < -4.6,
                 aux > 4.6, h["d_ddt"][:M_JAX] > 1.0):
        assert int(mask.sum()) > 0


def test_epilogue_forward_matches_pallas_f32(jx):
    v, j, wd, wa, b2, scal, _, _ = _epi_inputs()
    with jx.dm.matmul_dtype(jx.jnp.float32):
        args = _jax_epi(jx, v, j, wd, wa, b2, scal, "float32")
        packed, tfeat = jx.epi.neddf_epilogue(*args, "float32", True)
    out, t_feat = tepi.neddf_epilogue_plain(*_t([v, j, wd, wa, b2, scal]), "ReLU")
    assert tuple(out.shape) == (10, M_PORT)
    ref = np.asarray(packed)[:, :10].T
    for k in range(10):
        atol = 1e-5 * max(1.0, np.abs(ref[k]).max())
        np.testing.assert_allclose(out[k, :M_JAX].numpy(), ref[k], rtol=1e-5,
                                   atol=atol, err_msg=str(k))
    np.testing.assert_allclose(t_feat[:M_JAX].numpy(), np.asarray(tfeat), **F32)


def _jax_epi_vjp(jx, v, j, wd, wa, b2, scal, g_out, g_tfeat, dtype):
    args = _jax_epi(jx, v, j, wd, wa, b2, scal, dtype)
    _, vjp = jx.jax.vjp(lambda *a: jx.epi.neddf_epilogue(*a, dtype, True), *args)
    jnp = jx.jnp
    g_packed = jnp.zeros((M_JAX, 16), jnp.float32)
    g_packed = g_packed.at[:, :10].set(jnp.asarray(g_out[:, :M_JAX].T))
    g_t = jnp.asarray(g_tfeat[:M_JAX]).astype(args[0].dtype)
    dv, dj, dwd, dwa, db2, _ = vjp((g_packed, g_t))
    return dv, dj, dwd[:, 0], dwa[:, 0], db2


def test_epilogue_backward_matches_pallas_vjp_f32(jx):
    v, j, wd, wa, b2, scal, g_out, g_tfeat = _epi_inputs(seed=8)
    with jx.dm.matmul_dtype(jx.jnp.float32):
        refs = _jax_epi_vjp(jx, v, j, wd, wa, b2, scal, g_out, g_tfeat, "float32")
    got = tepi.neddf_epilogue_bwd_plain(*_t([
        v[:M_JAX], j[:, :M_JAX], wd, wa, b2, scal, g_out[:, :M_JAX], g_tfeat[:M_JAX]]), "ReLU")
    for name, g, r in zip(("dv", "dj", "dwd", "dwa", "db2"), got, refs):
        assert tuple(g.shape) == tuple(r.shape), name
        _close(g.numpy(), r, 1e-5)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_epilogue_bf16_tracks_pallas_bf16(jx, direction):
    v, j, wd, wa, b2, scal, g_out, g_tfeat = _epi_inputs(seed=9)
    tb = torch.bfloat16
    args_t = _t([v[:M_JAX], j[:, :M_JAX]], tb) + _t([wd, wa, b2, scal])
    with jx.dm.matmul_dtype(jx.jnp.bfloat16):
        if direction == "forward":
            packed, tfeat = jx.epi.neddf_epilogue(
                *_jax_epi(jx, v, j, wd, wa, b2, scal, "bfloat16"), "bfloat16", True)
            refs = [np.asarray(packed)[:, k] for k in range(10)] + [tfeat]
        else:
            refs = _jax_epi_vjp(jx, v, j, wd, wa, b2, scal, g_out, g_tfeat, "bfloat16")
    if direction == "forward":
        out, t_feat = tepi.neddf_epilogue_plain(*args_t, "ReLU")
        got = list(out) + [t_feat]
    else:
        cot = _t([g_out[:, :M_JAX], g_tfeat[:M_JAX]])
        got = tepi.neddf_epilogue_bwd_plain(*args_t, *cot, "ReLU")
    for g, r in zip(got, refs):
        _close(g.float().numpy(), np.asarray(r, np.float32), 2.0**-5)


def test_wrappers_take_the_plain_versions_for_cpu_tensors():
    cfg = COLOR
    vs, js, ws, bs, gv, gj = _mlp_inputs(cfg, m=100, seed=10)
    before = (tdm.dual_mlp_seg.launches, tdm.dual_mlp_seg_bwd.launches,
              tepi.neddf_epilogue.launches, tepi.neddf_epilogue_bwd.launches)
    calls = tdm.dual_mlp_seg_plain.calls
    a = tdm.dual_mlp_seg(_t(vs), _t(js), _t(ws), _t(bs), cfg["layout"], "tanhExp",
                         cfg["has_j"], 1, stash=True)
    assert tdm.dual_mlp_seg_plain.calls == calls + 1
    tdm.dual_mlp_seg_bwd(_t(vs), _t(js), _t(ws), cfg["layout"], "tanhExp", cfg["has_j"],
                         a[2], *_t([gv, gj]))
    ev, ej, ewd, ewa, eb2, escal, eg, et = _epi_inputs(m=100)
    tepi.neddf_epilogue(*_t([ev, ej, ewd, ewa, eb2, escal]), "ReLU")
    tepi.neddf_epilogue_bwd(*_t([ev, ej, ewd, ewa, eb2, escal, eg, et]), "ReLU")
    assert before == (tdm.dual_mlp_seg.launches, tdm.dual_mlp_seg_bwd.launches,
                      tepi.neddf_epilogue.launches, tepi.neddf_epilogue_bwd.launches)


def _colour_kernel_args(n_tan=1, widths=(60, 24, 3, 256)):
    m = 10
    vs = [torch.zeros((m, w)) for w in widths]
    js = [torch.zeros((n_tan, m, widths[0])), torch.zeros((n_tan, m, widths[-1]))]
    ws = [torch.zeros((sum(widths), 256))] + [torch.zeros((256, 256))] * 2
    bs = [torch.zeros(256)] * 3
    return vs, js, ws, bs


@pytest.mark.parametrize("bad", ["k2", "act", "segments", "has_j", "fan_in"])
def test_seg_kernel_checks_refuse_unsupported_inputs(bad):
    vs, js, ws, bs = _colour_kernel_args()
    has_j, act, n_tan, layout = (True, False, False, True), "tanhExp", 1, (False,) * 3
    if bad == "k2":
        vs, js, ws, bs = _colour_kernel_args(n_tan=2)
        n_tan = 2
    elif bad == "act":
        act = "SiLU"  # not one of the five activations
    elif bad == "segments":
        vs = vs + [torch.zeros((10, 4))]
        has_j = has_j + (False,)
    elif bad == "has_j":
        has_j = (True, True, False, True)
    elif bad == "fan_in":
        ws[0] = torch.zeros((300, 256))
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        tdm._check_seg_args(vs, js, ws, bs, layout, act, has_j, n_tan)


def test_seg_and_epilogue_checks_accept_the_training_shapes():
    vs, js, ws, bs = _colour_kernel_args()
    has_j = (True, False, False, True)
    tdm._check_seg_args(vs, js, ws, bs, (False,) * 3, "tanhExp", has_j, 1)
    z = torch.zeros
    for c in (256, 128, 576):
        args = (z((10, c)), z((3, 10, c)), z(c), z(c), z(2), z(8), "ReLU")
        # every width up to 512, and past it (up to 2048) but in the top
        # mode, the fused trunk's: the per-layer route runs the epilogue on
        # its own at any width it takes
        tepi._check_kernel_args(*args)
        if c <= 512:
            tepi._check_kernel_args(*args, top=True)
        else:
            with pytest.raises(NotImplementedError, match="width 576 > 512"):
                tepi._check_kernel_args(*args, top=True)


# ------------------------------------------------------------------ on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(
        ref.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["color_k1", "trunk_k3"])
def test_cuda_seg_forward_and_backward_match_plain(dtype, name):
    dev = _cuda()
    if name == "color_k1":
        cfg = dict(widths=(60, 24, 3, 256), has_j=(True, False, False, True), n_tan=1,
                   layout=(False,) * 3)
    else:
        cfg = dict(widths=(60,), has_j=(True,), n_tan=3,
                   layout=tuple(li == 5 for li in range(7)))
    rng = np.random.default_rng(0)
    m, k, c0 = 4096 + 77, cfg["n_tan"], cfg["widths"][0]
    vs = [torch.tensor(rng.normal(size=(m, w)), dtype=dtype, device=dev)
          for w in cfg["widths"]]
    js = [torch.tensor(rng.normal(size=(k, m, w)), dtype=dtype, device=dev)
          for w, h in zip(cfg["widths"], cfg["has_j"]) if h]
    ws, bs = [], []
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else (c0 + 256 if split else 256)
        w = rng.normal(scale=fan ** -0.5, size=(fan, 256))
        ws.append(torch.tensor(w, dtype=dtype, device=dev))
        bs.append(torch.tensor(rng.normal(scale=0.1, size=256), dtype=torch.float32,
                               device=dev))
    args = (cfg["layout"], "tanhExp", cfg["has_j"], k)
    fwd = tdm.dual_mlp_trunk if name == "trunk_k3" else None
    if fwd is not None:
        got = fwd(vs[0], js[0], ws, bs, cfg["layout"], "tanhExp", stash=True)
    else:
        got = tdm.dual_mlp_seg(vs, js, ws, bs, *args, stash=True)
    ref = tdm.dual_mlp_seg_plain(vs, js, ws, bs, *args, stash=True)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-5
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]]):
        assert _err(g, r) <= tol
    gv = torch.tensor(rng.normal(size=(m, 256)), dtype=dtype, device=dev)
    gj = torch.tensor(rng.normal(size=(k, m, 256)), dtype=dtype, device=dev)
    bwd_args = (vs, js, ws, cfg["layout"], "tanhExp", cfg["has_j"], ref[2], gv, gj)
    counts = (tdm.PASS_LAUNCHES["gstack"], tdm.PASS_LAUNCHES["dual_act"],
              tdm.Products.epilogue_launches, tdm.Products.prologue_launches)
    kern = tdm.dual_mlp_seg_bwd(*bwd_args)
    torch.cuda.synchronize()
    # one stacked cotangent of its own (the top layer's); every layer below
    # takes its own from the dx product's epilogue and its input from the
    # dW product's prologue
    n_l = len(ws)
    assert (tdm.PASS_LAUNCHES["gstack"], tdm.PASS_LAUNCHES["dual_act"],
            tdm.Products.epilogue_launches, tdm.Products.prologue_launches) == (
        counts[0] + 1, counts[1], counts[2] + n_l - 1, counts[3] + n_l - 1)
    plain = tdm.dual_mlp_seg_bwd_plain(*bwd_args)
    for g, r in zip(sum(kern, []), sum(plain, [])):
        assert _err(g, r) <= (1e-4 if dtype == torch.float32 else 2.0**-4)
    again = tdm.dual_mlp_seg_bwd(*bwd_args)
    pairs = zip(kern[2] + kern[3], again[2] + again[3])
    assert all(torch.equal(a, b) for a, b in pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_epilogue_matches_plain(dtype):
    dev = _cuda()
    v, j, wd, wa, b2, scal, g_out, g_tfeat = _epi_inputs(m=5000 + 3)
    rng = np.random.default_rng(1)
    wd = rng.normal(scale=1 / 16, size=256).astype(np.float32)
    wa = rng.normal(scale=1 / 16, size=256).astype(np.float32)
    v = np.repeat(v, 8, axis=1)
    j = np.repeat(j, 8, axis=2)
    g_tfeat = np.repeat(g_tfeat, 8, axis=1)
    args = [t.to(dev) for t in _t([v, j], dtype) + _t([wd, wa, b2, scal])]
    g = [t.to(dev) for t in _t([g_out]) + _t([g_tfeat], dtype)]
    tol = 1e-4 if dtype == torch.float32 else 2.0**-5
    for a, b in zip(tepi.neddf_epilogue(*args, "ReLU"), tepi.neddf_epilogue_plain(*args, "ReLU")):
        assert _err(a, b) <= tol
    kern = tepi.neddf_epilogue_bwd(*args, *g, "ReLU")
    for a, b in zip(kern, tepi.neddf_epilogue_bwd_plain(*args, *g, "ReLU")):
        assert _err(a, b) <= tol
    again = tepi.neddf_epilogue_bwd(*args, *g, "ReLU")
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
