"""The per-layer route of the port's kernels (tensor parallelism's column
shards and widths over 512) and the spec tree of its width shards.

On the CPU (the route's plain launchers, ``DualProductsPlain``):

* ``parallel/mesh.py::field_param_specs`` over a NeDDF renderer's state
  dict equals the JAX package's ``field_param_specs`` tree at ``model`` 2
  and 4, leaf for leaf.
* The per-layer walk (``dual_mlp_layers_walk`` / ``dual_mlp_layers_bwd``)
  at width 640 (over 512 and not a multiple of 64) and 16, the K=3 trunk
  (a post-skip layer) and the K=1 colour trunk (four segments), against
  the Pallas ``dual_mlp_seg`` in interpret mode (forward and VJP) and
  against the fused walk's plain versions (``dual_mlp_seg_plain``,
  ``dual_mlp_seg_bwd_plain``); one layer's two column shards side by side
  equal the whole layer (the walk over two gloo ranks, with its
  collectives, is ``test_torch_tp.py``'s).
* The value-only walk (``mlp.mlp_seg_layers``, the eval colour trunk) at
  640 against ``mlp_seg_plain``.
* The epilogue's plain versions at width 640 against the Pallas
  ``neddf_epilogue`` and its VJP in interpret mode.
* The route takes any width (and the epilogue's forward and standalone
  backward with it); the epilogue's top mode keeps the fused trunk's 512.

On the card (marked ``cuda``, skipped here): the per-layer forward
(``csrc/layer_fwd.cu``'s wide kernel, wgmma + TMA: S = 4, 2 and 1, one
and two K segments, every activation; ReLU and LeakyReLU over the
kernel's own f32 stash; ``test_torch_layer_fwd.py`` holds both of its
kernels over a grid), ``gstack`` from f32 cotangents, and the epilogue forward and
standalone backward, each against its plain version at the widths 640,
1024 and 2048 and at the shards 1024/2 and 1024/4 of a 1024-wide layer.

Tolerances: against the Pallas kernels f32 1e-4 and bf16 2^-4 of the
largest magnitude (``test_torch_widths_acts.py``'s); against the fused
walk's plain versions f32 1e-6 and bf16 2^-8 (its bars; db 1e-6): the
same math but the route's dW reads the layer input that the forward
wrote, T(f(z)), where the fused backward recomputes f(T(z)) from the
stash, and the route's cotangent reaches ``gstack`` in f32. The
epilogue as ``test_torch_widths_acts.py`` (1e-5, its VJP 1e-4). On the
card: f32 1e-4, bf16 2^-5 (one bf16 rounding step of an output).
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import neddf_epilogue as tepi
from neddf_tpu_torch.parallel.mesh import field_param_specs
from tests.test_torch_widths_acts import (  # noqa: F401  (jx is a fixture)
    DTYPES,
    JAX_TOL,
    PLAIN_TOL,
    ROWS_JAX,
    M,
    _dual_cfg,
    _dual_inputs,
    _epi_inputs,
    _pad,
    _rel,
    jx,
)

SMALL_NEDDF = {
    "_target_": "neddf_tpu.fields.NeDDF", "embed_pos_rank": 4, "embed_dir_rank": 2,
    "ddf_layer_count": 4, "ddf_layer_width": 16, "col_layer_count": 3,
    "col_layer_width": 16, "skips": [1],
}
# (width, trunk, dtype): each width with each trunk once, f32 and bf16 both
WALKS = [(640, "trunk", "float32"), (640, "color", "bfloat16"),
         (16, "trunk", "bfloat16"), (16, "color", "float32")]


# ------------------------------------------------------------------ the specs
@pytest.mark.parametrize("model", [2, 4])
def test_the_spec_tree_is_the_jax_packages(jx, model):
    from jax.sharding import PartitionSpec

    from neddf_tpu.parallel.mesh import field_param_specs as jspecs
    from neddf_tpu.render import NeRFRender as JRender
    from neddf_tpu_torch.render.renderer import NeRFRender

    net = dict(SMALL_NEDDF, ddf_layer_width=32, col_layer_width=64)
    jrender = JRender(network_config=net, sample_coarse=4, sample_fine=4,
                      use_coarse_network=False, sampling_type="cone")
    tree = jspecs(jrender.init(jx.jax.random.PRNGKey(0)), model)
    want = {}

    def walk(node, prefix):
        if isinstance(node, PartitionSpec):
            want[prefix] = tuple(node)
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, child in items:
            walk(child, f"{prefix}.{key}" if prefix else str(key))

    walk(tree, "")
    render = NeRFRender(network_config=net, sample_coarse=4, sample_fine=4,
                        use_coarse_network=False, sampling_type="cone")
    got = field_param_specs({n: p.shape for n, p in render.state_dict().items()}, model)
    assert got == want
    assert got["network_fine.layers_ddf.0.w"] == (None, "model")
    assert got["network_fine.layer_col_out.b"] == ()


# ------------------------------------------------------------------- the walk
def _walk(args, bs, k):
    vs, js, ws, layout, act, has_j, pres, gv, gj = args
    n_tan = pres[0].shape[0] - 1
    full, inputs, pres2 = tdm.dual_mlp_layers_walk(vs, js, ws, bs, layout, act, has_j, n_tan,
                                                   k, stash=True)
    g = torch.cat([gv[None], gj], dim=0)
    grads = tdm.dual_mlp_layers_bwd(inputs, ws, layout, act, [v.shape[1] for v in vs], has_j,
                                    pres2, g, k)
    return full, pres2, grads


@pytest.mark.parametrize("width, name, dtype", WALKS)
def test_layer_walk_matches_the_fused_walk_and_pallas(jx, width, name, dtype):
    cfg = _dual_cfg(width)[name]
    cd = DTYPES[dtype]
    act = "tanhExp"
    args, bs = _dual_inputs(cfg, width, cd, act, seed=width + len(name))
    vs, js, ws, layout, _, has_j, pres, gv, gj = args
    full, pres2, got = _walk(args, bs, tdm.DualProductsPlain(cd))
    v, j = tdm.dual_mlp_seg_plain(vs, js, ws, bs, layout, act, has_j, cfg["n_tan"])
    assert torch.equal(full[0], v) and torch.equal(full[1:], j)
    for a, b in zip(pres2, pres):
        assert torch.equal(a, b)
    plain = tdm.dual_mlp_seg_bwd_plain(*args)
    jnp = jx.jnp

    def jt(t, axis=0):
        return jnp.asarray(_pad(t.float().numpy(), ROWS_JAX, axis),
                           None if dtype == "float32" else jnp.bfloat16)

    def f(vs_, js_, ws_, bs_):
        return jx.dm.dual_mlp_seg(vs_, js_, ws_, bs_, layout, act, has_j, dtype, True)

    with jx.dm.matmul_dtype(jnp.dtype(dtype)):
        (jv, jj), vjp = jx.jax.vjp(f, tuple(jt(x) for x in vs), tuple(jt(t, 1) for t in js),
                                  tuple(jnp.asarray(w.float().numpy()) for w in ws),
                                  tuple(jnp.asarray(b.numpy()) for b in bs))
        ref = vjp((jt(gv), jt(gj, 1)))
    assert _rel(full[0], np.asarray(jv, np.float32)[:M]) <= JAX_TOL[dtype]
    assert _rel(full[1:], np.asarray(jj, np.float32)[:, :M]) <= JAX_TOL[dtype]
    for kind, gg, pp, rr in zip(("dv", "dj", "dW", "db"), got, plain, ref):
        assert len(gg) == len(pp), kind
        for i, (g, p, r) in enumerate(zip(gg, pp, rr)):
            r = np.asarray(r, np.float32)
            r = r[:M] if kind == "dv" else r[:, :M] if kind == "dj" else r
            assert tuple(g.shape) == r.shape, (kind, i)
            assert _rel(g, p) <= (1e-6 if kind == "db" else PLAIN_TOL[dtype]), (kind, i)
            assert _rel(g, r) <= JAX_TOL[dtype], (kind, i)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_two_column_shards_side_by_side_are_the_whole_layer(dtype):
    cd = DTYPES[dtype]
    rng = np.random.default_rng(3)
    xs = [torch.tensor(rng.normal(size=(4, M, k)), dtype=torch.float32).to(cd)
          for k in (60, 640)]
    w = torch.tensor(rng.normal(scale=700 ** -0.5, size=(700, 640)), dtype=torch.float32).to(cd)
    b = torch.tensor(rng.normal(size=640), dtype=torch.float32)
    k = tdm.DualProductsPlain(cd)
    out, z = k.layer_fwd(xs, w, b, "Softplus", True)
    parts = [k.layer_fwd(xs, w[:, c].contiguous(), b[c], "Softplus", True)
             for c in (slice(0, 320), slice(320, 640))]
    # the same sums (f32) in another blocking of the product: one rounding
    # step of the output at most
    assert _rel(torch.cat([p[0] for p in parts], dim=-1), out) <= PLAIN_TOL[dtype]
    assert _rel(torch.cat([p[1] for p in parts], dim=-1), z) <= PLAIN_TOL[dtype]


def test_value_only_walk_matches_mlp_seg_plain():
    rng = np.random.default_rng(4)
    widths, width = (24, 12, 3, 640), 640
    vs = [torch.tensor(rng.normal(size=(M, w)), dtype=torch.float32) for w in widths]
    ws, bs = [], []
    for li in range(3):
        fan = sum(widths) if li == 0 else width
        ws.append(torch.tensor(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, width)),
                               dtype=torch.float32))
        bs.append(torch.tensor(rng.normal(scale=0.1, size=width), dtype=torch.float32))
    got = tmlp.mlp_seg_layers(vs, ws, bs, "tanhExp", use_kernels=True)
    want = tmlp.mlp_seg_plain(vs, ws, bs, (False,) * 3, "tanhExp")
    assert _rel(got, want) <= 1e-6


# --------------------------------------------------------------- the epilogue
def test_epilogue_at_640_matches_the_pallas_epilogue(jx):
    width = 640
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(width, M, seed=9)
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


def test_refusals_name_the_routes_limit():
    # the route takes any width; it refuses an activation, a K, a width < 1
    assert tdm.route_refusal("tanhExp", 2048, 3) is None
    assert tdm.route_refusal("Softplus", 640, 0) is None
    assert tdm.route_refusal("tanhExp", 2049, 1) is None
    assert tdm.route_refusal("tanhExp", 8200, 3) is None
    assert tdm.route_refusal("tanhExp", 64, 2) == "K=2"
    assert tdm.route_refusal("GELU", 64, 3) == "activation 'GELU'"
    assert tdm.route_refusal("tanhExp", 0, 3) == "width 0"
    args = [torch.zeros((4, 2048)), torch.zeros((3, 4, 2048)), torch.zeros(2048),
            torch.zeros(2048), torch.zeros(2), torch.zeros(8)]
    tepi._check_kernel_args(*args, "ReLU")
    with pytest.raises(NotImplementedError, match="width 2048 > 512"):
        tepi._check_kernel_args(*args, "ReLU", top=True)
    # past 2048 the forward and the standalone backward take the width (the
    # backward's column-chunked kernel); the top mode keeps the fused 512
    wide = [torch.zeros((4, 2050)), torch.zeros((3, 4, 2050)), torch.zeros(2050),
            torch.zeros(2050), torch.zeros(2), torch.zeros(8)]
    tepi._check_kernel_args(*wide, "ReLU")
    with pytest.raises(NotImplementedError, match="width 2050 > 512"):
        tepi._check_kernel_args(*wide, "ReLU", top=True)
    with pytest.raises(NotImplementedError, match="density activation 'GELU'"):
        tepi._check_kernel_args(*wide, "GELU")


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


CARD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
# (S, rows, K segments, N = the shard's columns, activation): widths 640,
# 1024, 2048 whole, and the shards 1024/2 and 1024/4 of a 1024-wide layer
# (whose input is the full 1024)
# (ReLU and LeakyReLU: a pre-activation within a rounding of 0 may take
# the other side of the kink in the kernel than in the plain version, so
# they are held over the kernel's own f32 stash below)
FWD_CASES = [(4, 3001, (60,), 640, "tanhExp"), (2, 2999, (87, 1024), 1024, "Softplus"),
             (1, 4097, (87, 2048), 2048, "Sigmoid"), (4, 2001, (60, 1024), 512, "Softplus"),
             (2, 2002, (1024,), 256, "Sigmoid"), (1, 1999, (1024,), 256, "tanhExp")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", range(len(FWD_CASES)))
def test_cuda_layer_forward_matches_plain(case, dtype):
    dev = _card()
    cd = DTYPES[dtype]
    s, m, ks, n, act = FWD_CASES[case]
    g = torch.Generator(device=dev).manual_seed(case)
    xs = [torch.randn((s, m, k), device=dev, generator=g).to(cd) for k in ks]
    w = (torch.randn((sum(ks), n), device=dev, generator=g) * sum(ks) ** -0.5).to(cd)
    b = torch.randn(n, device=dev, generator=g)
    wide = tdm.LAYER_FWD_LAUNCHES["wide"]
    out, z = tdm.DualProducts(cd, dev).layer_fwd(xs, w, b, act, True)
    assert tdm.LAYER_FWD_LAUNCHES["wide"] == wide + 1
    pout, pz = tdm.DualProductsPlain(cd).layer_fwd(xs, w, b, act, True)
    assert _rel(out.cpu(), pout.cpu()) <= CARD_TOL[dtype]
    assert _rel(z.cpu(), pz.cpu()) <= CARD_TOL[dtype]
    out2, _ = tdm.DualProducts(cd, dev).layer_fwd(xs, w, b, act, False)
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["ReLU", "LeakyReLU"])
def test_cuda_layer_forward_at_the_kink_matches_its_own_stash(act):
    """f32: the stash is the unrounded pre-activation, so the activated
    streams are held to the plain activation of the kernel's own stash
    (bitwise but the f32 rounding of f'(z) z), and the stash to the plain
    product."""
    from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES

    dev = _card()
    f, df, _ = ACTIVATION_TRIPLES[act]
    g = torch.Generator(device=dev).manual_seed(7)
    for s, ks, n in ((4, (60, 1024), 512), (2, (87, 1024), 256), (1, (1024,), 640)):
        xs = [torch.randn((s, 2001, k), device=dev, generator=g) for k in ks]
        w = torch.randn((sum(ks), n), device=dev, generator=g) * sum(ks) ** -0.5
        b = torch.randn(n, device=dev, generator=g)
        wide = tdm.LAYER_FWD_LAUNCHES["wide"]
        out, z = tdm.DualProducts(torch.float32, dev).layer_fwd(xs, w, b, act, True)
        assert tdm.LAYER_FWD_LAUNCHES["wide"] == wide + 1
        _, pz = tdm.DualProductsPlain(torch.float32).layer_fwd(xs, w, b, act, True)
        assert _rel(z.cpu(), pz.cpu()) <= CARD_TOL["float32"]
        want = torch.cat([f(z[:1]), df(z[:1]) * z[1:]], dim=0)
        assert _rel(out.cpu(), want.cpu()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", [640, 1024, 2048, 512, 256])
def test_cuda_gstack_from_f32_cotangents_matches_plain(width, dtype):
    dev = _card()
    cd = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(width)
    z = torch.randn((4, 3001, width), device=dev, generator=g).to(cd)
    gg = torch.randn((4, 3001, width), device=dev, generator=g)
    gs, db = tdm.DualProducts(cd, dev).gstack(gg[0], gg[1:], z, "tanhExp")
    pgs, pdb = tdm.DualProductsPlain(cd).gstack(gg[0], gg[1:], z, "tanhExp")
    assert _rel(gs.cpu(), pgs.cpu()) <= CARD_TOL[dtype]
    assert _rel(db.cpu(), pdb.cpu()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("width", [640, 1024, 2048])
def test_cuda_epilogue_past_512_matches_plain(width, dtype):
    dev = _card()
    cd = DTYPES[dtype]
    v, j, wd, wa, b2, scal, g_out, g_t = _epi_inputs(width, 3001, seed=width, dtype=cd,
                                                     device=dev)
    out, t_feat = tepi.neddf_epilogue(v, j, wd, wa, b2, scal, "ReLU")
    pout, pt = tepi.neddf_epilogue_plain(v, j, wd, wa, b2, scal, "ReLU")
    assert _rel(out.cpu(), pout.cpu()) <= 1e-4
    assert _rel(t_feat.cpu(), pt.cpu()) <= CARD_TOL[dtype]
    got = tepi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    want = tepi.neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_t, "ReLU")
    for name, a, b in zip(("dv", "dj", "dwd", "dwa", "db2"), got, want):
        assert _rel(a.cpu(), b.cpu()) <= (CARD_TOL[dtype] if name in ("dv", "dj") else 1e-4), name
