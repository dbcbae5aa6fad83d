"""NeRF's and NeuS's per-layer route on the CPU, in one process: the route
that tensor parallelism (``trainer.mesh.model > 1``) and widths over 512
take, here as whole layers (one shard).

* The value-only walk with NeRF's hidden-first post-skip layer
  (``[h, seg0]``) and NeuS's colour trunk (four segments, a 3-wide last
  layer whole on every rank), forward and backward
  (``kernels/mlp.py::MLPLayers`` over the plain launcher), against the
  plain versions (``mlp_seg_plain`` / ``mlp_seg_bwd_plain``) and the
  Pallas ``mlp_seg`` in interpret mode with its custom VJP, at widths 16
  and 640, f32 and bf16.
* The per-layer sdf trunk, its sweep and its second-order backward
  (``kernels/sdf_mlp.py::SDFLayers``) at width 640 against
  ``sdf_trunk_with_grad(_vjp)``, the Pallas ``sdf_mlp`` (interpret) and
  ``jax.grad`` of the JAX package's oracle, ReLU and tanhExp.
* NeRF and NeuS at width 640 (past the tile forward's 512, so the
  per-layer route) against the JAX fields with ``fused="off"``; NeRF in
  bf16 against the port's fused route's plain versions.
* ``field_param_specs`` / ``tp_shard_names`` against the JAX package's
  ``field_param_specs`` tree at models 2 and 4, leaf for leaf.
* The route takes a full width over 2048 and refuses an unknown
  activation on the kernels' launcher, naming it; the fused kernels
  refuse widths over 512.

Tolerances: the route against the plain versions in f32 within 1e-5 of
the largest magnitude (the post-skip layer's two K segments are one
product here, two there: sums in another order), in bf16 within one bf16
step (2^-8); against Pallas the bars of ``test_torch_mlp_seg.py`` (f32
1e-5, bf16 2^-6 forward and 2^-5 gradients) and ``test_torch_sdf_mlp.py``
(1e-4); the fields as ``test_torch_nerf_neus_field.py`` holds them in f32
(outputs 1e-5, gradients 1e-4). NeuS at 640 runs tanhExp: under ReLU a
pre-activation within an f32 rounding of 0 may take the other side of
the kink in one of the two sums, which moves a gradient by a whole term.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import sdf_grad as tgrad
from neddf_tpu_torch.parallel.mesh import field_param_specs, tp_shard_names
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

WIDE = 640
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# NeRF's trunk (one segment, a post-skip layer reading [h, seg0]) and
# NeuS's colour trunk (four segments, a 3-wide last layer)
MLP_CASES = {
    "nerf_trunk": dict(widths=(24,), layout=(False, False, True, False), narrow=False),
    "neus_color": dict(widths=(3, 12, 3, None), layout=(False, False, False), narrow=True),
}
SDF_LAYOUT = (False, False, True, False)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.mlp as jmlp
    import neddf_tpu.kernels.sdf_mlp as jsdf
    import neddf_tpu.ops.sdf_grad as jgrad

    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, mlp=jmlp, sdf=jsdf, grad=jgrad)


def _rel(got, ref):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref.detach().float() if isinstance(ref, torch.Tensor) else ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _mlp_inputs(case, width, m, seed):
    rng = np.random.default_rng(seed)
    widths = [width if w is None else w for w in case["widths"]]
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in widths]
    n = len(case["layout"])
    ws, bs = [], []
    for li, split in enumerate(case["layout"]):
        fan = sum(widths) if li == 0 else width + widths[0] * split
        out = 3 if case["narrow"] and li == n - 1 else width
        ws.append(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=out).astype(np.float32))
    g = rng.normal(size=(m, ws[-1].shape[1])).astype(np.float32)
    return vs, ws, bs, g


def _port_mlp(case, vs, ws, bs, g, cd, route):
    tvs = [torch.tensor(v).to(cd).requires_grad_() for v in vs]
    tws = [torch.tensor(w, requires_grad=True) for w in ws]
    tbs = [torch.tensor(b, requires_grad=True) for b in bs]
    if route:
        out = tmlp.mlp_layers_apply(tvs, tws, tbs, case["layout"], "ReLU", cd, True,
                                    whole_last=case["narrow"])
    else:
        out = tmlp.mlp_apply(tvs, tws, tbs, case["layout"], "ReLU", cd, True)
    torch.sum(out.float() * torch.from_numpy(g)).backward()
    return out, [t.grad for t in (*tvs, *tws, *tbs)]


def _pallas_mlp(jx, case, vs, ws, bs, g, dtype):
    jnp = jx.jnp
    jvs = tuple(jnp.asarray(v, dtype) for v in vs)
    jws, jbs = tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))

    def run(v_, w_, b_):
        return jx.mlp.mlp_seg(v_, w_, b_, case["layout"], "ReLU", dtype, True)

    def loss(v_, w_, b_):
        return jnp.sum(run(v_, w_, b_).astype(jnp.float32) * g)

    with jx.dm.matmul_dtype(jnp.dtype(dtype)), jx.mlp.mlp_stash(True):
        out = run(jvs, jws, jbs)
        grads = jx.jax.grad(loss, argnums=(0, 1, 2))(jvs, jws, jbs)
    return out, [x for part in grads for x in part]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [16, WIDE])
@pytest.mark.parametrize("name", list(MLP_CASES))
def test_hidden_first_walk_matches_plain_and_pallas(jx, name, width, dtype):
    case, cd = MLP_CASES[name], DTYPES[dtype]
    m = jx.mlp.TILE_M
    vs, ws, bs, g = _mlp_inputs(case, width, m, seed=width + len(name))
    before = dict(tdm.ROUTE_LAUNCHES), tmlp.mlp_seg_plain.calls
    out, grads = _port_mlp(case, vs, ws, bs, g, cd, route=True)
    # the route ran its plain launcher, not the fused route's plain versions
    assert tmlp.mlp_seg_plain.calls == before[1] and tdm.ROUTE_LAUNCHES == before[0]
    assert tuple(out.shape) == (m, ws[-1].shape[1]) and out.dtype == cd
    pout, pgrads = _port_mlp(case, vs, ws, bs, g, cd, route=False)
    tol = 1e-5 if cd == torch.float32 else 2.0**-8
    assert _rel(out, pout) <= tol
    for i, (a, b) in enumerate(zip(grads, pgrads)):
        assert _rel(a, b) <= tol, ("plain", i, _rel(a, b))
    jout, jgrads = _pallas_mlp(jx, case, vs, ws, bs, g, dtype)
    fwd_tol, grad_tol = (1e-5, 1e-5) if cd == torch.float32 else (2.0**-6, 2.0**-5)
    assert _rel(out, np.asarray(jout, np.float32)) <= fwd_tol
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        assert _rel(a, np.asarray(b, np.float32)) <= grad_tol, ("pallas", i, _rel(a, b))


def test_value_walk_without_grad_is_the_forward_of_the_op():
    case = MLP_CASES["nerf_trunk"]
    vs, ws, bs, _ = _mlp_inputs(case, WIDE, 300, seed=1)
    tvs, tws, tbs = ([torch.from_numpy(x) for x in xs] for xs in (vs, ws, bs))
    got = tmlp.mlp_seg_layers(tvs, tws, tbs, "ReLU", True, None, case["layout"])
    with torch.no_grad():
        want = tmlp.mlp_layers_apply(tvs, tws, tbs, case["layout"], "ReLU", torch.float32, True)
    assert torch.equal(got, want)


def _sdf_inputs(m, width, seed):
    rng = np.random.default_rng(seed)
    e_dim = 36
    e = rng.normal(size=(m, e_dim)).astype(np.float32)
    ws, bs = [], []
    for li, split in enumerate(SDF_LAYOUT):
        fan = e_dim if li == 0 else width + e_dim * split
        ws.append((rng.normal(size=(fan, width)) * 1.5 * fan ** -0.5).astype(np.float32))
        bs.append((rng.normal(size=width) * 0.1).astype(np.float32))
    ch = rng.normal(size=(m, width)).astype(np.float32)
    cg = rng.normal(size=(m, e_dim)).astype(np.float32)
    return e, ws, bs, ch, cg


@pytest.mark.parametrize("act", ["ReLU", "tanhExp"])
def test_per_layer_sdf_route_matches_plain_pallas_and_jax_grad(jx, act):
    m = jx.sdf.TILE_M
    e, ws, bs, ch, cg = _sdf_inputs(m, WIDE, seed=len(act))
    te = torch.tensor(e, requires_grad=True)
    tws = [torch.tensor(w, requires_grad=True) for w in ws]
    tbs = [torch.tensor(b, requires_grad=True) for b in bs]
    calls = tgrad.sdf_trunk_with_grad.calls, tgrad.sdf_trunk_with_grad_vjp.calls
    h, g_e = tsdf.sdf_layers_apply(te, tws, tbs, SDF_LAYOUT, act, True)
    (torch.sum(h * torch.from_numpy(ch)) + torch.sum(g_e * torch.from_numpy(cg))).backward()
    assert (tgrad.sdf_trunk_with_grad.calls, tgrad.sdf_trunk_with_grad_vjp.calls) == calls
    got = [h, g_e, te.grad, *[w.grad for w in tws], *[b.grad for b in tbs]]

    # the plain versions, on the route's own stash (a ReLU kink taken the
    # other way in a re-summed z would move a gradient by a whole term)
    k = tsdf.sdf_layer_launcher(te.device, False)
    tw = [torch.from_numpy(w) for w in ws]
    _, _, _, pres = tsdf.sdf_layers_walk(torch.from_numpy(e), tw, [torch.from_numpy(b) for b in bs],
                                         SDF_LAYOUT, act, k)
    ph, pge, ppres = tgrad.sdf_trunk_with_grad(torch.from_numpy(e), tw,
                                               [torch.from_numpy(b) for b in bs], SDF_LAYOUT,
                                               act, stash=True)
    de, dws, dbs = tgrad.sdf_trunk_with_grad_vjp(torch.from_numpy(e), tw, SDF_LAYOUT, act, pres,
                                                 torch.from_numpy(ch), torch.from_numpy(cg))
    for i, (a, b) in enumerate(zip(got, [ph, pge, de, *dws, *dbs])):
        assert _rel(a, b) <= 1e-5, ("plain", i, _rel(a, b))
    for a, b in zip(pres, ppres):
        assert _rel(a, b) <= 1e-5

    jnp = jx.jnp
    args = (jnp.asarray(e), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    fns = (lambda e_, w_, b_: jx.sdf.sdf_mlp(e_, w_, b_, SDF_LAYOUT, act, "float32", True),
           lambda e_, w_, b_: jx.grad.sdf_trunk_with_grad(e_, w_, b_, SDF_LAYOUT, act))
    for fn in fns:
        def loss(e_, w_, b_):
            jh, jge = fn(e_, w_, b_)
            return jnp.sum(jh * ch) + jnp.sum(jge * cg)

        with jx.dm.matmul_dtype(jnp.float32):
            jh, jge = fn(*args)
            jde, jdw, jdb = jx.jax.grad(loss, argnums=(0, 1, 2))(*args)
        if act == "ReLU":  # the JAX sums' own stash decides the kinks there
            continue
        for i, (a, b) in enumerate(zip(got, [jh, jge, jde, *jdw, *jdb])):
            assert _rel(a, np.asarray(b)) <= 1e-4, ("jax", i, _rel(a, np.asarray(b)))


# ------------------------------------------------------------ the fields
@pytest.fixture(scope="module")
def fields():
    from tests import test_torch_nerf_neus_field as nf

    return nf


def test_nerf_wide_matches_jax_in_f32_and_the_fused_route_in_bf16(fields):
    from neddf_tpu_torch.fields import nerf as tnerf

    cfg = {**fields.NERF, "layer_width": WIDE}
    params = None
    for dtype in ("float32", "bfloat16"):
        jfield = fields.JNeRF(**cfg, compute_dtype=dtype, fused="off")
        params = jfield.init(fields.jax.random.PRNGKey(3)) if params is None else params
        field = fields.NeRF(**cfg, compute_dtype=dtype)
        field.load_state_dict(fields.params_from_jax(params), strict=True)
        assert field.per_layer and field.tp_group is None
        before = tmlp.mlp_seg_plain.calls
        ref, got, jgrads = fields._outputs_and_grads(jfield, params, field, 500,
                                                      ("density", "color"))
        assert tmlp.mlp_seg_plain.calls == before  # the per-layer route ran
        if dtype == "float32":
            for k in ("density", "color"):
                fields._close(got[k].detach().numpy(), ref[k], 1e-5, k)
            for name, p in field.named_parameters():
                fields._close(p.grad.numpy(), jgrads[name], 1e-4, name)
            continue
        fused = fields.NeRF(**cfg, compute_dtype=dtype)
        fused.load_state_dict(fields.params_from_jax(params), strict=True)
        refusal = tnerf.kernel_refusal
        # the fused route's plain versions take any width: a predicate that
        # takes every configuration keeps the field on the fused route
        tnerf.kernel_refusal = lambda *args: None
        try:
            assert not fused.per_layer
            _, want, _ = fields._outputs_and_grads(jfield, params, fused, 500,
                                                   ("density", "color"))
        finally:
            tnerf.kernel_refusal = refusal
        for k in ("density", "color"):
            assert _rel(got[k], want[k]) <= 2.0**-8, k
        for (name, p), q in zip(field.named_parameters(), fused.parameters()):
            assert _rel(p.grad, q.grad) <= 2.0**-8, name


def test_neus_wide_matches_jax(fields):
    cfg = {**fields.NEUS, "sdf_layer_width": WIDE, "col_layer_width": WIDE,
           "activation_type": "tanhExp"}
    jfield = fields.JNeuS(**cfg, fused="off", normals="reverse")
    params = jfield.init(fields.jax.random.PRNGKey(5))
    field = fields.NeuS(**cfg)
    field.load_state_dict(fields.params_from_jax(params), strict=True)
    assert field.per_layer
    calls = tgrad.sdf_trunk_with_grad.calls, tmlp.mlp_seg_plain.calls
    with fields.matmul_dtype(fields.jnp.float32):
        ref, got, jgrads = fields._outputs_and_grads(jfield, params, field, 0,
                                                      ("sdf", "density", "color"), seed=2)
    assert (tgrad.sdf_trunk_with_grad.calls, tmlp.mlp_seg_plain.calls) == calls
    for k in ("sdf", "density", "color"):
        fields._close(got[k].detach().numpy(), ref[k], 1e-5, k)
    for name, p in field.named_parameters():
        fields._close(p.grad.numpy(), jgrads[name], 1e-4, name)


# ------------------------------------------------------------ specs, refusals
# tests/parallel/test_mesh.py's SMALL_NERF and SMALL_NEUS
SMALL = {"nerf": dict(embed_pos_rank=4, embed_dir_rank=2, layer_count=4, layer_width=16,
                      skips=[1]),
         "neus": dict(embed_pos_rank=3, embed_dir_rank=2, sdf_layer_count=4,
                      sdf_layer_width=16, col_layer_count=3, col_layer_width=16, skips=[1])}


def _flat_specs(tree, prefix=""):
    from jax.sharding import PartitionSpec

    if isinstance(tree, PartitionSpec):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, child in items:
        out.update(_flat_specs(child, f"{prefix}.{key}" if prefix else str(key)))
    return out


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("family", ["nerf", "neus"])
def test_param_specs_and_shards_follow_the_jax_rule(jx, family, model):
    from neddf_tpu.fields import NeRF as JNeRF
    from neddf_tpu.fields import NeuS as JNeuS
    from neddf_tpu.parallel.mesh import field_param_specs as jspecs
    from neddf_tpu_torch.render.renderer import NeRFRender

    jfield = {"nerf": JNeRF, "neus": JNeuS}[family](**SMALL[family])
    want = _flat_specs(jspecs(jfield.init(jx.jax.random.PRNGKey(0)), model))
    target = {"nerf": "neddf_tpu_torch.fields.NeRF", "neus": "neddf_tpu_torch.fields.NeuS"}
    renderer = NeRFRender(network_config={"_target_": target[family], **SMALL[family]},
                          use_coarse_network=family == "nerf",
                          generator=torch.Generator().manual_seed(0))
    shapes = {n: p.shape for n, p in renderer.network_fine.named_parameters()}
    got = field_param_specs(shapes, model)
    assert got == want
    names = tp_shard_names(renderer, model)
    nets = ("network_fine", "network_coarse") if family == "nerf" else ("network_fine",)
    assert names == {f"{net}.{n}" for net in nets for n, spec in got.items() if spec}
    # the heads and NeuS's 3-wide colour output stay whole
    whole = {n for n in shapes if not got[n]}
    if family == "nerf":
        assert whole == {"outL_density.w", "outL_density.b", "outL_color.1.w", "outL_color.1.b"}
    else:
        last = len(renderer.network_fine.layers_col) - 1
        assert whole == {f"layers_col.{last}.w", f"layers_col.{last}.b", "variance"}


@pytest.mark.parametrize("family", ["nerf", "neus"])
def test_widths_over_2048_are_taken_and_other_refusals_named(family):
    # the kernels' launcher without a card: the route's checks run before
    # any launch, so they take and refuse here as they do on the card
    k = object.__new__(tsdf.SDFProducts if family == "neus" else tmlp.MLPProducts)
    x = torch.zeros((4, 24))
    ws = [torch.zeros((24, 4096)), torch.zeros((4096, 4096))]
    bs = [torch.zeros(4096)] * 2
    # a full width of 4096 (and any other) passes the route's checks
    tdm._route_checks(ws, "ReLU", 0, None, "the per-layer route")
    assert tdm.route_refusal("ReLU", 2048, 0) is None
    assert tdm.route_refusal("ReLU", 2049, 0) is None
    assert tdm.route_refusal("ReLU", 8200, 0) is None
    # what the route refuses still raises on the kernels' launcher, named
    with pytest.raises(NotImplementedError, match="activation 'GELU'"):
        if family == "neus":
            tsdf.sdf_layers_walk(x, ws, bs, (False, False), "GELU", k)
        else:
            tdm.dual_mlp_layers_walk([x], [], ws, bs, (False, False), "GELU", (False,), 0, k,
                                     hidden_first=True)
    assert tdm.route_refusal("ReLU", 0, 0) == "width 0"
    # the fused kernels still stop at 512
    assert tmlp.kernel_refusal("ReLU", 513, 8) == "width 513 > 512"
    assert tsdf.kernel_refusal("ReLU", 1024, 8) == "width 1024 > 512"


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _field_step(field, sampling, keys):
    """Outputs and parameter gradients of sum(out[k] * weight[k]), f32."""
    field.zero_grad(set_to_none=True)
    out = field(sampling, field.schedule(0), need_aux=True)
    g = torch.Generator(device=sampling.sample_pos.device).manual_seed(1)
    loss = sum(torch.sum(out[k].float() * torch.randn(out[k].shape, generator=g,
                                                        device=out[k].device)) for k in keys)
    loss.backward()
    return ({k: out[k].detach().float().cpu() for k in keys},
            {n: p.grad.detach().cpu() for n, p in field.named_parameters()})


@pytest.mark.cuda
@pytest.mark.parametrize("width", [602, 1000, 2048])
@pytest.mark.parametrize("family", ["nerf", "neus"])
def test_cuda_fields_past_512_take_the_route_and_match_plain(family, width):
    """NeRF and NeuS wider than 512 on the card (f32, tanhExp: no kink)
    run the per-layer route's kernels, no fused wrapper, and match their
    plain versions (``fused="off"``) within 1e-4 (outputs) and 1e-3
    (gradients, the second-order normals' among them) of the largest."""
    from neddf_tpu_torch.fields.nerf import NeRF
    from neddf_tpu_torch.fields.neus import NeuS
    from neddf_tpu_torch.geometry.rays import Sampling

    dev = _card()
    torch.manual_seed(0)
    if family == "nerf":
        field = NeRF(embed_pos_rank=10, embed_dir_rank=4, layer_count=8, layer_width=width,
                     activation_type="tanhExp").to(dev)
        keys, route, fused = ("density", "color"), (tmlp.mlp_seg_layers,), (tmlp.mlp_seg,)
    else:
        field = NeuS(sdf_layer_width=width, col_layer_width=width,
                     activation_type="tanhExp").to(dev)
        keys = ("sdf", "density", "color")
        route, fused = (tmlp.mlp_seg_layers, tsdf.sdf_mlp_layers), (tmlp.mlp_seg, tsdf.sdf_mlp)
    g = torch.Generator(device=dev).manual_seed(2)
    pos = torch.rand((8, 37, 3), generator=g, device=dev) - 0.5
    dirs = torch.randn((8, 37, 3), generator=g, device=dev)
    sampling = Sampling(pos, dirs / dirs.norm(dim=-1, keepdim=True), torch.zeros_like(pos))
    for fn in route + fused:
        fn.launches = 0
    got = _field_step(field, sampling, keys)
    assert all(fn.launches > 0 for fn in route) and not any(fn.launches for fn in fused)
    field.fused = "off"
    want = _field_step(field, sampling, keys)
    for k in keys:
        assert torch.isfinite(got[0][k]).all() and _rel(got[0][k], want[0][k]) <= 1e-4, k
    for name, grad in want[1].items():
        assert _rel(got[1][name], grad) <= 1e-3, name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["nerf", "neus"])
def test_cuda_fields_over_2048_run_and_unknown_activations_raise(family):
    """Past 2048 the fields run the route's kernels (finite outputs and
    gradients); an activation the route does not take raises, named."""
    from neddf_tpu_torch.fields.nerf import NeRF
    from neddf_tpu_torch.fields.neus import NeuS
    from neddf_tpu_torch.geometry.rays import Sampling

    dev = _card()

    def make(**kw):
        return (NeRF(layer_width=2304, **kw) if family == "nerf"
                else NeuS(sdf_layer_width=2304, col_layer_width=2304, **kw)).to(dev)

    pos = torch.rand((2, 4, 3), device=dev) - 0.5
    sampling = Sampling(pos, torch.ones_like(pos), torch.zeros_like(pos))
    field = make()
    out = field(sampling, field.schedule(0), need_aux=True)
    sum(v.float().sum() for v in out.values()).backward()
    assert all(torch.isfinite(v).all() for v in out.values())
    assert all(torch.isfinite(p.grad).all() for p in field.parameters())
    field = make(activation_type="GELU")
    with pytest.raises(NotImplementedError, match="activation 'GELU'"):
        field(sampling, field.schedule(0), need_aux=True)
