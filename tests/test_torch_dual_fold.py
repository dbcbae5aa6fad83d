"""The dual-MLP backward as its kernels walk it, with the elementwise
passes folded into the products over rows grouped by point.

* ``dual_mlp.grouped_rows``: the stream-grouped row map of the products
  (a tile or a reduction stage holds every stream of its points) covers
  each row of the stacked planes exactly once, for ragged point counts.
* ``dual_mlp.dual_mlp_seg_bwd_route`` over the plain launcher
  ``dual_mlp.DualProductsPlain`` (the card's ``DualProducts`` methods in
  PyTorch, with the grouped stages, splits and per-tile db partials)
  against the plain version ``dual_mlp_seg_bwd_plain`` and against the
  JAX package's ``dual_mlp_seg`` VJP with the Pallas kernel in interpret
  mode: K = 3 and K = 1 (four segments), each with a post-skip layer,
  tanhExp, ReLU and LeakyReLU, f32 and bf16, ragged rows (the Pallas
  kernel takes whole 512-row tiles: its inputs get zero rows with zero
  cotangents, which add nothing).
* The launcher's calls per backward: one top-layer ``gstack``, L - 1
  products with the stacked cotangent as their epilogue and L - 1 with
  the layer input as their prologue, and no layer-input pass; under an
  activation whose f'' is zero the stacked cotangent reads no tangent
  stash.
* On the card (marked ``cuda``): the grouped products against the plain
  launcher at ragged rows, and the same tangent-stash check.

Tolerances. Against the plain version both sides multiply the same
operands: f32 1e-6 of the largest magnitude (the sums in another order);
bf16 the stacked cotangents bitwise (formed from the same f32 products
and rounded once), dv/dj and dW within 2^-8 and db within 1e-6. Against
the Pallas VJP, as ``test_torch_train_kernels.py``: f32 1e-4 (torch's and
XLA's tanh differ by an ulp near 1, which f'' multiplies), bf16 2^-4.
"""
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES, SECOND_DERIVATIVE_ZERO
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

C = 32
M = 512 - 45  # ragged against every group size (128 / S, 64 / S, 32 / S points)
ROWS_JAX = 512  # one row tile of the Pallas kernel
ACTS = ("tanhExp", "ReLU", "LeakyReLU")
CONFIGS = {
    "trunk_k3": dict(widths=(24,), has_j=(True,), n_tan=3, layout=(False, False, True, False)),
    "color_k1": dict(widths=(24, 12, 3, C), has_j=(True, False, False, True), n_tan=1,
                     layout=(False, True, False)),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PLAIN_TOL = {"float32": 1e-6, "bfloat16": 2.0**-8}
JAX_TOL = {"float32": 1e-4, "bfloat16": 2.0**-4}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm

    assert jdm.TILE_M == ROWS_JAX
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm)


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _inputs(cfg, dtype, act, m=M, seed=0, device="cpu"):
    """Seeded segments, tangents, weights and output cotangents in T, and
    the plain forward's stash."""
    rng = np.random.default_rng(seed)
    k = cfg["n_tan"]

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=torch.float32, device=device).to(dt)

    vs = [t(rng.normal(size=(m, w))) for w in cfg["widths"]]
    js = [t(rng.normal(size=(k, m, w))) for w, h in zip(cfg["widths"], cfg["has_j"]) if h]
    ws, bs = [], []
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else C + cfg["widths"][0] * split
        ws.append(t(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, C))))
        bs.append(t(rng.normal(scale=0.1, size=C), torch.float32))
    _, _, pres = tdm.dual_mlp_seg_plain(vs, js, ws, bs, cfg["layout"], act, cfg["has_j"], k,
                                        stash=True)
    gv, gj = t(rng.normal(size=(m, C))), t(rng.normal(size=(k, m, C)))
    return (vs, js, ws, cfg["layout"], act, cfg["has_j"], pres, gv, gj), bs


class Recording(tdm.DualProductsPlain):
    """The plain launcher, counting the walk's calls by method (not those
    its methods make of each other) and keeping the stacked cotangents it
    forms, in the order of the walk."""

    def __init__(self, dtype):
        super().__init__(dtype)
        self.calls = Counter()
        self.stacked = []
        self._depth = 0

    def _call(self, name, *args):
        if self._depth == 0:
            self.calls[name] += 1
        self._depth += 1
        try:
            return getattr(super(), name)(*args)
        finally:
            self._depth -= 1

    def gstack(self, *args):
        out = self._call("gstack", *args)
        self.stacked.append(out[0])
        return out

    def nt_gstack(self, *args):
        out = self._call("nt_gstack", *args)
        self.stacked.append(out[0])
        return out

    def tn_dual_act(self, *args):
        return self._call("tn_dual_act", *args)

    def nt(self, *args):
        return self._call("nt", *args)

    def tn(self, *args):
        return self._call("tn", *args)


def _plain_stacked(vs, ws, layout, act, pres, gv, gj):
    """The stacked cotangents of the layers, top first, as
    ``dual_mlp_seg_bwd_plain`` forms them: G = T(g f'(z_v) + f''(z_v) sum_a
    g_a z_a, g_a f'(z_v)), then g = G W^T over the layer's hidden rows."""
    _, df, ddf = ACTIVATION_TRIPLES[act]
    c0 = vs[0].shape[1]
    g = torch.cat([gv[None], gj], dim=0).float()
    out = []
    for li in reversed(range(len(ws))):
        z = pres[li].float()
        d1, d2 = df(z[0]), ddf(z[0])
        gpre_v = g[0] * d1 + d2 * torch.sum(g[1:] * z[1:], dim=0)
        out.append(torch.cat([gpre_v[None], g[1:] * d1], dim=0).to(gv.dtype))
        w = ws[li].float()
        g = out[-1].float() @ (w[c0:] if layout[li] else w).T
    return out


# ---------------------------------------------------------------- the row map
@pytest.mark.parametrize("points", [1, 31, 33, 37, 64, 97])
@pytest.mark.parametrize("streams", [2, 4])
def test_grouped_row_map_covers_every_row_once(streams, points):
    # a 128-row tile of the nt product, a stage of the tn product (64 bf16
    # or 32 f32 rows): 128 / S, 64 / S and 32 / S points per group
    for per in (128 // streams, 64 // streams, 32 // streams):
        rows = tdm.grouped_rows(streams, points, per)
        groups = -(-points // per)
        assert tuple(rows.shape) == (groups, streams * per)
        valid = rows[rows >= 0]
        assert torch.equal(valid.sort().values, torch.arange(streams * points))
        assert int((rows < 0).sum()) == streams * (groups * per - points)
        # every group holds the S streams of the same points, in stream order
        grid = rows.view(groups, streams, per)
        point = torch.where(grid >= 0, grid % points, -1)
        assert torch.equal(point, point[:, :1].expand_as(point))
        stream = torch.arange(streams).view(1, streams, 1)
        assert bool(((grid // points == stream) | (grid < 0)).all())


def test_grouped_plan_splits_whole_stages_of_points():
    # route_tn's k-block by element size (128 bytes of a row), S streams of
    # depth / S points each (fold_plan plans tn_dual_act)
    depth = {2: 64, 4: 32}
    for itemsize, streams, points in [(2, 4, 99_328), (2, 2, 99_328), (4, 4, 33_287),
                                      (4, 2, 33_287), (2, 4, 97)]:
        plan = tdm.fold_plan("tn_dual_act", 256, 256, points, itemsize, streams=streams)
        per = depth[itemsize] // streams
        assert plan["step"] == per and plan["k_chunk"] % per == 0
        assert 1 <= plan["splits"] <= 64
        assert (plan["splits"] - 1) * plan["k_chunk"] < points <= plan["splits"] * plan["k_chunk"]
    with pytest.raises(ValueError):
        tdm.fold_plan("tn_dual_act", 256, 256, 97, 2, streams=3)


# ---------------------------------------------------------- the walk, on the CPU
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_matches_plain(name, act, dtype):
    args, _ = _inputs(CONFIGS[name], DTYPES[dtype], act, seed=1)
    launcher = Recording(DTYPES[dtype])
    got = tdm.dual_mlp_seg_bwd_route(*args, launcher)
    ref = tdm.dual_mlp_seg_bwd_plain(*args)
    vs, _, ws, layout, _, _, pres, gv, gj = args
    stacked = _plain_stacked(vs, ws, layout, act, pres, gv, gj)
    assert len(launcher.stacked) == len(stacked) == len(ws)
    for li, (g, r) in enumerate(zip(launcher.stacked, stacked)):
        assert g.dtype == r.dtype == gv.dtype
        if dtype == "bfloat16":
            assert torch.equal(g, r), ("stacked cotangent", li)
        else:
            assert _rel(g, r) <= PLAIN_TOL[dtype], ("stacked cotangent", li)
    for kind, gg, rr in zip(("dv", "dj", "dW", "db"), got, ref):
        assert len(gg) == len(rr)
        for i, (g, r) in enumerate(zip(gg, rr)):
            assert g.shape == r.shape and g.dtype == r.dtype, (kind, i)
            tol = 1e-6 if kind == "db" else PLAIN_TOL[dtype]
            assert _rel(g, r) <= tol, (kind, i)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_matches_pallas_vjp(jx, name, act, dtype):
    cfg = CONFIGS[name]
    cd = DTYPES[dtype]
    args, bs = _inputs(cfg, cd, act, seed=2)
    got = tdm.dual_mlp_seg_bwd_route(*args, tdm.DualProductsPlain(cd))
    vs, js, ws, layout, _, has_j, _, gv, gj = args
    jnp = jx.jnp

    def j(t, axis=0):  # zero rows to the Pallas tile
        a = t.float().numpy()
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, ROWS_JAX - a.shape[axis])
        return jnp.asarray(np.pad(a, pad), None if dtype == "float32" else jnp.bfloat16)

    def f(vs_, js_, ws_, bs_):
        return jx.dm.dual_mlp_seg(vs_, js_, ws_, bs_, layout, act, has_j, dtype, True)

    with jx.dm.matmul_dtype(jnp.dtype(dtype)):
        _, vjp = jx.jax.vjp(f, tuple(j(v) for v in vs), tuple(j(t, 1) for t in js),
                            tuple(jnp.asarray(w.float().numpy()) for w in ws),
                            tuple(jnp.asarray(b.numpy()) for b in bs))
        ref = vjp((j(gv), j(gj, 1)))
    tol = JAX_TOL[dtype]
    for kind, gg, rr in zip(("dv", "dj", "dW", "db"), got, ref):
        assert len(gg) == len(rr)
        for i, (g, r) in enumerate(zip(gg, rr)):
            r = torch.from_numpy(np.array(r, np.float32))
            if kind == "dv":
                r = r[:M]
            elif kind == "dj":
                r = r[:, :M]
            assert tuple(g.shape) == tuple(r.shape), (kind, i)
            assert _rel(g, r) <= tol, (kind, i)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_calls_one_gstack_and_folds_every_layer_below(name):
    cfg = CONFIGS[name]
    args, _ = _inputs(cfg, torch.bfloat16, "tanhExp", m=37, seed=3)
    launcher = Recording(torch.bfloat16)
    tdm.dual_mlp_seg_bwd_route(*args, launcher)
    n_l = len(cfg["layout"])
    n_skip = sum(cfg["layout"])
    # layer 0: one nt and one tn per segment; a post-skip layer's seg0 rows:
    # one plain nt and one plain tn
    n_seg = len(cfg["widths"])
    assert launcher.calls == Counter(gstack=1, nt_gstack=n_l - 1, tn_dual_act=n_l - 1,
                                     nt=n_seg + n_skip, tn=n_seg + n_skip)
    assert launcher.planes == ["gstack"] + ["gs"] * (n_l - 1)
    for cls in (tdm.DualProducts, tdm.DualProductsPlain):
        assert not any("dual_act" in attr and attr != "tn_dual_act" for attr in dir(cls))


@pytest.mark.parametrize("act", ACTS)
def test_stacked_cotangent_reads_the_tangent_stash_only_where_f2_is_not_zero(act):
    gen = torch.Generator().manual_seed(4)
    m, s = 37, 4
    z = torch.randn((s, m, C), generator=gen)
    z[1:] = float("nan")  # a read of the tangent stash shows in every output
    gs = torch.randn((s, m, C), generator=gen)
    w = torch.randn((C, C), generator=gen)
    k = tdm.DualProductsPlain(torch.float32)
    outs = [*k.gstack(gs[0], gs[1:], z, act), *k.nt_gstack(gs, w, z, act)]
    finite = [bool(torch.isfinite(t).all()) for t in outs]
    assert finite == [act in SECOND_DERIVATIVE_ZERO] * 4


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("points", [1, 33, 97, 4096 + 77])
@pytest.mark.parametrize("streams", [2, 4])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_grouped_products_match_the_plain_launcher(dtype, act, streams, points):
    """nt_gstack and tn_dual_act at width 256 against the plain launcher on
    the same inputs: an off-by-one in the row map corrupts one stream."""
    dev = _card()
    cd = DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(points)
    z = torch.randn((streams, points, 256), generator=gen, device=dev).to(cd)
    gs = (torch.randn((streams, points, 256), generator=gen, device=dev) * 0.1).to(cd)
    w = (torch.randn((256, 256), generator=gen, device=dev) / 16).to(cd)
    kern, plain = tdm.DualProducts(cd, dev), tdm.DualProductsPlain(cd)
    counts = tdm.folded_launches()
    got_g, got_db = kern.nt_gstack(gs, w, z, act)
    got_w = kern.tn_dual_act(z, gs, act)
    torch.cuda.synchronize()
    assert tdm.folded_launches() == {"epilogue": counts["epilogue"] + 1,
                                     "prologue": counts["prologue"] + 1}
    ref_g, ref_db = plain.nt_gstack(gs, w, z, act)
    ref_w = plain.tn_dual_act(z, gs, act)
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    for a in range(streams):  # stream by stream: a corrupt one shows alone
        assert _rel(got_g[a].cpu(), ref_g[a].cpu()) <= tol, ("stream", a)
    assert _rel(got_db.cpu(), ref_db.cpu()) <= (1e-4 if dtype == "bfloat16" else 1e-5)
    assert _rel(got_w.cpu(), ref_w.cpu()) <= 1e-5
    again = kern.tn_dual_act(z, gs, act), kern.nt_gstack(gs, w, z, act)[1]
    assert torch.equal(again[0], got_w) and torch.equal(again[1], got_db)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
def test_cuda_stacked_cotangent_reads_no_tangent_stash_where_f2_is_zero(act):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    m, s = 4096 + 77, 4
    z = torch.randn((s, m, 256), generator=gen, device=dev)
    z[1:] = float("nan")
    gs = torch.randn((s, m, 256), generator=gen, device=dev)
    w = torch.randn((256, 256), generator=gen, device=dev) / 16
    k = tdm.DualProducts(torch.float32, dev)
    outs = [*k.gstack(gs[0], gs[1:].contiguous(), z, act), *k.nt_gstack(gs, w, z, act)]
    torch.cuda.synchronize()
    finite = [bool(torch.isfinite(t).all()) for t in outs]
    assert finite == [act in SECOND_DERIVATIVE_ZERO] * 4
