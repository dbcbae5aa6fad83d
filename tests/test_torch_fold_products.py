"""The folded backward products on wgmma (``csrc/route_products.cu``:
route_nt with the activation's epilogue, route_tn with its prologue):
``Products.nt_act``, ``.nn_adjoint``, ``.tn_act``,
``DualProducts.nt_gstack`` and ``.tn_dual_act``.

On the CPU:

* ``dual_mlp.fold_plan``, the launchers' host-side plan: the output tiles
  (128 rows, or 128 / S points grouped by point), db's row tiles, the
  k-blocks of the sweep adjoint's two K segments and the zero columns
  its f32 tf32 planes leave between them, the padding copies where an
  operand's rows or address are not whole 16-byte vectors (TMA's), tn's
  fixed splits in points over rows grouped by point, and the refusals.
* ``tools/fold_probe.py``'s altered copies of ``route_products.cu``.
* The plain versions of the dual products under Softplus and Sigmoid at
  the stream counts ``test_torch_widths_acts.py`` does not take (S = 2 in
  f32, S = 4 in bf16), through the dual walk over ``DualProductsPlain``,
  against the JAX package's ``dual_mlp_seg`` VJP with the Pallas kernel in
  interpret mode.

On the card (marked ``cuda``): each mode against its plain version under
the five activations, bf16 and f32 (nn_adjoint f32 only, as the sdf trunk
runs), ragged rows, the raw seg0 columns past ``n_act``, the side plane,
the kept product, the sweep adjoint's two K segments and its top, the
NeuS colour trunk's 3-deep top layer, S = 2 and 4; dW and db bitwise
equal over two runs; each call one launch of its own kernel and none of
shallow_nt.

Tolerances. Against the plain version both sides multiply the same
operands and differ in the order of the f32 sums (and in f32 by the
3xTF32 split's dropped lo*lo, ~2^-21 of a product): f32 outputs 1e-5 of
the largest magnitude; bf16 outputs 2^-7 (a sum on a rounding boundary
rounds to the neighbouring bf16 value, 2^-8 relative); dW 1e-5 (bf16
1e-4: the layer input f(z), rounded to bf16 on both sides from f32
values an ulp apart, takes the neighbouring bf16 value in a few
elements); db 1e-4 (a column sum over 20,011 rows in another order, of
terms of both signs).
Against the Pallas
VJP as ``test_torch_widths_acts.py``: f32 1e-4, bf16 2^-4.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES, SECOND_DERIVATIVE_ZERO
from tests.test_torch_widths_acts import (JAX_TOL, M, PLAIN_TOL, ROWS_JAX, _dual_cfg,
                                          _dual_inputs, _pad, _rel, jx)  # noqa: F401
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
ALL_ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
R_BF16 = 4 * 99_328  # the K=3 trunk's stacked rows at the training batch
R_F32 = 265_216  # NeuS: both passes' rows through one network


# ------------------------------------------------------------------ the plan
def test_plan_nt_tiles_and_blocks_at_the_shipped_shapes():
    p = tdm.fold_plan("nt_act", R_BF16, 256, 256, 2)
    assert (p["tile_rows"], p["row_tiles"], p["tiles"]) == (128, 3104, 6208)
    assert (p["kb1"], p["nk"], p["pad_a"], p["pad_a2"], p["pad_b"], p["ldw"]) == (
        4, 4, 0, 0, 0, 0)
    p = tdm.fold_plan("nt_act", R_F32, 256, 256, 4)
    assert (p["row_tiles"], p["kb1"], p["nk"], p["ldw"]) == (2072, 8, 8, 256)


@pytest.mark.parametrize("streams, rows", [(2, 64), (4, 32)])
def test_plan_grouped_tile_holds_every_stream_of_its_points(streams, rows):
    p = tdm.fold_plan("nt_gstack", 99_328, 256, 256, 2, streams=streams)
    assert p["tile_rows"] == rows and p["row_tiles"] == -(-99_328 // rows)
    assert p["tiles"] == p["row_tiles"] * 2
    p = tdm.fold_plan("nt_gstack", 99_328 + 5, 45, 256, 4, streams=streams)
    assert p["row_tiles"] == -(-(99_328 + 5) // rows) and p["tiles"] == p["row_tiles"]


def test_plan_two_segments_leave_zero_columns_between_them():
    # the sweep adjoint of the post-skip layer: [qbar (256) | cg (36)] W [292, 256]
    p = tdm.fold_plan("nn_adjoint", R_F32, 256, 292, 4, k1=256)
    assert (p["kb1"], p["nk"], p["ldw"], p["pad_a"], p["pad_a2"]) == (8, 10, 292, 0, 0)
    # a first segment off the k-block: its second starts at the next one
    p = tdm.fold_plan("nn_adjoint", 1000, 64, 100 + 36, 4, k1=100)
    assert (p["kb1"], p["nk"], p["ldw"]) == (4, 6, 128 + 36)
    # one segment (layer 0: cg W0)
    p = tdm.fold_plan("nn_adjoint", R_F32, 256, 36, 4)
    assert (p["kb1"], p["nk"], p["ldw"], p["pad_a2"]) == (2, 2, 36, 0)
    with pytest.raises(ValueError, match="segments"):
        tdm.fold_plan("nt_act", 1000, 64, 136, 4, k1=100)


@pytest.mark.parametrize("itemsize, vec", [(2, 8), (4, 4)])
def test_plan_pads_rows_off_16_bytes(itemsize, vec):
    # the NeuS colour trunk's top layer: G [R, 3] against W rows [256, 3]
    p = tdm.fold_plan("nt_act", 1000, 256, 3, itemsize)
    assert p["pad_a"] == vec and p["pad_b"] == (vec if itemsize == 2 else 0)
    assert p["ldw"] == (4 if itemsize == 4 else 0) and p["nk"] == 1
    # rows of whole vectors at an address off 16 bytes
    p = tdm.fold_plan("nt_act", 1000, 256, 256, itemsize, a_ptr=itemsize * 3)
    assert p["pad_a"] == 256 and p["pad_b"] == 0
    # tn: its dW against a 3-wide G, and a 60-wide stash (NeRF's embedding)
    p = tdm.fold_plan("tn_act", 256, 3, 1000, itemsize)
    assert (p["pad_a"], p["pad_b"]) == (0, vec)
    p = tdm.fold_plan("tn_act", 60, 256, 1000, itemsize)
    assert (p["pad_a"], p["pad_b"]) == ((0 if 60 * itemsize % 16 == 0 else 64), 0)
    # the sweep's two segments each on their own
    p = tdm.fold_plan("nn_adjoint", 1000, 256, 256 + 30, 4, k1=256)
    assert (p["pad_a"], p["pad_a2"]) == (0, 32)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("points", [1, 97, 99_328, 265_216 + 3])
def test_plan_tn_splits_cover_every_point_in_whole_blocks(itemsize, streams, points):
    mode = "tn_act" if streams == 1 else "tn_dual_act"
    p = tdm.fold_plan(mode, 256, 256, points, itemsize, streams=streams)
    step = {2: 64, 4: 32}[itemsize] // streams
    assert p["step"] == step and p["k_chunk"] % step == 0
    assert (p["splits"] - 1) * p["k_chunk"] < points <= p["splits"] * p["k_chunk"]
    assert p["splits"] <= 64
    if points >= 99_328:  # enough k-blocks: the 4 tiles' units fill most SMs
        assert p["splits"] * 4 >= 0.9 * tdm.H100_SMS


def test_plan_refusals():
    with pytest.raises(ValueError, match="mode"):
        tdm.fold_plan("nn_act", 10, 10, 10, 2)
    with pytest.raises(ValueError, match="streams"):
        tdm.fold_plan("nt_gstack", 10, 10, 10, 2, streams=3)
    with pytest.raises(ValueError, match="streams"):
        tdm.fold_plan("nt_act", 10, 10, 10, 2, streams=2)
    with pytest.raises(ValueError, match="f32"):
        tdm.fold_plan("nn_adjoint", 10, 10, 10, 2)
    with pytest.raises(ValueError, match="aligned"):
        tdm.fold_plan("tn_act", 10, 10, 10, 4, b_ptr=2)
    with pytest.raises(ValueError, match="byte operands"):
        tdm.fold_plan("tn_act", 10, 10, 10, 8)


def test_plain_tn_dual_act_takes_the_kernels_splits():
    """DualProductsPlain.tn_dual_act walks fold_plan's splits of whole
    grouped k-blocks; its sum matches one product of the layer input."""
    gen = torch.Generator().manual_seed(3)
    s, pts, m, n = 4, 20_000 + 7, 16, 8
    z = torch.randn((s, pts, m), generator=gen)
    gs = torch.randn((s, pts, n), generator=gen)
    plan = tdm.fold_plan("tn_dual_act", m, n, pts, 4, streams=s)
    assert plan["splits"] > 1
    got = tdm.DualProductsPlain(torch.float32).tn_dual_act(z, gs, "tanhExp")
    f, df, _ = ACTIVATION_TRIPLES["tanhExp"]
    h = torch.cat([f(z[0])] + [df(z[0]) * z[a] for a in range(1, s)])
    ref = h.T.double() @ gs.reshape(s * pts, n).double()
    assert _rel(got, ref) <= 1e-5


# ------------------------------------- plain versions against the Pallas VJP
@pytest.mark.parametrize("name", ["no_stash", "ring3", "ahead2", "ahead3", "ahead2_unroll2"])
def test_probe_variants_alter_only_their_lines(tmp_path, monkeypatch, name):
    """``tools/fold_probe.py``'s altered copies of the package: each
    substitution lands once in ``route_products.cu``, and every other
    source is the checkout's."""
    sys.path.insert(0, str(REPO / "tools"))
    import fold_probe

    monkeypatch.setattr(fold_probe, "OUT", tmp_path)
    subs = fold_probe.VARIANTS[name]
    tree = fold_probe.variant(name, subs) / "neddf_tpu_torch"
    src = REPO / "neddf_tpu_torch"
    text = (tree / "csrc" / "route_products.cu").read_text()
    assert all(text.count(new) == 1 for _, new in subs)
    want = (src / "csrc" / "route_products.cu").read_text()
    for old, new in subs:
        want = want.replace(old, new)
    assert text == want
    for path in (src / "csrc").iterdir():
        if path.name != "route_products.cu":
            assert (tree / "csrc" / path.name).read_bytes() == path.read_bytes()


@pytest.mark.parametrize("act", ["Softplus", "Sigmoid"])
@pytest.mark.parametrize("name, dtype", [("color", "float32"), ("trunk", "bfloat16")])
def test_dual_walk_at_other_streams_matches_plain_and_pallas(jx, name, dtype, act):  # noqa: F811
    width = 48
    cfg = _dual_cfg(width)[name]
    cd = DTYPES[dtype]
    args, bs = _dual_inputs(cfg, width, cd, act, seed=width + len(act))
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


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _launches():
    return dict(tdm.FOLD_LAUNCHES), sum(tdm.SHALLOW_LAUNCHES.values())


def _one_launch(before, mode):
    fold, gemm = _launches()
    assert fold[mode] == before[0][mode] + 1 and gemm == before[1], (fold, gemm)
    assert sum(fold.values()) == sum(before[0].values()) + 1


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2.0**-7


def _dw_tol(cd):
    # bf16: the layer input f(z) is rounded to bf16 on both sides from f32
    # values that may differ by an ulp (Softplus: the kernel's log1pf(expf)
    # against torch's softplus), so a few elements take the neighbouring
    # bf16 value (1.1e-5 to 1.6e-5 seen at 20,011 points)
    return 1e-5 if cd == torch.float32 else 1e-4


# (rows, k, n, n_act): the trunk's hidden layer (ragged rows), NeRF's
# post-skip layer (60 raw seg0 columns), NeuS's (36), the colour trunk's
# 3-deep top, a narrow odd width
NT_CASES = [(20_011, 256, 256, 256), (20_011, 256, 316, 256), (9_001, 256, 292, 256),
            (9_001, 3, 256, 256), (4_099, 45, 45, 45)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", NT_CASES)
@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_nt_act_matches_plain(dtype, act, case):
    dev = _card()
    cd = DTYPES[dtype]
    r, k, n, n_act = case
    gen = torch.Generator(device=dev).manual_seed(r + k + n)
    a = (torch.randn((r, k), generator=gen, device=dev) * 0.3).to(cd)
    w = (torch.randn((n, k), generator=gen, device=dev) / k ** 0.5).to(cd)
    z = torch.randn((r, n_act), generator=gen, device=dev).to(cd)
    add = torch.randn((r, n_act), generator=gen, device=dev) * 0.1
    kern, plain = tdm.Products(cd, dev), tdm.ProductsPlain(cd)
    for kw in (dict(n_act=n_act, db=True), dict(add=add, n_act=n_act, db=True),
               dict(n_act=n_act, keep=True)):
        before = _launches()
        got = kern.nt_act(a, w, z, act, **kw)
        torch.cuda.synchronize()
        _one_launch(before, "nt_act")
        ref = plain.nt_act(a, w, z, act, **kw)
        for name, g, p, tol in zip(("out", "raw", "kept", "db"), got, ref,
                                   (_tol(dtype), 1e-5, 1e-5, 1e-4)):
            assert (g is None) == (p is None), name
            if g is not None:
                assert g.shape == p.shape and g.dtype == p.dtype, name
                assert _rel(g.float().cpu(), p.float().cpu()) <= tol, (name, kw.keys())
        if kw.get("db"):
            assert torch.equal(kern.nt_act(a, w, z, act, **kw)[3], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("segments", [(36,), (256, 36), (256,), (100, 30)])
def test_cuda_nn_adjoint_matches_plain(act, segments):
    """The sweep's adjoint, f32: pbar = [qbar | cg] W with qbar' = pbar
    f'(z) and zs = pbar q f''(z), the top's onehot0 pbar f''(z)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(sum(segments))
    r, n = 9_001, 256
    a = torch.randn((r, segments[0]), generator=gen, device=dev)
    a2 = torch.randn((r, segments[1]), generator=gen, device=dev) if len(segments) > 1 else None
    w = torch.randn((sum(segments), n), generator=gen, device=dev) / sum(segments) ** 0.5
    z = torch.randn((r, n), generator=gen, device=dev)
    q = torch.randn((r, n), generator=gen, device=dev)
    kern, plain = tdm.Products(torch.float32, dev), tdm.ProductsPlain(torch.float32)
    tops = (False,) if act in SECOND_DERIVATIVE_ZERO else (False, True)
    for top in tops:
        before = _launches()
        got = kern.nn_adjoint(a, w, z, act, a2=a2, q=None if top else q, top=top)
        torch.cuda.synchronize()
        _one_launch(before, "nn_adjoint")
        ref = plain.nn_adjoint(a, w, z, act, a2=a2, q=None if top else q, top=top)
        for g, p in zip(got, ref):
            assert (g is None) == (p is None)
            if g is not None:
                assert _rel(g.cpu(), p.cpu()) <= 1e-5, (top, segments)


# (rows, m, n): the hidden layer's dW at ragged rows, a 3-wide G (the
# colour trunk's top), a 45-wide stash (rows off 16 bytes)
TN_CASES = [(20_011, 256, 256), (20_011, 256, 3), (4_099, 45, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TN_CASES)
@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_tn_act_matches_plain(dtype, act, case):
    dev = _card()
    cd = DTYPES[dtype]
    r, m, n = case
    gen = torch.Generator(device=dev).manual_seed(r + m + n)
    z = torch.randn((r, m), generator=gen, device=dev).to(cd)
    g = (torch.randn((r, n), generator=gen, device=dev) * 0.1).to(cd)
    kern, plain = tdm.Products(cd, dev), tdm.ProductsPlain(cd)
    before = _launches()
    got = kern.tn_act(z, g, act)
    torch.cuda.synchronize()
    _one_launch(before, "tn_act")
    assert _rel(got.cpu(), plain.tn_act(z, g, act).cpu()) <= _dw_tol(cd)
    assert torch.equal(kern.tn_act(z, g, act), got)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 45])
@pytest.mark.parametrize("streams", [2, 4])
@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_dual_products_match_plain(dtype, act, streams, width):
    dev = _card()
    cd = DTYPES[dtype]
    points = 20_011
    gen = torch.Generator(device=dev).manual_seed(streams + width)
    z = torch.randn((streams, points, width), generator=gen, device=dev).to(cd)
    gs = (torch.randn((streams, points, 256), generator=gen, device=dev) * 0.1).to(cd)
    w = (torch.randn((width, 256), generator=gen, device=dev) / 16).to(cd)
    kern, plain = tdm.DualProducts(cd, dev), tdm.DualProductsPlain(cd)
    before = _launches()
    got_g, got_db = kern.nt_gstack(gs, w, z, act)
    torch.cuda.synchronize()
    _one_launch(before, "nt_gstack")
    before = _launches()
    got_w = kern.tn_dual_act(z, gs, act)
    torch.cuda.synchronize()
    _one_launch(before, "tn_dual_act")
    ref_g, ref_db = plain.nt_gstack(gs, w, z, act)
    errs = {"G": [_rel(got_g[a].float().cpu(), ref_g[a].float().cpu()) for a in range(streams)],
            "db": _rel(got_db.cpu(), ref_db.cpu()),
            "dW": _rel(got_w.cpu(), plain.tn_dual_act(z, gs, act).cpu())}
    # stream by stream: a corrupt one shows alone
    assert max(errs["G"]) <= _tol(dtype) and errs["db"] <= 1e-4 and errs["dW"] <= _dw_tol(cd), errs
    assert torch.equal(kern.tn_dual_act(z, gs, act), got_w)
    assert torch.equal(kern.nt_gstack(gs, w, z, act)[1], got_db)
