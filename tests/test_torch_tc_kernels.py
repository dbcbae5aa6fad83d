"""The tensor-core routes: the bf16 product of the backwards
(``csrc/dual_mlp_bwd.cu``, ``neddf_gemm_bf16_tc``) and the bf16 row-tile
forward (``csrc/mlp_tile.cuh``, ``tile_forward_tc``).

On the CPU: the Python planning of the product (layout, row strides,
copy widths, split-K) and the plain version of the products over the
same strided views, against the JAX package's own products
(``neddf_tpu.kernels.dual_mlp._mm`` / ``_mm_tn`` / ``_mm_nt``) at f32 and
on bf16-rounded operands; the zero-padded 3-wide last layer of
``mlp_seg`` against the unpadded one and the JAX package.

On the card (marked ``cuda``: they skip without one): the product kernel
against its plain version in all three layouts at ragged shapes, with
bitwise-equal results over two runs, and the tile forward for K = 0, 1
and 3 against the plain versions at a ragged M, with a post-skip layer
in each order and the stash.

Tolerances: the products of bf16 operands are exact in f32, so kernel,
plain version and JAX differ only in the order of the f32 sums: 1e-5 of
the largest magnitude on the CPU, 1e-4 on the card (a reduction over
7,003 rows in split partials). The bf16 tile forward rounds every
layer's activations to bf16, where a value on a rounding boundary may
round the other way and carry one bf16 step on: 2^-5, as for every bf16
route of the port.
"""
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
R = 7003  # rows of the reduced or output side: not a multiple of any tile
FAN_INS = (3, 24, 60, 256, 316)
WIDTHS = (3, 60, 256)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.mlp as jmlp

    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, mlp=jmlp)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _operands(layout, k, n, seed=0, rows=R):
    """The operands of one product as the backwards pass them: (a, b) and
    the strided call ``(m, n, k, a, sam, sak, b, sbk, sbn)``.

    nt: a [rows, k] times w_rows [n, k]^T (dx = G W^T);
    tn: a [rows, k]^T times g [rows, n] over the rows (dW = h^T G);
    nn: a [rows, k] times w [k, n].
    """
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(rows, k)).astype(np.float32)
    if layout == "nt":
        b = rng.normal(size=(n, k)).astype(np.float32)
        call = (rows, n, k, k, 1, 1, k)
    elif layout == "tn":
        b = rng.normal(size=(rows, n)).astype(np.float32)
        call = (k, n, rows, 1, k, n, 1)
    else:
        b = rng.normal(size=(k, n)).astype(np.float32)
        call = (rows, n, k, k, 1, n, 1)
    return a, b, call


def _plain(a, b, call):
    m, n, k, sam, sak, sbk, sbn = call
    return tdm.products_plain(m, n, k, a, sam, sak, b, sbk, sbn)


def _jax_product(jx, layout, a, b, dtype):
    fn = {"nt": jx.dm._mm_nt, "tn": jx.dm._mm_tn, "nn": jx.dm._mm}[layout]
    with jx.dm.matmul_dtype(jx.jnp.dtype(dtype)):
        return np.asarray(fn(jx.jnp.asarray(a), jx.jnp.asarray(b)), np.float32)


# ------------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
def test_plan_reads_the_layout_and_row_strides(layout):
    for k in FAN_INS:
        for n in WIDTHS:
            _, _, call = _operands(layout, k, n, rows=5)
            m_, n_, k_, sam, sak, sbk, sbn = call
            plan = tdm.tc_plan(m_, n_, k_, sam, sak, sbk, sbn)
            assert plan["layout"] == layout
            lda, ldb = {"nt": (sam, sbn), "tn": (sak, sbk), "nn": (sam, sbk)}[layout]
            assert (plan["lda"], plan["ldb"]) == (lda, ldb)


def test_plan_copy_widths_follow_alignment():
    # bf16 row strides: 256 (512 B) -> 16-byte copies; 60 (120 B) -> 8;
    # 316 (632 B) -> 8; 3 (6 B) -> element-wise; 24 (48 B) -> 16
    for ld, vec in ((256, 8), (60, 4), (316, 4), (3, 1), (24, 8), (6, 2)):
        assert tdm.tc_plan(10, 256, ld, ld, 1, 1, 256, 0, 0)["vec_a"] == vec
    # a pointer 8 bytes off a 16-byte boundary halves the copy
    assert tdm.tc_plan(10, 256, 256, 256, 1, 1, 256, 8, 0)["vec_a"] == 4
    assert tdm.tc_plan(10, 256, 256, 256, 1, 1, 256, 2, 0)["vec_a"] == 1


def test_plan_refuses_a_fourth_layout():
    # A with M contiguous against B with K contiguous
    with pytest.raises(ValueError):
        tdm.tc_plan(64, 64, 64, 1, 64, 1, 64)


@pytest.mark.parametrize("k", [1, 31, 4096, 4097, R, 4 * 99_328, 600_000])
def test_plan_splits_cover_the_reduction_once(k):
    plan = tdm.tc_plan(256, 256, k, 1, 256, 256, 1)
    splits, chunk = plan["splits"], plan["k_chunk"]
    assert 1 <= splits <= 64 and chunk % 64 == 0
    covered = sum(max(0, min(k, (z + 1) * chunk) - z * chunk) for z in range(splits))
    assert covered == k


@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_products_plain_match_the_jax_products(jx, layout, dtype):
    for k in (3, 60, 316):
        for n in (3, 256):
            a, b, call = _operands(layout, k, n, seed=k + n)
            if dtype == "bfloat16":  # the operands as the kernel reads them
                a = torch.from_numpy(a).bfloat16().float().numpy()
                b = torch.from_numpy(b).bfloat16().float().numpy()
            got = _plain(torch.from_numpy(a), torch.from_numpy(b), call)
            ref = _jax_product(jx, layout, a, b, dtype)
            assert got.shape == ref.shape
            assert _rel(got, ref) <= 1e-5, (k, n)


def test_padded_last_layer_equals_unpadded_and_jax(jx):
    """The wrapper pads a narrow last layer to 256 zero columns for the
    tile kernel and slices it off (``mlp._pad_columns``): the padded
    columns stay exactly zero, and the kept ones are the unpadded product
    within one f32 rounding (the CPU BLAS may order a 3-column and a
    256-column product's sums differently: 3.1e-7 of max |out| measured on
    an AVX512 host)."""
    rng = np.random.default_rng(3)
    widths, c, m = (3, 24, 3, 32), 256, 1024  # one tile of the Pallas kernel
    layout = (False,) * 3
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in widths]
    fans, outs = (sum(widths), c, c), (c, c, 3)
    ws = [rng.normal(scale=f ** -0.5, size=(f, o)).astype(np.float32)
          for f, o in zip(fans, outs)]
    bs = [rng.normal(scale=0.1, size=o).astype(np.float32) for o in outs]
    tv, tw, tb = ([torch.from_numpy(x) for x in xs] for xs in (vs, ws, bs))
    out = tmlp.mlp_seg_plain(tv, tw, tb, layout, "ReLU")
    tw_pad = tw[:-1] + [tmlp._pad_columns(tw[-1], c)]
    tb_pad = tb[:-1] + [tmlp._pad_columns(tb[-1], c)]
    padded = tmlp.mlp_seg_plain(tv, tw_pad, tb_pad, layout, "ReLU")
    assert _rel(padded[:, :3], out.numpy()) <= 1e-6
    assert torch.count_nonzero(padded[:, 3:]) == 0
    jnp = jx.jnp
    with jx.dm.matmul_dtype(jnp.dtype("float32")):
        ref = jx.mlp.mlp_seg(tuple(map(jnp.asarray, vs)), tuple(map(jnp.asarray, ws)),
                             tuple(map(jnp.asarray, bs)), layout, "ReLU", "float32", True)
    assert _rel(out, np.asarray(ref)) <= 1e-5


def test_accuracy_script_counts_roundings_and_bias():
    """``tc_accuracy.py``'s measures: a bf16 value on the other side of its
    f64 reference is a flip (nearer zero or not), and a uniform shrink
    reads as a negative mean signed error."""
    sys.path.insert(0, str(REPO))
    import tc_accuracy

    z64 = torch.tensor([1.0, -2.0, 3.0, 0.5], dtype=torch.float64)
    z = z64.bfloat16().clone()
    z[0] = 1 - 2.0**-8  # the bf16 neighbour of 1.0 nearer zero
    z[2] = 3 + 2.0**-6  # the bf16 neighbour of 3.0 farther from zero
    out = tc_accuracy.flips(z, z64)
    assert out == {"flip_share": 0.5, "toward_zero_share": 0.5}
    err = tc_accuracy.signed_err(z64 * (1 - 1e-3), z64)
    assert err["max_rel"] == pytest.approx(1e-3) and err["mean_signed_rel"] == pytest.approx(-1e-3)


def test_accuracy_script_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, str(REPO / "tc_accuracy.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"step"' not in out.stdout


# ------------------------------------------------------------------ on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(
        ref.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
@pytest.mark.parametrize("k", FAN_INS)
def test_cuda_tc_product_matches_plain(layout, k):
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    for n in WIDTHS:
        a, b, call = _operands(layout, k, n, seed=k * n)
        ta = torch.from_numpy(a).to(dev, torch.bfloat16)
        tb = torch.from_numpy(b).to(dev, torch.bfloat16)
        prod = tdm.Products(torch.bfloat16, dev)
        before = (tdm.Products.tc_launches, tdm.Products.tf32x3_launches)
        got = getattr(prod, layout)(ta, tb)
        assert (tdm.Products.tc_launches, tdm.Products.tf32x3_launches) == (
            before[0] + 1, before[1])
        ref = _plain(ta, tb, call)
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _err(got, ref) <= 1e-4, (n, _err(got, ref))
        again = getattr(prod, layout)(ta, tb)
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_tc_product_refuses_a_fourth_layout_and_other_dtypes():
    dev = _cuda()
    a = torch.zeros((64, 64), dtype=torch.bfloat16, device=dev)
    prod = tdm.Products(torch.bfloat16, dev)
    with pytest.raises(ValueError):
        prod.gemm(64, 64, 64, a, 1, 64, a, 1, 64)
    with pytest.raises(TypeError):
        prod.nt(a.float(), a)


def _layers(rng, fans, outs, dtype, dev):
    ws = [torch.tensor(rng.normal(scale=1.5 * f ** -0.5, size=(f, o)), dtype=dtype, device=dev)
          for f, o in zip(fans, outs)]
    bs = [torch.tensor(rng.normal(scale=0.1, size=o), dtype=torch.float32, device=dev)
          for o in outs]
    return ws, bs


TILE_CASES = {
    # K=3, one segment, [seg0, h] after layer 4 (the NeDDF trunk)
    "k3_seg_first": dict(widths=(60,), has_j=(True,), n_tan=3,
                         layout=tuple(li == 5 for li in range(7))),
    # K=1, four segments (seg0 is 60 wide: the skip piece ends inside a
    # stage whose other columns hold segment 1), [seg0, h] after layer 1
    "k1_seg_first": dict(widths=(60, 24, 3, 256), has_j=(True, False, False, True),
                         n_tan=1, layout=(False, False, True)),
    # K=0, [h, seg0] (the NeRF trunk)
    "k0_hidden_first": dict(widths=(60,), layout=tuple(li == 5 for li in range(8)), out=256),
    # K=0, four segments and a 3-wide last layer (the NeuS colour trunk)
    "k0_narrow_last": dict(widths=(3, 24, 3, 256), layout=(False,) * 4, out=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_cuda_tc_tile_forward_matches_plain(name):
    dev = _cuda()
    cfg = TILE_CASES[name]
    rng = np.random.default_rng(7)
    m, dtype = 4096 + 77, torch.bfloat16
    widths, layout = cfg["widths"], cfg["layout"]
    vs = [torch.tensor(rng.normal(size=(m, w)), dtype=dtype, device=dev) for w in widths]
    before = dict(tdm.TILE_LAUNCHES)
    if "n_tan" in cfg:
        k, c0 = cfg["n_tan"], widths[0]
        js = [torch.tensor(rng.normal(size=(k, m, w)), dtype=dtype, device=dev)
              for w, h in zip(widths, cfg["has_j"]) if h]
        fans = [sum(widths)] + [c0 + 256 if s else 256 for s in layout[1:]]
        ws, bs = _layers(rng, fans, [256] * len(layout), dtype, dev)
        args = (layout, "tanhExp", cfg["has_j"], k)
        if k == 3:
            got = tdm.dual_mlp_trunk(vs[0], js[0], ws, bs, layout, "tanhExp", stash=True)
        else:
            got = tdm.dual_mlp_seg(vs, js, ws, bs, *args, stash=True)
        ref = tdm.dual_mlp_seg_plain(vs, js, ws, bs, *args, stash=True)
        pairs = [(got[0], ref[0]), (got[1], ref[1])] + list(zip(got[2], ref[2]))
    else:
        n = len(layout)
        fans = [sum(widths)] + [256 + widths[0] * s for s in layout[1:]]
        outs = [256] * (n - 1) + [cfg["out"]]
        ws, bs = _layers(rng, fans, outs, dtype, dev)
        got = tmlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True)
        ref = tmlp.mlp_seg_plain(vs, ws, bs, layout, "ReLU", stash=True)
        pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1]))
    assert tdm.TILE_LAUNCHES == {"tc": before["tc"] + 1, "tf32x3": before["tf32x3"]}
    for g, r in pairs:
        assert g.shape == r.shape and torch.isfinite(g.float()).all()
        assert _err(g, r) <= 2.0**-5, _err(g, r)
