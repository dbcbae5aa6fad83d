"""The f32 routes on the tensor cores: the 3xTF32 split of the f32
products (``csrc/route_products.cu``, ``Products.nt``), of the f32
row-tile forward (``csrc/tile_hopper.cuh``, ``mlp_tile_fwd``) and of the
NeuS sweep (``csrc/sdf_sweep.cuh``).

On the CPU: the plain emulation beside the kernels' wrapper
(``kernels/dual_mlp.py``: ``tf32_round``, ``tf32_split``,
``products_tf32x3``) against the bit rule of ``cvt.rna.tf32.f32`` and
against f64; the emulated product at the NeuS backward's narrow shapes
in all three layouts against f64, against ``products_plain`` and against
the JAX package's own products (``neddf_tpu.kernels.dual_mlp._mm`` /
``_mm_tn`` / ``_mm_nt``); the emulated forward of whole trunks against
their plain versions.

On the card (marked ``cuda``: they skip without one): the f32 nt product
(``Products.nt``: shallow_nt at a depth of 3, route_nt past it) against
its plain version with ragged rows, narrow fan-ins and misaligned row
strides, bitwise equal over two runs; the f32 tile
forward for K = 0 (a 3-wide last layer, and [h, seg0]), K = 1 and K = 3,
and the NeuS trunk with its sweep, against the plain versions.

Tolerances: hi + lo reproduces an f32 value to 2^-22 of it (lo is x - hi
rounded to 10 bits), held at 2^-21. A product of two tf32 values is
exact in f32, so the emulated product differs from f64 only by the
dropped lo lo term and the f32 sums: 1e-5 of the largest magnitude;
from ``products_plain`` (one f32 matmul) by the same, within chip_smoke's
PRODUCT_REL_TOL of 1e-4. TF32 alone misses 1e-4 at these shapes (about
3e-4), which is why the routes take three products. Kernel against plain
version on the card: 1e-4, the f32 bar of every route of the port.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import mlp as tmlp
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import sdf_grad as tgrad
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

R = 2003  # rows of the reduced or output side: not a multiple of any tile
NEUS_K = (36, 39, 256, 295)  # NeuS's PE width, the issue's E, a trunk layer, post-skip
PRODUCT_REL_TOL = 1e-4  # chip_smoke.PRODUCT_REL_TOL
F32_TOL = 1e-4  # chip_smoke.REL_TOL["float32"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm

    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm)


def _rel(got, ref):
    got = torch.as_tensor(got).double()
    ref = torch.as_tensor(ref).double()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _values(kind: str, n: int = 4096, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    scale = {"unit": 1.0, "large": 1e30, "tiny": 1e-30, "negative": -3.0}[kind]
    x = rng.normal(size=n) * scale
    if kind == "negative":
        x = -np.abs(x)
    return torch.tensor(x, dtype=torch.float32)


def _operands(layout, k, n, rows=R, seed=0):
    """(a, b, call) of one product as the backwards pass it (see
    tests/test_torch_tc_kernels.py::_operands), f32."""
    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.normal(size=(rows, k)), dtype=torch.float32)
    if layout == "nt":
        b = torch.tensor(rng.normal(size=(n, k)), dtype=torch.float32)
        call = (rows, n, k, k, 1, 1, k)
    elif layout == "tn":
        b = torch.tensor(rng.normal(size=(rows, n)), dtype=torch.float32)
        call = (k, n, rows, 1, k, n, 1)
    else:
        b = torch.tensor(rng.normal(size=(k, n)), dtype=torch.float32)
        call = (rows, n, k, k, 1, n, 1)
    return a, b, call


def _f64(a, b, call):
    m, n, k, sam, sak, sbk, sbn = call
    av = torch.as_strided(a.double(), (m, k), (sam, sak))
    bv = torch.as_strided(b.double(), (k, n), (sbk, sbn))
    return av @ bv


# ------------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("kind", ["unit", "large", "tiny", "negative"])
def test_tf32_round_follows_the_rna_bit_rule(kind):
    x = _values(kind)
    hi = tdm.tf32_round(x)
    assert torch.all(_bits(hi) & 0x1FFF == 0)  # 10 mantissa bits left
    # nearest: within half a tf32 step (2^-11 of the leading power of two)
    step = torch.exp2(torch.floor(torch.log2(x.abs().double())) - 10)
    assert torch.all((hi.double() - x.double()).abs() <= step / 2)
    assert torch.all(torch.sign(hi) == torch.sign(x))
    # ties (the 13 dropped bits exactly 0x1000) go away from zero
    ties = (_bits(x) & ~0x1FFF) | 0x1000
    tied = torch.where(ties >= 2**31, ties - 2**32, ties).to(torch.int32).view(torch.float32)
    assert torch.all(tdm.tf32_round(tied).abs() > tied.abs())


@pytest.mark.parametrize("kind", ["unit", "large", "tiny", "negative"])
def test_split_reproduces_f32_values(kind):
    x = _values(kind, seed=1)
    hi, lo = tdm.tf32_split(x)
    assert torch.all(_bits(hi) & 0x1FFF == 0) and torch.all(_bits(lo) & 0x1FFF == 0)
    err = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert err.max().item() <= 2.0**-21
    # lo carries the next bits: hi alone is off by up to 2^-11
    assert ((hi.double() - x.double()).abs() / x.double().abs()).max().item() > 2.0**-14


@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
@pytest.mark.parametrize("k", NEUS_K)
def test_tf32x3_product_at_neus_shapes(layout, k):
    for n in (3, 36, 256):
        a, b, call = _operands(layout, k, n, seed=k + n)
        got = tdm.products_tf32x3(*call[:3], a, *call[3:5], b, *call[5:])
        ref = _f64(a, b, call)
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert _rel(got, ref) <= 1e-5, (n, _rel(got, ref))
        plain = tdm.products_plain(*call[:3], a, *call[3:5], b, *call[5:])
        assert _rel(got, plain) <= PRODUCT_REL_TOL


@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
def test_tf32_alone_misses_the_f32_bar(layout):
    """One TF32 product (hi hi) is off by ~3e-4 at the NeuS trunk's shape:
    the reason for the three-product split."""
    a, b, call = _operands(layout, 256, 256, seed=5)
    m, n, k, sam, sak, sbk, sbn = call
    ah = tdm.tf32_round(torch.as_strided(a, (m, k), (sam, sak)))
    bh = tdm.tf32_round(torch.as_strided(b, (k, n), (sbk, sbn)))
    ref = _f64(a, b, call)
    assert _rel(ah @ bh, ref) > PRODUCT_REL_TOL
    assert _rel(tdm.products_tf32x3(m, n, k, a, sam, sak, b, sbk, sbn), ref) <= 1e-5


@pytest.mark.parametrize("layout", ["nt", "tn", "nn"])
def test_tf32x3_product_matches_the_jax_products(jx, layout):
    for k in (36, 295):
        a, b, call = _operands(layout, k, 256, rows=512, seed=k)
        got = tdm.products_tf32x3(*call[:3], a, *call[3:5], b, *call[5:])
        fn = {"nt": jx.dm._mm_nt, "tn": jx.dm._mm_tn, "nn": jx.dm._mm}[layout]
        with jx.dm.matmul_dtype(jx.jnp.dtype("float32")):
            ref = np.array(fn(jx.jnp.asarray(a.numpy()), jx.jnp.asarray(b.numpy())))
        assert _rel(got, torch.from_numpy(ref)) <= 1e-5


def _emulated_mlp(vs, ws, bs, layout, act):
    """mlp_seg_plain's f32 arithmetic with every product taken as the
    kernel takes it (3xTF32)."""
    f = ACTIVATION_TRIPLES[act][0]
    h, seg0 = torch.cat(vs, dim=-1), vs[0]
    for li, (w, b) in enumerate(zip(ws, bs)):
        if li > 0 and layout[li]:
            h = torch.cat([h, seg0], dim=-1)
        m, k = h.shape
        h = f(tdm.products_tf32x3(m, w.shape[1], k, h.contiguous(), k, 1, w, w.shape[1], 1) + b)
    return h


@pytest.mark.parametrize("name", ["neus_color", "nerf", "sdf_trunk"])
def test_emulated_trunk_forward_within_the_f32_bar(name):
    """A whole 8-layer trunk through the split products stays within the
    kernels' f32 bar of its plain version (at width 64)."""
    rng = np.random.default_rng(11)
    c, m = 64, 1024
    widths, act = {"neus_color": ((3, 24, 3, c), "ReLU"), "nerf": ((60,), "ReLU"),
                   "sdf_trunk": ((36,), "tanhExp")}[name]
    layout = (False,) * 9 if name == "neus_color" else tuple(li == 5 for li in range(8))
    outs = [c] * (len(layout) - 1) + [3 if name == "neus_color" else c]
    fans = [sum(widths)] + [c + widths[0] * s for s in layout[1:]]
    vs = [torch.tensor(rng.uniform(-1, 1, size=(m, w)), dtype=torch.float32) for w in widths]
    ws = [torch.tensor(rng.uniform(-1, 1, size=(f, o)) * 1.5 / f ** 0.5, dtype=torch.float32)
          for f, o in zip(fans, outs)]
    bs = [torch.tensor(rng.uniform(-0.1, 0.1, size=o), dtype=torch.float32) for o in outs]
    ref = tmlp.mlp_seg_plain(vs, ws, bs, layout, act)
    assert _rel(_emulated_mlp(vs, ws, bs, layout, act), ref) <= F32_TOL


# ------------------------------------------------------------------ on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", (3, 36, 256, 295))
def test_cuda_tf32x3_product_matches_plain(k):
    dev = _cuda()
    prod = tdm.Products(torch.float32, dev)
    for n in (3, 36, 256):
        a, b, call = _operands("nt", k, n, rows=7003, seed=k * n)
        ta, tb = a.to(dev), b.to(dev)
        shallow = k < tdm.ROUTE_NT_MIN_K
        before = dict(tdm.SHALLOW_LAUNCHES), dict(tdm.ROUTE_PRODUCT_LAUNCHES)
        got = prod.nt(ta, tb)  # shallow_nt at k = 3, route_nt past it
        assert tdm.SHALLOW_LAUNCHES["tf32x3"] == before[0]["tf32x3"] + shallow
        assert tdm.ROUTE_PRODUCT_LAUNCHES["nt"] == before[1]["nt"] + (not shallow)
        ref = tdm.products_plain(*call[:3], ta, *call[3:5], tb, *call[5:])
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel(got.cpu(), ref.cpu()) <= PRODUCT_REL_TOL
        assert torch.equal(got, prod.nt(ta, tb))


@pytest.mark.cuda
def test_cuda_tf32x3_product_with_misaligned_rows():
    """Operands as views into wider buffers: odd row strides, 299 and 301,
    and pointers 4 and 8 bytes off a 16-byte boundary (copied by the
    launcher to 16-byte rows), ragged on every side."""
    dev = _cuda()
    prod = tdm.Products(torch.float32, dev)
    rng = np.random.default_rng(3)
    m, n, k = 1001, 37, 295
    buf_a = torch.tensor(rng.normal(size=(m + 1) * 300), dtype=torch.float32, device=dev)
    buf_b = torch.tensor(rng.normal(size=(n + 1) * 301), dtype=torch.float32, device=dev)
    a = torch.as_strided(buf_a, (m, k), (299, 1), 1)
    b = torch.as_strided(buf_b, (n, k), (301, 1), 2)
    got = prod.nt(a, b)
    ref = tdm.products_plain(m, n, k, a, 299, 1, b, 1, 301)
    assert _rel(got.cpu(), ref.cpu()) <= PRODUCT_REL_TOL
    assert torch.equal(got, prod.nt(a, b))


def _layers(rng, fans, outs, dev):
    ws = [torch.tensor(rng.normal(scale=1.5 * f ** -0.5, size=(f, o)), dtype=torch.float32,
                       device=dev) for f, o in zip(fans, outs)]
    bs = [torch.tensor(rng.normal(scale=0.1, size=o), dtype=torch.float32, device=dev)
          for o in outs]
    return ws, bs


TILE_CASES = {
    "k3_seg_first": dict(widths=(60,), has_j=(True,), n_tan=3,
                         layout=tuple(li == 5 for li in range(7))),
    # the colour trunk's K=1 configuration (no post-skip layer: with one,
    # a 343-wide x0 beside h would not fit a block's shared memory in f32)
    "k1_four_segments": dict(widths=(60, 24, 3, 256), has_j=(True, False, False, True),
                             n_tan=1, layout=(False, False, False)),
    "k0_hidden_first": dict(widths=(60,), layout=tuple(li == 5 for li in range(8)), out=256),
    "k0_narrow_last": dict(widths=(3, 24, 3, 256), layout=(False,) * 9, out=3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_cuda_tf32x3_tile_forward_matches_plain(name):
    dev = _cuda()
    cfg = TILE_CASES[name]
    rng = np.random.default_rng(7)
    m, widths, layout = 4096 + 77, cfg["widths"], cfg["layout"]
    vs = [torch.tensor(rng.normal(size=(m, w)), dtype=torch.float32, device=dev)
          for w in widths]
    before = dict(tdm.TILE_LAUNCHES)
    if "n_tan" in cfg:
        k, c0 = cfg["n_tan"], widths[0]
        js = [torch.tensor(rng.normal(size=(k, m, w)), dtype=torch.float32, device=dev)
              for w, h in zip(widths, cfg["has_j"]) if h]
        fans = [sum(widths)] + [c0 + 256 if s else 256 for s in layout[1:]]
        ws, bs = _layers(rng, fans, [256] * len(layout), dev)
        args = (layout, "tanhExp", cfg["has_j"], k)
        if k == 3:
            got = tdm.dual_mlp_trunk(vs[0], js[0], ws, bs, layout, "tanhExp", stash=True)
        else:
            got = tdm.dual_mlp_seg(vs, js, ws, bs, *args, stash=True)
        ref = tdm.dual_mlp_seg_plain(vs, js, ws, bs, *args, stash=True)
        pairs = [(got[0], ref[0]), (got[1], ref[1])] + list(zip(got[2], ref[2]))
    else:
        fans = [sum(widths)] + [256 + widths[0] * s for s in layout[1:]]
        outs = [256] * (len(layout) - 1) + [cfg["out"]]
        ws, bs = _layers(rng, fans, outs, dev)
        got = tmlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True)
        ref = tmlp.mlp_seg_plain(vs, ws, bs, layout, "ReLU", stash=True)
        pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1]))
    assert tdm.TILE_LAUNCHES == {"tc": before["tc"], "tf32x3": before["tf32x3"] + 1}
    for g, r in pairs:
        assert g.shape == r.shape and torch.isfinite(g).all()
        assert _rel(g.cpu(), r.cpu()) <= F32_TOL
    if "n_tan" not in cfg:  # two runs of the forward agree bit for bit
        assert torch.equal(got[0], tmlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["ReLU", "tanhExp"])
def test_cuda_tf32x3_sdf_trunk_and_sweep_match_plain(act):
    """The NeuS trunk (E = 36, [h, e] after layer 4) and its channel-0
    sweep at a ragged M, forward and backward."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    m, e_dim = 5 * 128 + 19, 36
    layout = tuple(li == 5 for li in range(8))
    e = torch.tensor(rng.uniform(-1, 1, size=(m, e_dim)), dtype=torch.float32, device=dev)
    fans = [e_dim] + [256 + e_dim * s for s in layout[1:]]
    ws, bs = _layers(rng, fans, [256] * 8, dev)
    before = dict(tdm.TILE_LAUNCHES)
    got = tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
    assert tdm.TILE_LAUNCHES["tf32x3"] == before["tf32x3"] + 1
    ref = tgrad.sdf_trunk_with_grad(e, ws, bs, layout, act, stash=True)
    ge_ref = tgrad.channel0_sweep(ws, layout, act, got[2], e_dim)
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ge_ref, *ref[2]]):
        assert _rel(g.cpu(), r.cpu()) <= F32_TOL
    again = tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
    assert all(torch.equal(a, b) for a, b in zip([got[0], got[1], *got[2]],
                                                 [again[0], again[1], *again[2]]))
    ch = torch.tensor(rng.normal(size=(m, 256)), dtype=torch.float32, device=dev)
    cg = torch.tensor(rng.normal(size=(m, e_dim)), dtype=torch.float32, device=dev)
    args = (e, ws, layout, act, ref[2], ch, cg)
    kern = tsdf.sdf_mlp_bwd(*args)
    plain = tgrad.sdf_trunk_with_grad_vjp(*args)
    for g, r in zip([kern[0], *kern[1], *kern[2]], [plain[0], *plain[1], *plain[2]]):
        assert _rel(g.cpu(), r.cpu()) <= F32_TOL
    again = tsdf.sdf_mlp_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(kern[1] + kern[2], again[1] + again[2]))
