"""The NeuS reverse sweep on wgmma + TMA (``csrc/sdf_sweep.cuh``, planned
by ``kernels/sdf_mlp.py::sweep_plan``) and the shallow nt product
(``csrc/route_products.cu``'s shallow_nt, planned by
``kernels/dual_mlp.py::route_plan``).

On the CPU:

* ``sweep_plan`` at every width class x E in {3, 36, 78, 120, 150} x the
  post-skip layouts: it fits the shared memory (its size does not depend
  on E), reads W's f32 rows from L2 at most half as many bytes as one
  64-row tile per pass over two tf32 planes would, and its numbers at the
  NeuS step (width 256, E = 36, 265,216 rows) are the ones the source's
  note gives; what it refuses it refuses with ValueError.
* The shallow plan (an nt of depth 1, 3 and 7) and its plain version
  (``ProductsPlain.nt``) against the JAX package's ``_mm_nt``
  (``neddf_tpu/kernels/dual_mlp.py:208-228``), f32 and bf16 operands: f32
  within 1e-6 of the largest magnitude (the order of the f32 sums), bf16
  operands within 1e-6 too (both multiply bf16 values exactly in f32).

On the card (marked ``cuda``, skipped here): the sweep against its plain
version (``ops/sdf_grad.py::channel0_sweep`` over the kernel's own stash)
at widths 1 to 512, E in {3, 36, 78, 120, 150}, the five activations and
rows {1, 63, 64, 65, 265,216}, within 1e-4 of the largest magnitude (the
f32 bar of every route of the port), and bitwise equal over two runs; the
shallow nt against its plain version at depths 1-7, bf16 and f32, widths
3 to 2000 (two chunks of W's columns), the same rows: f32 within 1e-6
relative (K fused multiply-adds against one matmul's sums), bf16
operands the same.
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import sdf_grad as tgrad
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

CLASSES = (64, 128, 256, 512)
E_DIMS = (3, 36, 78, 120, 150)
LAYOUTS = {  # post-skip layers [h, e]
    "none": (False,) * 8,
    "neus": tuple(li == 5 for li in range(8)),
    "two": tuple(li in (3, 6) for li in range(8)),
    "deep": tuple(li in (5, 9) for li in range(12)),
}
M_NEUS = 1024 * (65 + 194)  # a NeuS step's rows, both passes
SMEM = 232_448


def _split(layout):
    return [tdm.SPLIT_HIDDEN_FIRST if s else 0 for s in layout]


def _rel(got, ref):
    got = np.asarray(got.detach().float().cpu(), np.float64)
    ref = np.asarray(ref.detach().float().cpu(), np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("e_dim", E_DIMS)
@pytest.mark.parametrize("cls", CLASSES)
def test_sweep_plan_fits_every_class_and_e(cls, e_dim):
    smem = set()
    for width in (cls // 2 + 1, cls):
        for layout in LAYOUTS.values():
            plan = tsdf.sweep_plan(width, e_dim, _split(layout), M_NEUS)
            assert plan["class"] == cls and plan["smem"] <= SMEM
            assert plan["stages"] >= 2 and plan["consumers"] in (1, 2)
            # W's rows read once per 64-row tile at most, as one f32 plane
            assert plan["w_l2_bytes"] * 2 <= plan["w_l2_bytes_two_planes"]
            if width == cls:  # two regions of p fit but at 512 (a narrower 512 may fit them)
                assert plan["park"] == (cls == 512)
            assert plan["ints"] == (64, plan["consumers"], plan["stages"], plan["smem"],
                                    int(plan["park"]), plan["grid"], plan["scratch_bytes"],
                                    plan["ne"])
            assert plan["ne"] == (64 if cls > 64 and e_dim <= 64 else plan["nc"])
            if width == cls:
                smem.add(plan["smem"])
    # the shared memory holds no E-wide buffer: one size at the class's full width
    assert len(smem) == 1


def test_sweep_plan_at_the_neus_step():
    plan = tsdf.sweep_plan(256, 36, _split(LAYOUTS["neus"]), M_NEUS)
    assert (plan["consumers"], plan["stages"], plan["park"], plan["nc"], plan["ne"]) == (
        1, 3, False, 128, 64)
    assert plan["smem"] == 2 * 64 * 1024 + 3 * 32 * 1024 + (3 * 3 + 16) * 8
    tiles = M_NEUS // 64
    # 7 x 256 hidden rows and 2 x 36 e rows of W, 256 columns, f32
    assert plan["w_l2_bytes"] == (7 * 256 + 2 * 36) * 256 * 4
    assert plan["w_l2_bytes_two_planes"] * tiles == pytest.approx(15.82e9, rel=1e-3)
    assert plan["grid"] == 132 and plan["scratch_bytes"] == 0 and plan["ld"] == 256
    # the classes 64 and 128 serve 128 rows a pass; 512 parks its output
    assert tsdf.sweep_plan(128, 36, _split(LAYOUTS["neus"]), M_NEUS)["consumers"] == 2
    big = tsdf.sweep_plan(512, 36, _split(LAYOUTS["neus"]), M_NEUS)
    assert big["park"] and big["scratch_bytes"] == big["grid"] * 64 * 512 * 4
    # a width off 16-byte rows reads copies of W and the stash 48 wide
    assert tsdf.sweep_plan(45, 36, _split(LAYOUTS["neus"]))["ld"] == 48
    # a small call launches no more blocks than it has tile groups
    assert tsdf.sweep_plan(256, 36, _split(LAYOUTS["neus"]), 65)["grid"] == 2
    assert tsdf.sweep_plan(128, 36, _split(LAYOUTS["neus"]), 65)["grid"] == 1


@pytest.mark.parametrize("args", [(513, 36, [0, 0]), (0, 36, [0, 0]), (256, 0, [0, 0]),
                                  (256, 36, [2, 0]), (256, 36, [0]), (256, 36, [0, 1]),
                                  (256, 36, [0] * 13)])
def test_sweep_plan_refuses(args):
    with pytest.raises(ValueError):
        tsdf.sweep_plan(*args)


# ---------------------------------------------------------- the shallow nt
@pytest.fixture(scope="module")
def jax_mm_nt():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm

    def mm_nt(a, b, dtype):
        with jdm.matmul_dtype(jnp.dtype(dtype)):
            return np.asarray(jdm._mm_nt(jnp.asarray(a), jnp.asarray(b)), np.float32)

    return mm_nt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_shallow_plan_and_plain_match_jax(jax_mm_nt, k, dtype):
    rng = np.random.default_rng(k)
    m = 1003
    for n in (3, 256, 2000):
        plan = tdm.route_plan("nt", m, n, k, k, k, 4 if dtype == "float32" else 2)
        assert plan["kernel"] == "shallow"
        assert plan["cols"] % 4 == 0 and k * plan["cols"] * 4 <= tdm.SHALLOW_SMEM
        assert plan["chunks"] == -(-n // plan["cols"]) and plan["cols"] <= -(-n // 4) * 4
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(n, k)).astype(np.float32)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        if dtype == "bfloat16":
            ta, tb = ta.bfloat16(), tb.bfloat16()
            a, b = ta.float().numpy(), tb.float().numpy()
        got = tdm.ProductsPlain(getattr(torch, dtype)).nt(ta, tb)
        ref = jax_mm_nt(a, b, dtype)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert _rel(got, torch.from_numpy(ref.copy())) <= 1e-6, n
    # W past the shared memory's f32 columns takes chunks of them
    wide = tdm.route_plan("nt", m, 4000, 7, 7, 7, 2)
    assert wide["chunks"] == 3 and wide["cols"] == tdm.SHALLOW_SMEM // 4 // 7 // 4 * 4


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


ACTS = ("tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid")
SWEEP_WIDTHS = (1, 45, 64, 100, 128, 200, 256, 300, 512)
ROWS = (1, 63, 64, 65, 20_011)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("width", SWEEP_WIDTHS)
def test_cuda_sweep_matches_plain(width, act):
    """The sweep launched alone (``sweep_launch``) over the stash of the
    plain trunk, at every E (its plan takes any: where the fused trunk's
    plan refuses E, at width 512 from E = 129 after a post-skip layer,
    only ``sdf_mlp`` refuses), against the plain sweep over that stash;
    and ``sdf_mlp`` (trunk and sweep) wherever it takes the configuration,
    its gE against the plain sweep over its own stash."""
    dev = _card()
    i = SWEEP_WIDTHS.index(width) + ACTS.index(act)
    e_dim, m = E_DIMS[i % len(E_DIMS)], ROWS[i % len(ROWS)]
    layout = LAYOUTS["neus" if i % 2 else "two"]
    g = torch.Generator(device=dev).manual_seed(i)
    fans = [e_dim] + [width + e_dim * s for s in layout[1:]]
    ws = [torch.randn(f, width, device=dev, generator=g) * 1.5 / f ** 0.5 for f in fans]
    bs = [torch.randn(width, device=dev, generator=g) * 0.1 for _ in fans]
    e = torch.rand(m, e_dim, device=dev, generator=g) * 2 - 1
    pres = tgrad.sdf_trunk_with_grad(e, ws, bs, layout, act, stash=True)[2]
    ge = torch.empty((m, e_dim), device=dev)
    before = tsdf.SWEEP_LAUNCHES["sweep"]
    tsdf.sweep_launch(tdm._ACT_CODES[act], e_dim, ws, _split(layout), pres, ge,
                      torch.cuda.current_stream(dev).cuda_stream)
    assert tsdf.SWEEP_LAUNCHES["sweep"] == before + 1
    ref = tgrad.channel0_sweep(ws, layout, act, pres, e_dim)
    assert torch.isfinite(ge).all() and _rel(ge, ref) <= 1e-4, _rel(ge, ref)
    if tsdf.kernel_refusal(act, width, len(ws), e_dim, layout) is not None:
        with pytest.raises(NotImplementedError, match="shared memory"):
            tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
        return
    h, ge, pres = tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
    ref = tgrad.channel0_sweep(ws, layout, act, pres, e_dim)
    assert ge.shape == (m, e_dim) and torch.isfinite(ge).all()
    assert _rel(ge, ref) <= 1e-4, _rel(ge, ref)
    assert torch.equal(ge, tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS)
def test_cuda_sweep_at_the_neus_rows(act):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    layout = LAYOUTS["neus"]
    fans = [36] + [256 + 36 * s for s in layout[1:]]
    ws = [torch.randn(f, 256, device=dev, generator=g) * 1.5 / f ** 0.5 for f in fans]
    bs = [torch.randn(256, device=dev, generator=g) * 0.1 for _ in fans]
    e = torch.rand(M_NEUS, 36, device=dev, generator=g) * 2 - 1
    _, ge, pres = tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
    ref = tgrad.channel0_sweep(ws, layout, act, pres, 36)
    assert torch.isfinite(ge).all() and _rel(ge, ref) <= 1e-4, _rel(ge, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", range(1, 8))
def test_cuda_shallow_nt_matches_plain(k, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(k)
    prod = tdm.Products(dtype, dev)
    key = "tc" if dtype == torch.bfloat16 else "tf32x3"
    for i, n in enumerate((3, 45, 256, 1024, 2000)):
        m = (*ROWS, M_NEUS)[(k + i) % 6]
        a = torch.randn(m, k, device=dev, generator=g).to(dtype)
        b = torch.randn(n, k, device=dev, generator=g).to(dtype)
        before = tdm.SHALLOW_LAUNCHES[key]
        got = prod.nt(a, b)
        assert tdm.SHALLOW_LAUNCHES[key] == before + 1
        ref = tdm.ProductsPlain(dtype).nt(a, b)
        assert got.shape == (m, n) and torch.isfinite(got).all()
        assert _rel(got, ref) <= 1e-6, (n, m, _rel(got, ref))
        assert torch.equal(got, prod.nt(a, b))
