"""The per-layer route's plain backward products (``csrc/route_products.cu``:
route_nt, dx = G W^T, and route_tn, dW = X^T G, launched by
``kernels/dual_mlp.py::Products.nt`` / ``.tn`` through ``route_plan``).

On the CPU:

* the plan: which kernel takes which shape (1024 x 1024 at the main
  path's rows, a tensor-parallel shard of 512, layer 0's 60- and 36-wide
  sides, NeRF's K = 3 dx, which stays on tc_gemm_kernel, the N = 3 dW,
  ragged rows), tn's split count (it fills the SMs; fixed ranges of whole
  k-blocks, in order), the copy of operands whose rows or address are not
  whole 16-byte vectors, and f32 nt's tf32 planes of W;
* ``ProductsPlain.nt`` / ``.tn`` (the plain versions the wrappers take
  for CPU tensors, and the card's references) against the JAX package's
  ``_mm_nt`` / ``_mm_tn`` (``neddf_tpu/kernels/dual_mlp.py:208-228``) on
  numpy inputs from a seed: f32 within 1e-6 of the largest magnitude (the
  two differ in the order of the f32 sums), bf16 operands within 2^-8
  (both multiply bf16 values exactly and sum in f32). JAX is imported in
  that test alone: the ``cuda`` tests below run where it is not
  installed.

On the card (marked ``cuda``): each kernel against ``ProductsPlain`` at N
in {3, 45, 257, 1024} and fan in {36, 60, 512, 1024}, ragged rows, bf16
and f32, within ``PRODUCT_REL_TOL`` = 1e-4 of the largest magnitude, and
bitwise equal over two runs; the launch counts show which kernel ran.
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
R_MAIN = 4 * 99_328  # the K=3 trunk's rows at 512 rays (4 streams x 194 points)
R_F32 = 265_216  # NeuS's rows (both passes of 1024 rays)
PRODUCT_REL_TOL = 1e-4


def _rel(got, ref):
    got = np.asarray(got.detach().float().cpu(), np.float64)
    ref = np.asarray(ref.detach().float().cpu(), np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ------------------------------------------------------------------ the plan
# (layout, m, n, k, lda, ldb, itemsize) -> (kernel, pad_a, pad_b)
CHOICES = {
    "nt 1024 bf16": (("nt", R_MAIN, 1024, 1024, 1024, 1024, 2), ("route", 0, 0)),
    "tn 1024 bf16": (("tn", 1024, 1024, R_MAIN, 1024, 1024, 2), ("route", 0, 0)),
    "nt 1024 f32": (("nt", R_F32, 1024, 1024, 1024, 1024, 4), ("route", 0, 0)),
    "tn 1024 f32": (("tn", 1024, 1024, R_F32, 1024, 1024, 4), ("route", 0, 0)),
    "nt shard 512": (("nt", R_MAIN, 1024, 512, 512, 512, 2), ("route", 0, 0)),
    "tn shard 512": (("tn", 1024, 512, R_MAIN, 1024, 512, 2), ("route", 0, 0)),
    "nt fan 60 bf16": (("nt", R_MAIN, 60, 1024, 1024, 1024, 2), ("route", 0, 0)),
    "tn fan 60 bf16": (("tn", 60, 1024, R_MAIN, 60, 1024, 2), ("route", 64, 0)),
    "tn fan 36 f32": (("tn", 36, 1024, R_F32, 36, 1024, 4), ("route", 0, 0)),
    "tn fan 36 bf16": (("tn", 36, 1024, R_MAIN, 36, 1024, 2), ("route", 40, 0)),
    "nt K=3": (("nt", 198_656, 256, 3, 3, 3, 2), ("tc",)),
    "nt K=7 f32": (("nt", 1000, 256, 7, 7, 7, 4), ("tc",)),
    "nt K=8": (("nt", 1000, 256, 8, 8, 8, 2), ("route", 0, 0)),
    "tn N=3 bf16": (("tn", 1024, 3, 198_656, 1024, 3, 2), ("route", 0, 8)),
    "tn N=3 f32": (("tn", 1024, 3, R_F32, 1024, 3, 4), ("route", 0, 4)),
    "nt N=45 bf16": (("nt", 20_011, 3, 45, 45, 45, 2), ("route", 48, 48)),
    "nt N=45 f32": (("nt", 20_011, 3, 45, 45, 45, 4), ("route", 48, 0)),
    "tn ragged": (("tn", 257, 45, 20_011, 257, 45, 2), ("route", 264, 48)),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_plan_picks_the_kernel_and_padding_by_shape(case):
    args, want = CHOICES[case]
    plan = tdm.route_plan(*args)
    assert plan["kernel"] == want[0]
    if want[0] == "route":
        assert (plan["pad_a"], plan["pad_b"]) == want[1:]
        layout, itemsize = args[0], args[-1]
        k = args[3]
        # f32 nt: W's tf32 hi and lo planes, rows of whole 16-byte vectors
        assert plan["ldw"] == (-(-k // 4) * 4 if layout == "nt" and itemsize == 4 else 0)


def test_plan_pads_an_operand_off_16_bytes():
    # rows of whole vectors but an address 8 bytes off: copied at the same width
    plan = tdm.route_plan("tn", 1024, 1024, 4096, 1024, 1024, 2, a_ptr=8, b_ptr=16)
    assert (plan["pad_a"], plan["pad_b"]) == (1024, 0)
    plan = tdm.route_plan("nt", 4096, 60, 1024, 1024, 1024, 2, a_ptr=16, b_ptr=2)
    assert (plan["pad_a"], plan["pad_b"]) == (0, 1024)
    # f32 nt: W goes through the split's pre-pass, which reads any rows
    plan = tdm.route_plan("nt", 4096, 60, 1022, 1022, 1023, 4, a_ptr=4, b_ptr=4)
    assert (plan["pad_a"], plan["pad_b"], plan["ldw"]) == (1024, 0, 1024)
    with pytest.raises(ValueError):
        tdm.route_plan("tn", 8, 8, 8, 8, 8, 4, a_ptr=2)
    with pytest.raises(ValueError):
        tdm.route_plan("nn", 8, 8, 8, 8, 8, 2)
    with pytest.raises(ValueError):
        tdm.route_plan("nt", 8, 8, 8, 8, 8, 8)


def test_padded_rows_copies_the_rows_at_a_16_byte_stride():
    # 9 columns of 12-column rows: neither the rows nor the start on 16 bytes
    base = torch.arange(36, dtype=torch.float32).view(3, 12)
    for dtype, width in ((torch.float32, 12), (torch.bfloat16, 16)):
        x = base[:, 1:10].to(dtype)
        out = tdm._padded_rows(x, width)
        assert out.shape == (3, width) and out.dtype == dtype and out.is_contiguous()
        assert (out.stride(0) * out.element_size()) % 16 == 0
        assert torch.equal(out[:, :9], x)


# (m, n, rows, itemsize) -> splits at 132 SMs
SPLITS = {
    "1024 bf16": ((1024, 1024, R_MAIN, 2), 2),  # 64 tiles: 128 units, one wave
    "1024 f32": ((1024, 1024, R_F32, 4), 2),
    "shard 512": ((1024, 512, R_MAIN, 2), 4),  # 32 tiles
    "fan 60": ((60, 1024, R_MAIN, 2), 16),  # 8 tiles
    "N=3": ((1024, 3, 198_656, 2), 16),
    "few rows": ((1024, 1024, 1000, 2), 1),  # under 16 k-blocks a split
    "ragged": ((257, 45, 20_011, 2), 19),  # 3 tiles: one k-block range each SM
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_tn_splits_fill_the_sms_in_fixed_ranges(case):
    (m, n, rows, itemsize), splits = SPLITS[case]
    plan = tdm.route_plan("tn", m, n, rows, m, n, itemsize)
    bk = 128 // itemsize
    assert plan["splits"] == splits
    chunk = plan["k_chunk"]
    # whole k-blocks of at least 16 (but the last), every row in exactly one
    # split, none empty, in order
    assert chunk % bk == 0 and (splits == 1 or chunk >= 16 * bk)
    assert (splits - 1) * chunk < rows <= splits * chunk
    # the busiest SM reduces within 5% of the least any split count gives
    tiles = -(-m // 128) * -(-n // 128)

    def span(s):
        return -(-tiles * s // 132) * -(-(-(-rows // bk)) // s)

    best = min(span(s) for s in range(1, 65) if s == 1 or -(-rows // bk) // s >= 16)
    assert span(splits) <= 1.05 * best
    # the plan is a function of the shape (and the card's SMs) alone
    assert tdm.route_plan("tn", m, n, rows, m, n, itemsize) == plan
    assert tdm.route_plan("nt", rows, n, m, m, m, itemsize)["splits"] == 1


def test_tn_splits_summed_in_order_equal_the_whole_sum():
    # the launcher's parts [splits, m, n], each its range's sum, added in
    # order (neddf_sum_splits) against one product over every row, in f64
    g = np.random.default_rng(3)
    rows, m, n = 20_011, 37, 45
    plan = tdm.route_plan("tn", m, n, rows, m, n, 4)
    x = torch.from_numpy(g.standard_normal((rows, m)))
    y = torch.from_numpy(g.standard_normal((rows, n)))
    c = plan["k_chunk"]
    parts = [x[i * c : (i + 1) * c].T @ y[i * c : (i + 1) * c] for i in range(plan["splits"])]
    total = torch.zeros((m, n), dtype=torch.float64)
    for p in parts:
        total = total + p
    assert plan["splits"] > 1
    assert torch.allclose(total, x.T @ y, rtol=0, atol=1e-9)


# --------------------------------------- the plain versions against JAX's
@pytest.fixture(scope="module")
def jax_products():
    import jax.numpy as jnp

    from neddf_tpu.kernels import dual_mlp as jdm

    return jnp, jdm


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["nt", "tn"])
def test_plain_products_match_jax(jax_products, layout, dtype):
    jnp, jdm = jax_products
    g = np.random.default_rng(11 + (layout == "tn") + 2 * (dtype == "bfloat16"))
    rows, width, fan = 1031, 96, 60
    a = g.standard_normal((rows, width if layout == "nt" else fan)).astype(np.float32)
    b = g.standard_normal((fan, width) if layout == "nt" else (rows, width)).astype(np.float32)
    cd = DTYPES[dtype]
    ta, tb = torch.from_numpy(a).to(cd), torch.from_numpy(b).to(cd)
    plain = tdm.ProductsPlain(cd)
    calls = tdm.route_product_plain.calls
    got = plain.nt(ta, tb) if layout == "nt" else plain.tn(ta, tb)
    assert tdm.route_product_plain.calls == calls + 1
    jt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    # the JAX products take the operands in the kernel's matmul dtype; feed
    # them the port's rounded values
    ja, jb = (jnp.asarray(t.float().numpy()).astype(jt) for t in (ta, tb))
    with jdm.matmul_dtype(jt):
        want = jdm._mm_nt(ja, jb) if layout == "nt" else jdm._mm_tn(ja, jb)
    want = np.array(want, np.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    tol = 1e-6 if dtype == "float32" else 2.0**-8
    assert _rel(got, torch.from_numpy(want)) <= tol


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _check(dev, dtype, layout, rows, width, fan, seed, offset=0):
    """One product of the route against its plain version: nt G [rows,
    width] W [fan, width]^T, tn X [rows, fan]^T G [rows, width]; offset > 0
    views the first operand at that many elements into its storage."""
    cd = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(seed)
    cols = width if layout == "nt" else fan
    a = torch.randn((rows * cols + offset,), device=dev, generator=g).to(cd)[offset:]
    a = a.view(rows, cols)
    b_shape = (fan, width) if layout == "nt" else (rows, width)
    b = (torch.randn(b_shape, device=dev, generator=g) * 0.1).to(cd)
    k = tdm.Products(cd, dev)
    plan = tdm.route_plan(layout, *((rows, fan, width) if layout == "nt" else (fan, width, rows)),
                          a.stride(0), b.stride(0), a.element_size(), a.data_ptr(),
                          b.data_ptr(), k.sms)
    before = dict(tdm.ROUTE_PRODUCT_LAUNCHES), tdm.Products.tc_launches + \
        tdm.Products.tf32x3_launches
    got = getattr(k, layout)(a, b)
    again = getattr(k, layout)(a, b)
    want = getattr(tdm.ProductsPlain(cd), layout)(a, b)
    torch.cuda.synchronize()
    route = plan["kernel"] == "route"
    assert tdm.ROUTE_PRODUCT_LAUNCHES[layout] == before[0][layout] + 2 * route
    assert (tdm.Products.tc_launches + tdm.Products.tf32x3_launches
            == before[1] + 2 * (not route))
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= PRODUCT_REL_TOL, f"{layout} {dtype}: {_rel(got, want)}"
    assert torch.equal(got, again)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fan", [36, 60, 512, 1024])
@pytest.mark.parametrize("width", [3, 45, 257, 1024])
def test_cuda_route_nt_matches_plain(width, fan, dtype):
    dev = _card()
    plan = _check(dev, dtype, "nt", 20_011, width, fan, seed=width + fan)
    assert plan["kernel"] == ("tc" if width < tdm.ROUTE_NT_MIN_K else "route")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fan", [36, 60, 512, 1024])
@pytest.mark.parametrize("width", [3, 45, 257, 1024])
def test_cuda_route_tn_matches_plain(width, fan, dtype):
    dev = _card()
    plan = _check(dev, dtype, "tn", 20_011, width, fan, seed=width * fan)
    assert plan["kernel"] == "route"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["nt", "tn"])
def test_cuda_route_products_at_the_main_rows(layout, dtype):
    # the splits of a long reduction (tn), many tiles per SM (nt), an
    # operand 8 bytes off 16 (padded by the launcher)
    dev = _card()
    rows = 4 * 99_328 + 7 if dtype == "bfloat16" else 65_536 + 5
    _check(dev, dtype, layout, rows, 512, 256, seed=5)
    _check(dev, dtype, layout, 4099, 256, 96, seed=6, offset=4 if dtype == "bfloat16" else 2)
