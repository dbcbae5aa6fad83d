"""The per-layer route's layer forward (``csrc/layer_fwd.cu``, launched by
``kernels/dual_mlp.py::Products.layer_fwd``): a bytes-bound kernel for
outputs up to 32 wide and a wgmma + TMA product for the rest.

On the CPU (this file imports no JAX; the layer's plain version is
``ProductsPlain.layer_fwd``, held to the Pallas forwards by
``test_torch_tp_kernels.py`` and ``test_torch_fused_bwd.py``):

* the launch plan (``layer_fwd_plan``): the kernel by N and by the
  narrow kernel's shared memory, the padding of segments whose rows are
  not whole 16-byte vectors, W^T's padded K and planes (which the
  launcher checks against its own k-blocks), and the refusals; the TMA
  maps (the stream grouping: dims (k, S, M), box (BK, S, 128 / S)) are
  the launcher's alone and are held on the card, by the wide kernel's
  agreement with the plain version at S = 1, 2, 4 and ragged M and N;
* the wide kernel's f32 arithmetic emulated in torch: W^T laid out as the
  pre-pass writes it (each segment's k-blocks, zero rows between), split
  into tf32 hi and lo, x split likewise, each k-block's three products
  summed from zero and added to the running sum in f32, against an f64
  product: within 1e-6 of the largest magnitude (the f32 bar on the card
  is 1e-4).

On the card (marked ``cuda``): both kernels against
``ProductsPlain.layer_fwd`` at N in {3, 45, 128, 257, 1000, 1024}, S in
{1, 2, 4}, one and two K segments (a 60- and an 87-wide bf16 segment
that the launcher pads, f32's 36-wide one that TMA takes as it is),
bf16 and f32, and all five activations; the counts show which kernel ran.
Tolerances: f32 1e-4, bf16 2^-5 of the largest magnitude (one bf16
rounding step of an output). Under ReLU and LeakyReLU a pre-activation
within a rounding of 0 may take the other side of the kink in the kernel
than in the plain sums, so their tangent outputs are held only where the
plain z_v is not within 1e-3 of 0.
"""
import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdm
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ACTS = ["tanhExp", "ReLU", "LeakyReLU", "Softplus", "Sigmoid"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, ref):
    got = np.asarray(got.detach().float().cpu(), np.float32)
    ref = np.asarray(ref.detach().float().cpu(), np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


# ------------------------------------------------------------ the launch plan
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_picks_the_narrow_kernel_up_to_32_columns_that_fit(itemsize):
    for n, nb in ((1, 4), (3, 4), (4, 4), (5, 32), (16, 32), (17, 32), (32, 32)):
        plan = tdm.layer_fwd_plan(1, 265216, n, [1024], itemsize)
        if nb * 1024 * itemsize > 64 * 1024:  # f32 past 4 columns at K = 1024
            assert plan["kernel"] == "wide"
            continue
        assert plan["kernel"] == "narrow" and plan["nb"] == nb
        assert plan["smem"] == nb * 1024 * itemsize
    for n in (33, 45, 128, 1024):
        assert tdm.layer_fwd_plan(4, 99328, n, [1024], itemsize)["kernel"] == "wide"
    # two segments: each padded to 8 elements in shared memory
    plan = tdm.layer_fwd_plan(2, 100, 3, [87, 1024], itemsize)
    assert plan == {"kernel": "narrow", "nb": 4, "smem": 4 * (88 + 1024) * itemsize}
    # W's columns past 64 KB of shared memory: the wide kernel
    k_max = 64 * 1024 // (32 * itemsize)
    assert tdm.layer_fwd_plan(1, 10, 32, [k_max], itemsize)["kernel"] == "narrow"
    assert tdm.layer_fwd_plan(1, 10, 32, [k_max + 8], itemsize)["kernel"] == "wide"


def test_plan_gives_wt_the_k_blocks_of_each_segment():
    # bf16: 64-deep k-blocks, one plane of W^T
    plan = tdm.layer_fwd_plan(4, 99328, 1024, [1024], 2)
    assert plan == {"kernel": "wide", "widths": [1024], "pad": [False], "kp": 1024, "planes": 1}
    # f32: 32-deep k-blocks, two planes (tf32 hi, lo); the 36-wide segment
    # takes a k-block of its own
    plan = tdm.layer_fwd_plan(1, 265216, 1024, [1024, 36], 4)
    assert plan["pad"] == [False, False] and plan["widths"] == [1024, 36]
    assert plan["kp"] == 34 * 32 and plan["planes"] == 2
    # S = 2, ragged points and columns: the plan does not depend on them
    assert tdm.layer_fwd_plan(2, 2999, 257, [1024], 2) == {
        "kernel": "wide", "widths": [1024], "pad": [False], "kp": 1024, "planes": 1}


def test_plan_pads_the_segments_that_tma_cannot_take():
    # bf16: a 60- or 87-wide segment's rows are not whole 16-byte vectors
    plan = tdm.layer_fwd_plan(4, 5000, 1024, [60, 1024], 2)
    assert plan["widths"] == [64, 1024] and plan["pad"] == [True, False]
    assert plan["kp"] == 17 * 64
    plan = tdm.layer_fwd_plan(1, 5000, 1024, [1024, 60], 2)  # hidden first
    assert plan["widths"] == [1024, 64] and plan["pad"] == [False, True]
    plan = tdm.layer_fwd_plan(2, 5000, 1024, [87, 1024], 2)
    assert plan["widths"] == [88, 1024] and plan["kp"] == (2 + 16) * 64
    # f32: 87 -> 88; a segment at an address off 16 bytes is copied as well
    plan = tdm.layer_fwd_plan(2, 5000, 1024, [87, 1024], 4, [64, 4096, 0, 0])
    assert plan["widths"] == [88, 1024] and plan["pad"] == [True, False]
    plan = tdm.layer_fwd_plan(1, 5000, 1024, [1024], 4, [8, 0, 0])
    assert plan["pad"] == [True] and plan["widths"] == [1024]


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(NotImplementedError):
        tdm.layer_fwd_plan(3, 100, 64, [64], 2)
    with pytest.raises(ValueError):
        tdm.layer_fwd_plan(1, 100, 64, [64], 2, [1, 0, 0])  # off the element size
    with pytest.raises(ValueError):
        tdm.layer_fwd_plan(1, 100, 64, [64], 8)
    with pytest.raises(ValueError):
        tdm.layer_fwd_plan(1, 100, 64, [64, 32, 32], 2)
    with pytest.raises(ValueError):
        tdm.layer_fwd_plan(1, 100, 0, [64], 2)


# -------------------------------------------- the wide kernel's f32 arithmetic
def _wt_planes(w, ks, bk):
    """W [K, N] as the pre-pass writes W^T [N, Kp]: each segment's rows
    at its own k-blocks, zero rows past a segment's end."""
    blocks = [-(-k // bk) for k in ks]
    wt = torch.zeros((w.shape[1], sum(blocks) * bk), dtype=w.dtype)
    src = dst = 0
    for k, nb in zip(ks, blocks):
        wt[:, dst : dst + k] = w[src : src + k].T
        src, dst = src + k, dst + nb * bk
    return wt


def _x_blocks(xs, ks, bk):
    """The segments [R, k_i] laid along the same padded K."""
    return torch.cat([torch.nn.functional.pad(x, (0, -(-k // bk) * bk - k))
                      for x, k in zip(xs, ks)], dim=1)


@pytest.mark.parametrize("ks", [(1024,), (1024, 36), (87, 1024)])
def test_tf32x3_split_of_wt_matches_an_f64_product(ks):
    bk = 32
    rng = np.random.default_rng(len(ks) * 7 + ks[0])
    rows, n = 96, 136
    xs = [torch.from_numpy(rng.normal(size=(rows, k)).astype(np.float32)) for k in ks]
    w = torch.from_numpy((rng.normal(size=(sum(ks), n)) * sum(ks) ** -0.5).astype(np.float32))
    hi, lo = tdm.tf32_split(_wt_planes(w, ks, bk))
    assert torch.equal(tdm.tf32_round(hi), hi) and torch.equal(tdm.tf32_round(lo), lo)
    x = _x_blocks(xs, ks, bk)
    xh, xl = tdm.tf32_split(x)
    total = torch.zeros((rows, n))
    for k0 in range(0, x.shape[1], bk):
        sl = slice(k0, k0 + bk)
        part = xl[:, sl] @ hi[:, sl].T + xh[:, sl] @ lo[:, sl].T + xh[:, sl] @ hi[:, sl].T
        total = total + part
    want = torch.cat(xs, dim=1).double() @ w.double()
    err = (total.double() - want).abs().max() / want.abs().max()
    assert err <= 1e-6
    # the split alone (hi only) is a TF32 product: far off the f32 bar
    coarse = (xh @ hi.T).double()
    assert (coarse - want).abs().max() / want.abs().max() > 1e-5


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


CARD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
# K segments per operand type: one 1024-wide; two with a narrow one that
# the wide kernel's launcher pads in bf16 (60 before, 87 before) or that
# TMA takes as it is in f32 (36 after, hidden first)
SEGMENTS = {"one": {"float32": (1024,), "bfloat16": (1024,)},
            "two": {"float32": (1024, 36), "bfloat16": (60, 1024)}}
WIDTHS = [3, 45, 128, 257, 1000, 1024]


def _check_layer(dev, dtype, s, m, ks, n, act, seed):
    cd = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn((s, m, k), device=dev, generator=g).to(cd) for k in ks]
    w = (torch.randn((sum(ks), n), device=dev, generator=g) * sum(ks) ** -0.5).to(cd)
    b = torch.randn(n, device=dev, generator=g) * 0.5
    before = dict(tdm.LAYER_FWD_LAUNCHES)
    out, z = tdm.DualProducts(cd, dev).layer_fwd(xs, w, b, act, True)
    plan = tdm.layer_fwd_plan(s, m, n, ks, w.element_size())
    assert tdm.LAYER_FWD_LAUNCHES[plan["kernel"]] == before[plan["kernel"]] + 1
    pout, pz = tdm.DualProductsPlain(cd).layer_fwd(xs, w, b, act, True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(z).all()
    assert _rel(z, pz) <= CARD_TOL[dtype], f"stash {_rel(z, pz)}"
    assert _rel(out[0], pout[0]) <= CARD_TOL[dtype], f"value {_rel(out[0], pout[0])}"
    if s > 1:
        got, want = out[1:].float(), pout[1:].float()
        if act in ("ReLU", "LeakyReLU"):
            far = (pz[0].float().abs() > 1e-3)[None]
            got, want = got * far, want * far
        assert _rel(got, want) <= CARD_TOL[dtype], f"tangents {_rel(got, want)}"
    out2, none = tdm.DualProducts(cd, dev).layer_fwd(xs, w, b, act, False)
    assert none is None and torch.equal(out, out2)
    return plan["kernel"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("segments", list(SEGMENTS))
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("n", WIDTHS)
def test_cuda_layer_forward_matches_plain(n, s, segments, dtype):
    dev = _card()
    i = WIDTHS.index(n) + 3 * s + (segments == "two")
    kernel = _check_layer(dev, dtype, s, 2001 + 37 * s, SEGMENTS[segments][dtype], n,
                          ACTS[i % len(ACTS)], seed=i)
    assert kernel == ("narrow" if n <= tdm.LAYER_FWD_NARROW_MAX_N else "wide")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("n", [3, 1024])
def test_cuda_layer_forward_takes_every_activation(n, act, dtype):
    dev = _card()
    ks = (87, 1024) if dtype == "bfloat16" else (1024, 36)
    _check_layer(dev, dtype, 4, 3001, ks, n, act, seed=ACTS.index(act))


@pytest.mark.cuda
def test_cuda_layer_forward_refuses_what_it_does_not_take():
    dev = _card()
    k = tdm.DualProducts(torch.bfloat16, dev)
    x = torch.zeros((3, 64, 64), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((64, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        k.layer_fwd([x], w, torch.zeros(64, device=dev), "ReLU", False)
    with pytest.raises(ValueError):
        k.layer_fwd([x[:2]], w, torch.zeros(64, device=dev, dtype=torch.bfloat16), "ReLU",
                    False)
