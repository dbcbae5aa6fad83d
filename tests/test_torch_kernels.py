"""The two kernels' plain PyTorch versions against the Pallas kernels they
port (run in interpret mode on the CPU, as tests/kernels/ runs them) and
against the JAX dense-dual reference; the CUDA kernels against the plain
versions on the card (marked ``cuda``: they skip without one).

Tolerances: in f32 both sides multiply the same operands and differ only
in summation order, 1e-5 relative on the outputs. In bf16 both round
every layer's activations to bf16 and may round a value that sits on a
rounding boundary differently, carrying one bf16 step (2^-8 relative)
through the later layers: 2^-5 of the output's largest magnitude.

The JAX side is imported inside the tests (fixture ``jx``): the GPU
machine has no JAX, and there only the ``cuda`` tests run.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import dual_mlp as tdual_mlp
from neddf_tpu_torch.kernels import mlp as tmlp

C0, C, K = 60, 32, 3
# 5 layers, the NeDDF trunk shape at narrow width: layer 3 consumes [seg0, h]
TRUNK_LAYOUT = (False, False, False, True, False)
M_JAX = 2 * 512  # two row tiles of the Pallas dual kernel (TILE_M = 512)
M_PORT = M_JAX + 37  # a ragged remainder on the port's side
SEG_WIDTHS = (60, 24, 3, 32)  # PE(pos), PE(dir), normal, trunk features
M_MLP = 1024  # one row tile of the Pallas mlp kernel (TILE_M = 1024)
F32_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    import neddf_tpu.kernels.dual_mlp as jdual_mlp
    import neddf_tpu.kernels.mlp as jmlp
    from neddf_tpu.ops import activations as jact
    from neddf_tpu.ops import dual as jdual

    assert (jdual_mlp.TILE_M, jmlp.TILE_M) == (512, 1024)
    return SimpleNamespace(jnp=jnp, dual_mlp_seg=jdual_mlp.dual_mlp_seg,
                           matmul_dtype=jdual_mlp.matmul_dtype, mlp=jmlp,
                           act=jact, dual=jdual)


def _trunk_inputs(seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(M_PORT, C0)).astype(np.float32)
    j0 = rng.normal(size=(K, M_PORT, C0)).astype(np.float32)
    ws, bs = [], []
    for li, split in enumerate(TRUNK_LAYOUT):
        fan_in = C0 if li == 0 else (C0 + C if split else C)
        ws.append(rng.normal(scale=1.0 / np.sqrt(fan_in), size=(fan_in, C)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=(C,)).astype(np.float32))
    return v0, j0, ws, bs


def _torch(xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def test_trunk_plain_matches_pallas_interpret_f32(jx):
    v0, j0, ws, bs = _trunk_inputs()
    with jx.matmul_dtype(jx.jnp.float32):
        jv, jj = jx.dual_mlp_seg(
            (jx.jnp.asarray(v0[:M_JAX]),), (jx.jnp.asarray(j0[:, :M_JAX]),),
            tuple(map(jx.jnp.asarray, ws)), tuple(map(jx.jnp.asarray, bs)),
            TRUNK_LAYOUT, "tanhExp", (True,), "float32", True,
        )
    tv, tj = tdual_mlp.dual_mlp_trunk_plain(
        torch.from_numpy(v0), torch.from_numpy(j0), _torch(ws), _torch(bs), TRUNK_LAYOUT
    )
    assert tuple(tv.shape) == (M_PORT, C) and tuple(tj.shape) == (K, M_PORT, C)
    np.testing.assert_allclose(tv[:M_JAX].numpy(), np.asarray(jv), **F32_TOL)
    np.testing.assert_allclose(tj[:, :M_JAX].numpy(), np.asarray(jj), **F32_TOL)


def test_trunk_plain_matches_jax_mlp_dual_including_ragged_rows(jx):
    v0, j0, ws, bs = _trunk_inputs(1)
    f, df = jx.act.ACTIVATIONS["tanhExp"]
    jnp = jx.jnp
    d = jnp.concatenate([jnp.asarray(v0)[:, None], jnp.moveaxis(jnp.asarray(j0), 0, 1)], 1)
    skips = tuple(li - 1 for li, s in enumerate(TRUNK_LAYOUT) if s)
    ref = jx.dual.mlp_dual(d, tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
                           f, df, skips=skips)
    tv, tj = tdual_mlp.dual_mlp_trunk_plain(
        torch.from_numpy(v0), torch.from_numpy(j0), _torch(ws), _torch(bs), TRUNK_LAYOUT
    )
    np.testing.assert_allclose(tv.numpy(), np.asarray(ref[:, 0]), **F32_TOL)
    np.testing.assert_allclose(
        tj.numpy(), np.asarray(jx.jnp.moveaxis(ref[:, 1:], 1, 0)), **F32_TOL
    )


def test_trunk_plain_bf16_matches_pallas_interpret_bf16(jx):
    v0, j0, ws, bs = _trunk_inputs(2)
    bf = jx.jnp.bfloat16
    with jx.matmul_dtype(bf):
        jv, jj = jx.dual_mlp_seg(
            (jx.jnp.asarray(v0[:M_JAX]).astype(bf),),
            (jx.jnp.asarray(j0[:, :M_JAX]).astype(bf),),
            tuple(jx.jnp.asarray(w) for w in ws), tuple(map(jx.jnp.asarray, bs)),
            TRUNK_LAYOUT, "tanhExp", (True,), "bfloat16", True,
        )
    tb = torch.bfloat16
    tv, tj = tdual_mlp.dual_mlp_trunk_plain(
        torch.from_numpy(v0).to(tb), torch.from_numpy(j0).to(tb), _torch(ws, tb),
        _torch(bs), TRUNK_LAYOUT,
    )
    assert tv.dtype == tb and tj.dtype == tb
    for got, ref in ((tv[:M_JAX], jv), (tj[:, :M_JAX], jj)):
        ref = np.asarray(ref.astype(jx.jnp.float32))
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 2.0**-5 * np.abs(ref).max(), err


def _mlp_inputs(seed=3, m=M_MLP + 21):
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in SEG_WIDTHS]
    fans = [sum(SEG_WIDTHS), C, C]
    ws = [rng.normal(scale=1.0 / np.sqrt(f), size=(f, C)).astype(np.float32) for f in fans]
    bs = [rng.normal(scale=0.1, size=(C,)).astype(np.float32) for _ in fans]
    return vs, ws, bs


def test_mlp_seg_plain_matches_pallas_interpret_f32(jx):
    vs, ws, bs = _mlp_inputs()
    layout = (False,) * len(ws)
    with jx.matmul_dtype(jx.jnp.float32):
        ref = jx.mlp.mlp_seg(
            tuple(jx.jnp.asarray(v[:M_MLP]) for v in vs), tuple(map(jx.jnp.asarray, ws)),
            tuple(map(jx.jnp.asarray, bs)), layout, "tanhExp", "float32", True,
        )
    got = tmlp.mlp_seg_plain(_torch(vs), _torch(ws), _torch(bs), layout)
    assert tuple(got.shape) == (M_MLP + 21, C)
    np.testing.assert_allclose(got[:M_MLP].numpy(), np.asarray(ref), **F32_TOL)


def test_mlp_seg_plain_matches_concat_reference_including_ragged_rows(jx):
    vs, ws, bs = _mlp_inputs(4)
    h = jx.jnp.concatenate([jx.jnp.asarray(v) for v in vs], axis=-1)
    for w, b in zip(ws, bs):
        h = jx.act.tanh_exp(h @ jx.jnp.asarray(w) + jx.jnp.asarray(b))
    got = tmlp.mlp_seg_plain(_torch(vs), _torch(ws), _torch(bs), (False,) * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(h), **F32_TOL)


def test_mlp_seg_plain_post_skip_is_nerf_order(jx):
    """Post-skip layers consume [h, seg0] (NeRF order), like the Pallas kernel."""
    vs, ws, bs = _mlp_inputs(5)
    layout = (False, True, False)
    ws[1] = np.random.default_rng(6).normal(
        scale=0.1, size=(C + SEG_WIDTHS[0], C)).astype(np.float32)
    with jx.matmul_dtype(jx.jnp.float32):
        ref = jx.mlp.mlp_seg(
            tuple(jx.jnp.asarray(v[:M_MLP]) for v in vs), tuple(map(jx.jnp.asarray, ws)),
            tuple(map(jx.jnp.asarray, bs)), layout, "tanhExp", "float32", True,
        )
    got = tmlp.mlp_seg_plain(_torch(vs), _torch(ws), _torch(bs), layout)
    np.testing.assert_allclose(got[:M_MLP].numpy(), np.asarray(ref), **F32_TOL)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    v0, j0, ws, bs = _trunk_inputs(7)
    launches = tdual_mlp.dual_mlp_trunk.launches
    calls = tdual_mlp.dual_mlp_trunk_plain.calls
    a = tdual_mlp.dual_mlp_trunk(torch.from_numpy(v0), torch.from_numpy(j0),
                                 _torch(ws), _torch(bs), TRUNK_LAYOUT)
    b = tdual_mlp.dual_mlp_trunk_plain(torch.from_numpy(v0), torch.from_numpy(j0),
                                       _torch(ws), _torch(bs), TRUNK_LAYOUT)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert tdual_mlp.dual_mlp_trunk.launches == launches
    assert tdual_mlp.dual_mlp_trunk_plain.calls == calls + 2

    vs, mws, mbs = _mlp_inputs(8)
    launches = tmlp.mlp_seg.launches
    out = tmlp.mlp_seg(_torch(vs), _torch(mws), _torch(mbs), (False,) * 3)
    assert torch.equal(out, tmlp.mlp_seg_plain(_torch(vs), _torch(mws), _torch(mbs),
                                               (False,) * 3))
    assert tmlp.mlp_seg.launches == launches


def _kernel_trunk_args(width=256, n_layers=7):
    v0 = torch.zeros((10, C0))
    j0 = torch.zeros((3, 10, C0))
    layout = tuple(li == 5 for li in range(n_layers))
    ws = [torch.zeros((C0 if li == 0 else (C0 + width if layout[li] else width), width))
          for li in range(n_layers)]
    bs = [torch.zeros(width) for _ in range(n_layers)]
    return v0, j0, ws, bs, layout


@pytest.mark.parametrize("bad", ["act", "k1", "width", "shape", "dtype", "skip0", "layers"])
def test_trunk_kernel_checks_refuse_unsupported_inputs(bad):
    v0, j0, ws, bs, layout = _kernel_trunk_args()
    act = "tanhExp"
    if bad == "act":
        act = "SiLU"  # none of the kernels' five activations
    elif bad == "k1":
        j0 = torch.zeros((1, 10, C0))
    elif bad == "width":
        v0, j0, ws, bs, layout = _kernel_trunk_args(width=576)  # over 512
    elif bad == "shape":
        ws[5] = torch.zeros((256, 256))
    elif bad == "dtype":
        ws[2] = ws[2].to(torch.float64)
    elif bad == "skip0":
        layout = (True,) + layout[1:]
    elif bad == "layers":
        v0, j0, ws, bs, layout = _kernel_trunk_args(n_layers=9)
    with pytest.raises((ValueError, TypeError, NotImplementedError)):
        tdual_mlp._check_kernel_args(v0, j0, ws, bs, layout, act)


def test_mlp_kernel_checks_refuse_post_skip_and_accept_the_eval_trunk():
    vs = [torch.zeros((10, w)) for w in (60, 24, 3, 256)]
    ws = [torch.zeros((343, 256)), torch.zeros((256, 256)), torch.zeros((256, 256))]
    bs = [torch.zeros(256)] * 3
    tmlp._check_kernel_args(vs, ws, bs, (False,) * 3, "tanhExp")
    # a post-skip layer ([h, seg0]) needs the 60 skip rows in its weight
    with pytest.raises(ValueError):
        tmlp._check_kernel_args(vs, ws, bs, (False, True, False), "tanhExp")
    tmlp._check_kernel_args(vs, [ws[0], torch.zeros((316, 256)), ws[2]], bs,
                            (False, True, False), "tanhExp")
    v0, j0, tws, tbs, layout = _kernel_trunk_args()
    tdual_mlp._check_kernel_args(v0, j0, tws, tbs, layout, "tanhExp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    m, width = 1000 * 3 + 5, 256
    layout = tuple(li == 5 for li in range(7))
    v0 = torch.randn((m, C0), generator=gen, device=dev).to(dtype)
    j0 = torch.randn((3, m, C0), generator=gen, device=dev).to(dtype)
    ws = [(torch.randn((C0 if li == 0 else (C0 + width if s else width), width),
                       generator=gen, device=dev) / 16).to(dtype)
          for li, s in enumerate(layout)]
    bs = [torch.randn(width, generator=gen, device=dev) * 0.1 for _ in layout]
    tol = 1e-4 if dtype == torch.float32 else 2.0**-5
    for got, ref in zip(tdual_mlp.dual_mlp_trunk(v0, j0, ws, bs, layout),
                        tdual_mlp.dual_mlp_trunk_plain(v0, j0, ws, bs, layout)):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), err
    segs = [torch.randn((m, w), generator=gen, device=dev).to(dtype) for w in (60, 24, 3, 256)]
    cws = [(torch.randn((f, width), generator=gen, device=dev) / 16).to(dtype)
           for f in (343, 256, 256)]
    got = tmlp.mlp_seg(segs, cws, bs[:3], (False,) * 3)
    ref = tmlp.mlp_seg_plain(segs, cws, bs[:3], (False,) * 3)
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
