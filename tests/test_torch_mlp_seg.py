"""``mlp_seg`` (the NeRF trunk and the NeuS colour trunk): the plain
PyTorch versions of the forward and of the hand-written backward against
the Pallas kernel they port (``neddf_tpu.kernels.mlp.mlp_seg``, interpret
mode on the CPU), and the CUDA kernels against the plain versions on the
card (marked ``cuda``: they skip without one).

Configurations: a post-skip layer in the ``[h, seg0]`` order, ReLU and
tanhExp, several input segments, and a last layer 3 wide (NeuS colour).

Tolerances: in f32 both sides multiply the same operands and differ only
in summation order: the output and every gradient within 1e-5 of their
largest magnitude. In bf16 (operands, stash and gpre rounded to bf16 on
both sides, against the Pallas stash variant) a value on a rounding
boundary may round the other way and carry one bf16 step (2^-8) on:
2^-6 of the largest magnitude forward, 2^-5 for the gradients.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import mlp as tmlp

C = 32
M = 1024  # one forward tile, two backward tiles of the Pallas kernel
CONFIGS = {
    # NeRF-like: one segment, skip after layer 1, [h, seg0]
    "nerf_skip": dict(widths=(24,), layout=(False, False, True, False), out=C, act="ReLU"),
    # NeuS-colour-like: four segments, 3-wide last layer
    "neus_color": dict(widths=(3, 12, 3, C), layout=(False,) * 4, out=3, act="ReLU"),
    "tanhexp_skip_narrow": dict(widths=(16, 8), layout=(False, True, False), out=3,
                                act="tanhExp"),
}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.mlp as jmlp

    assert jmlp.TILE_M == M
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, mlp=jmlp)


def _inputs(cfg, m=M, seed=0):
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=(m, w)).astype(np.float32) for w in cfg["widths"]]
    ws, bs = [], []
    n = len(cfg["layout"])
    for li, split in enumerate(cfg["layout"]):
        fan = sum(cfg["widths"]) if li == 0 else C + cfg["widths"][0] * split
        out = cfg["out"] if li == n - 1 else C
        ws.append(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)).astype(np.float32))
        bs.append(rng.normal(scale=0.1, size=out).astype(np.float32))
    g = rng.normal(size=(m, cfg["out"])).astype(np.float32)
    return vs, ws, bs, g


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _jax_value_and_grads(jx, cfg, vs, ws, bs, g, dtype):
    """Pallas forward and its custom VJP of sum(out * g), interpret mode."""
    jnp = jx.jnp
    out_dtype = "bfloat16" if dtype == "bfloat16" else "float32"
    jvs = tuple(jnp.asarray(v, out_dtype) for v in vs)
    jws, jbs = tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs))

    def run(v_, w_, b_):
        return jx.mlp.mlp_seg(v_, w_, b_, cfg["layout"], cfg["act"], out_dtype, True)

    def loss(v_, w_, b_):
        return jnp.sum(run(v_, w_, b_).astype(jnp.float32) * g)

    with jx.dm.matmul_dtype(jnp.dtype(out_dtype)), jx.mlp.mlp_stash(True):
        out = run(jvs, jws, jbs)
        grads = jx.jax.grad(loss, argnums=(0, 1, 2))(jvs, jws, jbs)
    return out, grads


def _port_value_and_grads(cfg, vs, ws, bs, g, dtype):
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tvs = [torch.tensor(v).to(cd).requires_grad_() for v in vs]
    tws = [torch.tensor(w, requires_grad=True) for w in ws]
    tbs = [torch.tensor(b, requires_grad=True) for b in bs]
    out = tmlp.mlp_apply(tvs, tws, tbs, cfg["layout"], cfg["act"], cd, True)
    torch.sum(out.float() * torch.from_numpy(g)).backward()
    return out, ([v.grad for v in tvs], [w.grad for w in tws], [b.grad for b in tbs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_forward_and_grads_match_pallas(jx, name, dtype):
    cfg = CONFIGS[name]
    vs, ws, bs, g = _inputs(cfg)
    jout, jgrads = _jax_value_and_grads(jx, cfg, vs, ws, bs, g, dtype)
    before = (tmlp.mlp_seg_plain.calls, tmlp.mlp_seg_bwd_plain.calls)
    tout, tgrads = _port_value_and_grads(cfg, vs, ws, bs, g, dtype)
    assert (tmlp.mlp_seg_plain.calls, tmlp.mlp_seg_bwd_plain.calls) == (
        before[0] + 1, before[1] + 1)
    assert tuple(tout.shape) == (M, cfg["out"])
    fwd_tol, grad_tol = (1e-5, 1e-5) if dtype == "float32" else (2.0**-6, 2.0**-5)
    assert _rel(tout.float().detach(), np.asarray(jout, np.float32)) <= fwd_tol
    for kind, tt, jj in zip(("dv", "dW", "db"), tgrads, jgrads):
        for i, (t, j) in enumerate(zip(tt, jj)):
            err = _rel(t.float(), np.asarray(j, np.float32))
            assert err <= grad_tol, (kind, i, err)


def test_plain_stash_is_every_pre_activation():
    cfg = CONFIGS["nerf_skip"]
    vs, ws, bs, _ = _inputs(cfg, m=40)
    tv = [torch.from_numpy(v) for v in vs]
    out, pres = tmlp.mlp_seg_plain(tv, list(map(torch.from_numpy, ws)),
                                   list(map(torch.from_numpy, bs)), cfg["layout"], "ReLU",
                                   stash=True)
    assert [tuple(p.shape) for p in pres] == [(40, w.shape[1]) for w in ws]
    torch.testing.assert_close(out, torch.relu(pres[-1]), rtol=0, atol=0)


def test_kernel_checks_accept_nerf_and_neus_layouts_and_refuse_others():
    nerf_ws = [torch.zeros((60, 256))] + [torch.zeros((316 if li == 5 else 256, 256))
                                          for li in range(1, 8)]
    nerf_layout = tuple(li == 5 for li in range(8))
    bs = [torch.zeros(256)] * 8
    tmlp._check_kernel_args([torch.zeros((10, 60))], nerf_ws, bs, nerf_layout, "ReLU")
    segs = [torch.zeros((10, w)) for w in (3, 24, 3, 256)]
    neus_ws = [torch.zeros((286, 256))] + [torch.zeros((256, 256))] * 7 + [
        torch.zeros((256, 3))]
    neus_bs = [torch.zeros(256)] * 8 + [torch.zeros(3)]
    tmlp._check_kernel_args(segs, neus_ws, neus_bs, (False,) * 9, "ReLU")
    bad = [
        (segs, neus_ws, neus_bs, (False,) * 9, "SiLU"),  # not one of the five activations
        (segs, neus_ws[:-1] + [torch.zeros((256, 300))], neus_bs[:-1] + [torch.zeros(300)],
         (False,) * 9, "ReLU"),  # last layer wider than 256
        (segs, [torch.zeros((286, 3))] + neus_ws[1:], neus_bs, (False,) * 9,
         "ReLU"),  # a narrow layer before the last
        ([torch.zeros((10, 60))], nerf_ws[:5] + [torch.zeros((256, 256))] + nerf_ws[6:],
         bs, nerf_layout, "ReLU"),  # post-skip layer without the skip rows
        (segs, neus_ws * 2, neus_bs * 2, (False,) * 18, "ReLU"),  # too many layers
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tmlp._check_kernel_args(*args)


# ------------------------------------------------------------------ on the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / max(
        ref.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["nerf", "neus_color"])
def test_cuda_forward_and_backward_match_plain(dtype, name):
    dev = _cuda()
    rng = np.random.default_rng(0)
    m = 4096 + 77
    if name == "nerf":
        widths, layout, outs = (60,), tuple(li == 5 for li in range(8)), [256] * 8
    else:
        widths, layout, outs = (3, 24, 3, 256), (False,) * 9, [256] * 8 + [3]
    vs = [torch.tensor(rng.normal(size=(m, w)), dtype=dtype, device=dev) for w in widths]
    ws, bs = [], []
    for li, (split, out) in enumerate(zip(layout, outs)):
        fan = sum(widths) if li == 0 else 256 + widths[0] * split
        ws.append(torch.tensor(rng.normal(scale=1.5 * fan ** -0.5, size=(fan, out)),
                               dtype=dtype, device=dev))
        bs.append(torch.tensor(rng.normal(scale=0.1, size=out), dtype=torch.float32,
                               device=dev))
    got = tmlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True)
    ref = tmlp.mlp_seg_plain(vs, ws, bs, layout, "ReLU", stash=True)
    tol = 1e-4 if dtype == torch.float32 else 2.0**-5
    for g, r in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert g.shape == r.shape and _err(g, r) <= tol
    gout = torch.tensor(rng.normal(size=(m, outs[-1])), dtype=dtype, device=dev)
    args = (vs, ws, layout, "ReLU", ref[1], gout)
    kern = tmlp.mlp_seg_bwd(*args)
    plain = tmlp.mlp_seg_bwd_plain(*args)
    for g, r in zip(sum(kern, []), sum(plain, [])):
        assert _err(g, r) <= (1e-4 if dtype == torch.float32 else 2.0**-4)
    again = tmlp.mlp_seg_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(kern[1] + kern[2], again[1] + again[2]))
