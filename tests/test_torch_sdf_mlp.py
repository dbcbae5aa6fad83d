"""``sdf_mlp`` (the NeuS trunk with its channel-0 gradient): the plain
PyTorch versions of the forward (``ops/sdf_grad.py::sdf_trunk_with_grad``)
and of the hand-written backward (``sdf_trunk_with_grad_vjp``) against
the Pallas kernel they port (``neddf_tpu.kernels.sdf_mlp.sdf_mlp``,
interpret mode on the CPU) and against ``jax.grad`` of the JAX package's
jnp oracle (``neddf_tpu.ops.sdf_grad.sdf_trunk_with_grad``); the normals'
chain to the positions; and the CUDA kernels against the plain versions
on the card (marked ``cuda``: they skip without one).

ReLU (the shipped NeuS) and tanhExp: with ReLU every f'' term of the
sweep's adjoint is zero, so only tanhExp checks those terms. One and two
row tiles of the Pallas kernel.

Tolerances (f32 on both sides, sums in another order): h, gE and every
gradient within 1e-4 of their largest magnitude (tanhExp's f'' multiplies
the ulp by which torch's and XLA's tanh differ near 1 by about 30).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neddf_tpu_torch.kernels import sdf_mlp as tsdf
from neddf_tpu_torch.ops import sdf_grad as tgrad
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

L, C, E = 4, 24, 30
LAYOUT = (False, False, True, False)
TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import neddf_tpu.kernels.dual_mlp as jdm
    import neddf_tpu.kernels.sdf_mlp as jsdf
    import neddf_tpu.ops.sdf_grad as jgrad

    assert jsdf.TILE_M == 512
    return SimpleNamespace(jax=jax, jnp=jnp, dm=jdm, sdf=jsdf, grad=jgrad)


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(m, E)).astype(np.float32)
    ws, bs = [], []
    for li in range(L):
        fan = E if li == 0 else C + E * LAYOUT[li]
        ws.append((rng.normal(size=(fan, C)) * 0.4).astype(np.float32))
        bs.append((rng.normal(size=C) * 0.1).astype(np.float32))
    ch = rng.normal(size=(m, C)).astype(np.float32)
    cg = rng.normal(size=(m, E)).astype(np.float32)
    return e, ws, bs, ch, cg


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)


def _jax(jx, fn, e, ws, bs, ch, cg):
    """(h, gE) and the gradient of sum(h ch) + sum(gE cg) by e, W, b."""
    jnp = jx.jnp
    args = (jnp.asarray(e), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))

    def loss(e_, w_, b_):
        h, g_e = fn(e_, w_, b_)
        return jnp.sum(h * ch) + jnp.sum(g_e * cg)

    with jx.dm.matmul_dtype(jnp.float32):
        out = fn(*args)
        grads = jx.jax.grad(loss, argnums=(0, 1, 2))(*args)
    return out, grads


def _port(e, ws, bs, ch, cg, act):
    te = torch.tensor(e, requires_grad=True)
    tws = [torch.tensor(w, requires_grad=True) for w in ws]
    tbs = [torch.tensor(b, requires_grad=True) for b in bs]
    h, g_e = tsdf.sdf_apply(te, tws, tbs, LAYOUT, act, True)
    (torch.sum(h * torch.from_numpy(ch)) + torch.sum(g_e * torch.from_numpy(cg))).backward()
    return (h, g_e), (te.grad, [w.grad for w in tws], [b.grad for b in tbs])


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("act", ["ReLU", "tanhExp"])
def test_plain_versions_match_pallas_and_jax_grad(jx, act, tiles):
    e, ws, bs, ch, cg = _inputs(512 * tiles, seed=tiles)
    calls = (tgrad.sdf_trunk_with_grad.calls, tgrad.sdf_trunk_with_grad_vjp.calls)
    (th, tge), tgrads = _port(e, ws, bs, ch, cg, act)
    assert (tgrad.sdf_trunk_with_grad.calls, tgrad.sdf_trunk_with_grad_vjp.calls) == (
        calls[0] + 1, calls[1] + 1)

    def pallas(e_, w_, b_):
        return jx.sdf.sdf_mlp(e_, w_, b_, LAYOUT, act, "float32", True)

    def oracle(e_, w_, b_):
        return jx.grad.sdf_trunk_with_grad(e_, w_, b_, LAYOUT, act)

    for fn in (pallas, oracle):
        (jh, jge), jgrads = _jax(jx, fn, e, ws, bs, ch, cg)
        assert _rel(th.detach(), jh) <= TOL
        assert _rel(tge.detach(), jge) <= TOL
        assert _rel(tgrads[0], jgrads[0]) <= TOL
        for i in range(L):
            assert _rel(tgrads[1][i], jgrads[1][i]) <= TOL, ("dW", i)
            assert _rel(tgrads[2][i], jgrads[2][i]) <= TOL, ("db", i)


def test_pe_chain_to_pos_matches_jax(jx):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
    g_e = rng.normal(size=(50, 36)).astype(np.float32)
    want = jx.grad.pe_chain_to_pos(jx.jnp.asarray(g_e), jx.jnp.asarray(pos), 6)
    got = tgrad.pe_chain_to_pos(torch.from_numpy(g_e), torch.from_numpy(pos), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_checks_accept_the_neus_trunk_and_refuse_others():
    layout = tuple(li == 5 for li in range(8))
    ws = [torch.zeros((36, 256))] + [torch.zeros((292 if li == 5 else 256, 256))
                                     for li in range(1, 8)]
    bs = [torch.zeros(256)] * 8
    e = torch.zeros((10, 36))
    tsdf._check_kernel_args(e, ws, bs, layout, "ReLU")
    tsdf._check_kernel_args(e, ws, bs, layout, "tanhExp")
    bad = [
        (e.to(torch.bfloat16), ws, bs, layout, "ReLU"),
        (e, ws, bs, layout, "SiLU"),  # not one of the five activations
        (e, ws[:5] + [torch.zeros((256, 256))] + ws[6:], bs, layout, "ReLU"),
        (e, ws, bs, (True,) + layout[1:], "ReLU"),
        (e, [w[:, :128] for w in ws], [b[:128] for b in bs], layout, "ReLU"),
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            tsdf._check_kernel_args(*args)


# ------------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("act", ["ReLU", "tanhExp"])
def test_cuda_forward_and_backward_match_plain(act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    m, e_dim = 3 * 128 + 45, 36
    layout = tuple(li == 5 for li in range(8))
    e = torch.tensor(rng.uniform(-1, 1, size=(m, e_dim)), dtype=torch.float32, device=dev)
    ws, bs = [], []
    for li, split in enumerate(layout):
        fan = e_dim if li == 0 else 256 + e_dim * split
        ws.append(torch.tensor(rng.uniform(-1, 1, size=(fan, 256)) / fan ** 0.5,
                               dtype=torch.float32, device=dev))
        bs.append(torch.tensor(rng.uniform(-1, 1, size=256) / fan ** 0.5,
                               dtype=torch.float32, device=dev))
    got = tsdf.sdf_mlp(e, ws, bs, layout, act, stash=True)
    ref = tgrad.sdf_trunk_with_grad(e, ws, bs, layout, act, stash=True)
    # gE against the plain sweep over the kernel's own z: f'(z) is a step
    # for ReLU, and a z within an f32 rounding of 0 may fall either side
    ge_ref = tgrad.channel0_sweep(ws, layout, act, got[2], e_dim)
    for g, r in zip([got[0], got[1], *got[2]], [ref[0], ge_ref, *ref[2]]):
        err = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        assert err <= 1e-4
    ch = torch.tensor(rng.normal(size=(m, 256)), dtype=torch.float32, device=dev)
    cg = torch.tensor(rng.normal(size=(m, e_dim)), dtype=torch.float32, device=dev)
    args = (e, ws, layout, act, ref[2], ch, cg)
    kern = tsdf.sdf_mlp_bwd(*args)
    plain = tgrad.sdf_trunk_with_grad_vjp(*args)
    for g, r in zip([kern[0], *kern[1], *kern[2]], [plain[0], *plain[1], *plain[2]]):
        err = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        assert err <= 1e-4
    again = tsdf.sdf_mlp_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(kern[1] + kern[2], again[1] + again[2]))
