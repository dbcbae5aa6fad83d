"""SDF trunk with an explicit reverse sweep for its channel-0 gradient.

Counterpart of ``neddf_tpu/ops/sdf_grad.py`` and the plain versions of
the kernels of ``kernels/sdf_mlp.py``:

* ``sdf_trunk_with_grad`` returns ``h [M, C]`` and ``gE [M, E] = d h[:, 0]
  / d e`` (the JAX package's jnp oracle of the Pallas forward,
  ``_trunk_and_sweep:69``), with the per-layer pre-activations when asked;
  ``channel0_sweep`` is its reverse sweep alone, from given z_l;
* ``sdf_trunk_with_grad_vjp`` is the VJP of that pair, written out as the
  Pallas backward (``_bwd_kernel:135-242``) computes it: the replayed
  sweep, the ascending adjoint of the sweep with its f'' terms, then the
  descending trunk backward with the combined z cotangents;
* ``pe_chain_to_pos`` chains ``gE`` from the PE channels to the positions.

``layout[l]`` marks a post-skip layer whose input is ``[h_{l-1}, e]``
(hidden rows of W first, as NeRF/NeuS concatenate). Everything is f32.

Under tensor parallelism (``group``, the model group of
``parallel/mesh.py``; None: the whole layers) the weights and biases are
this rank's column shards ([fan_in, W/n], [W/n]) and the z_l its columns:
each layer's activation is gathered over the group (``parallel/tp.py``)
before the next layer reads it; the sweep's q_l = p_l W_l^T is this rank's
part of a sum over the columns, reduce-scattered before f'(z_{l-1})
multiplies it; channel 0 is in the shard of the group's rank 0; the
ranks' parts of gE are summed, so every rank holds the whole normal. The
VJP takes this rank's cotangents of the gathered h and of the summed gE,
and returns this rank's part of de and its shards of dW and db. These
are the plain versions of ``kernels/sdf_mlp.py``'s per-layer route.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES
from neddf_tpu_torch.parallel.tp import (
    all_gather_last,
    all_reduce_sum,
    holds_column0,
    reduce_scatter_last,
)

Tensor = torch.Tensor


def _onehot0(n: int, like: Tensor, group=None) -> Tensor:
    """[1, n]: 1 at column 0 (zeros on a rank whose shard lacks it)."""
    out = torch.zeros((1, n), dtype=like.dtype, device=like.device)
    if holds_column0(group):
        out[0, 0] = 1.0
    return out


def sdf_trunk_with_grad(
    e: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    stash: bool = False,
    group=None,
):
    """(features h [M, C], gE [M, E] = d h[:, 0] / d e), plus the list of
    pre-activations z_l [M, C] when ``stash`` (the kernel's stash; this
    rank's columns under ``group``).

    The sweep is ``channel0_sweep``.
    """
    sdf_trunk_with_grad.calls += 1
    f = ACTIVATION_TRIPLES[act_name][0]
    e = e.float()
    zs: List[Tensor] = []
    h: Optional[Tensor] = None
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li == 0:
            z = e @ w + b
        elif layout[li]:
            c = h.shape[1]
            z = h @ w[:c] + e @ w[c:] + b
        else:
            z = h @ w + b
        zs.append(z)
        h = all_gather_last(f(z), group)
    g_e = channel0_sweep(weights, layout, act_name, zs, e.shape[1], group)
    return (h, g_e, zs) if stash else (h, g_e)


sdf_trunk_with_grad.calls = 0


def channel0_sweep(
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    zs: Sequence[Tensor],
    e_dim: int,
    group=None,
) -> Tensor:
    """gE [M, E] = d h[:, 0] / d e from the pre-activations z_l alone:
    p_{L-1} = onehot0 * f'(z_{L-1}); downward q_l = p_l W_l^T, p_{l-1} =
    q_l[hidden] * f'(z_{l-1}); gE collects the e rows of layer 0 and of
    every post-skip layer."""
    df = ACTIVATION_TRIPLES[act_name][1]
    p = df(zs[-1]) * _onehot0(zs[-1].shape[1], zs[-1], group)
    g_e = torch.zeros((zs[0].shape[0], e_dim), dtype=p.dtype, device=p.device)
    for li in range(len(weights) - 1, -1, -1):
        q = p @ weights[li].T
        if li == 0:
            g_e = g_e + q
        elif layout[li]:
            c = weights[li].shape[0] - e_dim
            g_e = g_e + q[:, c:]
            p = reduce_scatter_last(q[:, :c], group) * df(zs[li - 1])
        else:
            p = reduce_scatter_last(q, group) * df(zs[li - 1])
    return all_reduce_sum(g_e, group)


def sdf_trunk_with_grad_vjp(
    e: Tensor,
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    pres: Sequence[Tensor],
    ch: Tensor,
    cg: Tensor,
    group=None,
):
    """VJP of ``sdf_trunk_with_grad`` from its stash.

    Args:
        e: [M, E] input; weights: per layer [fan_in, C]; layout, act_name
            as in the forward; pres: the forward's z_l [M, C].
        ch: [M, C] cotangent of h; cg: [M, E] cotangent of gE.

    Returns:
        (de [M, E], dW per layer [fan_in, C], db per layer [C]), f32.
    """
    sdf_trunk_with_grad_vjp.calls += 1
    f, df, ddf = ACTIVATION_TRIPLES[act_name]
    n_layers = len(weights)
    e = e.float()
    e_dim = e.shape[1]
    zs = [z.float() for z in pres]
    hs = [all_gather_last(f(z), group) for z in zs]
    onehot = _onehot0(zs[-1].shape[1], e, group)

    # replay the sweep (q_l: the sum over the ranks, at this rank's columns)
    ps: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    qs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    p = df(zs[-1]) * onehot
    for li in range(n_layers - 1, -1, -1):
        ps[li] = p
        if li > 0:
            c = weights[li].shape[0] - e_dim if layout[li] else weights[li].shape[0]
            qs[li] = reduce_scatter_last((p @ weights[li].T)[:, :c], group)
            p = qs[li] * df(zs[li - 1])

    ch = reduce_scatter_last(ch.float(), group)
    cg = all_reduce_sum(cg.float(), group)
    # adjoint of the sweep, ascending
    zbar_sweep: List[Optional[Tensor]] = [None] * n_layers
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    pbar = None
    for li in range(n_layers):
        w = weights[li]
        if li == 0:
            qbar = cg
        else:
            d1 = df(zs[li - 1])
            zb = pbar * qs[li] * ddf(zs[li - 1])
            qbar = all_gather_last(pbar * d1, group)
            if layout[li]:
                qbar = torch.cat([qbar, cg], dim=1)
            zbar_sweep[li - 1] = zb
        dws[li] = qbar.T @ ps[li]
        pbar = qbar @ w
    zbar_sweep[-1] = pbar * onehot * ddf(zs[-1])

    # trunk backward with the combined z cotangents, descending
    hbar = ch
    ebar = None
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    for li in range(n_layers - 1, -1, -1):
        w = weights[li]
        zbar = hbar * df(zs[li]) + zbar_sweep[li]
        dbs[li] = zbar.sum(dim=0)
        if li == 0:
            dw2 = e.T @ zbar
            eb = zbar @ w.T
        elif layout[li]:
            c = hs[li - 1].shape[1]
            dw2 = torch.cat([hs[li - 1].T @ zbar, e.T @ zbar], dim=0)
            inbar = zbar @ w.T
            hbar = reduce_scatter_last(inbar[:, :c], group)
            eb = inbar[:, c:]
        else:
            dw2 = hs[li - 1].T @ zbar
            hbar = reduce_scatter_last(zbar @ w.T, group)
            eb = None
        if eb is not None:
            ebar = eb if ebar is None else ebar + eb
        dws[li] = dws[li] + dw2
    return ebar, dws, dbs


sdf_trunk_with_grad_vjp.calls = 0


def pe_chain_to_pos(g_e: Tensor, pos: Tensor, rank: int) -> Tensor:
    """Chain a gradient over the PE channels to the positions:
    ``out[:, a] = sum_k g_e[:, k] d PE_k / d pos_a``. Channel ``t*d + a``
    of each half depends on axis ``a`` alone, so this is an elementwise
    product and a sum over the bands (plain glue, differentiable)."""
    m, d = pos.shape
    freq = (2.0 ** torch.arange(rank, dtype=pos.dtype, device=pos.device)).repeat_interleave(d)
    phase = freq[None, :] * pos.repeat(1, rank)
    per_chan = (g_e[:, : rank * d] * (freq * torch.cos(phase))
                - g_e[:, rank * d :] * (freq * torch.sin(phase)))
    return per_chan.reshape(m, rank, d).sum(dim=1)
