"""SDF trunk with its channel-0 gradient: CUDA kernel wrappers and the
autograd op.

Port of ``neddf_tpu/kernels/sdf_mlp.py::sdf_mlp``, the NeuS trunk: the
features ``h [M, C]`` of ``e = PE(pos) [M, E]`` and ``gE = d h[:, 0] / d e
[M, E]`` by an explicit reverse sweep, and the VJP of that pair.

* ``sdf_mlp`` launches the f32 row-tile trunk of ``csrc/mlp_fwd.cu``
  (``h`` and the stash of every layer's pre-activation ``[M, C]``), then
  ``csrc/sdf_mlp.cu``'s sweep (``gE``), one block per row tile each, both
  on the tensor cores by the 3xTF32 split.
* ``sdf_mlp_bwd`` runs the Pallas ``_bwd_kernel`` from the stash as
  launches of that file's elementwise kernels and of the hand-written
  products (``csrc/dual_mlp_bwd.cu``): the replayed sweep, the ascending
  adjoint of the sweep (the f'' terms), the descending trunk backward;
  dW and db are summed in a fixed order (bitwise reproducible).
* ``SDFMLP`` is the ``torch.autograd.Function`` over both; its backward
  takes the cotangents of both outputs, ``(ch, cg)``.

The plain versions are ``ops/sdf_grad.py::sdf_trunk_with_grad`` and
``sdf_trunk_with_grad_vjp``. For a CPU tensor each wrapper runs its plain
version; for a CUDA tensor it launches its kernels or raises. f32 only:
NeuS runs its trunk in f32.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.kernels.dual_mlp import Products, count_tile_launch
from neddf_tpu_torch.kernels.mlp import (
    _ACT_CODES,
    _DB_ROWS,
    _KERNEL_DTYPES,
    _SPLIT_HIDDEN_FIRST,
)
from neddf_tpu_torch.ops.sdf_grad import sdf_trunk_with_grad, sdf_trunk_with_grad_vjp

Tensor = torch.Tensor

_KERNEL_WIDTH = 256
_KERNEL_MAX_LAYERS = 12


def _check_kernel_args(e, weights, biases, layout, act_name) -> None:
    what = "CUDA sdf_mlp kernel"
    if act_name not in _ACT_CODES:
        raise NotImplementedError(f"{what}: activation {act_name!r}")
    if e.dtype != torch.float32 or e.dim() != 2:
        raise TypeError(f"{what}: e {tuple(e.shape)} {e.dtype} (f32 [M, E] only)")
    if not 2 <= len(weights) <= _KERNEL_MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"{what}: {len(weights)} layers")
    if len(layout) != len(weights) or layout[0]:
        raise ValueError(f"{what}: layout {tuple(layout)}")
    e_dim, width = e.shape[1], _KERNEL_WIDTH
    for li, (w, b) in enumerate(zip(weights, biases)):
        fan_in = e_dim if li == 0 else width + e_dim * bool(layout[li])
        if tuple(w.shape) != (fan_in, width) or tuple(b.shape) != (width,):
            raise ValueError(
                f"{what}: layer {li} w {tuple(w.shape)} b {tuple(b.shape)}, "
                f"expected ({fan_in}, {width})"
            )
        if w.dtype != torch.float32 or b.dtype != torch.float32:
            raise TypeError(f"{what}: layer {li} dtypes {w.dtype}/{b.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"{what}: layer {li} weight not 16-byte aligned")
    for t in (e, *weights, *biases):
        if t.device != e.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input")


def sdf_mlp(
    e: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    stash: bool = False,
):
    """(h [M, C], gE [M, E]) and, with ``stash``, the per-layer z: the
    CUDA kernel for CUDA tensors, ``sdf_trunk_with_grad`` for CPU ones."""
    if e.device.type == "cpu":
        return sdf_trunk_with_grad(e, weights, biases, layout, act_name, stash)
    if e.device.type != "cuda":
        raise ValueError(f"sdf_mlp: unsupported device {e.device}")
    _check_kernel_args(e, weights, biases, layout, act_name)
    m, e_dim = e.shape
    opts = dict(dtype=torch.float32, device=e.device)
    h = torch.empty((m, _KERNEL_WIDTH), **opts)
    g_e = torch.empty((m, e_dim), **opts)
    # the sweep reads the stash back, so the kernel always writes it
    pres = [torch.empty((m, _KERNEL_WIDTH), **opts) for _ in weights]
    if m:
        split = [_SPLIT_HIDDEN_FIRST if s else 0 for s in layout]
        act, lib = _ACT_CODES[act_name], _build.library()
        with torch.cuda.device(e.device):
            stream = torch.cuda.current_stream(e.device).cuda_stream
            _build.check(lib.neddf_mlp_seg_fwd(
                _KERNEL_DTYPES[torch.float32], act, _KERNEL_WIDTH, m, 1, _build.pointers([e]),
                _build.ints([e_dim]), len(weights), _build.pointers(weights),
                _build.pointers(biases), _build.ints(split), _build.pointers(pres),
                h.data_ptr(), stream), "sdf_mlp trunk")
            _build.check(lib.neddf_sdf_sweep(
                act, m, e_dim, len(weights), _build.pointers(weights), _build.ints(split),
                _build.pointers(pres), g_e.data_ptr(), stream), "sdf_mlp sweep")
        sdf_mlp.launches += 1
        count_tile_launch(torch.float32)
    return (h, g_e, pres) if stash else (h, g_e)


sdf_mlp.launches = 0


def sdf_mlp_bwd(
    e: Tensor,
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    pres: Sequence[Tensor],
    ch: Tensor,
    cg: Tensor,
):
    """VJP of ``sdf_mlp``: the CUDA kernels for CUDA tensors,
    ``sdf_trunk_with_grad_vjp`` for CPU ones (same arguments and
    results: de [M, E], dW per layer, db per layer, f32)."""
    if e.device.type == "cpu":
        return sdf_trunk_with_grad_vjp(e, weights, layout, act_name, pres, ch, cg)
    if e.device.type != "cuda":
        raise ValueError(f"sdf_mlp_bwd: unsupported device {e.device}")
    device = e.device
    biases = [torch.empty(w.shape[1], device=device) for w in weights]
    _check_kernel_args(e, weights, biases, layout, act_name)
    m, e_dim = e.shape
    c = _KERNEL_WIDTH
    n_layers = len(weights)
    for t, shape in [(p, (m, c)) for p in pres] + [(ch, (m, c)), (cg, (m, e_dim))]:
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError("sdf_mlp_bwd: stash/cotangent shape, dtype, layout or device")
    if len(pres) != n_layers:
        raise ValueError("sdf_mlp_bwd: one stash per layer")
    k = Products(torch.float32, device)
    act = _ACT_CODES[act_name]
    n = m * c
    n_db = -(-m // _DB_ROWS)

    def empty():
        return torch.empty((m, c), dtype=torch.float32, device=device)

    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    with torch.cuda.device(device):
        # replay the sweep: p_l for every layer, q_l[hidden] for l >= 1
        ps: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
        qs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
        p = empty()
        _build.check(k.lib.neddf_sdf_sweep_p(act, n, c, None, pres[-1].data_ptr(),
                                             p.data_ptr(), k.stream), "sdf_mlp_bwd sweep")
        for li in range(n_layers - 1, 0, -1):
            ps[li] = p
            qs[li] = k.nt(p, weights[li][:c])
            p = empty()
            _build.check(k.lib.neddf_sdf_sweep_p(
                act, n, c, qs[li].data_ptr(), pres[li - 1].data_ptr(), p.data_ptr(),
                k.stream), "sdf_mlp_bwd sweep")
        ps[0] = p

        # adjoint of the sweep, ascending: dW_l = qbar_l^T p_l, pbar_l = qbar_l W_l
        zs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
        dws[0] = k.tn(cg, ps[0])
        pbar = k.nn(cg, weights[0])
        for li in range(1, n_layers):
            w = weights[li]
            qbar, zs[li - 1] = empty(), empty()
            _build.check(k.lib.neddf_sdf_adjoint(
                act, n, c, pbar.data_ptr(), qs[li].data_ptr(), pres[li - 1].data_ptr(),
                qbar.data_ptr(), zs[li - 1].data_ptr(), k.stream), "sdf_mlp_bwd adjoint")
            if layout[li]:
                dws[li] = torch.cat([k.tn(qbar, ps[li]), k.tn(cg, ps[li])], dim=0)
                pbar = k.nn(qbar, w[:c])
                pbar += k.nn(cg, w[c:])
            else:
                dws[li] = k.tn(qbar, ps[li])
                pbar = k.nn(qbar, w)
            ps[li] = qs[li] = None
        zs[-1] = empty()
        _build.check(k.lib.neddf_sdf_adjoint(
            act, n, c, pbar.data_ptr(), None, pres[-1].data_ptr(), None, zs[-1].data_ptr(),
            k.stream), "sdf_mlp_bwd adjoint")
        del ps, qs, pbar

        # trunk backward with the combined z cotangents, descending
        hbar, ebar = ch, None
        for li in range(n_layers - 1, -1, -1):
            w = weights[li]
            zbar = empty()
            db_parts = torch.empty((n_db, c), dtype=torch.float32, device=device)
            _build.check(k.lib.neddf_sdf_zbar(
                act, c, m, _DB_ROWS, hbar.data_ptr(), pres[li].data_ptr(),
                zs[li].data_ptr(), zbar.data_ptr(), db_parts.data_ptr(), k.stream),
                "sdf_mlp_bwd zbar")
            zs[li] = None
            dbs[li] = torch.empty(c, dtype=torch.float32, device=device)
            k.sum_splits(db_parts, dbs[li])
            if li == 0:
                dw2, eb = k.tn(e, zbar), k.nt(zbar, w)
            else:
                h_in = empty()
                _build.check(k.lib.neddf_sdf_act(act, n, pres[li - 1].data_ptr(),
                                                 h_in.data_ptr(), k.stream), "sdf_mlp_bwd act")
                if layout[li]:
                    dw2 = torch.cat([k.tn(h_in, zbar), k.tn(e, zbar)], dim=0)
                    hbar, eb = k.nt(zbar, w[:c]), k.nt(zbar, w[c:])
                else:
                    dw2, eb = k.tn(h_in, zbar), None
                    hbar = k.nt(zbar, w)
            if eb is not None:
                ebar = eb if ebar is None else ebar + eb
            dws[li] = dws[li] + dw2
    sdf_mlp_bwd.launches += 1
    return ebar, dws, dbs


sdf_mlp_bwd.launches = 0


class SDFMLP(torch.autograd.Function):
    """``sdf_mlp`` with its hand-written backward (``_sdf_fwd`` /
    ``_sdf_bwd:375-391``).

    ``apply(config, e, *weights, *biases)`` with ``config = (layout,
    act_name, use_kernels)``; f32 parameters. ``use_kernels=False`` runs
    the plain versions on any device; ``True`` lets the wrappers choose
    by device (kernels on CUDA). Returns ``(h [M, C], gE [M, E])``.
    """

    @staticmethod
    def forward(ctx, config, e, *args):
        layout, act_name, use_kernels = config
        n_l = len(layout)
        weights = [w.float().contiguous() for w in args[:n_l]]
        biases = [b.float().contiguous() for b in args[n_l:]]
        e = e.float().contiguous()
        fwd = sdf_mlp if use_kernels else sdf_trunk_with_grad
        if not any(ctx.needs_input_grad[1:]):
            return fwd(e, weights, biases, layout, act_name)
        h, g_e, pres = fwd(e, weights, biases, layout, act_name, stash=True)
        ctx.config = config
        ctx.save_for_backward(e, *weights, *pres)
        return h, g_e

    @staticmethod
    def backward(ctx, ch, cg):
        layout, act_name, use_kernels = ctx.config
        saved = ctx.saved_tensors
        n_l = len(layout)
        e, weights, pres = saved[0], saved[1 : 1 + n_l], saved[1 + n_l :]
        ch = torch.zeros_like(pres[-1]) if ch is None else ch.float().contiguous()
        cg = torch.zeros_like(e) if cg is None else cg.float().contiguous()
        bwd = sdf_mlp_bwd if use_kernels else sdf_trunk_with_grad_vjp
        de, dws, dbs = bwd(e, weights, layout, act_name, pres, ch, cg)
        return (None, de, *dws, *dbs)


def sdf_apply(e, weights, biases, layout, act_name, use_kernels):
    """Differentiable ``sdf_mlp`` (see ``SDFMLP``)."""
    return SDFMLP.apply((tuple(layout), act_name, use_kernels), e, *weights, *biases)
