"""NeDDF head/density/penalty epilogue: CUDA kernel wrappers, plain
versions and the autograd op.

Port of ``neddf_tpu/kernels/neddf_epilogue.py::neddf_epilogue``. From the
distance trunk's streams ``v [M, C]`` and ``j [3, M, C]`` one pass gives,
per sample row:

* the two 1-wide heads on all four streams (h1 = stack . wd, h2 =
  stack . wa, the stream and the head weights rounded to the compute
  dtype, sums in f32), plus the f32 biases b2 on the value row;
* D = softplus(h1_v) + d_near and grad D = sigmoid(h1_v) h1_t;
  aux = s sigmoid(h2_v) and its gradient; density = act((1/D)(1 -
  sqrt(|grad D|^2 + aux^2))) with the field's density activation (ReLU
  by default; any of ``ops/activations.py``'s, a run-time code in the
  kernel); the normal grad D / (|grad D| + 1e-7);
* the weighted sum of the four trunk penalties (constraints_aux_grad,
  constraints_dDdt, range_distance, range_aux_grad) with the reference's
  stop-gradient placements;
* t_feat = sum_a j[a] sg(grad D)_a, the seed of the colour trunk's K=1
  directional tangent.

Outputs: ``out [10, M]`` f32, rows 0 density, 1 distance, 2 aux_grad,
3:6 normal, 6:9 grad D, 9 penalty sum (one row per quantity, so each is
a contiguous [M] vector; the Pallas kernel's lane-packed [M, 16] was a
TPU layout), and ``t_feat [M, C]`` in the compute dtype. Rows 3:9 carry
no gradient: the field consumes them only under stop-gradient
(``neddf_epilogue.py:42-44``).

The backward is the hand-written second-order VJP of ``_bwd_kernel``
(``:183-326``): it recomputes the heads, reads the cotangents of rows
0, 1, 2 and 9 and of t_feat (which flows into j alone), and returns dv,
dj, dwd, dwa [C] and db2 [2] (f32, summed across rows in a fixed order)
(``neddf_epilogue_bwd``). On the training path its kernel also finishes
the K=3 trunk's top layer (``neddf_epilogue_gstack``): it adds the colour
trunk's cotangent of v_feat to dv and forms the top layer's stacked
cotangent from the trunk's stash, so dv and dj never reach device
memory; ``DDFTrunkEpilogue`` is the autograd op of the trunk and the
epilogue together, whose backward continues the trunk's from there.

For CPU tensors the wrappers run the plain versions (``*_plain``); for
CUDA tensors they launch ``csrc/neddf_epilogue.cu`` or raise. The forward
and the standalone backward take any width C (the per-layer route's,
whose NeDDF runs them on the gathered full-width features; past 2048 the
backward runs its column-chunked kernel), the top mode up to 512 (the
fused trunk's ``dual_mlp.KERNEL_MAX_WIDTH``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.kernels.dual_mlp import (
    _ACT_CODES,
    DualProductsPlain,
    dual_mlp_seg_bwd,
    dual_mlp_seg_bwd_plain,
    dual_mlp_seg_plain,
    dual_mlp_trunk,
    width_refusal,
)
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES

Tensor = torch.Tensor

N_OUT = 10
_EPS_NORM = 1e-7
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _relu(x: Tensor) -> Tensor:
    return torch.clamp(x, min=0.0)


def _step(x: Tensor) -> Tensor:
    return (x > 0).to(x.dtype)


def _math(v, j, wd, wa, b2, scal, density_act):
    """Forward math on f32 [M] rows (``_epilogue_math:115``), the density
    through the activation ``density_act``."""
    cd = v.dtype
    stack = torch.cat([v[None], j], dim=0).float()  # [4, M, C]
    h1 = stack @ wd.to(cd).float()  # [4, M]
    h2 = stack @ wa.to(cd).float()
    d_near, ags, drmax, w_ag, w_ddt, w_rd, w_ra = (scal[i] for i in range(7))
    ddf_out = h1[0] + b2[0]
    aux_out = h2[0] + b2[1]
    hj1, hj2 = h1[1:], h2[1:]
    spd = torch.sigmoid(ddf_out)
    distance = F.softplus(ddf_out) + d_near
    dg = spd * hj1  # [3, M]
    sig_a = torch.sigmoid(aux_out)
    aux = ags * sig_a
    auxd = ags * sig_a * (1.0 - sig_a)
    agg = auxd * hj2
    grad_sq = torch.sum(dg * dg, dim=0)
    dgn = torch.sqrt(grad_sq)
    d_ddt = torch.sqrt(grad_sq + aux * aux)
    dinv = 1.0 / distance
    density = ACTIVATION_TRIPLES[density_act][0](dinv * (1.0 - d_ddt))
    inv_dgn_eps = 1.0 / (dgn + _EPS_NORM)
    norm = dg * inv_dgn_eps
    d2 = torch.sum(agg * norm, dim=0)
    rest = 3.0 * aux * dinv
    ag_scale = aux * dgn * distance
    p1 = ag_scale * torch.square(d2 - rest)
    p2 = torch.square(_relu(d_ddt - 1.0))
    p3 = torch.square(_relu(-4.6 - ddf_out) + _relu(ddf_out - drmax))
    p4 = torch.square(_relu(-4.6 - aux_out) + _relu(aux_out - 4.6))
    pen = w_ag * p1 + w_ddt * p2 + w_rd * p3 + w_ra * p4
    return dict(stack=stack, ddf_out=ddf_out, aux_out=aux_out, hj1=hj1, hj2=hj2,
                spd=spd, distance=distance, dg=dg, sig_a=sig_a, aux=aux, auxd=auxd,
                agg=agg, dgn=dgn, d_ddt=d_ddt, dinv=dinv, density=density,
                norm=norm, inv_dgn_eps=inv_dgn_eps, d2=d2, rest=rest,
                ag_scale=ag_scale, pen=pen)


def neddf_epilogue_plain(
    v: Tensor, j: Tensor, wd: Tensor, wa: Tensor, b2: Tensor, scal: Tensor,
    density_act: str,
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the epilogue kernel.

    Args:
        v: [M, C] and j: [3, M, C] trunk streams in the compute dtype.
        wd, wa: [C] f32 head weights (rounded to v's dtype here).
        b2: [2] f32 (distance bias, aux bias).
        scal: [8] f32 (d_near, aux_grad_scale, distance_range_max,
            w_constraints_aux_grad, w_constraints_dDdt,
            w_range_distance, w_range_aux_grad, unused).
        density_act: the density's activation (``ops/activations.py``).

    Returns:
        (out [10, M] f32, t_feat [M, C] in v's dtype).
    """
    neddf_epilogue_plain.calls += 1
    m = _math(v, j, wd, wa, b2, scal, density_act)
    out = torch.stack([m["density"], m["distance"], m["aux"], *m["norm"], *m["dg"],
                       m["pen"]], dim=0)
    t_feat = torch.sum(m["stack"][1:] * m["dg"][:, :, None], dim=0).to(v.dtype)
    return out, t_feat


neddf_epilogue_plain.calls = 0


def neddf_epilogue_bwd_plain(
    v: Tensor, j: Tensor, wd: Tensor, wa: Tensor, b2: Tensor, scal: Tensor,
    g_out: Tensor, g_tfeat: Tensor, density_act: str,
):
    """Plain version of the epilogue backward (``_bwd_kernel:183-326``).

    Args:
        v, j, wd, wa, b2, scal, density_act: the forward's inputs.
        g_out: [10, M] f32 cotangent of ``out`` (rows 3:9 are ignored).
        g_tfeat: [M, C] cotangent of t_feat.

    Returns:
        (dv [M, C], dj [3, M, C] in v's dtype, dwd [C], dwa [C], db2 [2]
        f32).
    """
    neddf_epilogue_bwd_plain.calls += 1
    m = _math(v, j, wd, wa, b2, scal, density_act)
    ags, drmax, w_ag, w_ddt, w_rd, w_ra = (scal[i] for i in range(1, 7))
    g_out = g_out.float()
    g_dens, g_dist_ext, g_aux_ext, g_pen = g_out[0], g_out[1], g_out[2], g_out[9]
    ddf_out, aux_out = m["ddf_out"], m["aux_out"]
    dg, agg, norm = m["dg"], m["agg"], m["norm"]
    dgn, d_ddt, dinv = m["dgn"], m["d_ddt"], m["dinv"]
    aux, auxd, sig_a, spd = m["aux"], m["auxd"], m["sig_a"], m["spd"]
    inv = m["inv_dgn_eps"]

    g_diff = g_pen * w_ag * m["ag_scale"] * 2.0 * (m["d2"] - m["rest"])
    g_agg = g_diff * norm
    g_norm_int = g_diff * agg
    g_aux = -g_diff * 3.0 * dinv
    g_dddt = g_pen * w_ddt * 2.0 * _relu(d_ddt - 1.0)
    r3 = _relu(-4.6 - ddf_out) + _relu(ddf_out - drmax)
    g_ddf_out = g_pen * w_rd * 2.0 * r3 * (_step(ddf_out - drmax) - _step(-4.6 - ddf_out))
    r4 = _relu(-4.6 - aux_out) + _relu(aux_out - 4.6)
    g_aux_out = g_pen * w_ra * 2.0 * r4 * (_step(aux_out - 4.6) - _step(-4.6 - aux_out))

    u = dinv * (1.0 - d_ddt)
    g_u = g_dens * ACTIVATION_TRIPLES[density_act][1](u)
    g_dinv = g_u * (1.0 - d_ddt)
    g_dddt = g_dddt - g_u * dinv
    g_aux = g_aux + g_aux_ext
    inv_dddt = 1.0 / torch.clamp(d_ddt, min=1e-12)
    g_grad_sq = g_dddt * 0.5 * inv_dddt
    g_aux = g_aux + g_dddt * aux * inv_dddt
    g_dg = g_norm_int * inv
    g_dgn = -torch.sum(g_norm_int * dg, dim=0) * inv * inv
    g_grad_sq = g_grad_sq + g_dgn * 0.5 / torch.clamp(dgn, min=1e-12)
    g_dg = g_dg + 2.0 * dg * g_grad_sq
    g_dist = g_dist_ext - g_dinv * dinv * dinv
    g_hj2 = g_agg * auxd
    g_auxd = torch.sum(g_agg * m["hj2"], dim=0)
    g_aux_out = g_aux_out + g_auxd * ags * sig_a * (1.0 - sig_a) * (1.0 - 2.0 * sig_a)
    g_aux_out = g_aux_out + g_aux * auxd
    g_hj1 = g_dg * spd
    g_spd = torch.sum(g_dg * m["hj1"], dim=0)
    g_ddf_out = g_ddf_out + g_spd * spd * (1.0 - spd)
    g_ddf_out = g_ddf_out + g_dist * spd

    g_h1 = torch.cat([g_ddf_out[None], g_hj1], dim=0)  # [4, M]
    g_h2 = torch.cat([g_aux_out[None], g_hj2], dim=0)
    d_stream = g_h1[:, :, None] * wd.float() + g_h2[:, :, None] * wa.float()
    d_stream[1:] += g_tfeat.float()[None] * dg[:, :, None]
    stack = m["stack"]
    dwd = torch.einsum("smc,sm->c", stack, g_h1)
    dwa = torch.einsum("smc,sm->c", stack, g_h2)
    db2 = torch.stack([g_ddf_out.sum(), g_aux_out.sum()])
    return d_stream[0].to(v.dtype), d_stream[1:].to(j.dtype), dwd, dwa, db2


neddf_epilogue_bwd_plain.calls = 0


def _check_kernel_args(v, j, wd, wa, b2, scal, density_act, top=False) -> None:
    what = "CUDA neddf_epilogue kernel"
    if v.dtype not in _KERNEL_DTYPES or j.dtype != v.dtype:
        raise TypeError(f"{what}: dtypes {v.dtype}/{j.dtype}")
    if v.dim() != 2 or tuple(j.shape) != (3,) + tuple(v.shape):
        raise ValueError(f"{what}: shapes {tuple(v.shape)} / {tuple(j.shape)}")
    width = v.shape[1]
    # the top mode finishes the fused trunk's top layer: its widths;
    # the forward and the standalone backward: any, the per-layer route's
    if top and (refusal := width_refusal(width)) is not None:
        raise NotImplementedError(f"{what}: {refusal}")
    if width < 1:
        raise NotImplementedError(f"{what}: width {width}")
    if density_act not in _ACT_CODES:
        raise NotImplementedError(f"{what}: density activation {density_act!r}")
    for t, n in ((wd, width), (wa, width), (b2, 2), (scal, 8)):
        if tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{what}: parameter {tuple(t.shape)} {t.dtype}")
    for t in (v, j, wd, wa, b2, scal):
        if t.device != v.device or not t.is_contiguous():
            raise ValueError(f"{what}: device or layout")


def neddf_epilogue(v, j, wd, wa, b2, scal, density_act):
    """Epilogue forward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see ``neddf_epilogue_plain``)."""
    if v.device.type == "cpu":
        return neddf_epilogue_plain(v, j, wd, wa, b2, scal, density_act)
    if v.device.type != "cuda":
        raise ValueError(f"neddf_epilogue: unsupported device {v.device}")
    _check_kernel_args(v, j, wd, wa, b2, scal, density_act)
    m, c = v.shape
    out = torch.empty((N_OUT, m), dtype=torch.float32, device=v.device)
    t_feat = torch.empty_like(v)
    if m == 0:
        return out, t_feat
    lib = _build.library()
    code = lib.neddf_epilogue_fwd(
        _KERNEL_DTYPES[v.dtype], _ACT_CODES[density_act], c, m, v.data_ptr(), j.data_ptr(),
        wd.data_ptr(),
        wa.data_ptr(), b2.data_ptr(), scal.data_ptr(), out.data_ptr(),
        t_feat.data_ptr(), _build.stream(v.device))
    _build.check(code, "neddf_epilogue")
    neddf_epilogue.launches += 1
    return out, t_feat


neddf_epilogue.launches = 0


def _bwd_cotangents(what, v, g_out, g_tfeat):
    m, c = v.shape
    g_out = g_out.float().contiguous()
    g_tfeat = g_tfeat.to(v.dtype).contiguous()
    if tuple(g_out.shape) != (N_OUT, m) or tuple(g_tfeat.shape) != (m, c):
        raise ValueError(f"{what}: cotangent shapes")
    return g_out, g_tfeat


def _launch_bwd(what, v, j, wd, wa, b2, scal, g_out, g_tfeat, out_v, out_t, act=0,
                g_col=None, z=None, *, density_act) -> Tensor:
    """One launch of ``csrc/neddf_epilogue.cu``'s backward (the top mode
    when ``z`` is given) over v's M > 0 rows: its outputs into out_v and
    out_t; returns the fixed-order sums [dwd, dwa, db2 (, the top db)]."""
    m, c = v.shape
    top = z is not None
    lib = _build.library()
    dt = _KERNEL_DTYPES[v.dtype]
    blocks = ctypes.c_int(0)
    stream = _build.stream(v.device)
    _build.check(lib.neddf_epilogue_bwd_blocks(dt, act, int(top), c, m,
                                               ctypes.byref(blocks)), f"{what} blocks")
    width = 2 * c + 2 + (c if top else 0)
    parts = torch.empty((blocks.value, width), dtype=torch.float32, device=v.device)
    red = torch.empty(width, dtype=torch.float32, device=v.device)
    _build.check(lib.neddf_epilogue_bwd(
        dt, act, _ACT_CODES[density_act], int(top), c, m, blocks.value, v.data_ptr(),
        j.data_ptr(), wd.data_ptr(),
        wa.data_ptr(), b2.data_ptr(), scal.data_ptr(), g_out.data_ptr(),
        g_tfeat.data_ptr(), None if g_col is None else g_col.data_ptr(),
        None if z is None else z.data_ptr(), out_v.data_ptr(), out_t.data_ptr(),
        parts.data_ptr(), red.data_ptr(), stream), what)
    return red


def neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_tfeat, density_act):
    """Epilogue backward: the CUDA kernel (its standalone mode) for CUDA
    tensors, the plain version for CPU tensors (see
    ``neddf_epilogue_bwd_plain``)."""
    if v.device.type == "cpu":
        return neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_tfeat, density_act)
    if v.device.type != "cuda":
        raise ValueError(f"neddf_epilogue_bwd: unsupported device {v.device}")
    _check_kernel_args(v, j, wd, wa, b2, scal, density_act)
    m, c = v.shape
    g_out, g_tfeat = _bwd_cotangents("neddf_epilogue_bwd", v, g_out, g_tfeat)
    dv, dj = torch.empty_like(v), torch.empty_like(j)
    if m == 0:
        red = torch.zeros(2 * c + 2, dtype=torch.float32, device=v.device)
    else:
        red = _launch_bwd("neddf_epilogue_bwd", v, j, wd, wa, b2, scal, g_out, g_tfeat,
                          dv, dj, density_act=density_act)
        neddf_epilogue_bwd.launches += 1
    return dv, dj, red[:c], red[c : 2 * c], red[2 * c :]


neddf_epilogue_bwd.launches = 0


def neddf_epilogue_gstack_plain(v, j, wd, wa, b2, scal, g_out, g_tfeat, g_col, z, act_name,
                                density_act):
    """Plain version of the backward's top mode: the epilogue's VJP
    (``neddf_epilogue_bwd_plain``), then the add of the colour trunk's
    cotangent of v_feat in v's dtype, as autograd adds a tensor's two
    cotangents, then the K=3 trunk's top-layer stacked cotangent
    (``DualProductsPlain.gstack``).

    Args:
        v, j, wd, wa, b2, scal, g_out, g_tfeat: as ``neddf_epilogue_bwd_plain``.
        g_col: [M, C] the colour trunk's cotangent of v_feat.
        z: [4, M, C] the trunk's top-layer stash (v's dtype); only z[0]
            is read where f'' is identically zero.
        act_name: the trunk's activation; density_act: the density's.

    Returns:
        (gs [4, M, C] in v's dtype, dwd [C], dwa [C], db2 [2], the top
        layer's db [C], f32).
    """
    neddf_epilogue_gstack_plain.calls += 1
    dv, dj, dwd, dwa, db2 = neddf_epilogue_bwd_plain(v, j, wd, wa, b2, scal, g_out, g_tfeat,
                                                     density_act)
    gv = dv + g_col.to(dv.dtype)
    gs, db = DualProductsPlain(v.dtype).gstack(gv, dj, z, act_name)
    return gs, dwd, dwa, db2, db


neddf_epilogue_gstack_plain.calls = 0


def neddf_epilogue_gstack(v, j, wd, wa, b2, scal, g_out, g_tfeat, g_col, z, act_name,
                          density_act):
    """The epilogue's backward with the K=3 trunk's top layer (the
    kernel's top mode): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see ``neddf_epilogue_gstack_plain``)."""
    if v.device.type == "cpu":
        return neddf_epilogue_gstack_plain(v, j, wd, wa, b2, scal, g_out, g_tfeat, g_col, z,
                                           act_name, density_act)
    if v.device.type != "cuda":
        raise ValueError(f"neddf_epilogue_gstack: unsupported device {v.device}")
    what = "neddf_epilogue_gstack"
    _check_kernel_args(v, j, wd, wa, b2, scal, density_act, top=True)
    if act_name not in _ACT_CODES:
        raise NotImplementedError(f"CUDA {what} kernel: activation {act_name!r}")
    m, c = v.shape
    g_out, g_tfeat = _bwd_cotangents(what, v, g_out, g_tfeat)
    g_col = g_col.to(v.dtype).contiguous()
    if tuple(g_col.shape) != (m, c) or tuple(z.shape) != (4, m, c):
        raise ValueError(f"{what}: g_col {tuple(g_col.shape)} / stash {tuple(z.shape)}")
    if z.dtype != v.dtype or z.device != v.device or not z.is_contiguous():
        raise ValueError(f"{what}: stash dtype, device or layout")
    gs = torch.empty((4, m, c), dtype=v.dtype, device=v.device)
    if m == 0:
        red = torch.zeros(3 * c + 2, dtype=torch.float32, device=v.device)
    else:
        red = _launch_bwd(what, v, j, wd, wa, b2, scal, g_out, g_tfeat, gs[0], gs[1:],
                          _ACT_CODES[act_name], g_col, z, density_act=density_act)
        neddf_epilogue_gstack.launches += 1
    return gs, red[:c], red[c : 2 * c], red[2 * c : 2 * c + 2], red[2 * c + 2 :]


neddf_epilogue_gstack.launches = 0


class NeDDFEpilogue(torch.autograd.Function):
    """``neddf_epilogue`` with its hand-written backward (``_epi_fwd`` /
    ``_epi_bwd``). ``apply((use_kernels, density_act), v, j, wd, wa, b2,
    scal)``; ``use_kernels=False`` runs the plain versions on any device.
    The scalars ``scal`` get no gradient."""

    @staticmethod
    def forward(ctx, config, v, j, wd, wa, b2, scal):
        use_kernels, density_act = config
        args = (v, j, wd.float().contiguous(), wa.float().contiguous(),
                b2.float().contiguous(), scal)
        ctx.config = config
        ctx.save_for_backward(*args)
        fwd = neddf_epilogue if use_kernels else neddf_epilogue_plain
        return fwd(*args, density_act)

    @staticmethod
    def backward(ctx, g_out, g_tfeat):
        args = ctx.saved_tensors
        use_kernels, density_act = ctx.config
        bwd = neddf_epilogue_bwd if use_kernels else neddf_epilogue_bwd_plain
        dv, dj, dwd, dwa, db2 = bwd(*args, g_out, g_tfeat, density_act)
        return None, dv, dj, dwd, dwa, db2, None


class DDFTrunkEpilogue(torch.autograd.Function):
    """The NeDDF distance trunk (the K=3 dual MLP with its stash,
    ``kernels/dual_mlp.py``) and the epilogue forward in one op, whose
    backward runs the epilogue's VJP together with the trunk's top layer
    (``neddf_epilogue_gstack``) and continues the trunk's backward from
    the stacked cotangent it writes (``dual_mlp_seg_bwd`` with ``top``).

    ``apply(config, emb_v, emb_j, wd, wa, b2, scal, *weights, *biases)``
    with ``config = (layout, act_name, compute_dtype, use_kernels,
    density_act)`` (density_act: the density's activation):
    emb_v [M, C0] and emb_j [3, M, C0] the trunk's input in the compute
    dtype, wd and wa [C] the head weights, b2 [2], scal [8] (no
    gradient), the trunk's f32 master weights and biases (cast to the
    compute dtype inside; dW and db come back f32). ``use_kernels=False``
    runs the plain versions on any device; ``True`` lets the wrappers
    choose by device. Returns (v_feat [M, C] in the compute dtype, out
    [10, M] f32, t_feat [M, C]); v_feat's cotangent is the colour trunk's.
    """

    @staticmethod
    def forward(ctx, config, emb_v, emb_j, wd, wa, b2, scal, *params):
        layout, act_name, cd, use_kernels, dens = config
        n_l = len(layout)
        weights = [w.to(cd).contiguous() for w in params[:n_l]]
        biases = [b.float().contiguous() for b in params[n_l:]]
        head = (wd.float().contiguous(), wa.float().contiguous(), b2.float().contiguous(), scal)
        stash = any(ctx.needs_input_grad[1:])
        if use_kernels:
            trunk = dual_mlp_trunk(emb_v, emb_j, weights, biases, layout, act_name, stash)
        else:
            trunk = dual_mlp_seg_plain([emb_v], [emb_j], weights, biases, layout, act_name,
                                       (True,), 3, stash)
        v, j = trunk[0], trunk[1]
        out, t_feat = (neddf_epilogue if use_kernels else neddf_epilogue_plain)(v, j, *head,
                                                                                 dens)
        if stash:
            ctx.config = config
            ctx.save_for_backward(emb_v, emb_j, v, j, *head, *weights, *trunk[2])
        return v, out, t_feat

    @staticmethod
    def backward(ctx, g_vfeat, g_out, g_tfeat):
        layout, act_name, cd, use_kernels, dens = ctx.config
        n_l = len(layout)
        emb_v, emb_j, v, j, wd, wa, b2, scal, *rest = ctx.saved_tensors
        weights, pres = rest[:n_l], rest[n_l:]
        top = neddf_epilogue_gstack if use_kernels else neddf_epilogue_gstack_plain
        gs, dwd, dwa, db2, db_top = top(v, j, wd, wa, b2, scal, g_out, g_tfeat,
                                        g_vfeat.to(cd).contiguous(), pres[-1], act_name, dens)
        bwd = dual_mlp_seg_bwd if use_kernels else dual_mlp_seg_bwd_plain
        dvs, djs, dws, dbs = bwd([emb_v], [emb_j], weights, layout, act_name, (True,), pres,
                                 None, None, top=(gs, db_top))
        return (None, dvs[0], djs[0], dwd, dwa, db2, None, *dws, *dbs)
