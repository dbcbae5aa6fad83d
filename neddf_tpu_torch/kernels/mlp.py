"""Multi-segment value-only MLP: CUDA kernel wrappers, their plain
versions and the autograd op.

Port of ``neddf_tpu/kernels/mlp.py::mlp_seg``: layer 0 consumes
``concat(vs)`` as split weight rows, every layer is dense + activation,
and a post-skip layer (``layout[l]``) consumes ``[h, seg0]`` (NeRF/NeuS
order: the hidden rows of W first, then segment 0's).

* ``mlp_seg`` launches ``csrc/mlp_fwd.cu`` for CUDA tensors: the NeDDF
  eval colour trunk (tanhExp), the NeRF trunk (ReLU, one post-skip layer)
  and the NeuS colour trunk (ReLU, a 3-wide last layer, which the wrapper
  pads to the hidden width with zero columns and slices off), at any
  width up to 512 and with any of the five activations. With ``stash=True`` it also
  returns every layer's pre-activation ``[M, C_l]`` rounded to the
  compute dtype, as the Pallas forward's stash variant does.
* ``mlp_seg_bwd`` runs the Pallas ``_bwd_kernel`` from the stash as the
  walk ``mlp_seg_bwd_route`` over the hand-written products of
  ``csrc/route_products.cu`` (``MLPProducts``): the top layer's
  cotangent by ``csrc/mlp_bwd.cu``'s gpre, every lower one in the
  epilogue of the nt product that forms it, each layer's input f(z) in
  the prologue of its dW product; dW and db summed in a fixed order.
* ``MLPSeg`` is the ``torch.autograd.Function`` over both: f32 master
  weights cast to the compute dtype inside, f32 dW/db back.
* ``mlp_seg_layers`` / ``MLPLayers``: the value-only per-layer route (the
  NeDDF eval colour trunk, NeRF's trunk and NeuS's colour trunk under
  tensor parallelism, past width 512 or past the fused kernel's depth),
  the walk of ``kernels/dual_mlp.py`` with one stream: ``Products.layer_fwd``
  (``csrc/layer_fwd.cu``) per layer (a post-skip layer's ``[h, seg0]`` as two K segments, a
  narrow last layer whole on every rank), and backward ``gpre`` on the
  f32 cotangent after each reduce-scatter, the tn and nt products per
  layer.

For a CPU tensor each wrapper runs its plain version (``*_plain``); for a
CUDA tensor it launches its kernels or raises. There is no fallback.

Numerics (the Pallas kernels' under their matmul dtype T): operands in T,
products summed in f32, f32 bias and activations, rounded to T between
layers; the stash is T; the backward rounds gpre = g f'(z) to T before
both products, recomputes a layer's input as f(T(z)) rounded to T, and
keeps the cotangent between layers in f32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.kernels.dual_mlp import (
    _ACT_CODES,
    _DB_ROWS,
    Products,
    ProductsPlain,
    count_tile_launch,
    plan_refusal,
    tile_fwd_plan,
    tile_launch,
    width_refusal,
)
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_MAX_SEGMENTS = 4
_KERNEL_MAX_LAYERS = 12
_SPLIT_HIDDEN_FIRST = 2  # csrc/mlp_tile.cuh kSplitHiddenFirst


def mlp_seg_plain(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
    stash: bool = False,
):
    """Plain PyTorch version of the kernel (same signature).

    Args:
        vs: input segments, each [M, w_i], one dtype T (bf16 or f32).
        weights: per layer [fan_in, C_l] in T; biases: [C_l] f32.
        layout: per layer, True if it consumes ``[h, seg0]`` (post-skip).
        act_name: activation of every layer, the last one included.
        stash: also return the per-layer pre-activations [M, C_l] in T.

    Returns:
        [M, C_last] in T, and the list of stashes when ``stash``.
    """
    mlp_seg_plain.calls += 1
    f = ACTIVATION_TRIPLES[act_name][0]
    dtype = vs[0].dtype
    seg0 = vs[0].float()
    h = torch.cat(list(vs), dim=-1).float()
    pres = []
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li > 0 and layout[li]:
            h = torch.cat([h, seg0], dim=-1)
        z = h @ w.float() + b.float()
        if stash:
            pres.append(z.to(dtype))
        h = f(z).to(dtype).float()
    out = h.to(dtype)
    return (out, pres) if stash else out


mlp_seg_plain.calls = 0


def mlp_seg_bwd_plain(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    pres: Sequence[Tensor],
    g: Tensor,
):
    """Plain version of ``mlp_seg_bwd`` (``_bwd_kernel:103-182``).

    Args:
        vs, weights, layout, act_name: as in the forward (weights in T).
        pres: the forward's stash, per layer [M, C_l] in T.
        g: [M, C_last] output cotangent.

    Returns:
        (dvs per segment [M, w_i] in T, dW per layer [fan_in, C_l] f32,
        db per layer [C_l] f32).
    """
    mlp_seg_bwd_plain.calls += 1
    f, df, _ = ACTIVATION_TRIPLES[act_name]
    dtype = vs[0].dtype
    seg0 = vs[0].float()
    g = g.float()
    g_skip = None
    dws: List[Tensor] = [None] * len(weights)  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * len(weights)  # type: ignore[list-item]
    dvs: List[Tensor] = []
    for li in reversed(range(len(weights))):
        w = weights[li].float()
        gpre = g * df(pres[li].float())
        dbs[li] = gpre.sum(dim=0)
        gq = gpre.to(dtype).float()
        if li == 0:
            blocks, off = [], 0
            for i, v in enumerate(vs):
                rows = w[off : off + v.shape[1]]
                off += v.shape[1]
                d_in = gq @ rows.T
                if i == 0 and g_skip is not None:
                    d_in = d_in + g_skip
                dvs.append(d_in.to(dtype))
                blocks.append(v.float().T @ gq)
            dws[0] = torch.cat(blocks, dim=0)
            continue
        h_in = f(pres[li - 1].float()).to(dtype).float()
        c = h_in.shape[1]
        if layout[li]:
            skip = gq @ w[c:].T
            g_skip = skip if g_skip is None else g_skip + skip
            dws[li] = torch.cat([h_in.T @ gq, seg0.T @ gq], dim=0)
            g = gq @ w[:c].T
        else:
            dws[li] = h_in.T @ gq
            g = gq @ w.T
    return dvs, dws, dbs


mlp_seg_bwd_plain.calls = 0


def kernel_refusal(act_name: str, width: int, n_layers: int,
                   n_segments: int = 1, itemsize: Optional[int] = None,
                   seg_widths: Optional[Sequence[int]] = None,
                   layout: Optional[Sequence[bool]] = None,
                   last_width: Optional[int] = None) -> Optional[str]:
    """What of a configuration the CUDA kernels do not take (None: they
    take it): ``_check_kernel_args`` raises NotImplementedError on it. With
    the operand size ``itemsize`` (2 bf16, 4 f32), the input segments'
    widths ``seg_widths``, the post-skip ``layout`` ([h, seg0]) and the last
    layer's width it also refuses a trunk whose row-tile forward plan
    (``dual_mlp.tile_fwd_plan``) does not fit the shared memory."""
    if act_name not in _ACT_CODES:
        return f"activation {act_name!r}"
    if (refusal := width_refusal(width)) is not None:
        return refusal
    if not 1 <= n_layers <= _KERNEL_MAX_LAYERS:
        return f"{n_layers} layers"
    if not 1 <= n_segments <= _KERNEL_MAX_SEGMENTS:
        return f"{n_segments} segments"
    if seg_widths is None or itemsize not in (2, 4):
        return None
    split = [_SPLIT_HIDDEN_FIRST if s else 0 for s in (layout or (False,) * n_layers)]
    return plan_refusal(lambda: tile_fwd_plan(itemsize, 0, width, seg_widths, split, last_width))


def _check_kernel_args(vs, weights, biases, layout, act_name) -> None:
    what = "CUDA mlp_seg kernel"
    refusal = kernel_refusal(act_name, weights[0].shape[1] if weights else 0, len(weights),
                             len(vs))
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")
    if len(biases) != len(weights):
        raise ValueError(f"{what}: {len(weights)} layers")
    if len(layout) != len(weights) or layout[0]:
        raise ValueError(f"{what}: layout {tuple(layout)}")
    dtype, m = vs[0].dtype, vs[0].shape[0]
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: dtype {dtype}")
    for v in vs:
        if v.dim() != 2 or v.shape[0] != m or v.dtype != dtype:
            raise ValueError(f"{what}: segment {tuple(v.shape)} {v.dtype}")
    width = weights[0].shape[1]
    c0 = vs[0].shape[1]
    for li, (w, b) in enumerate(zip(weights, biases)):
        fan_in = sum(v.shape[1] for v in vs) if li == 0 else width + c0 * bool(layout[li])
        # every layer is `width` wide but the last, which may be narrower
        out_ok = w.shape[1] == width or (li == len(weights) - 1 and 1 <= w.shape[1] < width)
        if w.dim() != 2 or w.shape[0] != fan_in or not out_ok or tuple(b.shape) != (w.shape[1],):
            raise ValueError(
                f"{what}: layer {li} w {tuple(w.shape)} b {tuple(b.shape)}, "
                f"expected ({fan_in}, {width})"
            )
        if w.dtype != dtype or b.dtype != torch.float32:
            raise TypeError(f"{what}: layer {li} dtypes {w.dtype}/{b.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"{what}: layer {li} weight not 16-byte aligned")
    for t in (*vs, *weights, *biases):
        if t.device != vs[0].device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input")
    refusal = kernel_refusal(act_name, width, len(weights), len(vs), itemsize=dtype.itemsize,
                             seg_widths=[v.shape[1] for v in vs], layout=layout,
                             last_width=weights[-1].shape[1])
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")


def mlp_seg(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
    stash: bool = False,
):
    """MLP forward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see ``mlp_seg_plain`` for the arguments)."""
    device = vs[0].device
    if device.type == "cpu":
        return mlp_seg_plain(vs, weights, biases, layout, act_name, stash)
    if device.type != "cuda":
        raise ValueError(f"mlp_seg: unsupported device {device}")
    _check_kernel_args(vs, weights, biases, layout, act_name)
    m, dtype = vs[0].shape[0], vs[0].dtype
    width = weights[0].shape[1]
    n_out = weights[-1].shape[1]  # the last layer may be narrower (NeuS's colour output)
    out = torch.empty((m, n_out), dtype=dtype, device=device)
    pres = [torch.empty((m, w.shape[1]), dtype=dtype, device=device)
            for w in weights] if stash else []
    if m:
        lib = _build.library()
        seg_w = [v.shape[1] for v in vs]
        split = [_SPLIT_HIDDEN_FIRST if s else 0 for s in layout]
        plan, scratch = tile_launch(dtype, 0, width, seg_w, split, n_out, m, device)
        code = lib.neddf_mlp_seg_fwd(
            _KERNEL_DTYPES[dtype], _ACT_CODES[act_name], width, n_out, m, len(vs),
            _build.pointers(vs), _build.ints(seg_w),
            len(weights), _build.pointers(weights), _build.pointers(biases),
            _build.ints(split), _build.pointers(pres) if stash else None,
            out.data_ptr(), plan, None if scratch is None else scratch.data_ptr(),
            _build.stream(device),
        )
        _build.check(code, "mlp_seg")
        mlp_seg.launches += 1
        count_tile_launch(dtype)
    return (out, pres) if stash else out


mlp_seg.launches = 0


def mlp_layer_launcher(dtype: torch.dtype, device: torch.device, use_kernels: bool):
    """The value-only per-layer route's launcher: ``MLPProducts`` (the
    kernels) for CUDA tensors under ``use_kernels``, else
    ``MLPProductsPlain``."""
    from neddf_tpu_torch.kernels.dual_mlp import layer_launcher

    return layer_launcher(dtype, device, use_kernels, (MLPProducts, MLPProductsPlain))


def mlp_seg_layers(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    act_name: str,
    use_kernels: bool,
    group=None,
    layout: Optional[Sequence[bool]] = None,
    whole_last: bool = False,
) -> Tensor:
    """The value-only per-layer route of ``mlp_seg`` over a width shard or
    a configuration the fused kernel refuses, without its backward (the
    eval trunks): the per-layer walk of ``kernels/dual_mlp.py`` with no tangent
    planes (S = 1), ``Products.layer_fwd`` per layer for CUDA tensors under
    ``use_kernels`` (its plain version otherwise), each layer's output
    gathered over the model group ``group`` (None: one shard); a post-skip
    layer (``layout``, default none) reads ``[h, seg0]``, and a
    ``whole_last`` layer (NeuS's 3-wide colour output) is whole on every
    rank. ``weights``/``biases`` are this rank's column shards in the
    compute dtype / f32. Returns [M, W]."""
    from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_layers_walk

    layout = (False,) * len(weights) if layout is None else tuple(layout)
    k = mlp_layer_launcher(vs[0].dtype, vs[0].device, use_kernels)
    full, _, _ = dual_mlp_layers_walk(vs, [], weights, biases, layout, act_name,
                                      (False,) * len(vs), 0, k, group, hidden_first=True,
                                      whole_last=whole_last)
    if isinstance(k, MLPProducts):
        mlp_seg_layers.launches += 1
    return full[0]


# calls of the value-only route that ran its kernels (the eval walk, and
# the forward and backward of MLPLayers: one each)
mlp_seg_layers.launches = 0


# launches of the cotangent kernel (csrc/mlp_bwd.cu), the one elementwise
# pass the backwards of this module and of sdf_mlp.py run beside their
# products: the top layer's, and on the per-layer routes every layer's
# after its reduce-scatter (and the sdf sweep's steps)
PASS_LAUNCHES = {"gpre": 0}


class MLPProducts(Products):
    """``dual_mlp.Products`` and the top layer's cotangent ``gpre``."""

    def gpre(self, g: Tensor, z: Tensor, act_name: str, add: Optional[Tensor] = None,
             db: bool = True):
        """The top layer's cotangent, and on the per-layer route every
        layer's after its reduce-scatter: (T(g f'(z) + add) [M, n], its
        column sums [n] f32, or None without ``db``), g and add f32, z in
        T."""
        m, n = z.shape
        gs = self._empty((m, n), self.dtype)
        parts = self._empty((-(-m // _DB_ROWS), n)) if db else None
        _build.check(self.lib.neddf_mlp_bwd_gpre(
            self.dt, _ACT_CODES[act_name], n, m, _DB_ROWS, g.data_ptr(), z.data_ptr(),
            None if add is None else add.data_ptr(), gs.data_ptr(),
            None if parts is None else parts.data_ptr(), self.stream), "backward gpre")
        PASS_LAUNCHES["gpre"] += 1
        return gs, self.sum_rows(parts) if db else None


class MLPProductsPlain(ProductsPlain):
    """The plain version of ``MLPProducts``."""

    def gpre(self, g, z, act_name, add=None, db=True):
        v = g.float() * ACTIVATION_TRIPLES[act_name][1](z.float())
        if add is not None:
            v = v + add
        self.planes.append("gpre")
        return v.to(self.dtype), v.sum(dim=0) if db else None


def mlp_seg_bwd_route(vs, weights, layout, act_name, pres, g, k):
    """The kernels' walk of the backward over the launcher ``k``
    (``MLPProducts`` on the card, ``MLPProductsPlain`` in the CPU tests),
    as ``mlp_seg_bwd_plain`` computes it: the top layer's
    gpre = T(g f'(z)) by its own kernel; then per layer, in reverse, dW =
    f(z_{l-1})^T gpre (the activation as the tn product's prologue) and
    gpre W^T over all of W's rows with the epilogue gpre_{l-1} = T(. f'(z_{l-1}))
    and its column sums (db); a post-skip layer's seg0 columns leave raw
    for layer 0's first segment."""
    dtype = vs[0].dtype
    n_layers = len(weights)
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dvs: List[Tensor] = []
    gs, dbs[-1] = k.gpre(g.float(), pres[-1], act_name)
    g_skip = None
    for li in reversed(range(n_layers)):
        w = weights[li]
        if li == 0:
            blocks, off = [], 0
            for i, v in enumerate(vs):
                rows = w[off : off + v.shape[1]]
                off += v.shape[1]
                d_in = k.nt(gs, rows)
                if i == 0 and g_skip is not None:
                    d_in += g_skip
                dvs.append(d_in.to(dtype))
                blocks.append(k.tn(v, gs))
            dws[0] = torch.cat(blocks, dim=0)
            break
        c = pres[li - 1].shape[1]
        dws[li] = k.tn_act(pres[li - 1], gs, act_name)
        if layout[li]:
            dws[li] = torch.cat([dws[li], k.tn(vs[0], gs)], dim=0)
        gs, skip, _, dbs[li - 1] = k.nt_act(gs, w, pres[li - 1], act_name, n_act=c, db=True)
        if skip is not None:
            g_skip = skip if g_skip is None else g_skip + skip
    return dvs, dws, dbs


def mlp_seg_bwd(
    vs: Sequence[Tensor],
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    pres: Sequence[Tensor],
    g: Tensor,
):
    """MLP backward: the CUDA kernels for CUDA tensors
    (``mlp_seg_bwd_route`` over ``MLPProducts``: the activations folded into
    the f32-accumulating products, dW and db split into a fixed number of
    partials summed in a fixed order, bitwise reproducible), the plain
    version for CPU tensors (see ``mlp_seg_bwd_plain``)."""
    device = vs[0].device
    if device.type == "cpu":
        return mlp_seg_bwd_plain(vs, weights, layout, act_name, pres, g)
    if device.type != "cuda":
        raise ValueError(f"mlp_seg_bwd: unsupported device {device}")
    biases = [torch.empty(w.shape[1], device=device) for w in weights]
    _check_kernel_args(vs, weights, biases, layout, act_name)
    dtype = vs[0].dtype
    m = vs[0].shape[0]
    if len(pres) != len(weights) or tuple(g.shape) != (m, weights[-1].shape[1]) or any(
            tuple(p.shape) != (m, w.shape[1]) for p, w in zip(pres, weights)):
        raise ValueError("mlp_seg_bwd: stash/cotangent shapes")
    for t in pres:
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError("mlp_seg_bwd: stash dtype, layout or device")
    out = mlp_seg_bwd_route(vs, weights, layout, act_name, pres, g.contiguous(),
                            MLPProducts(dtype, device))
    mlp_seg_bwd.launches += 1
    return out


mlp_seg_bwd.launches = 0


class MLPSeg(torch.autograd.Function):
    """``mlp_seg`` with its hand-written backward (``_mlp_fwd`` /
    ``_mlp_bwd:331-352``).

    ``apply(config, *vs, *weights, *biases)`` with ``config = (layout,
    act_name, compute_dtype, use_kernels)``. ``weights``/``biases`` are
    the f32 master parameters: the weights are cast to ``compute_dtype``
    inside, dW and db come back in f32. ``use_kernels=False`` runs the
    plain versions on any device; ``True`` lets the wrappers choose by
    device (kernels on CUDA). Returns [M, C_last] in the compute dtype.
    """

    @staticmethod
    def forward(ctx, config, *args):
        layout, act_name, cd, use_kernels = config
        n_l = len(layout)
        n_seg = len(args) - 2 * n_l
        vs = args[:n_seg]
        weights = [w.to(cd).contiguous() for w in args[n_seg : n_seg + n_l]]
        biases = [b.float().contiguous() for b in args[n_seg + n_l :]]
        fwd = mlp_seg if use_kernels else mlp_seg_plain
        if not any(ctx.needs_input_grad[1:]):
            return fwd(vs, weights, biases, layout, act_name)
        out, pres = fwd(vs, weights, biases, layout, act_name, stash=True)
        ctx.config = config
        ctx.n_seg = n_seg
        ctx.save_for_backward(*vs, *weights, *pres)
        return out

    @staticmethod
    def backward(ctx, g):
        layout, act_name, cd, use_kernels = ctx.config
        saved = ctx.saved_tensors
        n_seg, n_l = ctx.n_seg, len(layout)
        vs = saved[:n_seg]
        weights = saved[n_seg : n_seg + n_l]
        pres = saved[n_seg + n_l :]
        bwd = mlp_seg_bwd if use_kernels else mlp_seg_bwd_plain
        dvs, dws, dbs = bwd(vs, weights, layout, act_name, pres, g.to(cd).contiguous())
        return (None, *dvs, *dws, *dbs)


def mlp_apply(vs, weights, biases, layout, act_name, compute_dtype, use_kernels):
    """Differentiable ``mlp_seg`` (see ``MLPSeg``)."""
    config = (tuple(layout), act_name, compute_dtype, use_kernels)
    return MLPSeg.apply(config, *vs, *weights, *biases)


class MLPLayers(torch.autograd.Function):
    """The value-only per-layer route as an autograd op, beside
    ``dual_mlp.DualMLPLayers``: the route of NeRF's trunk and NeuS's colour
    trunk under tensor parallelism and past the fused kernel's width or depth
    (``dual_mlp_layers_walk`` / ``dual_mlp_layers_bwd`` with one stream,
    a post-skip layer reading ``[h, seg0]``).

    ``apply(config, *vs, *weights, *biases)`` with ``config = (layout,
    act_name, compute_dtype, use_kernels, group, whole_last)``;
    ``weights``/``biases`` this rank's f32 master column shards (cast to
    the compute dtype inside; dW and db come back f32), a ``whole_last``
    layer whole on every rank, ``group`` the model group (None: one
    shard). Returns the gathered output [M, W] in the compute dtype."""

    @staticmethod
    def forward(ctx, config, *args):
        from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_layers_walk

        layout, act_name, cd, use_kernels, group, whole_last = config
        n_l = len(layout)
        n_seg = len(args) - 2 * n_l
        vs = args[:n_seg]
        weights = [w.to(cd).contiguous() for w in args[n_seg : n_seg + n_l]]
        biases = [b.float().contiguous() for b in args[n_seg + n_l :]]
        k = mlp_layer_launcher(cd, vs[0].device, use_kernels)
        stash = any(ctx.needs_input_grad[1:])
        full, inputs, pres = dual_mlp_layers_walk(
            vs, [], weights, biases, layout, act_name, (False,) * n_seg, 0, k, group, stash,
            hidden_first=True, whole_last=whole_last)
        if isinstance(k, MLPProducts):
            mlp_seg_layers.launches += 1
        if stash:
            ctx.config = config
            ctx.seg_widths = [v.shape[1] for v in vs]
            ctx.n_inputs = [len(x) for x in inputs]
            ctx.save_for_backward(*weights, *pres, *[t for x in inputs for t in x])
        return full[0]

    @staticmethod
    def backward(ctx, g):
        from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_layers_bwd, saved_route

        layout, act_name, cd, use_kernels, group, whole_last = ctx.config
        weights, pres, inputs = saved_route(ctx, len(layout))
        k = mlp_layer_launcher(cd, g.device, use_kernels)
        dvs, _, dws, dbs = dual_mlp_layers_bwd(
            inputs, weights, layout, act_name, ctx.seg_widths, (False,) * len(ctx.seg_widths),
            pres, g[None], k, group, hidden_first=True, whole_last=whole_last)
        if isinstance(k, MLPProducts):
            mlp_seg_layers.launches += 1
        return (None, *dvs, *dws, *dbs)


def mlp_layers_apply(vs, weights, biases, layout, act_name, compute_dtype, use_kernels,
                     group=None, whole_last=False):
    """Differentiable value-only per-layer route (see ``MLPLayers``)."""
    config = (tuple(layout), act_name, compute_dtype, use_kernels, group, whole_last)
    return MLPLayers.apply(config, *vs, *weights, *biases)
