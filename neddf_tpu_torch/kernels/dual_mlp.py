"""Dual-MLP: CUDA kernel wrappers, their plain versions and the autograd op.

Port of ``neddf_tpu/kernels/dual_mlp.py::dual_mlp_seg``: a value stream
``v [M, C]`` and K tangent planes ``j [K, M, C]`` go through L dense
layers; layer 0 reads several input segments as split weight rows
(segments without tangents contribute zeros to the tangent rows), and a
post-skip layer consumes ``[seg0, h]`` (NeDDF order). Each layer
computes ``z = h W + b`` on the stacked streams, then ``f(z_v)`` for the
values and ``f'(z_v) * z_t`` for the tangents.

* ``dual_mlp_trunk`` (K=3, one segment: the distance trunk) and
  ``dual_mlp_seg`` (K in {1, 3}, up to 4 segments: the colour trunk's
  K=1 training configuration) launch ``csrc/dual_mlp_fwd.cu`` for CUDA
  tensors. With ``stash=True`` they also return every layer's
  pre-activation stack ``[K+1, M, C]`` rounded to the compute dtype, as
  the Pallas forward stashes it for its backward (``dual_mlp.py:570-580``).
* ``dual_mlp_seg_bwd`` launches ``csrc/dual_mlp_bwd.cu``: the dual chain
  rule in reverse, with the f'' coupling, from the stash.
* ``DualMLPSeg`` is the ``torch.autograd.Function`` over both: it takes
  f32 master weights, casts them to the compute dtype inside, and
  returns f32 dW/db (``_seg_bwd:1224-1225``).
* The per-layer route (``dual_mlp_layers``, ``DualMLPLayers``): the same
  function one layer at a time, for a column shard of each layer under
  tensor parallelism and for the configurations the fused kernels refuse
  (widths over the tile forward's 512, more layers than they hold), at
  any width and depth. Each layer is one launch with the activation as
  its epilogue (``Products.layer_fwd``, ``csrc/layer_fwd.cu``: a
  bytes-bound kernel for outputs up to 32 wide, else wgmma fed by TMA,
  the streams grouped by point in a row tile; ``layer_fwd_plan``), layer
  0's segments and a post-skip layer's input as two K segments:
  ``[seg0, h]`` for NeDDF, ``[h, seg0]`` hidden first for the
  value-only walks of NeRF and NeuS), its output gathered over the model
  group before the next layer reads it (``parallel/tp.py``; a narrow
  last layer may be whole on every rank: NeuS's colour output); the
  backward per layer: ``gstack`` (one stream: ``gpre``) from the f32
  cotangent of the layer's shard, dW = x^T G (tn) over the layer's saved
  full-width input, and G W^T (nt), whose partial sum is reduce-scattered
  before the layer below.

For a CPU tensor each wrapper runs its plain version (``*_plain``), the
same arithmetic in torch ops; for a CUDA tensor it launches its kernel
or raises. There is no fallback from one to the other.

Numerics (the Pallas kernels' under their matmul dtype): operands in
the compute dtype T (bf16 or f32), products summed in f32, the f32 bias
on the value rows, activations in f32 and rounded to T between layers;
the stash is T; the backward rounds its stacked cotangent to T before
both products, recomputes a layer's input as f(T(z)) rounded to T, and
sums in f32.
"""
from __future__ import annotations

import functools
import time
from typing import List, Optional, Sequence, Tuple

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES, SECOND_DERIVATIVE_ZERO

Tensor = torch.Tensor

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_N_TAN = (3,)
_SEG_N_TAN = (1, 3)
# the widest layer the kernels take: csrc/mlp_tile.cuh instantiates the
# width classes 64, 128, 256 and 512, a width runs on the next class up
KERNEL_MAX_WIDTH = 512
# stream counts S = K+1 of the per-layer forward (csrc/layer_fwd.cu): the
# K=3 and K=1 dual trunks and the value-only MLP
_ROUTE_STREAMS = (1, 2, 4)
_KERNEL_MAX_LAYERS = 8
_KERNEL_MAX_SEGMENTS = 4
# the row-tile forward's most layers (csrc/mlp_tile.cuh kMaxLayers)
_KERNEL_MAX_LAYERS_TILE = 12
# the SMs of an H100 SXM: the default card of the launch plans
H100_SMS = 132
# the kernels' activations (csrc/mlp_tile.cuh: kTanhExp, kReLU, kLeakyReLU,
# kSoftplus, kSigmoid)
_ACT_CODES = {"tanhExp": 0, "ReLU": 1, "LeakyReLU": 2, "Softplus": 3, "Sigmoid": 4}


def width_refusal(width: int) -> Optional[str]:
    """Why the kernels do not take a layer width (None: they take it):
    every width from 1 to ``KERNEL_MAX_WIDTH``."""
    if width > KERNEL_MAX_WIDTH:
        return f"width {width} > {KERNEL_MAX_WIDTH}"
    if width < 1:
        return f"width {width}"
    return None


# ---------------------------------------------------------------- plain math
def _stack(v: Tensor, j: Optional[Tensor], n_tan: int) -> Tensor:
    """[M, w] value + [K, M, w] tangents (zeros if None) -> [K+1, M, w]."""
    if j is None:
        j = torch.zeros((n_tan,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    return torch.cat([v[None], j], dim=0)


def _dual_act(z: Tensor, f, df) -> Tensor:
    """Stacked pre-activation [K+1, M, C] -> (f(z_v), f'(z_v) z_t)."""
    return torch.cat([f(z[:1]), df(z[:1]) * z[1:]], dim=0)


def _seg_js(js: Sequence[Tensor], has_j: Sequence[bool]) -> List[Optional[Tensor]]:
    """Per-segment tangent planes (None where a segment has none)."""
    if len(js) != sum(bool(h) for h in has_j):
        raise ValueError(f"{len(js)} tangent inputs for has_j {tuple(has_j)}")
    it = iter(js)
    return [next(it) if hj else None for hj in has_j]


def _forward_math(vs, js, weights, biases, layout, act_name, has_j, n_tan, stash):
    f, df, _ = ACTIVATION_TRIPLES[act_name]
    dtype = vs[0].dtype
    seg_j = _seg_js(js, has_j)
    x0 = torch.cat([_stack(v, j, n_tan) for v, j in zip(vs, seg_j)], dim=-1).float()
    seg0 = x0[..., : vs[0].shape[1]]
    h, pres = x0, []
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li > 0 and layout[li]:
            h = torch.cat([seg0, h], dim=-1)
        z = h @ w.float()
        z = torch.cat([z[:1] + b.float(), z[1:]], dim=0)
        if stash:
            pres.append(z.to(dtype))
        h = _dual_act(z, f, df).to(dtype).float()
    h = h.to(dtype)
    return h[0], h[1:], pres


def dual_mlp_trunk_plain(
    v0: Tensor,
    j0: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the trunk kernel (same signature).

    Args:
        v0: [M, C0] input values; j0: [K, M, C0] input tangent planes.
        weights: per layer [fan_in, C] in v0's dtype; biases: [C] f32.
        layout: per layer, True if it consumes ``[seg0, h]`` (post-skip).
        act_name: activation of every layer.

    Returns:
        (v [M, C], j [K, M, C]) in v0's dtype.
    """
    dual_mlp_trunk_plain.calls += 1
    v, j, _ = _forward_math([v0], [j0], weights, biases, layout, act_name, (True,),
                            j0.shape[0], False)
    return v, j


dual_mlp_trunk_plain.calls = 0


def dual_mlp_seg_plain(
    vs: Sequence[Tensor],
    js: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    has_j: Sequence[bool],
    n_tan: int,
    stash: bool = False,
):
    """Plain version of ``dual_mlp_seg`` (same arguments and results).

    Args:
        vs: per-segment values [M, w_i], one dtype T (bf16 or f32).
        js: tangent planes [K, M, w_i] of the segments with ``has_j``.
        weights: per layer [fan_in, C] in T; biases: [C] f32.
        layout: per layer, True if it consumes ``[seg0, h]``.
        act_name: activation of every layer; has_j: per segment.
        n_tan: K; stash: also return the per-layer pre-activations.

    Returns:
        (v [M, C], j [K, M, C]) in T, plus the list of stashes
        ``[K+1, M, C]`` (T) when ``stash``.
    """
    dual_mlp_seg_plain.calls += 1
    v, j, pres = _forward_math(vs, js, weights, biases, layout, act_name, has_j,
                               n_tan, stash)
    return (v, j, pres) if stash else (v, j)


dual_mlp_seg_plain.calls = 0


def dual_mlp_seg_bwd_plain(
    vs: Sequence[Tensor],
    js: Sequence[Tensor],
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    has_j: Sequence[bool],
    pres: Sequence[Tensor],
    gv: Optional[Tensor],
    gj: Optional[Tensor],
    top: Optional[Tuple[Tensor, Tensor]] = None,
):
    """Plain version of ``dual_mlp_seg_bwd`` (``_bwd_kernel:835-932``).

    Args:
        vs, js, weights, layout, act_name, has_j: as in the forward
            (weights in the compute dtype T).
        pres: the forward's stash, per layer [K+1, M, C] in T.
        gv: [M, C] and gj: [K, M, C] output cotangents (None with ``top``).
        top: the top layer's stacked cotangent [K+1, M, C] in T and its db
            [C] f32, formed by the caller (the epilogue's top mode):
            the walk starts from them instead of from gv and gj.

    Returns:
        (dvs per segment [M, w_i] in T, djs per tangent input
        [K, M, w_i] in T, dW per layer [fan_in, C] f32, db per layer
        [C] f32).
    """
    dual_mlp_seg_bwd_plain.calls += 1
    f, df, ddf = ACTIVATION_TRIPLES[act_name]
    dtype = vs[0].dtype
    n_tan = pres[-1].shape[0] - 1
    seg_j = _seg_js(js, has_j)
    widths = [v.shape[1] for v in vs]
    c0 = widths[0]
    g = None if top is not None else torch.cat([gv[None], gj], dim=0).float()
    g_skip = None
    stack0 = _stack(vs[0], seg_j[0], n_tan).float()
    dws: List[Tensor] = [None] * len(weights)  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * len(weights)  # type: ignore[list-item]
    dvs: List[Tensor] = []
    djs: List[Tensor] = []
    for li in reversed(range(len(weights))):
        w = weights[li].float()
        if g is None:
            gs, dbs[li] = top[0].float(), top[1]
        else:
            z = pres[li].float()
            d1, d2 = df(z[0]), ddf(z[0])
            gpre_v = g[0] * d1 + d2 * torch.sum(g[1:] * z[1:], dim=0)
            gs = torch.cat([gpre_v[None], g[1:] * d1], dim=0).to(dtype).float()
            dbs[li] = gpre_v.sum(dim=0)
        flat_g = gs.reshape(-1, gs.shape[-1])
        if li == 0:
            blocks, off = [], 0
            for i, (v, j, wi) in enumerate(zip(vs, seg_j, widths)):
                rows = w[off : off + wi]
                off += wi
                if has_j[i]:
                    d_in = gs @ rows.T
                    if i == 0 and g_skip is not None:
                        d_in = d_in + g_skip
                    dvs.append(d_in[0].to(dtype))
                    djs.append(d_in[1:].to(dtype))
                    seg = _stack(v, j, n_tan).float()
                    blocks.append(seg.reshape(-1, wi).T @ flat_g)
                else:
                    dvs.append((gs[0] @ rows.T).to(dtype))
                    blocks.append(v.float().T @ gs[0])
            dws[0] = torch.cat(blocks, dim=0)
            continue
        h_in = _dual_act(pres[li - 1].float(), f, df).to(dtype).float()
        flat_h = h_in.reshape(-1, h_in.shape[-1])
        if layout[li]:
            skip = gs @ w[:c0].T
            g_skip = skip if g_skip is None else g_skip + skip
            g = gs @ w[c0:].T
            dws[li] = torch.cat([stack0.reshape(-1, c0).T @ flat_g, flat_h.T @ flat_g], 0)
        else:
            g = gs @ w.T
            dws[li] = flat_h.T @ flat_g
    return dvs, djs, dws, dbs


dual_mlp_seg_bwd_plain.calls = 0


# ------------------------------------------------------------ CUDA wrappers
def kernel_refusal(act_name: str, width: int, n_layers: int, n_tan: int,
                   trunk: bool = True, *, itemsize: Optional[int] = None,
                   seg_widths: Optional[Sequence[int]] = None,
                   layout: Optional[Sequence[bool]] = None) -> Optional[str]:
    """What of a configuration the CUDA dual-MLP kernels do not take (None:
    they take it): the K=3 trunk (``trunk``) or the multi-segment
    configuration. With the operand size ``itemsize`` (2 bf16, 4 f32), the
    input segments' widths ``seg_widths`` and the post-skip ``layout``
    ([seg0, h]) it also refuses a trunk whose row-tile forward plan
    (``tile_fwd_plan``) does not fit the shared memory. The checks below
    raise NotImplementedError on it."""
    if act_name not in _ACT_CODES:
        return f"activation {act_name!r}"
    if (refusal := width_refusal(width)) is not None:
        return refusal
    if not 1 <= n_layers <= _KERNEL_MAX_LAYERS:
        return f"{n_layers} layers"
    if n_tan not in (_KERNEL_N_TAN if trunk else _SEG_N_TAN):
        return f"K={n_tan}"
    if seg_widths is None or itemsize not in _WIDE_BK:
        return None
    split = [SPLIT_SEG_FIRST if s else 0 for s in (layout or (False,) * n_layers)]
    return plan_refusal(lambda: tile_fwd_plan(itemsize, n_tan, width, seg_widths, split))


def plan_refusal(*plans) -> Optional[str]:
    """Why a fused kernel's launch plan does not fit (None: every plan
    fits): ``plans`` are callables that each make one plan or raise
    ValueError (``tile_fwd_plan``, ``sdf_mlp.sweep_plan``)."""
    for make in plans:
        try:
            make()
        except ValueError as err:
            return f"shared memory: {err}"
    return None


def route_refusal(act_name: str, width: int, n_tan: int) -> Optional[str]:
    """What of a configuration the per-layer route does not take (None: it
    takes it): ``width`` is the full (gathered) width of the layer, any
    from 1 up (its products, and the NeDDF epilogue that runs on its
    output, take any width), at any depth."""
    if act_name not in _ACT_CODES:
        return f"activation {act_name!r}"
    if width < 1:
        return f"width {width}"
    if n_tan + 1 not in _ROUTE_STREAMS:
        return f"K={n_tan}"
    return None


def _refuse(what: str, refusal: Optional[str]) -> None:
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")


def _check_kernel_args(v0, j0, weights, biases, layout, act_name) -> None:
    what = "CUDA trunk kernel"
    if v0.dtype not in _KERNEL_DTYPES or j0.dtype != v0.dtype:
        raise TypeError(f"{what}: dtypes {v0.dtype}/{j0.dtype}")
    if v0.dim() != 2 or j0.dim() != 3 or j0.shape[1:] != v0.shape:
        raise ValueError(f"{what}: shapes {tuple(v0.shape)} / {tuple(j0.shape)}")
    width = weights[0].shape[1] if weights else 0
    _refuse(what, kernel_refusal(act_name, width, len(weights), j0.shape[0]))
    _check_layers([v0], weights, biases, layout, what)
    _refuse(what, kernel_refusal(act_name, width, len(weights), j0.shape[0],
                                 itemsize=v0.element_size(), seg_widths=[v0.shape[1]],
                                 layout=layout))


def _check_layers(vs, weights, biases, layout, what) -> None:
    if len(biases) != len(weights):
        raise ValueError(f"{what}: {len(weights)} layers")
    if len(layout) != len(weights) or layout[0]:
        raise ValueError(f"{what}: layout {tuple(layout)}")
    c0 = vs[0].shape[1]
    x0w = sum(v.shape[1] for v in vs)
    width = weights[0].shape[1]
    for li, (w, b) in enumerate(zip(weights, biases)):
        fan_in = x0w if li == 0 else (c0 + width if layout[li] else width)
        if tuple(w.shape) != (fan_in, width) or tuple(b.shape) != (width,):
            raise ValueError(
                f"{what}: layer {li} w {tuple(w.shape)} b {tuple(b.shape)}, "
                f"expected ({fan_in}, {width})"
            )
        if w.dtype != vs[0].dtype or b.dtype != torch.float32:
            raise TypeError(f"{what}: layer {li} dtypes {w.dtype}/{b.dtype}")
        if w.data_ptr() % 16:
            raise ValueError(f"{what}: layer {li} weight not 16-byte aligned")
    for t in (*vs, *weights, *biases):
        if t.device != vs[0].device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input")


def _check_seg_args(vs, js, weights, biases, layout, act_name, has_j, n_tan) -> None:
    what = "CUDA dual_mlp_seg kernel"
    width = weights[0].shape[1] if weights else 0
    _refuse(what, kernel_refusal(act_name, width, len(weights), n_tan, trunk=False))
    if not 1 <= len(vs) <= _KERNEL_MAX_SEGMENTS or len(has_j) != len(vs):
        raise ValueError(f"{what}: {len(vs)} segments, has_j {tuple(has_j)}")
    dtype, m = vs[0].dtype, vs[0].shape[0]
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: dtype {dtype}")
    for v, j in zip(vs, _seg_js(js, has_j)):
        if v.dim() != 2 or v.shape[0] != m or v.dtype != dtype:
            raise ValueError(f"{what}: segment {tuple(v.shape)} {v.dtype}")
        if j is not None and (tuple(j.shape) != (n_tan,) + tuple(v.shape) or j.dtype != dtype
                              or not j.is_contiguous() or j.device != v.device):
            raise ValueError(f"{what}: tangent {tuple(j.shape)} {j.dtype}")
    _check_layers(vs, weights, biases, layout, what)
    _refuse(what, kernel_refusal(act_name, width, len(weights), n_tan, trunk=False,
                                 itemsize=dtype.itemsize, seg_widths=[v.shape[1] for v in vs],
                                 layout=layout))


# launches of the row-tile forward (csrc/tile_hopper.cuh's mlp_tile_fwd,
# wgmma fed by TMA) by operand type: "tc" bf16 and "tf32x3" f32 (by the
# 3xTF32 split), over every wrapper that runs it
TILE_LAUNCHES = {"tc": 0, "tf32x3": 0}


def count_tile_launch(dtype: torch.dtype) -> None:
    TILE_LAUNCHES["tc" if dtype == torch.bfloat16 else "tf32x3"] += 1


# the row-tile forward's plan (csrc/tile_hopper.cuh::tile_plan works out
# the same numbers, and its launcher refuses a call whose plan differs):
# row tiles of TILE_FWD_ROWS stacked rows (the S streams of 64 / S
# points), one or two per block, each owned by a consumer warpgroup,
# beside one producer warp; regions of k-blocks of [64 rows][128 bytes];
# a ring of 2-6 weight stages; all in the shared memory a block may use
TILE_FWD_ROWS = 64
TILE_FWD_SMEM = 232_448
SPLIT_SEG_FIRST = 1     # csrc/mlp_tile.cuh kSplitSegFirst: [seg0, h]
SPLIT_HIDDEN_FIRST = 2  # kSplitHiddenFirst: [h, seg0]
_TILE_KB = TILE_FWD_ROWS * 128
_TILE_MAX_STAGES = 6
# (consumer warpgroups, least ring stages, park) in the order they are tried
_TILE_TRIES = ((2, 3, False), (1, 2, False), (1, 2, True))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_pieces(layer: int, split: int, seg_widths: Sequence[int], n: int, bk: int) -> list:
    """The input pieces of a layer of the row-tile forward in the order of
    W's rows: (source, width, W's first row, first k-block), the source
    "x0" (layer 0: each segment a piece from a k-block of its own, of the
    staged input and of W^T), "seg" (segment 0 again, a post-skip layer)
    or "h" (the hidden state, ``n`` wide); ``bk`` the k-block's depth (64
    bf16, 32 f32)."""
    w0 = seg_widths[0]
    if layer == 0:
        rows = [sum(seg_widths[:i]) for i in range(len(seg_widths))]
        kbs = [sum(_cdiv(w, bk) for w in seg_widths[:i]) for i in range(len(seg_widths))]
        return [("x0", w, row, kb) for w, row, kb in zip(seg_widths, rows, kbs)]
    if split == SPLIT_SEG_FIRST:
        return [("seg", w0, 0, 0), ("h", n, w0, _cdiv(w0, bk))]
    if split == SPLIT_HIDDEN_FIRST:
        return [("h", n, 0, 0), ("seg", w0, n, _cdiv(n, bk))]
    return [("h", n, 0, 0)]


def tile_fwd_plan(itemsize: int, n_tan: int, width: int, seg_widths: Sequence[int],
                  split: Sequence[int], last_width: Optional[int] = None, m: int = 1,
                  sms: int = H100_SMS) -> dict:
    """How the row-tile forward launches a trunk: operands of ``itemsize``
    bytes (2 bf16, 4 f32), K = ``n_tan`` tangent planes, layers ``width``
    wide but the last (``last_width``, default ``width``), layer 0 over the
    segments ``seg_widths``, ``split[l]`` each layer's post-skip input (0,
    SPLIT_SEG_FIRST or SPLIT_HIDDEN_FIRST), ``m`` points, a card of ``sms``
    SMs.

    Returns the width ``class``; ``nc`` (an N chunk's columns: wgmma
    m64n128, m64n64 at the class 64) and ``chunks`` per layer; ``rows`` (64
    stacked rows a tile) and ``points`` (64 / S); ``consumers`` (tiles, and
    consumer warpgroups, of a block), ``warps`` by role (the producer's
    warpgroup: one warp loads the weights, three idle, its registers go to
    the consumers) and ``threads``;
    ``stages`` of the weight ring and ``stage_bytes``; ``kb`` (k-blocks of
    a consumer's regions: the copy of segment 0, A, B), ``f_bytes`` (S = 4:
    z_v for the partner warp), ``park`` (a layer's output parks in
    device memory: f32 at the class 512, where two buffers do not fit);
    ``smem``; ``kp`` (f32: the K of W^T's tf32 planes, [L, 2, width, kp],
    which the pre-pass writes at the start of ``scratch_bytes``);
    ``grid``; ``tma`` (bf16: layers whose W rows are whole 16-byte vectors
    go by TMA, the others by the producer warp's loads); ``w_l2_bytes``
    (the bytes of W a block reads per row tile, all layers); ``ints``, the
    numbers the launcher passes and the kernel's launcher checks.
    Raises ValueError where no layout fits the shared memory. Cached: a
    step asks for the same few plans every time."""
    last = width if last_width is None else last_width
    return _tile_fwd_plan(itemsize, n_tan, width, tuple(seg_widths),
                          tuple(int(s) for s in split), last, m, sms)


@functools.lru_cache(maxsize=4096)
def _tile_fwd_plan(itemsize: int, n_tan: int, width: int, seg_widths: tuple, split: tuple,
                   last: int, m: int, sms: int) -> dict:
    if itemsize not in _WIDE_BK or n_tan not in (0, 1, 3):
        raise ValueError(f"the row-tile forward: {itemsize}-byte operands, K={n_tan}")
    if width_refusal(width) is not None or not 1 <= last <= width:
        raise ValueError(f"the row-tile forward: width {width}, last width {last}")
    if not 1 <= len(split) <= _KERNEL_MAX_LAYERS_TILE or split[0]:
        raise ValueError(f"the row-tile forward: split {split}")
    cls = next(c for c in (64, 128, 256, 512) if width <= c)
    streams, bk = n_tan + 1, 128 // itemsize
    nc = 64 if cls == 64 else 128
    dbl = _cdiv(width, nc) > 1
    has_split = any(split)
    w0 = seg_widths[0]
    kbx = sum(_cdiv(w, bk) for w in seg_widths)  # each segment from a k-block of its own
    kbh = _cdiv(width, bk)
    kb_seg = _cdiv(w0, bk) if has_split else 0
    kb_a = kbh if has_split and len(seg_widths) == 1 else max(kbx, kbh)
    f_bytes = _cdiv(64 * (nc + 4), 1024) * 1024 if streams == 4 else 0
    stage_bytes = 128 * nc * (2 if itemsize == 4 else 1)

    def total(nw: int, st: int, park: bool) -> int:
        wg = (kb_seg + kb_a + (kbh if dbl and not park else 0)) * _TILE_KB + f_bytes
        return nw * wg + st * stage_bytes + (2 * st + 2) * 8

    choice = None
    for nw, least, park in _TILE_TRIES:
        if park and not dbl:
            break
        st = next((st for st in range(_TILE_MAX_STAGES, least - 1, -1)
                   if total(nw, st, park) <= TILE_FWD_SMEM), None)
        if st is not None:
            choice = (nw, st, park)
            break
    if choice is None:
        raise ValueError(f"the row-tile forward: no layout of segments {seg_widths} at "
                         f"width {width} fits {TILE_FWD_SMEM} bytes of shared memory")
    nw, stages, park = choice
    layers = len(split)
    pieces = [tile_pieces(l, split[l], seg_widths, width, bk) for l in range(layers)]
    kp = max((pc[-1][3] + _cdiv(pc[-1][1], bk)) * bk for pc in pieces) if itemsize == 4 else 0
    points = TILE_FWD_ROWS // streams
    groups = _cdiv(_cdiv(m, points), nw)
    grid = min(groups, sms)
    wt = layers * 2 * width * kp * 4
    park_off = _cdiv(wt, 256) * 256
    scratch = park_off + grid * TILE_FWD_ROWS * cls * itemsize if park else wt
    widths = [width] * (layers - 1) + [last]
    smem = total(nw, stages, park)
    return {
        "class": cls, "nc": nc, "chunks": [_cdiv(n, nc) for n in widths],
        "rows": TILE_FWD_ROWS, "points": points, "consumers": nw,
        "warps": {"consumer": 4 * nw, "producer": 1, "idle": 3}, "threads": 128 * (nw + 1),
        "stages": stages, "stage_bytes": stage_bytes,
        "kb": {"seg": kb_seg, "a": kb_a, "b": kbh if dbl and not park else 0},
        "f_bytes": f_bytes, "park": park, "smem": smem, "kp": kp, "grid": grid,
        "scratch_bytes": scratch,
        "tma": [itemsize == 4 or (n * itemsize) % 16 == 0 for n in widths],
        "w_l2_bytes": sum(_cdiv(n, nc) * sum(_cdiv(p[1], bk) for p in pc)
                          for n, pc in zip(widths, pieces)) * stage_bytes // nw,
        "ints": (TILE_FWD_ROWS, nw, stages, smem, int(park), kp, grid, scratch),
    }


def tile_row_order(streams: int) -> List[Tuple[int, int]]:
    """(point, stream) of each of a tile's 64 rows as the row-tile forward
    orders them: groups of 8 points, each group's S streams as blocks of 8
    rows, so that a thread's two wgmma accumulator rows r and r + 8 are
    streams s and s + 1 of one point (row = (p // 8) 8 S + 8 s + p % 8)."""
    if streams not in _ROUTE_STREAMS:
        raise ValueError(f"the row-tile forward: {streams} streams")
    shift = 3 + streams.bit_length() - 1
    return [((r >> shift) * 8 + (r & 7), (r >> 3) & (streams - 1))
            for r in range(TILE_FWD_ROWS)]


def tile_wt_planes_plain(weights: Sequence[Tensor], seg_widths: Sequence[int],
                         split: Sequence[int]) -> Tensor:
    """Plain version of the f32 pre-pass (csrc/tile_hopper.cuh::
    tile_wt_prep): every layer's W^T as tf32 hi and lo planes, [L, 2,
    width, kp], each input piece from a k-block (32) of its own, zeros
    between the pieces, past them and past a narrower last layer's
    columns."""
    width = weights[0].shape[1]
    pieces = [tile_pieces(l, split[l], seg_widths, width, 32) for l in range(len(weights))]
    kp = max((pc[-1][3] + _cdiv(pc[-1][1], 32)) * 32 for pc in pieces)
    wt = torch.zeros((len(weights), width, kp), dtype=torch.float32)
    for l, (w, pc) in enumerate(zip(weights, pieces)):
        for _, n, row, kbase in pc:
            wt[l, : w.shape[1], kbase * 32: kbase * 32 + n] = w[row: row + n].float().T
    hi, lo = tf32_split(wt)
    return torch.stack([hi, lo], dim=1)


def tile_launch(dtype: torch.dtype, n_tan: int, width: int, seg_widths: Sequence[int],
                split: Sequence[int], last_width: int, m: int, device: torch.device):
    """(the plan's ints as a C array, the device scratch or None) of a
    row-tile forward call: the plan (``tile_fwd_plan``) on the device's
    SM count, the scratch (f32: W^T's planes; a parked output) fresh from
    the caching allocator."""
    plan = tile_fwd_plan(torch.empty((), dtype=dtype).element_size(), n_tan, width,
                         seg_widths, split, last_width, m, _sm_count(device.index or 0))
    scratch = (torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=device)
               if plan["scratch_bytes"] else None)
    return _build.ints(plan["ints"]), scratch


def _launch_fwd(vs, seg_j, weights, biases, layout, act_name, n_tan, stash, what):
    m, device, dtype = vs[0].shape[0], vs[0].device, vs[0].dtype
    width = weights[0].shape[1]
    v_out = torch.empty((m, width), dtype=dtype, device=device)
    j_out = torch.empty((n_tan, m, width), dtype=dtype, device=device)
    pres = [torch.empty((n_tan + 1, m, width), dtype=dtype, device=device)
            for _ in weights] if stash else []
    if m == 0:
        return v_out, j_out, pres
    lib = _build.library()
    seg_w = [v.shape[1] for v in vs]
    split = [SPLIT_SEG_FIRST if s else 0 for s in layout]
    plan, scratch = tile_launch(dtype, n_tan, width, seg_w, split, width, m, device)
    code = lib.neddf_dual_mlp_fwd(
        _KERNEL_DTYPES[dtype], _ACT_CODES[act_name], n_tan, width, m, len(vs),
        _build.pointers(vs), _build.pointers(seg_j), _build.ints(seg_w),
        len(weights), _build.pointers(weights), _build.pointers(biases),
        _build.ints(split), _build.pointers(pres) if stash else None,
        v_out.data_ptr(), j_out.data_ptr(), plan,
        None if scratch is None else scratch.data_ptr(), _build.stream(device),
    )
    _build.check(code, what)
    count_tile_launch(dtype)
    return v_out, j_out, pres


def dual_mlp_trunk(
    v0: Tensor,
    j0: Tensor,
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str = "tanhExp",
    stash: bool = False,
):
    """Trunk forward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see ``dual_mlp_trunk_plain`` for the arguments).
    With ``stash`` it also returns the per-layer pre-activations."""
    if v0.device.type == "cpu":
        if stash:
            return dual_mlp_seg_plain([v0], [j0], weights, biases, layout, act_name,
                                      (True,), j0.shape[0], stash=True)
        return dual_mlp_trunk_plain(v0, j0, weights, biases, layout, act_name)
    if v0.device.type != "cuda":
        raise ValueError(f"dual_mlp_trunk: unsupported device {v0.device}")
    _check_kernel_args(v0, j0, weights, biases, layout, act_name)
    v, j, pres = _launch_fwd([v0], [j0], weights, biases, layout, act_name, j0.shape[0],
                             stash, "dual_mlp_trunk")
    if v0.shape[0]:
        dual_mlp_trunk.launches += 1
    return (v, j, pres) if stash else (v, j)


dual_mlp_trunk.launches = 0


def dual_mlp_seg(
    vs: Sequence[Tensor],
    js: Sequence[Tensor],
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    has_j: Sequence[bool],
    n_tan: int,
    stash: bool = False,
):
    """Multi-segment dual-MLP forward (the colour trunk's K=1 training
    configuration): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see ``dual_mlp_seg_plain`` for the arguments)."""
    device = vs[0].device
    if device.type == "cpu":
        return dual_mlp_seg_plain(vs, js, weights, biases, layout, act_name, has_j,
                                  n_tan, stash)
    if device.type != "cuda":
        raise ValueError(f"dual_mlp_seg: unsupported device {device}")
    _check_seg_args(vs, js, weights, biases, layout, act_name, has_j, n_tan)
    v, j, pres = _launch_fwd(list(vs), _seg_js(js, has_j), weights, biases, layout,
                             act_name, n_tan, stash, "dual_mlp_seg")
    if vs[0].shape[0]:
        dual_mlp_seg.launches += 1
    return (v, j, pres) if stash else (v, j)


dual_mlp_seg.launches = 0

_DB_ROWS = 64  # rows per block of the cotangent kernel (one db partial each)


def products_plain(m, n, k, a, sam, sak, b, sbk, sbn) -> Tensor:
    """Plain version of the products: ``sum_k A(m, k) B(k, n)`` over the
    same strided views (``a``/``b`` flat or not, read through their
    storage offset), as one f32 ``torch.matmul`` of the operands (TF32 as
    the caller set it). bf16 operands multiply exactly in f32, so it
    differs from the split kernel only in the order of the f32 sums."""
    av = torch.as_strided(a, (m, k), (sam, sak), a.storage_offset()).float()
    bv = torch.as_strided(b, (k, n), (sbk, sbn), b.storage_offset()).float()
    return av @ bv


def tf32_round(x: Tensor) -> Tensor:
    """f32 -> the nearest tf32 (10 mantissa bits), ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds: half a tf32 step (bit 12) is added to the
    magnitude bits and the 13 low bits cleared. Finite values only."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_split(x: Tensor):
    """x = hi + lo with hi = tf32(x) and lo = tf32(x - hi) (tc_ops.cuh's
    split_tf32); x - hi is exact in f32."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def products_tf32x3(m, n, k, a, sam, sak, b, sbk, sbn) -> Tensor:
    """Emulation of the f32 product on the tensor cores over the same
    strided views as ``products_plain``: each operand split into tf32 hi
    and lo, and ``lo_a hi_b + hi_a lo_b + hi_a hi_b`` (the dropped lo_a
    lo_b is below 2^-21 of |a b|). A product of two tf32 values is exact
    in f32, so only the f32 sums round, in another order than the
    kernel's."""
    av = torch.as_strided(a, (m, k), (sam, sak), a.storage_offset()).float()
    bv = torch.as_strided(b, (k, n), (sbk, sbn), b.storage_offset()).float()
    ah, al = tf32_split(av)
    bh, bl = tf32_split(bv)
    return al @ bh + ah @ bl + ah @ bh


# csrc/route_products.cu: the folded epilogue's modes (kModeDact,
# kModeAdjoint) and the rows of one db partial of an epilogue (a tile,
# kTileRows; over rows grouped by point 128 / S points); csrc/
# dual_mlp_bwd.cu: the rows of one group of the db sum's first level
# (neddf_sum_rows)
_MODE_DACT, _MODE_ADJOINT = 1, 2
_EPI_ROWS = 128
_SUM_GROUP_ROWS = 64

# launches of the per-layer route's forward (csrc/layer_fwd.cu), one per
# layer of a rank's column shard: "fwd" the dual trunks' (K = 1, 3),
# "fwd_value" the value-only MLP's (kernels/mlp.py); the backward counts in
# PASS_LAUNCHES["gstack"] and the products' counters
ROUTE_LAUNCHES = {"fwd": 0, "fwd_value": 0}
# the same launches by kernel: "narrow" layer_fwd_narrow (N <= 32, the read
# of x), "wide" layer_fwd_wide (wgmma + TMA, after its W^T pre-pass); and
# the wide kernel's by stream count (S = 4 the K=3 trunks', 2 the K=1
# colour trunk's, 1 the value-only walks')
LAYER_FWD_LAUNCHES = {"narrow": 0, "wide": 0}
LAYER_FWD_WIDE_STREAMS = {"s1": 0, "s2": 0, "s4": 0}
# host seconds spent in Products.layer_fwd (checks, plan, padding copies,
# W^T's buffer, the launch call), read beside the launch counts
LAYER_FWD_HOST = {"s": 0.0}

# the layer forward's launch plan (csrc/layer_fwd.cu holds the same
# constants and works out the tensor maps and tiles): the narrow kernel
# takes N <= 32 whose weight columns fit its shared memory, NB of them a
# template class (4: NeuS's colour output; 32); the wide kernel's k-block
# (128 bytes of operand) by operand bytes
LAYER_FWD_NARROW_MAX_N = 32
_NARROW_MAX_SMEM = 64 * 1024
_NARROW_CLASSES = (4, 32)
_WIDE_BK = {2: 64, 4: 32}


def _padded(x: Tensor, width: int) -> Tensor:
    """A fresh [S, M, width] copy of x [S, M, k] with zero columns past k:
    a wide layer's segment as TMA takes it (16-byte rows and address)."""
    out = x.new_zeros((*x.shape[:2], width))
    out[..., : x.shape[2]] = x
    return out


def layer_fwd_plan(streams: int, m: int, n: int, ks: Sequence[int], itemsize: int,
                   ptrs: Sequence[int] = ()) -> dict:
    """How ``Products.layer_fwd`` launches one layer of ``streams`` planes
    of ``m`` points, K segments of widths ``ks`` and ``n`` output columns,
    operands of ``itemsize`` bytes (2 bf16, 4 f32); ``ptrs`` the byte
    addresses of the operands (segments, weight, bias), which must be
    aligned to their element size (ValueError).

    ``narrow`` (n <= 32 and W's columns, NB = the next class up, in 64 KB
    of shared memory, rows padded to 8 elements): ``nb``, ``smem`` bytes;
    every other layer ``wide``: a segment whose rows are not whole 16-byte
    vectors (or whose address is not 16-byte aligned) is copied first with
    zero columns up to ``widths`` (``pad``), as TMA takes it; ``kp``, the K
    of W^T [planes, n, kp] that the pre-pass writes (each segment's
    k-blocks; f32: tf32 hi and lo planes), which the launcher checks.
    Raises NotImplementedError for a stream count the kernels do not
    take."""
    if streams not in _ROUTE_STREAMS:
        raise NotImplementedError(f"the layer forward: {streams} streams")
    if itemsize not in _WIDE_BK:
        raise ValueError(f"the layer forward: {itemsize}-byte operands")
    if not 1 <= len(ks) <= 2 or min(ks) < 1 or m < 1 or n < 1:
        raise ValueError(f"the layer forward: {m} points, segments {tuple(ks)}, {n} columns")
    for ptr in ptrs:
        if ptr % itemsize:
            raise ValueError(f"the layer forward: pointer {ptr:#x} not {itemsize}-byte aligned")
    if n <= LAYER_FWD_NARROW_MAX_N:
        nb = next(c for c in _NARROW_CLASSES if n <= c)
        smem = nb * sum(-(-k // 8) * 8 for k in ks) * itemsize
        if smem <= _NARROW_MAX_SMEM:
            return {"kernel": "narrow", "nb": nb, "smem": smem}
    bk = _WIDE_BK[itemsize]
    vec = 16 // itemsize
    widths = [-(-k // vec) * vec for k in ks]
    seg_ptrs = list(ptrs[: len(ks)]) or [0] * len(ks)
    pad = [w != k or p % 16 != 0 for w, k, p in zip(widths, ks, seg_ptrs)]
    return {"kernel": "wide", "widths": widths, "pad": pad,
            "kp": sum(-(-w // bk) for w in widths) * bk, "planes": 2 if itemsize == 4 else 1}

# launches of the per-layer route's plain products on wgmma
# (csrc/route_products.cu, by kernel: "nt" route_nt, dx = G W^T; "tn"
# route_tn, dW = X^T G); the host seconds spent in Products.nt / .tn on
# them (plan, padding copies, buffers, the launch call, the split sum)
ROUTE_PRODUCT_LAUNCHES = {"nt": 0, "tn": 0}
ROUTE_PRODUCT_HOST = {"s": 0.0}

# the route products' plan (csrc/route_products.cu holds the same tile,
# k-block and the tensor maps): route_nt takes a depth of at least one
# tf32 k8 step (a shallower nt, a 3-wide layer's dx, goes to shallow_nt,
# whose chunk of W's columns in shared memory is SHALLOW_SMEM bytes of f32);
# route_tn cuts its rows into fixed splits of a whole number of k-blocks,
# at least _ROUTE_MIN_SPLIT_BLOCKS each, at most _ROUTE_MAX_SPLITS, the
# fewest whose waves over the SMs take within _ROUTE_SPLIT_SLACK of the
# best count's k-blocks
ROUTE_NT_MIN_K = 8
SHALLOW_SMEM = 48 * 1024
_ROUTE_TILE = 128
_ROUTE_MIN_SPLIT_BLOCKS = 16
_ROUTE_MAX_SPLITS = 64
_ROUTE_SPLIT_SLACK = 1.05
_ROUTE_LAYOUTS = {"nt": 0, "tn": 1}


def route_plan(layout: str, m: int, n: int, k: int, lda: int, ldb: int, itemsize: int,
               a_ptr: int = 0, b_ptr: int = 0, sms: int = H100_SMS) -> dict:
    """How ``Products.nt`` / ``.tn`` launch ``out [m, n] f32``: ``nt`` a [m,
    k] b [n, k]^T, ``tn`` a [k, m]^T b [k, n] (a reduction over k rows),
    each operand's rows ``lda`` / ``ldb`` elements apart (contiguous
    within a row), operands of ``itemsize`` bytes (2 bf16, 4 f32) at the
    byte addresses ``a_ptr`` / ``b_ptr`` (ValueError off the element
    size), on a card of ``sms`` SMs.

    ``kernel``: "shallow" (shallow_nt, for an nt depth k under
    ``ROUTE_NT_MIN_K``: ``cols``, the columns of b a block holds in shared
    memory as f32, and ``chunks`` of them over n; any row strides) or
    "route" (route_nt / route_tn), with ``pad_a`` /
    ``pad_b``: the row length an operand is first copied to where its
    rows or address are not whole 16-byte vectors (TMA's), 0
    where it is taken as it is (f32 nt's b goes through the tf32 split's
    pre-pass, which reads any rows); ``ldw``: the row length of f32 nt's
    tf32 planes of b [2, n, ldw] (0: none); ``splits`` and ``k_chunk``:
    tn's fixed ranges of k_chunk rows (a whole number of k-blocks), each
    summed into its own [m, n] plane and the planes added in order (nt: 1
    and 0). The plan is a function of the shape, the strides, the
    addresses' offsets from 16 bytes and the SMs, cached: a step asks for
    the same few dozen plans every time (the host leads NeRF-deep, where
    working out tn's splits on every call cost ~10% of the step)."""
    if layout not in _ROUTE_LAYOUTS:
        raise ValueError(f"route products: layout {layout!r}")
    if itemsize not in _WIDE_BK:
        raise ValueError(f"route products: {itemsize}-byte operands")
    for ptr in (a_ptr, b_ptr):
        if ptr % itemsize:
            raise ValueError(f"route products: pointer {ptr:#x} not {itemsize}-byte aligned")
    return _route_plan(layout, m, n, k, lda, ldb, itemsize, a_ptr % 16, b_ptr % 16, sms)


@functools.lru_cache(maxsize=4096)
def _route_plan(layout: str, m: int, n: int, k: int, lda: int, ldb: int, itemsize: int,
                a_ptr: int, b_ptr: int, sms: int) -> dict:
    if layout == "nt" and k < ROUTE_NT_MIN_K:
        cols = min(-(-n // 4) * 4, SHALLOW_SMEM // 4 // max(k, 1) // 4 * 4)
        return {"kernel": "shallow", "cols": cols, "chunks": -(-n // cols)}
    vec = 16 // itemsize
    bk = _WIDE_BK[itemsize]
    if layout == "nt":
        f32 = itemsize == 4
        return {"kernel": "route", "pad_a": _pad_width(lda, a_ptr, k, itemsize),
                "pad_b": 0 if f32 else _pad_width(ldb, b_ptr, k, itemsize),
                "ldw": -(-k // vec) * vec if f32 else 0, "splits": 1, "k_chunk": 0}
    splits, k_chunk = _tn_splits(m, n, k, bk, sms)
    return {"kernel": "route", "pad_a": _pad_width(lda, a_ptr, m, itemsize),
            "pad_b": _pad_width(ldb, b_ptr, n, itemsize), "ldw": 0, "splits": splits,
            "k_chunk": k_chunk}


def _pad_width(ld: int, ptr: int, width: int, itemsize: int) -> int:
    """The row length an operand of ``width`` columns, rows ``ld`` elements
    apart from the byte address ``ptr``, is first copied to where its rows
    or address are not whole 16-byte vectors (TMA's); 0 where it is taken
    as it is."""
    vec = 16 // itemsize
    return 0 if (ld * itemsize) % 16 == 0 and ptr % 16 == 0 else -(-width // vec) * vec


def _tn_splits(m: int, n: int, k: int, step: int, sms: int,
               unit: Tuple[int, int] = (_ROUTE_TILE, _ROUTE_TILE)) -> Tuple[int, int]:
    """route_tn's fixed splits of a reduction over k rows (points) in
    k-blocks of ``step``, output tiles of ``unit`` (rows of m, columns of
    n): (splits, k_chunk), k_chunk a whole number of k-blocks, at least
    _ROUTE_MIN_SPLIT_BLOCKS each, at most _ROUTE_MAX_SPLITS, the fewest
    whose waves over the SMs take within _ROUTE_SPLIT_SLACK of the best
    count's k-blocks."""
    tiles = -(-m // unit[0]) * -(-n // unit[1])
    blocks = max(1, -(-k // step))
    top = max(1, min(_ROUTE_MAX_SPLITS, blocks // _ROUTE_MIN_SPLIT_BLOCKS))

    def span(s: int) -> int:  # k-blocks the busiest SM reduces
        return -(-tiles * s // sms) * -(-blocks // s)

    best = min(span(s) for s in range(1, top + 1))
    splits = next(s for s in range(1, top + 1) if span(s) <= best * _ROUTE_SPLIT_SLACK)
    k_chunk = -(-blocks // splits) * step
    return max(1, -(-k // k_chunk)), k_chunk


# launches of the folded products on wgmma (csrc/route_products.cu's
# route_nt with an epilogue, route_tn with a prologue), by mode
FOLD_MODES = ("nt_act", "nn_adjoint", "nt_gstack", "tn_act", "tn_dual_act")
FOLD_LAUNCHES = {mode: 0 for mode in FOLD_MODES}
# route_tn's output tile with a prologue (rows of m, columns of n) by
# operand bytes: bf16 64 x 256 (each element of A transformed once a
# split), f32 128 x 128
_FOLD_TN_UNIT = {2: (64, 256), 4: (_ROUTE_TILE, _ROUTE_TILE)}
# launches of shallow_nt (csrc/route_products.cu, an nt of a depth under
# ROUTE_NT_MIN_K) by operand type: "tc" bf16, "tf32x3" f32 (the keys of
# TILE_LAUNCHES)
SHALLOW_LAUNCHES = {"tc": 0, "tf32x3": 0}


def folded_launches() -> dict:
    """The folded products' launches so far, by end: "prologue" route_tn's
    (``tn_act``, ``tn_dual_act``), "epilogue" route_nt's (the others); a
    view of ``FOLD_LAUNCHES``."""
    tn = sum(v for mode, v in FOLD_LAUNCHES.items() if mode.startswith("tn"))
    return {"prologue": tn, "epilogue": sum(FOLD_LAUNCHES.values()) - tn}


def fold_plan(mode: str, m: int, n: int, k: int, itemsize: int, *, streams: int = 1,
              k1: Optional[int] = None, lda: Optional[int] = None, lda2: int = 0,
              ldb: Optional[int] = None, a_ptr: int = 0, a2_ptr: int = 0, b_ptr: int = 0,
              sms: int = H100_SMS) -> dict:
    """How a folded product launches (csrc/route_products.cu holds the same
    tiles, k-blocks and the tensor maps), for operands of ``itemsize``
    bytes (2 bf16, 4 f32) at the byte addresses ``a_ptr`` / ``a2_ptr`` /
    ``b_ptr`` (ValueError off the element size), rows ``lda`` / ``lda2`` /
    ``ldb`` elements apart (contiguous within a row; default: dense), on a
    card of ``sms`` SMs.

    ``nt_act``, ``nn_adjoint``, ``nt_gstack`` (route_nt with the epilogue):
    out [m, n] over a depth k, A [m, k] (``streams`` S > 1, nt_gstack: S
    planes of m points, grouped by point: ``tile_rows`` = 128 / S points
    of a tile), nn_adjoint's A in two K segments [m, k1] and [m, k - k1]
    (``k1`` None: one); B = W rows [n, k] (nn_adjoint: W [k, n], f32
    only). Returns ``tile_rows``, ``row_tiles`` (db's rows), ``tiles``,
    ``kb1`` (A's first segment's k-blocks) and ``nk``; ``pad_a`` /
    ``pad_a2`` / ``pad_b``: the row length a segment (bf16: B too) is
    first copied to, 0 where it is taken as it is; ``ldw``: f32's tf32
    planes of B [2, n, ldw] (the pre-pass reads B as it is and leaves
    zero columns up to the second segment's first k-block).

    ``tn_act``, ``tn_dual_act`` (route_tn with the prologue): out [m, n] =
    f(A)^T B over k rows (S > 1: S planes of k points, a k-block holding
    the S streams of ``step`` = depth / S points), A [k, m], B [k, n];
    returns ``pad_a``, ``pad_b``, ``step`` and tn's fixed ``splits`` of
    ``k_chunk`` rows (points). Raises ValueError for a mode, stream count
    or operand type the kernels do not take. The plan is a function of the
    shapes, the strides, the addresses' offsets from 16 bytes and the SMs,
    cached as ``route_plan``'s (a step asks for the same plans every
    time)."""
    if mode not in FOLD_MODES:
        raise ValueError(f"folded products: mode {mode!r}")
    if itemsize not in _WIDE_BK:
        raise ValueError(f"folded products: {itemsize}-byte operands")
    dual = mode in ("nt_gstack", "tn_dual_act")
    if (streams not in (2, 4)) if dual else streams != 1:
        raise ValueError(f"folded products: {mode} over {streams} streams")
    if mode == "nn_adjoint" and itemsize != 4:
        raise ValueError("folded products: nn_adjoint takes f32 operands only")
    for ptr in (a_ptr, a2_ptr, b_ptr):
        if ptr % itemsize:
            raise ValueError(f"folded products: pointer {ptr:#x} not {itemsize}-byte aligned")
    if min(m, n, k) < 1:
        raise ValueError(f"folded products: {mode} of {m} x {n} x {k}")
    two = k1 is not None and k1 < k
    if two and (k1 < 1 or mode != "nn_adjoint"):
        raise ValueError(f"folded products: {mode} with segments {k1}, {k - k1}")
    return _fold_plan(mode, m, n, k, itemsize, streams, k1 if two else None, lda, lda2, ldb,
                      a_ptr % 16, a2_ptr % 16, b_ptr % 16, sms)


@functools.lru_cache(maxsize=4096)
def _fold_plan(mode: str, m: int, n: int, k: int, itemsize: int, streams: int,
               k1: Optional[int], lda: Optional[int], lda2: int, ldb: Optional[int],
               a_ptr: int, a2_ptr: int, b_ptr: int, sms: int) -> dict:
    bk = _WIDE_BK[itemsize]
    if mode.startswith("tn"):
        step = bk // streams
        splits, k_chunk = _tn_splits(m, n, k, step, sms, _FOLD_TN_UNIT[itemsize])
        return {"pad_a": _pad_width(m if lda is None else lda, a_ptr, m, itemsize),
                "pad_b": _pad_width(n if ldb is None else ldb, b_ptr, n, itemsize),
                "step": step, "splits": splits, "k_chunk": k_chunk}
    two = k1 is not None
    ka = k1 if two else k
    kb1 = -(-ka // bk)
    nk = kb1 + (-(-(k - k1) // bk) if two else 0)
    f32 = itemsize == 4
    vec = 16 // itemsize
    tile_rows = _ROUTE_TILE // streams
    row_tiles = -(-m // tile_rows)
    return {"tile_rows": tile_rows, "row_tiles": row_tiles,
            "tiles": row_tiles * -(-n // _ROUTE_TILE), "kb1": kb1, "nk": nk,
            "pad_a": _pad_width(ka if lda is None else lda, a_ptr, ka, itemsize),
            "pad_a2": _pad_width(k - k1 if lda2 == 0 else lda2, a2_ptr, k - k1, itemsize)
            if two else 0,
            "pad_b": 0 if f32 else _pad_width(k if ldb is None else ldb, b_ptr, k, itemsize),
            "ldw": -(-(kb1 * bk + k - k1 if two else k) // vec) * vec if f32 else 0}


def _padded_rows(x: Tensor, width: int) -> Tensor:
    """A fresh copy of x [R, c] with rows ``width`` elements apart (16-byte
    rows), as TMA takes a route product's operand; the columns past c are
    left unset: the tensor maps stop at c and fill past it with zeros."""
    out = x.new_empty((x.shape[0], width))
    out[:, : x.shape[1]] = x
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route_product_plain(layout: str, a: Tensor, b: Tensor) -> Tensor:
    """Plain version of the backward's products (``ProductsPlain.nt`` /
    ``.tn`` / ``.nn``, and so of every folded mode): nt a [R, C] b [n,
    C]^T, tn a [R, m]^T b [R, n], nn a [R, k] b [k, n], one f32 matmul of
    the operands."""
    route_product_plain.calls += 1
    if layout == "nt":
        return a.float() @ b.float().T
    if layout == "nn":
        return a.float() @ b.float()
    return a.float().T @ b.float()


# calls of the plain route products (a run through the kernels makes none)
route_product_plain.calls = 0

# launches of the elementwise kernels that the dual backward runs beside
# its products: gstack, the top layer's stacked cotangent (one per call);
# dual_act, the layer inputs' pass that the dW products' prologue took
# over (none since; the phases of chip_smoke.py that hold the launches
# check that it stays 0); and the parallel db sum of every backward
# (db_sum, two kernels per call). kernels/mlp.py and kernels/sdf_mlp.py
# count their own top-layer passes
PASS_LAUNCHES = {"gstack": 0, "dual_act": 0, "db_sum": 0}


def grouped_rows(streams: int, points: int, per: int) -> Tensor:
    """The stream-grouped row map of the dual backward's products: the
    rows of stacked planes ``[streams * points]`` (plane-major) in the
    order a tile (nt: ``per`` = 128 / S points) or a reduction stage
    (tn: ``per`` = depth / S) takes them, ``[groups, streams * per]``:
    in group t, row ``a * per + r`` is row ``a * points + t * per + r``,
    or -1 past the last point (a ragged last group)."""
    groups = -(-points // per)
    pt = torch.arange(groups * per).view(groups, 1, per)
    rows = torch.arange(streams).view(1, streams, 1) * points + pt
    return torch.where(pt < points, rows, -1).view(groups, streams * per)


def sum_rows_plain(parts: Tensor) -> Tensor:
    """Plain version of ``Products.sum_rows``: [R, C] -> [C], the rows in
    groups of 64 summed, then the groups (f32)."""
    r, c = parts.shape
    groups = -(-r // _SUM_GROUP_ROWS)
    padded = torch.zeros((groups * _SUM_GROUP_ROWS, c), dtype=torch.float32,
                         device=parts.device)
    padded[:r] = parts
    return padded.view(groups, _SUM_GROUP_ROWS, c).sum(dim=1).sum(dim=0)


class Products:
    """Launchers of the hand-written backward products for one backward
    call: the plain nt and tn (``csrc/route_products.cu``'s route_nt /
    route_tn on wgmma, ``route_plan``; an nt of a depth under
    ``ROUTE_NT_MIN_K`` on its shallow_nt), the products with an
    activation's elementwise
    work folded in (route_nt with the epilogue: ``nt_act``,
    ``nn_adjoint``, ``DualProducts.nt_gstack``; route_tn with the
    prologue: ``tn_act``, ``DualProducts.tn_dual_act``; ``fold_plan``),
    the layer forward (``csrc/layer_fwd.cu``) and the fixed-order sums
    (``neddf_sum_splits``, ``neddf_sum_rows``); shared by the backwards of
    ``kernels/mlp.py``, ``kernels/sdf_mlp.py`` and this module, which add
    their own top-layer passes in subclasses. ``ProductsPlain`` computes
    the same in PyTorch, so that the backwards' walks run on the CPU.
    Launches count in ``ROUTE_PRODUCT_LAUNCHES`` (the plain route_nt /
    route_tn), ``FOLD_LAUNCHES`` (the folded modes) and ``SHALLOW_LAUNCHES``
    (shallow_nt by operand type)."""

    def __init__(self, dtype: torch.dtype, device: torch.device) -> None:
        self.lib = _build.library()
        self.dtype = dtype
        self.dt = _KERNEL_DTYPES[dtype]
        self.device = device
        self.stream = _build.stream(device)
        self.sms = _sm_count(torch.cuda.current_device() if device.index is None
                             else device.index)

    def _empty(self, shape, dtype=torch.float32) -> Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device)

    def sum_splits(self, parts: Tensor, out: Tensor) -> None:
        _build.check(self.lib.neddf_sum_splits(
            out.numel(), parts.shape[0], parts.data_ptr(), out.data_ptr(), self.stream),
            "dual_mlp_seg_bwd sum")

    def sum_rows(self, parts: Tensor) -> Tensor:
        """[R, C] f32 partials -> [C], summed over R in a fixed order over
        the whole card (two kernels: groups of rows, then the groups)."""
        r, c = parts.shape
        out = self._empty((c,))
        scratch = self._empty((-(-r // _SUM_GROUP_ROWS), c))
        _build.check(self.lib.neddf_sum_rows(r, c, _SUM_GROUP_ROWS, parts.data_ptr(),
                                             scratch.data_ptr(), out.data_ptr(), self.stream),
                     "db sum")
        PASS_LAUNCHES["db_sum"] += 1
        return out

    def nt(self, a: Tensor, w_rows: Tensor) -> Tensor:
        """a [R, C] (T) times w_rows [n, C]^T (T) -> [R, n] f32 (route_nt;
        see ``_route``)."""
        return self._route("nt", a, w_rows)

    def tn(self, a: Tensor, g: Tensor) -> Tensor:
        """a [R, m]^T (T) times g [R, n] (T) -> [m, n] f32, over R rows
        (route_tn; see ``_route``)."""
        return self._route("tn", a, g)

    def _route(self, layout: str, a: Tensor, b: Tensor) -> Tensor:
        """The plain ``nt`` (a [m, k] b [n, k]^T) or ``tn`` (a [k, m]^T b [k,
        n]) product of two row-strided 2-D operands in T -> [m, n] f32, on
        the kernel ``route_plan`` picks: ``csrc/route_products.cu``'s
        route_nt / route_tn (tn's splits summed in order by
        ``neddf_sum_splits``), or shallow_nt for an nt depth under
        ``ROUTE_NT_MIN_K``."""
        t0 = time.perf_counter()
        if a.dim() != 2 or b.dim() != 2 or a.stride(1) != 1 or b.stride(1) != 1:
            raise ValueError(f"route products: operands {tuple(a.shape)} {a.stride()}, "
                             f"{tuple(b.shape)} {b.stride()}")
        if a.dtype != self.dtype or b.dtype != self.dtype:
            raise TypeError(f"products: operands {a.dtype}/{b.dtype}, expected {self.dtype}")
        if layout == "nt":
            (m, k), n = a.shape, b.shape[0]
        else:
            (k, m), n = a.shape, b.shape[1]
        if (b.shape[1] if layout == "nt" else b.shape[0]) != k:
            raise ValueError(f"route {layout}: operands {tuple(a.shape)}, {tuple(b.shape)}")
        lda, ldb = a.stride(0), b.stride(0)
        plan = route_plan(layout, m, n, k, lda, ldb, a.element_size(), a.data_ptr(),
                          b.data_ptr(), self.sms)
        if m == 0 or n == 0 or k == 0:
            return torch.zeros((m, n), dtype=torch.float32, device=self.device)
        if plan["kernel"] == "shallow":  # an nt of a depth under ROUTE_NT_MIN_K
            out = self._empty((m, n))
            _build.check(self.lib.neddf_shallow_nt(
                self.dt, m, n, k, a.data_ptr(), lda, b.data_ptr(), ldb, plan["cols"],
                out.data_ptr(), self.stream), "shallow_nt")
            SHALLOW_LAUNCHES["tc" if self.dtype == torch.bfloat16 else "tf32x3"] += 1
            ROUTE_PRODUCT_HOST["s"] += time.perf_counter() - t0
            return out
        if plan["pad_a"]:
            a = _padded_rows(a, plan["pad_a"])
        if plan["pad_b"]:
            b = _padded_rows(b, plan["pad_b"])
        splits = plan["splits"]
        out = self._empty((m, n))
        parts = out if splits == 1 else self._empty((splits, m, n))
        planes = self._empty((2, n, plan["ldw"])) if plan["ldw"] else None
        _build.check(self.lib.neddf_route_product(
            self.dt, _ROUTE_LAYOUTS[layout], m, n, k, a.data_ptr(), a.stride(0), b.data_ptr(),
            b.stride(0), None if planes is None else planes[0].data_ptr(),
            None if planes is None else planes[1].data_ptr(), plan["ldw"], splits,
            plan["k_chunk"], parts.data_ptr(), self.stream), f"route_{layout}")
        ROUTE_PRODUCT_LAUNCHES[layout] += 1
        if splits > 1:
            self.sum_splits(parts, out)
        ROUTE_PRODUCT_HOST["s"] += time.perf_counter() - t0
        return out

    def _fold_operand(self, x: Tensor, width: int) -> Tensor:
        """x ([R, c] with unit column stride, or [S, M, c] contiguous) as the
        folded products' TMA takes it: a fresh copy with rows ``width``
        elements apart where ``width`` (fold_plan's pad) is not 0."""
        if not width:
            return x
        return _padded_rows(x, width) if x.dim() == 2 else _padded(x, width)

    def _fold_tn(self, mode: str, z: Tensor, g: Tensor, act_name: str) -> Tensor:
        """route_tn with the prologue: f(z)^T g over the rows of z [R, m]
        and g [R, n] (tn_act), or over the S planes of z [S, pts, m] and g
        [S, pts, n] with the dual layer input (tn_dual_act) -> [m, n] f32,
        the splits added in order."""
        if z.dtype != self.dtype or g.dtype != self.dtype:
            raise TypeError(f"{mode}: operands {z.dtype}/{g.dtype}, expected {self.dtype}")
        streams = 1 if z.dim() == 2 else z.shape[0]
        if z.shape[:-1] != g.shape[:-1] or z.dim() != g.dim() or any(
                t.stride(-1) != 1 or (t.dim() == 3 and not t.is_contiguous()) for t in (z, g)):
            raise ValueError(f"{mode}: operands {tuple(z.shape)} {z.stride()}, "
                             f"{tuple(g.shape)} {g.stride()}")
        rows, m, n = z.shape[-2], z.shape[-1], g.shape[-1]
        plan = fold_plan(mode, m, n, rows, z.element_size(), streams=streams, lda=z.stride(-2),
                         ldb=g.stride(-2), a_ptr=z.data_ptr(), b_ptr=g.data_ptr(), sms=self.sms)
        z, g = self._fold_operand(z, plan["pad_a"]), self._fold_operand(g, plan["pad_b"])
        splits = plan["splits"]
        out = self._empty((m, n))
        parts = out if splits == 1 else self._empty((splits, m, n))
        _build.check(self.lib.neddf_fold_tn(
            self.dt, _ACT_CODES[act_name], streams, m, n, rows, z.data_ptr(), z.stride(-2),
            g.data_ptr(), g.stride(-2), splits, plan["k_chunk"], parts.data_ptr(), self.stream),
            f"backward dW ({mode} prologue)")
        if splits > 1:
            self.sum_splits(parts, out)
        FOLD_LAUNCHES[mode] += 1
        return out

    def _fold_nt(self, mode: str, a: Tensor, b: Tensor, z: Tensor, act_name: str, fold_mode: int,
                 *, a2=None, side=None, n_act=None, out=True, out2=False, db=False):
        """route_nt with the epilogue (see ``neddf_fold_nt`` in
        csrc/route_products.cu): acc = [a | a2] b^T (nn_adjoint: [a | a2] b)
        over the rows of a [R, k1] (nt_gstack: the S planes of a [S, M,
        C]), combined with the stash z; returns the outputs by name (None
        where not asked for), db summed over the row tiles."""
        nn = mode == "nn_adjoint"
        for t in (a, b, z, a2, side):
            if t is not None and t.dtype != (torch.float32 if t is side else self.dtype):
                raise TypeError(f"{mode}: operand {t.dtype}, expected {self.dtype}")
        streams = 1 if a.dim() == 2 else a.shape[0]
        k1 = a.shape[-1]
        k = k1 + (0 if a2 is None else a2.shape[1])
        n = b.shape[1] if nn else b.shape[0]
        if b.stride(1) != 1 or b.shape[0 if nn else 1] != k or a.stride(-1) != 1 or (
                a.dim() == 3 and not a.is_contiguous()) or (a2 is not None and (
                a2.dim() != 2 or a2.shape[0] != a.shape[0] or a2.stride(1) != 1)):
            raise ValueError(f"{mode}: operands {tuple(a.shape)}, {tuple(b.shape)} {b.stride()}")
        r = a.shape[-2]
        plan = fold_plan(mode, r, n, k, a.element_size(), streams=streams,
                         k1=None if a2 is None else k1, lda=a.stride(-2),
                         lda2=0 if a2 is None else a2.stride(0), ldb=b.stride(0),
                         a_ptr=a.data_ptr(), a2_ptr=0 if a2 is None else a2.data_ptr(),
                         b_ptr=b.data_ptr(), sms=self.sms)
        a, b = self._fold_operand(a, plan["pad_a"]), self._fold_operand(b, plan["pad_b"])
        if a2 is not None:
            a2 = self._fold_operand(a2, plan["pad_a2"])
        planes = self._empty((2, n, plan["ldw"])) if plan["ldw"] else None
        n_act = n if n_act is None else n_act
        lead = (streams, r) if streams > 1 else (r,)
        res = {"out": self._empty((*lead, n_act), self.dtype) if out else None,
               "out2": self._empty((r, n_act)) if out2 else None,
               "raw": self._empty((r, n - n_act)) if n_act < n else None,
               "db": self._empty((plan["row_tiles"], n_act)) if db else None}
        ptr = {key: None if t is None else t.data_ptr() for key, t in res.items()}
        if not z.is_contiguous() or z.shape != (*lead, n_act):
            raise ValueError(f"{mode}: stash {tuple(z.shape)}, expected {(*lead, n_act)}")
        _build.check(self.lib.neddf_fold_nt(
            self.dt, int(nn), _ACT_CODES[act_name], fold_mode, streams, r, n, k, a.data_ptr(),
            a.stride(-2), None if a2 is None else a2.data_ptr(), 0 if a2 is None else a2.stride(0),
            k1, b.data_ptr(), b.stride(0), None if planes is None else planes[0].data_ptr(),
            None if planes is None else planes[1].data_ptr(), plan["ldw"], z.data_ptr(),
            None if side is None else side.data_ptr(), n_act, ptr["out"], ptr["out2"],
            ptr["raw"], ptr["db"], self.stream), f"backward product ({mode} epilogue)")
        if db:
            res["db"] = self.sum_rows(res["db"])
        FOLD_LAUNCHES[mode] += 1
        return res

    def tn_act(self, z: Tensor, g: Tensor, act_name: str) -> Tensor:
        """f(z) [R, m]^T times g [R, n] -> [m, n] f32: dW of a layer whose
        input is the activation of the stash z (T), f applied, and rounded
        to T, as the product's prologue (route_tn)."""
        return self._fold_tn("tn_act", z, g, act_name)

    def nt_act(self, a: Tensor, w_rows: Tensor, z: Tensor, act_name: str, *,
               add: Optional[Tensor] = None, n_act: Optional[int] = None, keep: bool = False,
               db: bool = False):
        """y = a w_rows^T as in ``nt``, and in its epilogue (route_nt), over
        the first ``n_act`` columns (all by default), v = y f'(z) (+ add):
        returns (T(v) [R, n_act], the other columns of y raw [R, n - n_act]
        f32 or None, y's first n_act columns f32 if ``keep`` else None, the
        column sums of v [n_act] f32 if ``db`` else None)."""
        res = self._fold_nt("nt_act", a, w_rows, z, act_name, _MODE_DACT, side=add, n_act=n_act,
                            out2=keep, db=db)
        return res["out"], res["raw"], res["out2"], res["db"]

    def nn_adjoint(self, a: Tensor, w_rows: Tensor, z: Tensor, act_name: str, *,
                   a2: Optional[Tensor] = None, q: Optional[Tensor] = None, top: bool = False):
        """pbar = [a | a2] w_rows (w_rows [k, n]; ``a2``, if given, is a
        second K segment against the rows of ``w_rows`` after a's), and in
        its epilogue (route_nt, f32) the adjoint of the sweep: (qbar = pbar
        f'(z) or None at the ``top``, zs = pbar q f''(z), or at the top
        onehot0 pbar f''(z); None where f'' is identically zero)."""
        if act_name in SECOND_DERIVATIVE_ZERO:
            if top:
                raise ValueError("the sweep's top adjoint is zero where f'' is")
            res = self._fold_nt("nn_adjoint", a, w_rows, z, act_name, _MODE_DACT, a2=a2)
            return res["out"], None
        res = self._fold_nt("nn_adjoint", a, w_rows, z, act_name, _MODE_ADJOINT, a2=a2, side=q,
                            out=not top, out2=True)
        return res["out"], res["out2"]

    def layer_fwd(self, xs: Sequence[Tensor], w: Tensor, b: Tensor, act_name: str,
                  stash: bool):
        """One layer of the per-layer route (``csrc/layer_fwd.cu``, the
        kernel ``layer_fwd_plan`` picks): the streams x [S, M, K] in one or
        two K segments ``xs`` (T, each a contiguous [S, M, k_i]) times the
        weight columns w [K, N] (T, N contiguous), the bias b [N] f32 on
        the value stream, activated: returns (out [S, M, N], the stash z
        [S, M, N] or None), both T."""
        t0 = time.perf_counter()
        s, m = xs[0].shape[:2]
        n = w.shape[1]
        if len(xs) > 2 or sum(x.shape[2] for x in xs) != w.shape[0]:
            raise ValueError(f"layer forward: segments {[tuple(x.shape) for x in xs]}, "
                             f"weight {tuple(w.shape)}")
        for t in (*xs, w):
            if t.dtype != self.dtype or not t.is_contiguous():
                raise ValueError("layer forward: operand dtype or layout")
        if b.dtype != torch.float32 or not b.is_contiguous() or b.shape != (n,):
            raise ValueError(f"layer forward: bias {b.dtype} {tuple(b.shape)}")
        out = self._empty((s, m, n), self.dtype)
        z = self._empty((s, m, n), self.dtype) if stash else None
        if m == 0:
            return out, z
        ks = [x.shape[2] for x in xs]
        plan = layer_fwd_plan(s, m, n, ks, w.element_size(),
                              [t.data_ptr() for t in (*xs, w, b)])
        wt, kp = [None, None], 0
        if plan["kernel"] == "wide":
            xs = [_padded(x, width) if pad else x
                  for x, width, pad in zip(xs, plan["widths"], plan["pad"])]
            kp = plan["kp"]
            planes = self._empty((plan["planes"], n, kp), self.dtype)
            wt = [p.data_ptr() for p in planes] + [None] * (2 - plan["planes"])
        x1 = xs[1] if len(xs) == 2 else None
        _build.check(self.lib.neddf_layer_fwd(
            self.dt, _ACT_CODES[act_name], int(plan["kernel"] == "wide"), s, m, n,
            xs[0].data_ptr(), xs[0].shape[2], None if x1 is None else x1.data_ptr(),
            0 if x1 is None else x1.shape[2], ks[0], ks[1] if x1 is not None else 0,
            w.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if z is None else z.data_ptr(), wt[0], wt[1], kp, self.stream),
            f"per-layer forward ({plan['kernel']})")
        LAYER_FWD_LAUNCHES[plan["kernel"]] += 1
        if plan["kernel"] == "wide":
            LAYER_FWD_WIDE_STREAMS[f"s{s}"] += 1
        ROUTE_LAUNCHES["fwd" if s > 1 else "fwd_value"] += 1
        LAYER_FWD_HOST["s"] += time.perf_counter() - t0
        return out, z


def layer_fwd_plain(xs, w, b, act_name: str, stash: bool, dtype: torch.dtype):
    """Plain version of ``Products.layer_fwd`` (in ``ProductsPlain``): one
    f32 matmul of the joined segments, the bias on the value stream, the
    activation in f32, both outputs rounded to ``dtype``."""
    layer_fwd_plain.calls += 1
    f, df, _ = ACTIVATION_TRIPLES[act_name]
    z = torch.cat(list(xs), dim=-1).float() @ w.float()
    z = torch.cat([z[:1] + b.float(), z[1:]], dim=0)
    return _dual_act(z, f, df).to(dtype), z.to(dtype) if stash else None


# calls of the plain layer forward (a run through the kernels makes none)
layer_fwd_plain.calls = 0


class ProductsPlain:
    """The plain version of ``Products``: the same methods in PyTorch on any
    device, each product one f32 matmul of the operands (as
    ``products_plain``), the epilogues and prologues as elementwise torch
    ops with the activations of ``ops/activations.py``. The backwards'
    walks (``mlp.mlp_seg_bwd_route``, ``sdf_mlp.sdf_mlp_bwd_route``) run
    over it on the CPU, where their tests hold them to the plain versions
    and to the JAX package. ``planes`` lists the [rows, n] planes the walk
    had the launcher write, by role, in order (the card's ``Products``
    writes the same ones)."""

    def __init__(self, dtype: torch.dtype) -> None:
        self.dtype = dtype
        self.planes: List[str] = []

    def nt(self, a: Tensor, w_rows: Tensor) -> Tensor:
        return route_product_plain("nt", a, w_rows)

    def tn(self, a: Tensor, g: Tensor) -> Tensor:
        return route_product_plain("tn", a, g)

    def nn(self, a: Tensor, w_rows: Tensor) -> Tensor:
        return route_product_plain("nn", a, w_rows)

    def tn_act(self, z: Tensor, g: Tensor, act_name: str) -> Tensor:
        f = ACTIVATION_TRIPLES[act_name][0]
        return self.tn(f(z.float()).to(self.dtype), g)

    def nt_act(self, a, w_rows, z, act_name, *, add=None, n_act=None, keep=False, db=False):
        df = ACTIVATION_TRIPLES[act_name][1]
        y = self.nt(a, w_rows)
        n_act = y.shape[1] if n_act is None else n_act
        ya = y[:, :n_act]
        v = ya * df(z.float())
        if add is not None:
            v = v + add
        raw = y[:, n_act:] if n_act < y.shape[1] else None
        self.planes += ["act"] + ["raw"] * (raw is not None) + ["q"] * keep
        return (v.to(self.dtype), raw, ya if keep else None, v.sum(dim=0) if db else None)

    def nn_adjoint(self, a, w_rows, z, act_name, *, a2=None, q=None, top=False):
        _, df, ddf = ACTIVATION_TRIPLES[act_name]
        k1 = a.shape[1]
        pbar = self.nn(a, w_rows[:k1])
        if a2 is not None:
            pbar = pbar + self.nn(a2, w_rows[k1:])
        zf = z.float()
        qbar = None if top else (pbar * df(zf)).to(self.dtype)
        self.planes += ["qbar"] * (not top)
        if act_name in SECOND_DERIVATIVE_ZERO:
            if top:
                raise ValueError("the sweep's top adjoint is zero where f'' is")
            return qbar, None
        if q is None:
            q = torch.zeros_like(pbar)
            q[:, 0] = 1.0
        self.planes.append("zs")
        return qbar, pbar * q * ddf(zf)

    def layer_fwd(self, xs, w, b, act_name, stash):
        self.planes += ["fwd"] + ["stash"] * stash
        return layer_fwd_plain(xs, w, b, act_name, stash, self.dtype)


class DualProducts(Products):
    """``Products`` and the dual backward's own launches over S = K+1
    stacked streams [S, M, C]: the top layer's stacked cotangent
    (``gstack``, an elementwise kernel), and the two products of every
    layer below it over rows grouped by point (``grouped_rows``), dx with
    the next layer's stacked cotangent as its epilogue (``nt_gstack``)
    and dW with the layer input as its prologue (``tn_dual_act``)."""

    def gstack(self, gv: Tensor, gj: Tensor, z: Tensor, act_name: str):
        """The top layer's (T(G) [S, M, C], db [C] f32) from the output
        cotangents gv [M, C], gj [K, M, C] (in T, or in f32: the per-layer
        route's) and the stash z [S, M, C] in T: G_v = g_v f'(z_v) +
        f''(z_v) sum_a g_a z_a, G_a = g_a f'(z_v); db the column sums of
        G_v."""
        s, m, c = z.shape
        g_f32 = gv.dtype == torch.float32
        if gj.dtype != gv.dtype or gv.dtype not in (self.dtype, torch.float32):
            raise TypeError(f"gstack: cotangents {gv.dtype}/{gj.dtype}")
        gs = self._empty((s, m, c), self.dtype)
        parts = self._empty((-(-m // _DB_ROWS), c))
        _build.check(self.lib.neddf_dual_bwd_gstack(
            self.dt, int(g_f32), _ACT_CODES[act_name], s - 1, c, m, _DB_ROWS, gv.data_ptr(),
            gj.data_ptr(), z.data_ptr(), gs.data_ptr(), parts.data_ptr(), self.stream),
            "dual backward gstack")
        PASS_LAUNCHES["gstack"] += 1
        return gs, self.sum_rows(parts)

    def nt_gstack(self, gs: Tensor, w_rows: Tensor, z: Tensor, act_name: str):
        """g = gs w_rows^T over the S planes of gs [S, M, C] (T) and w_rows
        [n, C] (T), and in its epilogue (route_nt over rows grouped by
        point) the stacked cotangent of the layer below from its stash z
        [S, M, n]: returns (T(G) [S, M, n], the column sums of G_v [n]
        f32), g never stored."""
        res = self._fold_nt("nt_gstack", gs, w_rows, z, act_name, 0, db=True)
        return res["out"], res["db"]

    def tn_dual_act(self, z: Tensor, gs: Tensor, act_name: str) -> Tensor:
        """dW = h_in^T gs over the S * M rows -> [m, n] f32, with the layer
        input h_in = (f(z_v), f'(z_v) z_a) of the stash z [S, M, m] (T)
        formed, and rounded to T, as the product's prologue (route_tn over
        rows grouped by point); gs [S, M, n]."""
        return self._fold_tn("tn_dual_act", z, gs, act_name)


class DualProductsPlain(ProductsPlain):
    """The plain version of ``DualProducts``: the same methods in PyTorch,
    with the grouped tile's bookkeeping (the reduction in grouped stages
    and splits, the db partials per 64-row block or per tile, each summed
    as ``sum_rows`` sums them) so that ``dual_mlp_seg_bwd_route`` runs the
    card's call sequence on the CPU. The stacked cotangent is formed as
    ``dual_mlp_seg_bwd_plain`` forms it, from the tangent stash only
    where f'' is not zero."""

    def _gstack(self, g: Tensor, z: Tensor, act_name: str, rows: int):
        _, df, ddf = ACTIVATION_TRIPLES[act_name]
        zf = z.float()
        d1 = df(zf[0])
        gv = g[0] * d1
        if act_name not in SECOND_DERIVATIVE_ZERO:
            gv = gv + ddf(zf[0]) * torch.sum(g[1:] * zf[1:], dim=0)
        gs = torch.cat([gv[None], g[1:] * d1], dim=0).to(self.dtype)
        m, c = gv.shape
        parts = torch.zeros((-(-m // rows) * rows, c), dtype=torch.float32, device=gv.device)
        parts[:m] = gv
        return gs, sum_rows_plain(parts.view(-1, rows, c).sum(dim=1))

    def gstack(self, gv, gj, z, act_name):
        self.planes.append("gstack")
        return self._gstack(torch.cat([gv[None], gj], dim=0).float(), z, act_name, _DB_ROWS)

    def nt_gstack(self, gs, w_rows, z, act_name):
        self.planes.append("gs")
        return self._gstack(self.nt(gs, w_rows), z, act_name, _EPI_ROWS // gs.shape[0])

    def tn_dual_act(self, z, gs, act_name):
        f, df, _ = ACTIVATION_TRIPLES[act_name]
        s, pts, m = z.shape
        n = gs.shape[2]
        plan = fold_plan("tn_dual_act", m, n, pts, z.element_size(), streams=s)
        h = _dual_act(z.float(), f, df).to(self.dtype).reshape(s * pts, m)
        g = gs.reshape(s * pts, n)
        step = plan["step"]
        per = plan["k_chunk"] // step  # k-blocks per split
        stages = grouped_rows(s, pts, step)
        out = torch.zeros((m, n), dtype=torch.float32, device=z.device)
        for split in range(plan["splits"]):
            rows = stages[split * per : (split + 1) * per].reshape(-1)
            rows = rows[rows >= 0]
            out = out + self.tn(h[rows], g[rows])
        return out


def dual_mlp_seg_bwd_route(vs, js, weights, layout, act_name, has_j, pres, gv, gj, k,
                           top=None):
    """The kernels' walk of the dual backward over the launcher ``k``
    (``DualProducts`` on the card, ``DualProductsPlain`` in the CPU
    tests), as ``dual_mlp_seg_bwd_plain`` computes it: the top layer's
    stacked cotangent G by its own kernel (``gstack``), or ``top`` = (G,
    db) as the caller formed them (the NeDDF epilogue's top mode, which
    then passes gv = gj = None); then per layer l >
    0, in reverse, dW_l = h_in^T G with h_in = (f(z_v), f'(z_v) z_a) of
    the stash z_{l-1} as the tn product's prologue (``tn_dual_act``), and
    G W_l^T with the epilogue G_{l-1} and its db (``nt_gstack``); a
    post-skip layer's seg0 rows of W take plain products (their dx is raw:
    it joins layer 0's first segment), and layer 0's segments too."""
    dtype = vs[0].dtype
    s, m, _ = pres[-1].shape
    n_tan = s - 1
    seg_j = _seg_js(js, has_j)
    c0 = vs[0].shape[1]
    n_layers = len(weights)
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dvs: List[Tensor] = []
    djs: List[Tensor] = []
    gs, dbs[-1] = top if top is not None else k.gstack(gv, gj, pres[-1], act_name)
    g_skip = None
    for li in reversed(range(n_layers)):
        w = weights[li]
        flat_g = gs.view(s * m, gs.shape[2])
        if li == 0:
            blocks, off = [], 0
            for i, (v, j) in enumerate(zip(vs, seg_j)):
                wi = v.shape[1]
                rows = w[off : off + wi]
                off += wi
                if has_j[i]:
                    d_in = k.nt(flat_g, rows)
                    if i == 0 and g_skip is not None:
                        d_in += g_skip
                    d_in = d_in.view(s, m, wi).to(dtype)
                    dvs.append(d_in[0])
                    djs.append(d_in[1:])
                    blocks.append(k.tn(torch.cat([v[None], j], dim=0).view(s * m, wi), flat_g))
                else:
                    dvs.append(k.nt(gs[0], rows).to(dtype))
                    blocks.append(k.tn(v, gs[0]))
            dws[0] = torch.cat(blocks, dim=0)
            break
        dws[li] = k.tn_dual_act(pres[li - 1], gs, act_name)
        if layout[li]:
            skip = k.nt(flat_g, w[:c0])
            g_skip = skip if g_skip is None else g_skip + skip
            stack0 = _stack(vs[0], seg_j[0], n_tan).view(s * m, c0)
            dws[li] = torch.cat([k.tn(stack0, flat_g), dws[li]], dim=0)
            w = w[c0:]
        gs, dbs[li - 1] = k.nt_gstack(gs, w, pres[li - 1], act_name)
    return dvs, djs, dws, dbs


def dual_mlp_seg_bwd(
    vs: Sequence[Tensor],
    js: Sequence[Tensor],
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    has_j: Sequence[bool],
    pres: Sequence[Tensor],
    gv: Optional[Tensor],
    gj: Optional[Tensor],
    top: Optional[Tuple[Tensor, Tensor]] = None,
):
    """Dual-MLP backward: the CUDA kernels for CUDA tensors
    (``dual_mlp_seg_bwd_route`` over ``DualProducts``), the plain version
    for CPU tensors (see ``dual_mlp_seg_bwd_plain``, also for ``top``).

    The top layer's stacked cotangent (with the f'' coupling) comes from
    its own kernel, or from the caller (``top``: the NeDDF trunk's, from
    the epilogue's backward, ``kernels/neddf_epilogue.py``); below it,
    ``csrc/route_products.cu`` folds each layer's elementwise work into
    its two f32-accumulating products on wgmma (f32 by the 3xTF32 split),
    whose rows are grouped by point so
    that a tile holds every stream of its points: dW = h_in^T G forms the
    layer input from the stash as its prologue, and dx = G W^T leaves as
    the next layer's stacked cotangent and its db partials through its
    epilogue. dW and db are split into a fixed number of partials summed
    in a fixed order, so two runs give bitwise-equal results.
    """
    device = vs[0].device
    if device.type == "cpu":
        return dual_mlp_seg_bwd_plain(vs, js, weights, layout, act_name, has_j, pres, gv, gj,
                                      top)
    if device.type != "cuda":
        raise ValueError(f"dual_mlp_seg_bwd: unsupported device {device}")
    if not pres or len(pres) != len(weights):
        raise ValueError("dual_mlp_seg_bwd: one stash per layer")
    s, m, width = pres[-1].shape
    n_tan = s - 1
    biases = [torch.empty(w.shape[1], device=device) for w in weights]
    _check_seg_args(vs, js, weights, biases, layout, act_name, has_j, n_tan)
    dtype = vs[0].dtype
    if top is None:
        cots, shapes = (gv, gj), [(m, width), (n_tan, m, width)]
    else:
        cots, shapes = (top[0],), [(s, m, width)]
        if tuple(top[1].shape) != (width,) or top[1].dtype != torch.float32:
            raise ValueError("dual_mlp_seg_bwd: the top db")
    for t in (*pres, *cots):
        if t.dtype != dtype or not t.is_contiguous() or t.device != device:
            raise ValueError("dual_mlp_seg_bwd: stash/cotangent dtype, layout or device")
    if [tuple(t.shape) for t in cots] != shapes or any(
            tuple(p.shape) != (s, m, width) for p in pres):
        raise ValueError("dual_mlp_seg_bwd: stash/cotangent shapes")
    out = dual_mlp_seg_bwd_route(vs, js, weights, layout, act_name, has_j, pres, gv, gj,
                                 DualProducts(dtype, device), top)
    dual_mlp_seg_bwd.launches += 1
    return out


dual_mlp_seg_bwd.launches = 0


# ------------------------------------------------------------- autograd op
class DualMLPSeg(torch.autograd.Function):
    """``dual_mlp_seg`` with its hand-written backward (``_seg_fwd`` /
    ``_seg_bwd:1175-1227``).

    ``apply(config, *vs, *js, *weights, *biases)`` with ``config =
    (layout, act_name, has_j, n_tan, compute_dtype, use_kernels)``.
    ``weights``/``biases`` are the f32 master parameters: the weights are
    cast to ``compute_dtype`` inside, dW and db come back in f32.
    ``use_kernels=False`` runs the plain versions on any device;
    ``True`` lets the wrappers choose by device (kernels on CUDA).
    Returns ``(v [M, C], j [K, M, C])`` in the compute dtype.
    """

    @staticmethod
    def forward(ctx, config, *args):
        layout, act_name, has_j, n_tan, cd, use_kernels = config
        n_seg, n_j, n_l = len(has_j), sum(has_j), len(layout)
        vs = args[:n_seg]
        js = args[n_seg : n_seg + n_j]
        weights = [w.to(cd).contiguous() for w in args[n_seg + n_j : n_seg + n_j + n_l]]
        biases = [b.float().contiguous() for b in args[n_seg + n_j + n_l :]]
        stash = any(ctx.needs_input_grad[1:])
        if not use_kernels:
            out = dual_mlp_seg_plain(vs, js, weights, biases, layout, act_name, has_j,
                                     n_tan, stash)
        elif n_seg == 1 and tuple(has_j) == (True,):
            out = dual_mlp_trunk(vs[0], js[0], weights, biases, layout, act_name, stash)
        else:
            out = dual_mlp_seg(vs, js, weights, biases, layout, act_name, has_j, n_tan,
                               stash)
        if stash:
            ctx.config = config
            ctx.save_for_backward(*vs, *js, *weights, *out[2])
        return out[0], out[1]

    @staticmethod
    def backward(ctx, gv, gj):
        layout, act_name, has_j, n_tan, cd, use_kernels = ctx.config
        saved = ctx.saved_tensors
        n_seg, n_j, n_l = len(has_j), sum(has_j), len(layout)
        vs = saved[:n_seg]
        js = saved[n_seg : n_seg + n_j]
        weights = saved[n_seg + n_j : n_seg + n_j + n_l]
        pres = saved[n_seg + n_j + n_l :]
        gv = gv.to(cd).contiguous()
        gj = gj.to(cd).contiguous()
        bwd = dual_mlp_seg_bwd if use_kernels else dual_mlp_seg_bwd_plain
        dvs, djs, dws, dbs = bwd(vs, js, weights, layout, act_name, has_j, pres, gv, gj)
        return (None, *dvs, *djs, *dws, *dbs)


def dual_mlp_apply(vs, js, weights, biases, layout, act_name, has_j, n_tan,
                   compute_dtype, use_kernels):
    """Differentiable ``dual_mlp_seg`` (see ``DualMLPSeg``)."""
    config = (tuple(layout), act_name, tuple(has_j), n_tan, compute_dtype, use_kernels)
    return DualMLPSeg.apply(config, *vs, *js, *weights, *biases)


# ------------------------------------------------------- the per-layer route
def layer_launcher(dtype: torch.dtype, device: torch.device, use_kernels: bool,
                   kinds: tuple = (DualProducts, DualProductsPlain)):
    """The per-layer route's launcher: the kernels' (``kinds[0]``) for CUDA
    tensors under ``use_kernels``, else their plain version (``kinds[1]``);
    the value-only and the sdf routes pass their own pair."""
    kernels, plain = kinds
    if use_kernels and device.type == "cuda":
        return kernels(dtype, device)
    if use_kernels and device.type != "cpu":
        raise ValueError(f"the per-layer route: unsupported device {device}")
    return plain(dtype)


def _layer0_segments(stacks: Sequence[Tensor]) -> List[Tensor]:
    """Layer 0's stacked input segments as at most two K segments of the
    per-layer forward: one, or all but the last (the narrow ones: the
    colour trunk's PE, direction and normal) joined, and the last."""
    if len(stacks) <= 2:
        return [s.contiguous() for s in stacks]
    return [torch.cat(list(stacks[:-1]), dim=-1), stacks[-1].contiguous()]


def post_skip_input(seg0: Tensor, full: Tensor, hidden_first: bool) -> List[Tensor]:
    """A post-skip layer's input as the per-layer forward's two K
    segments: ``[h, seg0]`` (NeRF and NeuS, the weight's hidden rows
    first) or ``[seg0, h]`` (NeDDF)."""
    return [full, seg0] if hidden_first else [seg0, full]


def dual_mlp_layers_walk(vs, js, weights, biases, layout, act_name, has_j, n_tan, k,
                         group=None, stash=False, hidden_first=False, whole_last=False):
    """The per-layer route's forward: a dual MLP (``dual_mlp_seg``'s
    arguments; K = ``n_tan`` in {0, 1, 3}, 0 the value-only MLP of
    ``kernels/mlp.py``) one layer at a time over the launcher ``k``, each
    layer this rank's column shard of the weights ([fan_in, W/n]; the
    whole layer where ``group`` is None), its output gathered to the full
    width over the model group ``group`` (``parallel/tp.py``) before the
    next layer, which reads it, and layer 0's segments and a post-skip
    layer's input (``post_skip_input``: ``[h, seg0]`` when
    ``hidden_first``, else ``[seg0, h]``) as two K segments. With
    ``whole_last`` the last layer is whole on every rank (NeuS's 3-wide
    colour output, which the JAX rule replicates) and its output is not
    gathered.

    Returns (the full-width stacked output [K+1, M, W] in the compute
    dtype, every layer's input segments, every layer's stash [K+1, M,
    W/n] or None)."""
    from neddf_tpu_torch.parallel.tp import all_gather_last

    if isinstance(k, Products):
        _route_checks(weights, act_name, n_tan, group, "the per-layer route", whole_last)
    seg_j = _seg_js(js, has_j)
    stacks = [_stack(v, j, n_tan) for v, j in zip(vs, seg_j)]
    seg0 = stacks[0].contiguous()
    h = _layer0_segments(stacks)
    inputs, pres = [], []
    last = len(weights) - 1
    for li, (w, b) in enumerate(zip(weights, biases)):
        if li > 0:
            h = post_skip_input(seg0, full, hidden_first) if layout[li] else [full]
        inputs.append(h)
        out, z = k.layer_fwd(h, w, b, act_name, stash)
        pres.append(z)
        full = out if whole_last and li == last else all_gather_last(out, group)
    return full, inputs, pres


def dual_mlp_layers_bwd(inputs, weights, layout, act_name, seg_widths, has_j, pres, g, k,
                        group=None, hidden_first=False, whole_last=False):
    """The per-layer route's backward from ``g`` [K+1, M, W], the cotangent
    of the gathered output (any float dtype), over the launcher ``k``:
    the sum reduce-scatter over the model group gives this rank's columns
    in f32 (``parallel/tp.py``; a ``whole_last`` layer's own cotangent
    stays as it is); then per layer, in reverse, the stacked cotangent of
    the pre-activation from the stash (``gstack``, f32 in; one stream:
    ``gpre``, the value-only MLP's), dW = x^T G and db over the layer's
    input segments (tn products), and G W^T (nt), this rank's part of the
    cotangent of the full-width input: for the layer below,
    reduce-scattered again; a post-skip layer's seg0 rows and layer 0's,
    this rank's cotangents of its replicated inputs.

    Returns (dvs per segment [M, w_i], djs per tangent input [K, M, w_i],
    both in the compute dtype; dW per layer [fan_in, W/n] and db [W/n],
    f32)."""
    from neddf_tpu_torch.parallel.tp import reduce_scatter_last

    dtype = pres[0].dtype
    s, m = g.shape[:2]
    c0 = seg_widths[0]
    n_layers = len(weights)
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    g = (g.float() if whole_last else reduce_scatter_last(g, group)).contiguous()
    g_skip = None
    for li in reversed(range(n_layers)):
        w = weights[li]
        if s == 1:
            gs, dbs[li] = k.gpre(g[0], pres[li][0], act_name)
            gs = gs[None]
        else:
            gs, dbs[li] = k.gstack(g[0], g[1:], pres[li], act_name)
        flat = gs.view(s * m, gs.shape[2])
        dws[li] = torch.cat([k.tn(x.view(s * m, x.shape[2]), flat) for x in inputs[li]],
                            dim=0)
        if li == 0:
            d_in = k.nt(flat, w).view(s, m, w.shape[0])
            dvs, djs, off = [], [], 0
            for i, wi in enumerate(seg_widths):
                d = d_in[:, :, off : off + wi]
                if i == 0 and g_skip is not None:
                    d = d + g_skip
                off += wi
                dvs.append(d[0].to(dtype))
                if has_j[i]:
                    djs.append(d[1:].to(dtype))
            return dvs, djs, dws, dbs
        if layout[li]:
            c = w.shape[0] - c0
            seg_rows, w = (w[c:], w[:c]) if hidden_first else (w[:c0], w[c0:])
            skip = k.nt(flat, seg_rows).view(s, m, c0)
            g_skip = skip if g_skip is None else g_skip + skip
        g = reduce_scatter_last(k.nt(flat, w).view(s, m, w.shape[0]), group).contiguous()
    raise ValueError("dual_mlp_layers_bwd: no layers")


def saved_route(ctx, n_layers: int):
    """(weights, stashes, every layer's input segments) that a per-layer
    route's autograd op saved as ``*weights, *pres, *inputs`` with
    ``ctx.n_inputs`` segments per layer."""
    saved = ctx.saved_tensors
    flat = list(saved[2 * n_layers :])
    inputs = []
    for n in ctx.n_inputs:
        inputs.append(flat[:n])
        flat = flat[n:]
    return saved[:n_layers], saved[n_layers : 2 * n_layers], inputs


def _route_checks(weights, act_name, n_tan, group, what: str, whole_last: bool = False) -> None:
    from neddf_tpu_torch.parallel.tp import group_size

    width = weights[0].shape[1] * group_size(group)
    _refuse(what, route_refusal(act_name, width, n_tan))
    sharded = weights[:-1] if whole_last else weights
    for w in sharded[1:]:
        if w.shape[1] != weights[0].shape[1]:
            raise ValueError(f"{what}: layer widths {[w.shape[1] for w in weights]}")
    if whole_last and weights[-1].shape[1] < 1:
        raise ValueError(f"{what}: last layer width {weights[-1].shape[1]}")


class DualMLPLayers(torch.autograd.Function):
    """The per-layer route of ``dual_mlp_seg`` (``dual_mlp_layers_walk`` /
    ``dual_mlp_layers_bwd``) as an autograd op: the route of a width
    shard under tensor parallelism and of the configurations the fused
    kernels refuse (widths over the tile forward's 512, deeper trunks).

    ``apply(config, *vs, *js, *weights, *biases)`` with ``config =
    (layout, act_name, has_j, n_tan, compute_dtype, use_kernels,
    group)``; ``weights``/``biases`` this rank's f32 master column shards
    (cast to the compute dtype inside; dW and db come back f32),
    ``group`` the model group (None: one shard). Returns the gathered
    stacked output [K+1, M, W] in the compute dtype (value, then the K
    tangent planes)."""

    @staticmethod
    def forward(ctx, config, *args):
        layout, act_name, has_j, n_tan, cd, use_kernels, group = config
        n_seg, n_j, n_l = len(has_j), sum(has_j), len(layout)
        vs = args[:n_seg]
        js = args[n_seg : n_seg + n_j]
        weights = [w.to(cd).contiguous() for w in args[n_seg + n_j : n_seg + n_j + n_l]]
        biases = [b.float().contiguous() for b in args[n_seg + n_j + n_l :]]
        device = vs[0].device
        k = layer_launcher(cd, device, use_kernels)
        stash = any(ctx.needs_input_grad[1:])
        full, inputs, pres = dual_mlp_layers_walk(vs, js, weights, biases, layout, act_name,
                                                  has_j, n_tan, k, group, stash)
        if isinstance(k, Products):
            dual_mlp_layers.launches += 1
        if stash:
            ctx.config = config
            ctx.seg_widths = [v.shape[1] for v in vs]
            ctx.n_inputs = [len(x) for x in inputs]
            ctx.save_for_backward(*weights, *pres, *[t for x in inputs for t in x])
        return full

    @staticmethod
    def backward(ctx, g):
        layout, act_name, has_j, n_tan, cd, use_kernels, group = ctx.config
        weights, pres, inputs = saved_route(ctx, len(layout))
        k = layer_launcher(cd, g.device, use_kernels)
        dvs, djs, dws, dbs = dual_mlp_layers_bwd(inputs, weights, layout, act_name,
                                                 ctx.seg_widths, has_j, pres, g, k, group)
        return (None, *dvs, *djs, *dws, *dbs)


def dual_mlp_layers(vs, js, weights, biases, layout, act_name, has_j, n_tan, compute_dtype,
                    use_kernels, group=None):
    """Differentiable per-layer route (see ``DualMLPLayers``): the gathered
    stacked output [K+1, M, W]."""
    config = (tuple(layout), act_name, tuple(has_j), n_tan, compute_dtype, use_kernels, group)
    return DualMLPLayers.apply(config, *vs, *js, *weights, *biases)


# calls of the per-layer route that ran its kernels (each call launches
# ROUTE_LAUNCHES["fwd"] once per layer)
dual_mlp_layers.launches = 0
