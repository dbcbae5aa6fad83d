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
                   trunk: bool = True) -> Optional[str]:
    """What of a configuration the CUDA dual-MLP kernels do not take (None:
    they take it): the K=3 trunk (``trunk``) or the multi-segment
    configuration. The checks below raise NotImplementedError on it."""
    if act_name not in _ACT_CODES:
        return f"activation {act_name!r}"
    if (refusal := width_refusal(width)) is not None:
        return refusal
    if not 1 <= n_layers <= _KERNEL_MAX_LAYERS:
        return f"{n_layers} layers"
    if n_tan not in (_KERNEL_N_TAN if trunk else _SEG_N_TAN):
        return f"K={n_tan}"
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
    _refuse(what, kernel_refusal(act_name, weights[0].shape[1] if weights else 0,
                                 len(weights), j0.shape[0]))
    _check_layers([v0], weights, biases, layout, what)


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
    _refuse(what, kernel_refusal(act_name, weights[0].shape[1] if weights else 0,
                                 len(weights), n_tan, trunk=False))
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


# launches of the row-tile forward (csrc/mlp_tile.cuh) by operand type:
# "tc" (bf16 mma) and "tf32x3" (f32 by the 3xTF32 split), both on the
# tensor cores, over every wrapper that runs it
TILE_LAUNCHES = {"tc": 0, "tf32x3": 0}


def count_tile_launch(dtype: torch.dtype) -> None:
    TILE_LAUNCHES["tc" if dtype == torch.bfloat16 else "tf32x3"] += 1


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
    code = lib.neddf_dual_mlp_fwd(
        _KERNEL_DTYPES[dtype], _ACT_CODES[act_name], n_tan, width, m, len(vs),
        _build.pointers(vs), _build.pointers(seg_j), _build.ints([v.shape[1] for v in vs]),
        len(weights), _build.pointers(weights), _build.pointers(biases),
        _build.ints(layout), _build.pointers(pres) if stash else None,
        v_out.data_ptr(), j_out.data_ptr(), _build.stream(device),
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

# split-K products: one partial per 2048 reduced rows, at most 64: the
# four 128x128 tiles of a 256x256 dW in 64 splits are one wave of two
# blocks per SM
_TC_ROWS_PER_SPLIT = 2048
_TC_MAX_SPLITS = 64
# csrc/dual_mlp_bwd.cu TcShape::BK, the depth of a stage (128 bytes of a
# row) by element size: a split covers whole stages
_TC_DEPTH = {2: 64, 4: 32}
_TC_LAYOUTS = {"nt": 0, "tn": 1, "nn": 2}
_DB_ROWS = 64  # rows per block of the cotangent kernel (one db partial each)
_STREAMS = (1, 2, 4)  # S of the products' rows grouped by point (1: not grouped)


def _vec_width(ptr: int, ld: int, itemsize: int) -> int:
    """Elements per copy (16, 8 or 4 bytes of them, or one bf16) that a row
    stride of ``ld`` elements from the byte address ``ptr`` keeps
    aligned; raises ValueError for a pointer off its element size."""
    if ptr % itemsize:
        raise ValueError(f"tensor-core product: pointer {ptr:#x} not {itemsize}-byte aligned")
    for nbytes in (16, 8, 4):
        vec = nbytes // itemsize
        if ptr % nbytes == 0 and ld % vec == 0:
            return vec
    return 1


def tc_plan(m: int, n: int, k: int, sam: int, sak: int, sbk: int, sbn: int,
            a_ptr: int = 0, b_ptr: int = 0, itemsize: int = 2, streams: int = 1) -> dict:
    """How the tensor-core product takes ``sum_k A(m, k) B(k, n)`` with
    ``A(m, k) = a[m*sam + k*sak]`` and ``B(k, n) = b[k*sbk + n*sbn]``, for
    operands of ``itemsize`` bytes (2: bf16, 4: f32 by the 3xTF32 split).

    Returns the layout (``nt``: K contiguous in both operands; ``tn``: M
    and N contiguous; ``nn``: K contiguous in A, N in B), each operand's
    row stride and copy width from its byte address, and the split of K
    into fixed-order partials with the rows each split covers (a
    multiple of the kernel's stage depth). With ``streams`` S > 1 (the
    dual backward's tn product over rows grouped by point) K counts
    points of S rows each: the splits are reckoned from S * k rows and
    cover a multiple of the points of one stage (depth / S). Raises
    ValueError for any other layout and for a pointer off its element
    size.
    """
    if sak == 1 and sbk == 1:
        layout, lda, ldb = "nt", sam, sbn
    elif sam == 1 and sbn == 1:
        layout, lda, ldb = "tn", sak, sbk
    elif sak == 1 and sbn == 1:
        layout, lda, ldb = "nn", sam, sbk
    else:
        raise ValueError(f"tensor-core product: strides ({sam}, {sak}) x ({sbk}, {sbn})")
    if itemsize not in _TC_DEPTH:
        raise ValueError(f"tensor-core product: {itemsize}-byte operands")
    lda, ldb = max(int(lda), 1), max(int(ldb), 1)
    if streams not in _STREAMS:
        raise ValueError(f"tensor-core product: {streams} streams")
    splits = max(1, min(_TC_MAX_SPLITS, -(-streams * k // _TC_ROWS_PER_SPLIT)))
    per_split = -(-k // splits)
    depth = _TC_DEPTH[itemsize] // streams
    k_chunk = -(-per_split // depth) * depth
    return {"layout": layout, "lda": lda, "ldb": ldb,
            "vec_a": _vec_width(a_ptr, lda, itemsize),
            "vec_b": _vec_width(b_ptr, ldb, itemsize), "splits": splits, "k_chunk": k_chunk}


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


# csrc/dual_mlp_bwd.cu: neddf_gemm_tc's code for "no activation", the
# epilogue's modes (kModeDact, kModeAdjoint), the rows of one db partial
# of an epilogue (kTcBM) and of one group of the db sum's first level
# (neddf_sum_rows)
_NO_ACT = -1
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
# tf32 k8 step (NeRF's 3-wide last layer's dx stays on tc_gemm_kernel);
# route_tn cuts its rows into fixed splits of a whole number of k-blocks,
# at least _ROUTE_MIN_SPLIT_BLOCKS each, at most _ROUTE_MAX_SPLITS, the
# fewest whose waves over the SMs take within _ROUTE_SPLIT_SLACK of the
# best count's k-blocks
ROUTE_NT_MIN_K = 8
_ROUTE_TILE = 128
_ROUTE_MIN_SPLIT_BLOCKS = 16
_ROUTE_MAX_SPLITS = 64
_ROUTE_SPLIT_SLACK = 1.05
_ROUTE_LAYOUTS = {"nt": 0, "tn": 1}
H100_SMS = 132


def route_plan(layout: str, m: int, n: int, k: int, lda: int, ldb: int, itemsize: int,
               a_ptr: int = 0, b_ptr: int = 0, sms: int = H100_SMS) -> dict:
    """How ``Products.nt`` / ``.tn`` launch ``out [m, n] f32``: ``nt`` a [m,
    k] b [n, k]^T, ``tn`` a [k, m]^T b [k, n] (a reduction over k rows),
    each operand's rows ``lda`` / ``ldb`` elements apart (contiguous
    within a row), operands of ``itemsize`` bytes (2 bf16, 4 f32) at the
    byte addresses ``a_ptr`` / ``b_ptr`` (ValueError off the element
    size), on a card of ``sms`` SMs.

    ``kernel``: "tc" (tc_gemm_kernel, for an nt depth k under
    ``ROUTE_NT_MIN_K``) or "route" (route_nt / route_tn), with ``pad_a`` /
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
        return {"kernel": "tc"}
    vec = 16 // itemsize

    def pad(ld: int, ptr: int, width: int) -> int:
        return 0 if (ld * itemsize) % 16 == 0 and ptr % 16 == 0 else -(-width // vec) * vec

    bk = _WIDE_BK[itemsize]
    if layout == "nt":
        f32 = itemsize == 4
        return {"kernel": "route", "pad_a": pad(lda, a_ptr, k),
                "pad_b": 0 if f32 else pad(ldb, b_ptr, k),
                "ldw": -(-k // vec) * vec if f32 else 0, "splits": 1, "k_chunk": 0}
    tiles = -(-m // _ROUTE_TILE) * -(-n // _ROUTE_TILE)
    blocks = max(1, -(-k // bk))
    top = max(1, min(_ROUTE_MAX_SPLITS, blocks // _ROUTE_MIN_SPLIT_BLOCKS))

    def span(s: int) -> int:  # k-blocks the busiest SM reduces
        return -(-tiles * s // sms) * -(-blocks // s)

    best = min(span(s) for s in range(1, top + 1))
    splits = next(s for s in range(1, top + 1) if span(s) <= best * _ROUTE_SPLIT_SLACK)
    k_chunk = -(-blocks // splits) * bk
    return {"kernel": "route", "pad_a": pad(lda, a_ptr, m), "pad_b": pad(ldb, b_ptr, n),
            "ldw": 0, "splits": max(1, -(-k // k_chunk)), "k_chunk": k_chunk}


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
    """Plain version of the route's products (``ProductsPlain.nt`` /
    ``.tn``): nt a [R, C] b [n, C]^T, tn a [R, m]^T b [R, n], one f32
    matmul of the operands."""
    route_product_plain.calls += 1
    if layout == "nt":
        return a.float() @ b.float().T
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
    """Launchers of the hand-written products of ``csrc/dual_mlp_bwd.cu``
    for one backward call: ``neddf_gemm_tc`` on the tensor cores (bf16
    operands by mma m16n8k16, f32 operands by the 3xTF32 split), alone or
    with an activation's elementwise work as the prologue of a tn product
    or the epilogue of an nt / nn one, and the fixed-order sums
    (``neddf_sum_splits``, ``neddf_sum_rows``); shared by the backwards of
    ``kernels/mlp.py``, ``kernels/sdf_mlp.py`` and this module, which add
    their own top-layer passes in subclasses. ``ProductsPlain`` computes
    the same in PyTorch, so that the backwards' walks run on the CPU.
    ``tc_launches`` (bf16) and ``tf32x3_launches`` (f32) count the
    launches of the product kernel, ``prologue_launches`` /
    ``epilogue_launches`` those of them with an activation folded in."""

    tc_launches = 0
    tf32x3_launches = 0
    prologue_launches = 0
    epilogue_launches = 0

    def __init__(self, dtype: torch.dtype, device: torch.device) -> None:
        self.lib = _build.library()
        self.dtype = dtype
        self.dt = _KERNEL_DTYPES[dtype]
        self.device = device
        self.stream = _build.stream(device)
        self.sms = _sm_count(torch.cuda.current_device() if device.index is None
                             else device.index)

    def _count(self) -> None:
        if self.dtype == torch.bfloat16:
            Products.tc_launches += 1
        else:
            Products.tf32x3_launches += 1

    def _empty(self, shape, dtype=torch.float32) -> Tensor:
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _plan(self, m, n, k, a, sam, sak, b, sbk, sbn, streams=1) -> dict:
        if a.dtype != self.dtype or b.dtype != self.dtype:
            raise TypeError(f"products: operands {a.dtype}/{b.dtype}, expected {self.dtype}")
        return tc_plan(m, n, k, sam, sak, sbk, sbn, a.data_ptr(), b.data_ptr(),
                       a.element_size(), streams)

    def gemm(self, m, n, k, a, sam, sak, b, sbk, sbn) -> Tensor:
        """sum_k a[m*sam + k*sak] * b[k*sbk + n*sbn] -> [m, n] f32, the k
        range split into a fixed number of partials summed in order."""
        plan = self._plan(m, n, k, a, sam, sak, b, sbk, sbn)
        splits = plan["splits"]
        out = self._empty((m, n))
        parts = out if splits == 1 else self._empty((splits, m, n))
        _build.check(self.lib.neddf_gemm_tc(
            self.dt, _TC_LAYOUTS[plan["layout"]], _NO_ACT, 0, 1, m, n, k, a.data_ptr(),
            plan["lda"], plan["vec_a"], None, 0, 0, 0, b.data_ptr(), plan["ldb"],
            plan["vec_b"], splits, parts.data_ptr(), None, None, 0, None, None, None, None,
            self.stream), "backward product")
        self._count()
        if splits > 1:
            self.sum_splits(parts, out)
        return out

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
        ``neddf_sum_splits``), or tc_gemm_kernel for an nt depth under
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
        if plan["kernel"] == "tc":
            if layout == "nt":
                return self.gemm(m, n, k, a, lda, 1, b, 1, ldb)
            return self.gemm(m, n, k, a, 1, lda, b, ldb, 1)
        if m == 0 or n == 0 or k == 0:
            return torch.zeros((m, n), dtype=torch.float32, device=self.device)
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

    def nn(self, a: Tensor, w_rows: Tensor) -> Tensor:
        """a [R, k] (T) times w_rows [k, n] (T) -> [R, n] f32."""
        r, k = a.shape
        n = w_rows.shape[1]
        return self.gemm(r, n, k, a, a.stride(0), 1, w_rows, w_rows.stride(0), 1)

    def tn_act(self, z: Tensor, g: Tensor, act_name: str) -> Tensor:
        """f(z) [R, m]^T times g [R, n] -> [m, n] f32: dW of a layer whose
        input is the activation of the stash z (T), f applied, and rounded
        to T, as the product's prologue."""
        r, m = z.shape
        n = g.shape[1]
        plan = self._plan(m, n, r, z, 1, z.stride(0), g, g.stride(0), 1)
        splits = plan["splits"]
        out = self._empty((m, n))
        parts = out if splits == 1 else self._empty((splits, m, n))
        _build.check(self.lib.neddf_gemm_tc(
            self.dt, _TC_LAYOUTS["tn"], _ACT_CODES[act_name], 0, 1, m, n, r, z.data_ptr(),
            plan["lda"], plan["vec_a"], None, 0, 0, 0, g.data_ptr(), plan["ldb"], plan["vec_b"],
            splits, parts.data_ptr(), None, None, 0, None, None, None, None, self.stream),
            "backward dW (activation prologue)")
        self._count()
        Products.prologue_launches += 1
        if splits > 1:
            self.sum_splits(parts, out)
        return out

    def _epilogue(self, layout, a, b, z, act_name, mode, *, a2=None, side=None, n_act=None,
                  out=True, out2=False, db=False):
        r = a.shape[0]
        k = a.shape[1] + (0 if a2 is None else a2.shape[1])
        if layout == "nt":
            n, sbk, sbn = b.shape[0], 1, b.stride(0)
        else:
            n, sbk, sbn = b.shape[1], b.stride(0), 1
        # launched as one split, whatever the plan's: the epilogue needs the
        # whole sum of a tile in its block (the per-layer sdf route's
        # post-skip adjoint sums over 2048 + 36 rows at width 2048)
        plan = self._plan(r, n, k, a, a.stride(0), 1, b, sbk, sbn)
        n_act = n if n_act is None else n_act
        vec_a2 = 0 if a2 is None else _vec_width(a2.data_ptr(), a2.stride(0), a2.element_size())
        res = {"out": self._empty((r, n_act), self.dtype) if out else None,
               "out2": self._empty((r, n_act)) if out2 else None,
               "raw": self._empty((r, n - n_act)) if n_act < n else None,
               "db": self._empty((-(-r // _EPI_ROWS), n_act)) if db else None}
        ptr = {key: None if t is None else t.data_ptr() for key, t in res.items()}
        _build.check(self.lib.neddf_gemm_tc(
            self.dt, _TC_LAYOUTS[layout], _ACT_CODES[act_name], mode, 1, r, n, k, a.data_ptr(),
            plan["lda"], plan["vec_a"], None if a2 is None else a2.data_ptr(),
            0 if a2 is None else a2.stride(0), vec_a2, a.shape[1], b.data_ptr(), plan["ldb"],
            plan["vec_b"], 1, None, z.data_ptr(), None if side is None else side.data_ptr(),
            n_act, ptr["out"], ptr["out2"], ptr["raw"], ptr["db"], self.stream),
            "backward product (activation epilogue)")
        self._count()
        Products.epilogue_launches += 1
        if db:
            res["db"] = self.sum_rows(res["db"])
        return res

    def nt_act(self, a: Tensor, w_rows: Tensor, z: Tensor, act_name: str, *,
               add: Optional[Tensor] = None, n_act: Optional[int] = None, keep: bool = False,
               db: bool = False):
        """y = a w_rows^T as in ``nt``, and in its epilogue, over the first
        ``n_act`` columns (all by default), v = y f'(z) (+ add): returns
        (T(v) [R, n_act], the other columns of y raw [R, n - n_act] f32 or
        None, y's first n_act columns f32 if ``keep`` else None, the column
        sums of v [n_act] f32 if ``db`` else None)."""
        res = self._epilogue("nt", a, w_rows, z, act_name, _MODE_DACT, side=add, n_act=n_act,
                             out2=keep, db=db)
        return res["out"], res["raw"], res["out2"], res["db"]

    def nn_adjoint(self, a: Tensor, w_rows: Tensor, z: Tensor, act_name: str, *,
                   a2: Optional[Tensor] = None, q: Optional[Tensor] = None, top: bool = False):
        """pbar = [a | a2] w_rows as in ``nn`` (``a2``, if given, is a second
        K segment against the rows of ``w_rows`` after a's), and in its
        epilogue the adjoint of the sweep: (qbar = pbar f'(z) or None at the
        ``top``, zs = pbar q f''(z), or at the top onehot0 pbar f''(z);
        None where f'' is identically zero)."""
        if act_name in SECOND_DERIVATIVE_ZERO:
            if top:
                raise ValueError("the sweep's top adjoint is zero where f'' is")
            res = self._epilogue("nn", a, w_rows, z, act_name, _MODE_DACT, a2=a2)
            return res["out"], None
        res = self._epilogue("nn", a, w_rows, z, act_name, _MODE_ADJOINT, a2=a2, side=q,
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
        return a.float() @ w_rows.float()

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
        [n, C] (T), and in its epilogue the stacked cotangent of the layer
        below from its stash z [S, M, n]: returns (T(G) [S, M, n], the
        column sums of G_v [n] f32), g never stored."""
        s, m, c = gs.shape
        n = w_rows.shape[0]
        plan = self._plan(m, n, c, gs, c, 1, w_rows, 1, w_rows.stride(0))
        if plan["splits"] != 1:
            raise ValueError(f"an epilogue needs the whole sum in one split ({c} rows)")
        out = self._empty((s, m, n), self.dtype)
        parts = self._empty((-(-m // (_EPI_ROWS // s)), n))
        _build.check(self.lib.neddf_gemm_tc(
            self.dt, _TC_LAYOUTS["nt"], _ACT_CODES[act_name], 0, s, m, n, c,
            gs.data_ptr(), plan["lda"], plan["vec_a"], None, 0, 0, 0, w_rows.data_ptr(),
            plan["ldb"], plan["vec_b"], 1, None, z.data_ptr(), None, n, out.data_ptr(), None,
            None, parts.data_ptr(), self.stream), "dual backward dx (stacked cotangent epilogue)")
        self._count()
        Products.epilogue_launches += 1
        return out, self.sum_rows(parts)

    def tn_dual_act(self, z: Tensor, gs: Tensor, act_name: str) -> Tensor:
        """dW = h_in^T gs over the S * M rows -> [m, n] f32, with the layer
        input h_in = (f(z_v), f'(z_v) z_a) of the stash z [S, M, m] (T)
        formed, and rounded to T, as the product's prologue; gs [S, M, n]."""
        s, pts, m = z.shape
        n = gs.shape[2]
        plan = self._plan(m, n, pts, z, 1, m, gs, n, 1, streams=s)
        splits = plan["splits"]
        out = self._empty((m, n))
        parts = out if splits == 1 else self._empty((splits, m, n))
        _build.check(self.lib.neddf_gemm_tc(
            self.dt, _TC_LAYOUTS["tn"], _ACT_CODES[act_name], 0, s, m, n, pts, z.data_ptr(),
            plan["lda"], plan["vec_a"], None, 0, 0, 0, gs.data_ptr(), plan["ldb"],
            plan["vec_b"], splits, parts.data_ptr(), None, None, 0, None, None, None, None,
            self.stream), "dual backward dW (layer input prologue)")
        self._count()
        Products.prologue_launches += 1
        if splits > 1:
            self.sum_splits(parts, out)
        return out


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
        plan = tc_plan(m, n, pts, 1, m, n, 1, itemsize=z.element_size(), streams=s)
        h = _dual_act(z.float(), f, df).to(self.dtype).reshape(s * pts, m)
        g = gs.reshape(s * pts, n)
        per = plan["k_chunk"] // (_TC_DEPTH[z.element_size()] // s)  # stages per split
        stages = grouped_rows(s, pts, _TC_DEPTH[z.element_size()] // s)
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
    the epilogue's backward, ``kernels/neddf_epilogue.py``); below it, ``csrc/dual_mlp_bwd.cu`` folds each layer's
    elementwise work into its two f32-accumulating products on the tensor
    cores (f32 by the 3xTF32 split), whose rows are grouped by point so
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
