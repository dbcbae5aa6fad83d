"""SDF trunk with its channel-0 gradient: CUDA kernel wrappers and the
autograd op.

Port of ``neddf_tpu/kernels/sdf_mlp.py::sdf_mlp``, the NeuS trunk: the
features ``h [M, C]`` of ``e = PE(pos) [M, E]`` and ``gE = d h[:, 0] / d e
[M, E]`` by an explicit reverse sweep, and the VJP of that pair.

* ``sdf_mlp`` launches the f32 row-tile trunk of ``csrc/mlp_fwd.cu``
  (``h`` and the stash of every layer's pre-activation ``[M, C]``), then
  the sweep (``gE``, ``csrc/sdf_sweep.cuh``: persistent, wgmma fed by
  TMA, its plan ``sweep_plan``), both on the tensor cores by the 3xTF32
  split.
* ``sdf_mlp_bwd`` runs the Pallas ``_bwd_kernel`` from the stash as the
  walk ``sdf_mlp_bwd_route`` over the hand-written products
  (``csrc/route_products.cu``, ``SDFProducts``): the replayed sweep,
  the ascending adjoint of the sweep (the f'' terms), the descending
  trunk backward, each elementwise step in the epilogue or prologue of
  the product beside it; dW and db are summed in a fixed order (bitwise
  reproducible). Where f'' is identically zero (ReLU, LeakyReLU; not
  tanhExp, Softplus, Sigmoid) the walk keeps no
  q plane and writes no zs plane, so a non-finite pbar q no longer turns
  zbar into NaN through 0 * f''; on finite inputs nothing changes.
* ``SDFMLP`` is the ``torch.autograd.Function`` over both; its backward
  takes the cotangents of both outputs, ``(ch, cg)``.

The plain versions are ``ops/sdf_grad.py::sdf_trunk_with_grad`` and
``sdf_trunk_with_grad_vjp``. For a CPU tensor each wrapper runs its plain
version; for a CUDA tensor it launches its kernels or raises. f32 only:
NeuS runs its trunk in f32.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch

from neddf_tpu_torch.kernels import _build
from neddf_tpu_torch.kernels.dual_mlp import (
    _ACT_CODES,
    _TILE_TRIES,
    H100_SMS,
    TILE_FWD_ROWS,
    TILE_FWD_SMEM,
    _cdiv,
    _sm_count,
    count_tile_launch,
    layer_launcher,
    plan_refusal,
    saved_route,
    tile_fwd_plan,
    tile_launch,
    width_refusal,
)
from neddf_tpu_torch.kernels.mlp import (
    _KERNEL_DTYPES,
    _SPLIT_HIDDEN_FIRST,
    MLPProducts,
    MLPProductsPlain,
)
from neddf_tpu_torch.ops.activations import ACTIVATION_TRIPLES, SECOND_DERIVATIVE_ZERO
from neddf_tpu_torch.ops.sdf_grad import sdf_trunk_with_grad, sdf_trunk_with_grad_vjp

Tensor = torch.Tensor

_KERNEL_MAX_LAYERS = 12


def kernel_refusal(act_name: str, width: int, n_layers: int, e_dim: Optional[int] = None,
                   layout: Optional[Sequence[bool]] = None) -> Optional[str]:
    """What of a trunk configuration the CUDA kernels do not take (None:
    they take it); ``_check_kernel_args`` raises NotImplementedError on
    it. With the input's width ``e_dim`` (E) and the post-skip ``layout``
    ([h, e]) it also refuses a trunk whose plans do not fit the shared
    memory: the f32 row-tile forward's (``dual_mlp.tile_fwd_plan``) or
    the sweep's (``sweep_plan``)."""
    if act_name not in _ACT_CODES:
        return f"activation {act_name!r}"
    if (refusal := width_refusal(width)) is not None:
        return refusal
    if not 2 <= n_layers <= _KERNEL_MAX_LAYERS:
        return f"{n_layers} layers"
    if e_dim is None:
        return None
    split = [_SPLIT_HIDDEN_FIRST if s else 0 for s in (layout or (False,) * n_layers)]
    return plan_refusal(lambda: tile_fwd_plan(4, 0, width, [e_dim], split),
                        lambda: sweep_plan(width, e_dim, split))


# the sweep's plan (csrc/sdf_sweep.cuh::sweep_plan works out the same
# numbers, and its launcher refuses a call whose plan differs): row tiles
# of SWEEP_ROWS rows, one or two per block (consumer warpgroups) beside
# the producer's warpgroup; two regions of p per tile (or, parked, one and
# a z region of a chunk's k-blocks); a ring of 2-6 stages of W's rows, each
# its f32 box split into tf32 hi and lo planes (NC x 128 bytes each);
# barriers 3 per stage and 16 for the z chunks
SWEEP_ROWS = TILE_FWD_ROWS
_SWEEP_KB = TILE_FWD_ROWS * 128
_SWEEP_MAX_STAGES = 6
_SWEEP_Z_BARRIERS = 16


def sweep_plan(width: int, e_dim: int, split: Sequence[int], m: int = 1,
               sms: int = H100_SMS) -> dict:
    """How the sweep launches for a trunk of layers ``width`` wide over
    the input's ``e_dim`` columns, ``split[l]`` each layer's post-skip input
    (0 or SPLIT_HIDDEN_FIRST: [h, e]), ``m`` rows, a card of ``sms`` SMs.

    Returns the width ``class``; ``nc`` (a hidden chunk's columns: wgmma
    m64n128, m64n64 at the class 64) and ``ne`` (an e chunk's: 64 where E
    <= 64, else nc); ``kb`` (k-blocks of p, 32 columns each); ``rows`` (64
    a tile); ``consumers`` (tiles, and consumer warpgroups, of a block),
    ``warps`` by role (the producer's warpgroup: W's TMA, the stash's
    TMA, two splitting W's stages into tf32 planes) and ``threads``;
    ``stages`` and ``stage_bytes``; ``park`` (the class 512: a layer's
    output parks in device memory, z comes a chunk at a time); ``smem``;
    ``grid``; ``scratch_bytes`` (the parked outputs); ``ld`` (the row
    length of W and of the stash as TMA reads them: ``width`` rounded up
    to a multiple of 4; the caller copies them where it differs);
    ``w_l2_bytes``, the bytes of W a block reads from L2 per 64-row tile
    (one f32 plane, the rows that lie in W, shared by the consumers) and
    ``w_l2_bytes_two_planes``, what one tile per pass over a pre-pass's
    tf32 hi and lo planes would read; ``ints``, the numbers the launcher
    passes and the kernel's launcher checks. Raises ValueError where no
    layout fits the shared memory. Cached."""
    return _sweep_plan(width, e_dim, tuple(int(s) for s in split), m, sms)


@functools.lru_cache(maxsize=4096)
def _sweep_plan(width: int, e_dim: int, split: tuple, m: int, sms: int) -> dict:
    if width_refusal(width) is not None or e_dim < 1:
        raise ValueError(f"the sweep: width {width}, E {e_dim}")
    if (not 2 <= len(split) <= _KERNEL_MAX_LAYERS or split[0]
            or any(s not in (0, _SPLIT_HIDDEN_FIRST) for s in split)):
        raise ValueError(f"the sweep: split {split}")
    cls = next(c for c in (64, 128, 256, 512) if width <= c)
    nc = 64 if cls == 64 else 128
    ne = 64 if nc == 128 and e_dim <= 64 else nc
    kb = _cdiv(width, 32)
    region, zreg, stage = kb * _SWEEP_KB, nc // 32 * _SWEEP_KB, 2 * nc * 128

    def total(nw: int, st: int, park: bool) -> int:
        return (nw * (region + zreg if park else 2 * region) + st * stage
                + (3 * st + _SWEEP_Z_BARRIERS) * 8)

    choice = None
    for nw, least, park in _TILE_TRIES:
        st = next((st for st in range(_SWEEP_MAX_STAGES, least - 1, -1)
                   if total(nw, st, park) <= TILE_FWD_SMEM), None)
        if st is not None:
            choice = (nw, st, park)
            break
    if choice is None:
        raise ValueError(f"the sweep: no layout at width {width} fits {TILE_FWD_SMEM} bytes "
                         "of shared memory")
    nw, stages, park = choice
    grid = min(_cdiv(_cdiv(m, SWEEP_ROWS), nw), sms)
    scratch = grid * SWEEP_ROWS * cls * 4 if park else 0
    smem = total(nw, stages, park)
    ld = _cdiv(width, 4) * 4
    rows = 0  # W's rows the stages of one tile hold, all layers
    for layer, s in enumerate(split):
        fan_in = e_dim if layer == 0 else width + (e_dim if s else 0)
        starts = ([(0 if layer == 0 else width) + i * ne for i in range(_cdiv(e_dim, ne))]
                  if layer == 0 or s else [])
        if layer > 0:
            starts += [c * nc for c in range(_cdiv(width, nc))]
        rows += sum(min(nc, fan_in - r0) for r0 in starts)
    return {
        "class": cls, "nc": nc, "ne": ne, "kb": kb, "rows": SWEEP_ROWS, "consumers": nw,
        "warps": {"consumer": 4 * nw, "w_tma": 1, "z_tma": 1, "split": 2},
        "threads": 128 * (nw + 1), "stages": stages, "stage_bytes": stage, "park": park,
        "smem": smem, "grid": grid, "scratch_bytes": scratch, "ld": ld,
        "w_l2_bytes": rows * ld * 4 // nw, "w_l2_bytes_two_planes": rows * ld * 8,
        "ints": (SWEEP_ROWS, nw, stages, smem, int(park), grid, scratch, ne),
    }


def _check_kernel_args(e, weights, biases, layout, act_name) -> None:
    what = "CUDA sdf_mlp kernel"
    width = weights[0].shape[1] if weights else 0
    refusal = kernel_refusal(act_name, width, len(weights))
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")
    if e.dtype != torch.float32 or e.dim() != 2:
        raise TypeError(f"{what}: e {tuple(e.shape)} {e.dtype} (f32 [M, E] only)")
    if len(biases) != len(weights):
        raise ValueError(f"{what}: {len(weights)} layers")
    if len(layout) != len(weights) or layout[0]:
        raise ValueError(f"{what}: layout {tuple(layout)}")
    e_dim, width = e.shape[1], weights[0].shape[1]
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
    refusal = kernel_refusal(act_name, width, len(weights), e.shape[1], layout)
    if refusal is not None:
        raise NotImplementedError(f"{what}: {refusal}")


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
    width = weights[0].shape[1]
    opts = dict(dtype=torch.float32, device=e.device)
    h = torch.empty((m, width), **opts)
    g_e = torch.empty((m, e_dim), **opts)
    # the sweep reads the stash back, so the kernel always writes it
    pres = [torch.empty((m, width), **opts) for _ in weights]
    if m:
        split = [_SPLIT_HIDDEN_FIRST if s else 0 for s in layout]
        act, lib = _ACT_CODES[act_name], _build.library()
        stream = _build.stream(e.device)
        plan, scratch = tile_launch(torch.float32, 0, width, [e_dim], split, width, m, e.device)
        _build.check(lib.neddf_mlp_seg_fwd(
            _KERNEL_DTYPES[torch.float32], act, width, width, m, 1, _build.pointers([e]),
            _build.ints([e_dim]), len(weights), _build.pointers(weights),
            _build.pointers(biases), _build.ints(split), _build.pointers(pres),
            h.data_ptr(), plan, None if scratch is None else scratch.data_ptr(), stream),
            "sdf_mlp trunk")
        count_tile_launch(torch.float32)
        sweep_launch(act, e_dim, weights, split, pres, g_e, stream)
        sdf_mlp.launches += 1
    return (h, g_e, pres) if stash else (h, g_e)


sdf_mlp.launches = 0

# launches of the sweep (csrc/sdf_sweep.cuh's sdf_sweep_kernel), over every
# caller of sdf_mlp (the training forward, the eval render, voxelize)
SWEEP_LAUNCHES = {"sweep": 0}


def _padded_columns(x: Tensor, ld: int) -> Tensor:
    """x [R, n] as a fresh [R, ld] copy with zero columns past n (rows of
    whole 16-byte vectors, as TMA reads them)."""
    out = x.new_zeros((x.shape[0], ld))
    out[:, : x.shape[1]] = x
    return out


def sweep_launch(act: int, e_dim: int, weights, split, pres, g_e: Tensor, stream: int) -> None:
    """The sweep (``csrc/sdf_sweep.cuh``) of the trunk whose stash the
    trunk's launch just wrote: gE into ``g_e`` [M, E], launched by its plan
    (``sweep_plan``; W and the stash copied with zero columns up to ``ld``
    where ``width`` is not a multiple of 4)."""
    m, width = pres[0].shape
    device = g_e.device
    plan = sweep_plan(width, e_dim, split, m, _sm_count(device.index or 0))
    ld = plan["ld"]
    if ld != width:
        weights = [_padded_columns(w, ld) for w in weights]
        pres = [_padded_columns(z, ld) for z in pres]
    scratch = (torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=device)
               if plan["scratch_bytes"] else None)
    _build.check(_build.library().neddf_sdf_sweep(
        act, m, e_dim, width, len(weights), _build.pointers(weights), _build.ints(split),
        _build.pointers(pres), ld, g_e.data_ptr(), _build.ints(plan["ints"]),
        None if scratch is None else scratch.data_ptr(), stream), "sdf_mlp sweep")
    SWEEP_LAUNCHES["sweep"] += 1


# launches of the top of the replayed sweep (csrc/sdf_mlp.cu's sdf_top),
# the one elementwise pass of the backward besides mlp.py's gpre
PASS_LAUNCHES = {"sdf_top": 0}


class SDFProducts(MLPProducts):
    """``mlp.MLPProducts`` and the top of the replayed sweep ``sdf_top``."""

    def sdf_top(self, z: Tensor, act_name: str, holds0: bool = True) -> Tensor:
        """p [M, C] = onehot0 f'(z) (f32): the top of the replayed sweep; on
        a column shard without channel 0 (``holds0`` False) p is zero."""
        p = self._empty(tuple(z.shape))
        _build.check(self.lib.neddf_sdf_top(_ACT_CODES[act_name], z.numel(), z.shape[1],
                                            0 if holds0 else -1, z.data_ptr(), p.data_ptr(),
                                            self.stream), "sdf_mlp top")
        PASS_LAUNCHES["sdf_top"] += 1
        return p


class SDFProductsPlain(MLPProductsPlain):
    """The plain version of ``SDFProducts``."""

    def sdf_top(self, z, act_name, holds0=True):
        p = torch.zeros(tuple(z.shape), dtype=torch.float32, device=z.device)
        if holds0:
            p[:, 0] = ACTIVATION_TRIPLES[act_name][1](z[:, 0].float())
        self.planes.append("p")
        return p


def sdf_mlp_bwd_route(e, weights, layout, act_name, pres, ch, cg, k):
    """The kernels' walk of the backward over the launcher ``k``
    (``SDFProducts`` on the card, ``SDFProductsPlain`` in the CPU tests):
    de [M, E], dW and db per layer (f32), as
    ``sdf_trunk_with_grad_vjp`` computes them.

    * replay: p_{L-1} = onehot0 f'(z_{L-1}); q_l = p_l W_l[hidden]^T with
      the epilogue p_{l-1} = q_l f'(z_{l-1}); q_l kept where f'' != 0;
    * ascending adjoint: pbar_l = [qbar_l | cg] W_l (qbar_0 = cg; a
      post-skip layer's two K segments in one product) with the epilogue
      qbar_{l+1} = pbar_l f'(z_l) and zs_l = pbar_l q_{l+1} f''(z_l) (top:
      onehot0); dW_l = qbar_l^T p_l (and cg^T p_l for the e rows);
    * descending trunk: zbar_{L-1} = ch f'(z_{L-1}) + zs_{L-1} (gpre);
      dW_l += f(z_{l-1})^T zbar_l (the prologue), zbar_l W_l^T over all
      of W's rows with the epilogue zbar_{l-1} = hbar f'(z_{l-1}) +
      zs_{l-1} and its column sums (db), the e rows' columns raw (ebar).

    Where f'' is identically zero no q is kept and no zs is formed: the
    last pbar, which only feeds zs_{L-1}, is not computed at all.
    """
    n_layers = len(weights)
    c = pres[0].shape[1]
    keep_q = act_name not in SECOND_DERIVATIVE_ZERO
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]

    # replay the sweep: p_l for every layer, q_l[hidden] for l >= 1
    ps: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    qs: List[Tensor] = [None] * (n_layers + 1)  # type: ignore[list-item]
    p = k.sdf_top(pres[-1], act_name)
    for li in range(n_layers - 1, 0, -1):
        ps[li] = p
        p, _, qs[li], _ = k.nt_act(p, weights[li][:c], pres[li - 1], act_name, keep=keep_q)
    ps[0] = p

    # adjoint of the sweep, ascending
    zs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dws[0] = k.tn(cg, ps[0])
    qbar, zs[0] = k.nn_adjoint(cg, weights[0], pres[0], act_name, q=qs[1])
    for li in range(1, n_layers):
        dws[li] = k.tn(qbar, ps[li])
        if layout[li]:
            dws[li] = torch.cat([dws[li], k.tn(cg, ps[li])], dim=0)
        ps[li] = qs[li] = None
        a2 = cg if layout[li] else None
        if li < n_layers - 1:
            qbar, zs[li] = k.nn_adjoint(qbar, weights[li], pres[li], act_name, a2=a2,
                                        q=qs[li + 1])
        elif keep_q:
            _, zs[li] = k.nn_adjoint(qbar, weights[li], pres[li], act_name, a2=a2, top=True)
    del ps, qs, qbar

    # trunk backward with the combined z cotangents, descending
    zbar, dbs[-1] = k.gpre(ch, pres[-1], act_name, add=zs[-1])
    ebar = None
    for li in range(n_layers - 1, -1, -1):
        w = weights[li]
        if li == 0:
            dw2, eb = k.tn(e, zbar), k.nt(zbar, w)
        else:
            dw2 = k.tn_act(pres[li - 1], zbar, act_name)
            if layout[li]:
                dw2 = torch.cat([dw2, k.tn(e, zbar)], dim=0)
            zbar, eb, _, dbs[li - 1] = k.nt_act(zbar, w, pres[li - 1], act_name,
                                                add=zs[li - 1], n_act=c, db=True)
            zs[li - 1] = None
        if eb is not None:
            ebar = eb if ebar is None else ebar + eb
        dws[li] = dws[li] + dw2
    return ebar, dws, dbs


def sdf_mlp_bwd(
    e: Tensor,
    weights: Sequence[Tensor],
    layout: Sequence[bool],
    act_name: str,
    pres: Sequence[Tensor],
    ch: Tensor,
    cg: Tensor,
):
    """VJP of ``sdf_mlp``: the CUDA kernels for CUDA tensors
    (``sdf_mlp_bwd_route`` over ``SDFProducts``), ``sdf_trunk_with_grad_vjp``
    for CPU ones (same arguments and results: de [M, E], dW per layer, db
    per layer, f32)."""
    if e.device.type == "cpu":
        return sdf_trunk_with_grad_vjp(e, weights, layout, act_name, pres, ch, cg)
    if e.device.type != "cuda":
        raise ValueError(f"sdf_mlp_bwd: unsupported device {e.device}")
    device = e.device
    biases = [torch.empty(w.shape[1], device=device) for w in weights]
    _check_kernel_args(e, weights, biases, layout, act_name)
    m, e_dim = e.shape
    c = weights[0].shape[1]
    for t, shape in [(p, (m, c)) for p in pres] + [(ch, (m, c)), (cg, (m, e_dim))]:
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError("sdf_mlp_bwd: stash/cotangent shape, dtype, layout or device")
    if len(pres) != len(weights):
        raise ValueError("sdf_mlp_bwd: one stash per layer")
    out = sdf_mlp_bwd_route(e, weights, layout, act_name, pres, ch, cg,
                            SDFProducts(torch.float32, device))
    sdf_mlp_bwd.launches += 1
    return out


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


# ------------------------------------------------------- the per-layer route
def sdf_layer_launcher(device: torch.device, use_kernels: bool):
    """The per-layer sdf route's launcher: ``SDFProducts`` (the kernels)
    for CUDA tensors under ``use_kernels``, else ``SDFProductsPlain``."""
    return layer_launcher(torch.float32, device, use_kernels, (SDFProducts, SDFProductsPlain))


def _sweep_layers(weights, layout, act_name, pres, e_dim, k, group, keep_p, keep_q):
    """The reverse sweep of channel 0 one layer at a time over column
    shards (the route's forward sweep and the backward's replay): p_{L-1}
    = onehot0 f'(z_{L-1}) at this rank's columns (``sdf_top``: zero
    without channel 0); per layer q_l = p_l W_l[hidden, cols]^T, this
    rank's part of a sum over the ranks' columns, in f32 (nt),
    reduce-scattered, then p_{l-1} = q_l f'(z_{l-1}) (``gpre``, no db);
    the e rows' products (layer 0, a post-skip layer) add up this rank's
    part of gE. Returns (p_l per layer where ``keep_p``, q_l per layer
    where ``keep_q``, else None; this rank's part of gE [M, E])."""
    from neddf_tpu_torch.parallel.tp import holds_column0, reduce_scatter_last

    n_layers = len(weights)
    ps: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    qs: List[Optional[Tensor]] = [None] * (n_layers + 1)
    g_e = None
    p = k.sdf_top(pres[-1], act_name, holds_column0(group))
    for li in range(n_layers - 1, -1, -1):
        ps[li] = p if keep_p else None
        w = weights[li]
        eb = None
        if li == 0:
            eb = k.nt(p, w)
        else:
            c = w.shape[0] - e_dim if layout[li] else w.shape[0]
            if layout[li]:
                eb = k.nt(p, w[c:])
            q = reduce_scatter_last(k.nt(p, w[:c]), group)
            qs[li] = q if keep_q else None
            p, _ = k.gpre(q, pres[li - 1], act_name, db=False)
        if eb is not None:
            g_e = eb if g_e is None else g_e + eb
    return ps, qs, g_e


def sdf_layers_walk(e, weights, biases, layout, act_name, k, group=None):
    """The per-layer route's forward of ``sdf_mlp`` over the launcher ``k``,
    for this rank's column shards of the trunk ([fan_in, W/n], f32): the
    trunk by ``dual_mlp_layers_walk`` (one stream, ``Products.layer_fwd`` per
    layer in 3xTF32, a post-skip layer's ``[h, e]`` as two K segments,
    every layer's output gathered over ``group``), then the sweep one
    layer at a time (``_sweep_layers``) and the ranks' parts of gE summed
    over the model group, so that every rank holds the whole normal.

    Returns (h [M, W], gE [M, E], every layer's input segments (gathered,
    f32), every layer's stash z_l [M, W/n])."""
    from neddf_tpu_torch.kernels.dual_mlp import dual_mlp_layers_walk
    from neddf_tpu_torch.parallel.tp import all_reduce_sum

    if e.dtype != torch.float32:
        raise TypeError(f"the per-layer sdf route: e {e.dtype} (f32 only)")
    full, inputs, pres = dual_mlp_layers_walk([e], [], weights, biases, layout, act_name,
                                              (False,), 0, k, group, stash=True,
                                              hidden_first=True)
    pres = [z[0] for z in pres]
    inputs = [[x[0] for x in xs] for xs in inputs]
    _, _, g_e = _sweep_layers(weights, layout, act_name, pres, e.shape[1], k, group, False,
                              False)
    return full[0], all_reduce_sum(g_e, group), inputs, pres


def sdf_layers_bwd(inputs, weights, layout, act_name, pres, ch, cg, k, group=None):
    """The VJP of ``sdf_layers_walk`` over the launcher ``k``: the three
    walks of ``sdf_mlp_bwd_route`` over column shards.

    ``ch`` [M, W] and ``cg`` [M, E] are this rank's cotangents of the
    gathered h and of the summed gE; the adjoints of the gathers and of
    the sum are the sum reduce-scatter of ch and the sum of cg over the
    model group. Then:

    * the replayed sweep (``_sweep_layers``), keeping q_l where f'' != 0;
    * the ascending adjoint: pbar_l[cols] = [qbar_l | cg] W_l[:, cols], a
      whole sum on this rank, with the epilogue qbar_{l+1} = pbar_l
      f'(z_l) and zs_l = pbar_l q_{l+1} f''(z_l) at the shard's columns
      (``nn_adjoint``; the top's onehot0 only on the rank that holds
      channel 0), qbar_{l+1} gathered before the next layer; dW_l +=
      [qbar_l | cg]^T p_l;
    * the descending trunk: zbar_{L-1} = ch f'(z_{L-1}) + zs_{L-1}
      (``gpre``, with db); dW_l += x_l^T zbar_l over the layer's saved
      input; zbar_l W_l[hidden, cols]^T in f32 (nt), reduce-scattered, then
      zbar_{l-1} = hbar f'(z_{l-1}) + zs_{l-1} and db (``gpre``); the e
      rows' products, this rank's part of de.

    Returns (de [M, E], this rank's part; dW per layer [fan_in, W/n]; db
    per layer [W/n]; f32)."""
    from neddf_tpu_torch.parallel.tp import (
        all_gather_last,
        all_reduce_sum,
        holds_column0,
        reduce_scatter_last,
    )

    n_layers = len(weights)
    e_dim = inputs[0][0].shape[1]
    keep_q = act_name not in SECOND_DERIVATIVE_ZERO
    dws: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    dbs: List[Tensor] = [None] * n_layers  # type: ignore[list-item]
    cg = all_reduce_sum(cg, group).contiguous()
    ps, qs, _ = _sweep_layers(weights, layout, act_name, pres, e_dim, k, group, True, keep_q)

    # adjoint of the sweep, ascending
    zs: List[Optional[Tensor]] = [None] * n_layers
    dws[0] = k.tn(cg, ps[0])
    qbar, zs[0] = k.nn_adjoint(cg, weights[0], pres[0], act_name, q=qs[1])
    for li in range(1, n_layers):
        qfull = all_gather_last(qbar, group)
        dws[li] = k.tn(qfull, ps[li])
        if layout[li]:
            dws[li] = torch.cat([dws[li], k.tn(cg, ps[li])], dim=0)
        ps[li] = qs[li] = None
        a2 = cg if layout[li] else None
        if li < n_layers - 1:
            qbar, zs[li] = k.nn_adjoint(qfull, weights[li], pres[li], act_name, a2=a2,
                                        q=qs[li + 1])
        elif keep_q and holds_column0(group):
            _, zs[li] = k.nn_adjoint(qfull, weights[li], pres[li], act_name, a2=a2, top=True)
    del ps, qs, qbar

    # trunk backward with the combined z cotangents, descending
    g = reduce_scatter_last(ch, group).contiguous()
    zbar, dbs[-1] = k.gpre(g, pres[-1], act_name, add=zs[-1])
    ebar = None
    for li in range(n_layers - 1, -1, -1):
        w = weights[li]
        dw2 = torch.cat([k.tn(x, zbar) for x in inputs[li]], dim=0)
        eb = None
        if li == 0:
            eb = k.nt(zbar, w)
        else:
            c = w.shape[0] - e_dim if layout[li] else w.shape[0]
            if layout[li]:
                eb = k.nt(zbar, w[c:])
            hbar = reduce_scatter_last(k.nt(zbar, w[:c]), group).contiguous()
            zbar, dbs[li - 1] = k.gpre(hbar, pres[li - 1], act_name, add=zs[li - 1])
            zs[li - 1] = None
        if eb is not None:
            ebar = eb if ebar is None else ebar + eb
        dws[li] = dws[li] + dw2
    return ebar, dws, dbs


def sdf_mlp_layers(e, weights, biases, layout, act_name, use_kernels, group=None):
    """(h [M, W], gE [M, E]) by the per-layer route, without its backward
    (the eval trunk): the kernels for CUDA tensors under ``use_kernels``,
    their plain versions otherwise (see ``sdf_layers_walk``)."""
    k = sdf_layer_launcher(e.device, use_kernels)
    h, g_e, _, _ = sdf_layers_walk(e, weights, biases, layout, act_name, k, group)
    if isinstance(k, SDFProducts):
        sdf_mlp_layers.launches += 1
    return h, g_e


# calls of the per-layer sdf route that ran its kernels (the eval walk, and
# SDFLayers' forward and backward: one each)
sdf_mlp_layers.launches = 0


class SDFLayers(torch.autograd.Function):
    """The per-layer sdf route (``sdf_layers_walk`` / ``sdf_layers_bwd``)
    as an autograd op: NeuS's trunk and normals under tensor parallelism
    and past the fused kernel's width (512) or depth.

    ``apply(config, e, *weights, *biases)`` with ``config = (layout,
    act_name, use_kernels, group)``; ``weights``/``biases`` this rank's
    f32 column shards. Returns ``(h [M, W], gE [M, E])``, the gathered
    features and the whole normal; its backward takes both cotangents."""

    @staticmethod
    def forward(ctx, config, e, *args):
        layout, act_name, use_kernels, group = config
        n_l = len(layout)
        weights = [w.float().contiguous() for w in args[:n_l]]
        biases = [b.float().contiguous() for b in args[n_l:]]
        e = e.float().contiguous()
        k = sdf_layer_launcher(e.device, use_kernels)
        h, g_e, inputs, pres = sdf_layers_walk(e, weights, biases, layout, act_name, k, group)
        if isinstance(k, SDFProducts):
            sdf_mlp_layers.launches += 1
        ctx.config = config
        ctx.n_inputs = [len(x) for x in inputs]
        ctx.save_for_backward(*weights, *pres, *[t for x in inputs for t in x])
        return h, g_e

    @staticmethod
    def backward(ctx, ch, cg):
        from neddf_tpu_torch.parallel.tp import group_size

        layout, act_name, use_kernels, group = ctx.config
        weights, pres, inputs = saved_route(ctx, len(layout))
        m, w = pres[0].shape[0], weights[0].shape[1]
        ch = (torch.zeros((m, w * group_size(group)), device=pres[0].device) if ch is None
              else ch.float().contiguous())
        cg = torch.zeros_like(inputs[0][0]) if cg is None else cg.float().contiguous()
        k = sdf_layer_launcher(pres[0].device, use_kernels)
        de, dws, dbs = sdf_layers_bwd(inputs, weights, layout, act_name, pres, ch, cg, k, group)
        if isinstance(k, SDFProducts):
            sdf_mlp_layers.launches += 1
        return (None, de, *dws, *dbs)


def sdf_layers_apply(e, weights, biases, layout, act_name, use_kernels, group=None):
    """Differentiable per-layer sdf route (see ``SDFLayers``)."""
    return SDFLayers.apply((tuple(layout), act_name, use_kernels, group), e, *weights, *biases)
