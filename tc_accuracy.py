"""How closely the tensor-core routes of neddf_tpu_torch round, and how
fast its f32 routes run.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tc_accuracy.py [--tree DIR] [--out FILE] [--params P ...]
                           [--batches N ...] [--seeds S ...] [--f32] [--passes]
                           [--train FAMILY ...] [--llff [CONFIG ...]] [--llff-step]

``--tree DIR`` imports ``neddf_tpu_torch`` from DIR instead of this
checkout (for instance an unpacked ``git archive`` of another commit),
with this checkout's data, checkpoint and inputs, so that two commits
are compared on one card in one call. Prints one JSON object (also
written to FILE):

* ``step``: the bf16 train step of ``chip_smoke.py`` phase 7
  (``pretrained/machine_neddf``, full width; with the checkpoint's
  parameters or with ``chip_smoke.family_params`` of a seed) on each
  batch of rays and draw seed, kernels against the plain versions: the worst relative gap
  over the losses and over the gradient norms, and the gaps of the aux
  head's two norms; for the first seed also how far the plain step
  itself moves the same numbers under a +-1e-7 camera shift;
* ``layers``: each layer of the K=3 trunk alone (the checkpoint's bf16
  weights; inputs: the PE of seeded points for layer 0, the plain
  version's output of the layer before for the others), through the
  kernel and the plain version. Against the pre-activation z computed in
  f64 from the same bf16 inputs and weights and then rounded to bf16:
  the share of elements whose bf16 z differs (a flip) and the share of
  those flips that lie nearer zero than the f64 value;
* ``trunk``: the whole trunk forward, kernel and plain, against the same
  trunk in f64 without any rounding: max error over the largest
  magnitude and mean signed error over the mean magnitude (negative: a
  bias toward zero);
* ``products``: the bf16 products at the fine trunk's shapes (dx: nt, dW:
  tn) against f64, the same two measures;
* ``ms``: median CUDA-event times of the trunk forward with its stash and
  of the two products.

With ``--f32`` only the f32 routes of the NeuS step (``f32``): each f32
product of ``chip_smoke.py`` phase 6b against f64 (the two measures
above) and its time; the times of the NeuS colour trunk's forward with
its stash and of its backward, and of ``sdf_mlp`` forward and backward
(ReLU, 265,216 rows); and phase 9's count of ReLU rows whose gE took the
other side of f'(0) from the all-plain pass.

With ``--passes`` only the backwards of ``sdf_mlp`` (ReLU) and of the NeuS
colour trunk (f32) at the NeuS step's 265,216 rows, of the NeRF trunk
(bf16) at its fine pass's 198,656 and the dual backward of NeDDF's fine
pass (bf16, 99,328 rows: the K=3 trunk of 7 layers and the K=1 colour
trunk of 3 layers over four segments, tanhExp) (``passes``): each
route's median CUDA-event ms, and by ``torch.profiler`` over three calls
every kernel it launches (the products by layout and by what they fold
in, and each elementwise pass) with its launches and device ms per call
and, for the elementwise passes, the bytes it must move; and the db sum
at the NeuS fine pass (1,552 tile partials of 256 columns): one-block
``neddf_sum_splits`` against ``neddf_sum_rows`` where the tree has it;
and NeDDF's fine pass from the epilogue's cotangents to the K=3 trunk's
top-layer stacked cotangent (``measure_epilogue``): the epilogue
backward, the add and the top ``gstack``, and the epilogue backward's top
mode where the tree has it, kernel by kernel with their byte bounds.

With ``--train FAMILY ...`` (neddf, nerf, neus; after ``--passes``
where both are given) a 200-step run of
each configuration through this tree's ``scripts/run.py`` (NeDDF: the
default config of ``chip_smoke.py`` phase 8; NeRF and NeuS: phase 11's)
(``train``): ms/step over steps 100-199, rays/s, peak device memory, and
by ``torch.profiler`` over five more steps the device time per step, its
busy share of the traced wall and the kernels by device time
(``chiprun_out/chip_smoke/tc_accuracy_profile_FAMILY_TREE.txt``, TREE the
name of the tree's directory); then the device operations (kernels,
copies, sets) per step and per ``camera_pose`` call, and the host ms of
one step's record through the tree's TensorBoard logger, where it has
one.

With ``--llff [CONFIG ...]`` only the held-out quality of the
forward-facing path (``llff``): ``tools/llff_experiment.py``'s experiment
through this tree's ``scripts/run.py`` and ``run_eval``: a 24-image
400x400 LLFF capture of the machine scene (the port's generator, under
``chiprun_out/chip_smoke/llff_quality_scene``; every 8th image held out),
600 epochs of the 21 train frames, then PSNR and SSIM of each held-out
view at full resolution. CONFIG (default: all three) is ``neddf_ndc``
and ``nerf_ndc`` (``chip_smoke.LLFF_OVERRIDES``: recentred poses, NDC
rays with the near plane at 0.9 of the scaled near bound, point samples;
NeRF at its trainer's 1024 rays) or ``neddf`` (the anchor without NDC:
the default cone sampling over the world window [2, 6]); each run's
ms/step over steps 100-199 too.

With ``--llff-step`` only ``chip_smoke.py`` phase 19b's f32 steps of
NeDDF-NDC and NeRF-NDC (``llff_step``) on a 24-image 400x400 capture,
through the kernels and through the plain versions, at 128 (phase 19b's
rays), 256 and 512 rays: the largest relative gap of the loss and the
gradient norms between the two, and at 128 rays each one's largest gaps
to the JAX package's numbers (``tools/llff_reference.npz``).

With ``--neus-run kernels|plain [--seed N]`` only the NeuS
configuration's 300-step run of ``chip_smoke.py`` phase 11
(``scripts/run.py``, f32; ``trainer.seed=N``) through this tree's
kernels or through the plain versions (``network.fused=off``):
the train PSNR of its first and last 50 steps and every 20th step's loss
and PSNR (``neus_run``).
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent


def tanh_exp64(x):
    """tanhExp and its derivative in f64, passing x through above 20."""
    import torch

    ex = torch.exp(torch.clamp(x, max=20.0))
    tx = torch.tanh(ex)
    f = torch.where(x > 20.0, x, x * tx)
    df = torch.where(x > 20.0, torch.ones_like(x), tx - x * ex * (tx * tx - 1.0))
    return f, df


def flips(z, z64):
    """Share of bf16 elements of z that differ from z64 rounded to bf16,
    and the share of those nearer zero."""
    ref = z64.float().bfloat16()
    diff = z != ref
    n = int(diff.sum())
    toward = int((diff & (z.float().abs() < ref.float().abs())).sum())
    return {"flip_share": n / z.numel(), "toward_zero_share": toward / max(n, 1)}


def signed_err(got, ref):
    """Max error over the largest |ref|, and the mean of (got - ref) *
    sign(ref) over the mean |ref| (negative: nearer zero)."""
    d = got.double() - ref
    return {"max_rel": (d.abs().max() / ref.abs().max()).item(),
            "mean_signed_rel": ((d * ref.sign()).mean() / ref.abs().mean()).item()}


def step_gaps(a: dict, b: dict) -> dict:
    """Relative gap of every loss and gradient norm of step a against b."""
    out = {f"loss {k}": abs(a["losses"][k] - v) / abs(v) for k, v in b["losses"].items()}
    out.update({k: abs(a["grad_norms"][k] - v) / abs(v) for k, v in b["grad_norms"].items()})
    return out


def summary(gaps: dict) -> dict:
    """Worst gap over the losses, over the gradient norms, and the two aux
    head norms (the numbers the density's relu kink makes jumpy)."""
    return {"loss": max(v for k, v in gaps.items() if k.startswith("loss ")),
            "grad_norm": max(v for k, v in gaps.items() if not k.startswith("loss ")),
            "aux_w": gaps["network_fine.layer_aux_out.w"],
            "aux_b": gaps["network_fine.layer_aux_out.b"]}


def measure_step(torch, smoke, params: str, batches, seeds) -> dict:
    """For each batch of rays and draw seed: the bf16 step's kernels vs
    plain versions; for the first seed also the plain step's own spread
    under a +-1e-7 camera shift (chip_smoke.FAMILY_SHIFT). ``params``:
    "checkpoint" (epoch 1000) or the seed of chip_smoke.family_params."""
    trainer = smoke.machine_trainer(torch)
    if params != "checkpoint":
        render = trainer.neural_render
        shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
        render.load_state_dict({k: torch.from_numpy(v) for k, v in
                                smoke.family_params(shapes, int(params)).items()})
    net = trainer.neural_render.network_fine
    net.compute_dtype = torch.bfloat16
    cam = smoke.MACHINE_CAMERA
    delta = trainer.camera_deltas[cam].clone()
    shift = torch.tensor(smoke.FAMILY_SHIFT, dtype=delta.dtype, device=delta.device)
    out = {}
    for batch in batches:
        for seed in seeds:
            net.fused = "auto"
            kern = smoke.machine_step(torch, trainer, batch, seed)
            net.fused = "off"
            plain = smoke.machine_step(torch, trainer, batch, seed)
            row = {"kernel_vs_plain": summary(step_gaps(kern, plain))}
            if seed == seeds[0]:
                moved = []
                for sign in (1.0, -1.0):
                    trainer.camera_deltas[cam] = delta + sign * shift
                    moved.append(summary(step_gaps(smoke.machine_step(torch, trainer, batch, seed),
                                                   plain)))
                trainer.camera_deltas[cam] = delta
                row["plain_shift_spread"] = {k: max(m[k] for m in moved) for k in moved[0]}
            out[f"{batch} rays, seed {seed}"] = row
            print(f"step, params {params}, {batch} rays, seed {seed}: {json.dumps(row)}",
                  flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def measure_trunk(torch, smoke, sd, dev) -> tuple:
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.ops.dual import pe_dual_planes_mip
    from neddf_tpu_torch.ops.pe import pe_grad_scale

    n = sum(1 for k in sd if k.startswith("network_fine.layers_ddf.") and k.endswith(".w"))
    ws = [sd[f"network_fine.layers_ddf.{i}.w"].to(dev).bfloat16() for i in range(n)]
    bs = [sd[f"network_fine.layers_ddf.{i}.b"].to(dev) for i in range(n)]
    skip = tuple(i == 5 for i in range(n))
    gen = torch.Generator(device=dev).manual_seed(2)
    m = smoke.M_TRAIN
    pos = torch.rand((m, 3), generator=gen, device=dev) * 2.0 - 1.0
    var = torch.rand((m, 3), generator=gen, device=dev) * 1e-5
    ev, ej = pe_dual_planes_mip(pos, 10, var=var, chan_scale=pe_grad_scale(10, dev))
    v0, j0 = ev.bfloat16().contiguous(), ej.bfloat16().contiguous()

    # each layer alone, on the plain version's input to it
    layers, v, j = [], v0, j0
    for i in range(n):
        if skip[i]:
            v, j = torch.cat([v0, v], 1).contiguous(), torch.cat([j0, j], 2).contiguous()
        args = ([ws[i]], [bs[i]], (False,))
        _, _, zk = dm.dual_mlp_trunk(v, j, *args, stash=True)
        pv, pj, zp = dm.dual_mlp_seg_plain([v], [j], *args, "tanhExp", (True,), 3, stash=True)
        x = torch.cat([v[None], j]).double()
        z64 = x @ ws[i].double()
        z64[0] += bs[i].double()
        layers.append({"kernel": flips(zk[0], z64), "plain": flips(zp[0], z64)})
        v, j = pv, pj
        del x, z64, zk, zp
    # the whole trunk against f64 without rounding
    vk, jk = dm.dual_mlp_trunk(v0, j0, ws, bs, skip)
    vp, jp = dm.dual_mlp_seg_plain([v0], [j0], ws, bs, skip, "tanhExp", (True,), 3)
    h64v, h64j = v0.double(), j0.double()
    for i in range(n):
        xv, xj = h64v, h64j
        if skip[i]:
            xv, xj = torch.cat([v0.double(), xv], 1), torch.cat([j0.double(), xj], 2)
        zv = xv @ ws[i].double() + bs[i].double()
        f, df = tanh_exp64(zv)
        h64v, h64j = f, df[None] * (xj @ ws[i].double())
    ref = torch.cat([h64v[None], h64j])
    trunk = {"kernel": signed_err(torch.cat([vk[None], jk]), ref),
             "plain": signed_err(torch.cat([vp[None], jp]), ref)}
    timed = (lambda: dm.dual_mlp_trunk(v0, j0, ws, bs, skip, stash=True))
    return layers, trunk, timed


def measure_products(torch, smoke, dev) -> tuple:
    from neddf_tpu_torch.kernels import dual_mlp as dm

    gen = torch.Generator(device=dev).manual_seed(4)
    prod = dm.Products(torch.bfloat16, dev)
    r = 4 * smoke.M_TRAIN
    g = (torch.randn((r, 256), generator=gen, device=dev) * 0.1).bfloat16()
    h = (torch.randn((r, 256), generator=gen, device=dev) * 0.1).bfloat16()
    w = (torch.randn((256, 256), generator=gen, device=dev) * 0.1).bfloat16()
    out = {"nt": signed_err(prod.nt(g, w), g.double() @ w.double().T),
           "tn": signed_err(prod.tn(h, g), h.double().T @ g.double())}
    return out, {"nt": lambda: prod.nt(g, w), "tn": lambda: prod.tn(h, g)}


def measure_f32(torch, smoke, dev) -> dict:
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk
    from neddf_tpu_torch.ops import sdf_grad

    out = {"products": {}, "ms": {}, "rows_off_plain_ge": {}}
    prod = dm.Products(torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, layout, a, b in smoke.product_cases(torch, gen, dev):
        if a.dtype != torch.float32:
            continue
        call, _ = smoke.product_call(layout, a, b)
        m, n, k, _, sam, sak, _, sbk, sbn = call
        ref = (torch.as_strided(a.double(), (m, k), (sam, sak))
               @ torch.as_strided(b.double(), (k, n), (sbk, sbn)))
        fn = (lambda: getattr(prod, layout)(a, b))
        out["products"][name] = {**signed_err(fn(), ref),
                                 "ms": smoke.time_pair(torch, fn, fn, reps=3, inner=10)[0]}
        print(f"f32 product {name}: {json.dumps(out['products'][name])}", flush=True)
        del ref
    torch.cuda.empty_cache()

    m = smoke.M_NEUS
    rand = torch.Generator(device=dev).manual_seed(5)
    widths = (3, 24, 3, 256)
    vs = [torch.rand((m, w), generator=rand, device=dev) * 2 - 1 for w in widths]
    ws = [(torch.rand((f, o), generator=rand, device=dev) * 2 - 1) * f ** -0.5
          for f, o in zip(smoke.NEUS_COL_FANS, smoke.NEUS_COL_OUTS)]
    bs = [torch.zeros(o, device=dev) for o in smoke.NEUS_COL_OUTS]
    layout = (False,) * len(ws)
    _, pres = mlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True)
    g = torch.rand((m, 3), generator=rand, device=dev) * 0.01
    routes = {
        "mlp_seg_neus_color": lambda: mlp.mlp_seg(vs, ws, bs, layout, "ReLU", stash=True),
        "mlp_seg_bwd_neus_color": lambda: mlp.mlp_seg_bwd(vs, ws, layout, "ReLU", pres, g),
    }
    e, sws, sbs, ch, cg = smoke.sdf_inputs(torch, dev, "ReLU", m)
    _, _, spres = sk.sdf_mlp(e, sws, sbs, smoke.SDF_LAYOUT, "ReLU", stash=True)
    routes["sdf_mlp"] = lambda: sk.sdf_mlp(e, sws, sbs, smoke.SDF_LAYOUT, "ReLU", stash=True)
    routes["sdf_mlp_bwd"] = lambda: sk.sdf_mlp_bwd(e, sws, smoke.SDF_LAYOUT, "ReLU", spres,
                                                   ch, cg)
    for name, fn in routes.items():
        out["ms"][name] = smoke.time_pair(torch, fn, fn, reps=3)[0]
    del vs, ws, pres, e, sws, spres, ch, cg
    torch.cuda.empty_cache()
    for rows in (smoke.M_NEUS, smoke.M_SDF_RAGGED):
        e, sws, sbs, _, _ = smoke.sdf_inputs(torch, dev, "ReLU", rows)
        fk = sk.sdf_mlp(e, sws, sbs, smoke.SDF_LAYOUT, "ReLU")
        fp = sdf_grad.sdf_trunk_with_grad(e, sws, sbs, smoke.SDF_LAYOUT, "ReLU")
        out["rows_off_plain_ge"][f"ReLU/{rows}"] = smoke.ge_rows_off_plain(fk, fp)
    return out


# the bytes each elementwise pass of the backwards must move per call, by
# kernel name, in [M, C] planes of 4-byte elements (T: the operand type's
# share of one): reads and writes once each
PASS_PLANES = {
    "sweep_p_kernel": 3, "adjoint_kernel": 5, "zbar_kernel": 4, "sdf_top_kernel": None,
    "gpre_kernel": None, "act_kernel": None, "sum_splits_kernel": 0, "sum_rows_kernel": 0,
    "gstack_kernel": None, "dual_act_kernel": None,
}
# NeDDF's fine pass: rows, and the dual backward's configurations (segment
# widths, tangent segments, K, fan-ins, post-skip flags)
M_NEDDF_FINE = 512 * 194
NEDDF_DUAL = {
    "dual_mlp_seg_bwd_trunk": ((60,), (True,), 3, [60] + [316 if li == 5 else 256
                                                        for li in range(1, 7)],
                               tuple(li == 5 for li in range(7))),
    "dual_mlp_seg_bwd_color": ((60, 24, 3, 256), (True, False, False, True), 1,
                               [343, 256, 256], (False,) * 3),
}


def measure_passes(torch, smoke, dev) -> dict:
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import mlp
    from neddf_tpu_torch.kernels import sdf_mlp as sk

    out = {"routes": {}}
    m = smoke.M_NEUS
    e, ws, bs, ch, cg = smoke.sdf_inputs(torch, dev, "ReLU", m)
    _, _, pres = sk.sdf_mlp(e, ws, bs, smoke.SDF_LAYOUT, "ReLU", stash=True)
    routes = {"sdf_mlp_bwd": (m, 4, [256] * 8, lambda: sk.sdf_mlp_bwd(
        e, ws, smoke.SDF_LAYOUT, "ReLU", pres, ch, cg))}
    rand = torch.Generator(device=dev).manual_seed(5)
    cases = {"mlp_seg_bwd_neus_color": (m, (3, 24, 3, 256), smoke.NEUS_COL_FANS,
                                        smoke.NEUS_COL_OUTS, (False,) * 9, torch.float32),
             "mlp_seg_bwd_nerf": (smoke.M_NERF_FINE, (60,), smoke.NERF_FANS, [256] * 8,
                                  tuple(li == 5 for li in range(8)), torch.bfloat16)}
    keep = [e, ws, pres, ch, cg]
    for name, (rows, widths, fans, outs, layout, dtype) in cases.items():
        vs = [(torch.rand((rows, w), generator=rand, device=dev) * 2 - 1).to(dtype)
              for w in widths]
        lw = [((torch.rand((f, o), generator=rand, device=dev) * 2 - 1) * f ** -0.5).to(dtype)
              for f, o in zip(fans, outs)]
        lb = [torch.zeros(o, device=dev) for o in outs]
        _, lp = mlp.mlp_seg(vs, lw, lb, layout, "ReLU", stash=True)
        g = (torch.rand((rows, outs[-1]), generator=rand, device=dev) * 0.01).to(dtype)
        keep += [vs, lw, lp, g]
        routes[name] = (rows, 4 if dtype == torch.float32 else 2, list(outs),
                        (lambda vs=vs, lw=lw, layout=layout, lp=lp, g=g:
                         mlp.mlp_seg_bwd(vs, lw, layout, "ReLU", lp, g)))
    for name, (widths, has_j, k, fans, layout) in NEDDF_DUAL.items():
        rows = M_NEDDF_FINE
        bf = torch.bfloat16
        vs = [(torch.rand((rows, w), generator=rand, device=dev) * 2 - 1).to(bf) for w in widths]
        js = [(torch.rand((k, rows, w), generator=rand, device=dev) * 0.2 - 0.1).to(bf)
              for w, h in zip(widths, has_j) if h]
        lw = [((torch.rand((f, 256), generator=rand, device=dev) * 2 - 1) * f ** -0.5).to(bf)
              for f in fans]
        lb = [torch.zeros(256, device=dev) for _ in fans]
        _, _, lp = dm.dual_mlp_seg(vs, js, lw, lb, layout, "tanhExp", has_j, k, stash=True)
        gv = (torch.rand((rows, 256), generator=rand, device=dev) * 0.02 - 0.01).to(bf)
        gj = (torch.rand((k, rows, 256), generator=rand, device=dev) * 0.02 - 0.01).to(bf)
        keep += [vs, js, lw, lp, gv, gj]
        routes[name] = (rows, 2, (k + 1, len(fans)),
                        (lambda vs=vs, js=js, lw=lw, layout=layout, has_j=has_j, lp=lp, gv=gv,
                         gj=gj: dm.dual_mlp_seg_bwd(vs, js, lw, layout, "tanhExp", has_j, lp,
                                                    gv, gj)))
    for name, (rows, t, outs, fn) in routes.items():
        kernels = smoke.profile_calls(torch, fn, calls=3)[0]
        for key, r in kernels.items():
            if key.startswith("shallow_nt_kernel") or key not in PASS_PLANES or key in (
                    "sum_splits_kernel", "sum_rows_kernel"):
                continue
            n = round(r["launches"])
            if key == "gstack_kernel":  # g (f32 every layer, T at the top only), z and gs in T
                streams, layers = outs
                nbytes = (4 + 2 * t if n == layers else 3 * t) * streams * rows * 256 * n
            elif key == "dual_act_kernel":  # z in, h out, in T, every stream
                nbytes = 2 * t * outs[0] * rows * 256 * n
            elif key == "gpre_kernel":  # g f32 in, z and gs in T: every layer, or the top one
                cols = sum(outs) if n == len(outs) else outs[-1] * n
                nbytes = (4 + 2 * t) * rows * cols
            elif key == "act_kernel":  # z in, h out, in T (layers 1..L-1's inputs)
                nbytes = 2 * t * rows * 256 * n
            elif key == "sdf_top_kernel":  # z's channel 0 in, p out
                nbytes = 4 * rows * (256 + 1) * n
            else:
                nbytes = PASS_PLANES[key] * 4 * rows * 256 * n
            if key == "sweep_p_kernel":  # the top launch reads z alone
                nbytes -= 4 * rows * 256
            r["bytes"] = nbytes
            r["bound_ms"] = 1e3 * nbytes / smoke.MEM_RATE
        out["routes"][name] = {
            "rows": rows, "ms": smoke.time_pair(torch, fn, fn, reps=3)[0], "kernels": kernels}
        print(f"passes {name}: {json.dumps(out['routes'][name])}", flush=True)
    del keep, routes
    torch.cuda.empty_cache()

    # the db sum at the NeuS fine pass: 3,104 partials of 64 rows (the
    # elementwise passes') or 1,552 of a 128-row tile (the epilogues'):
    # device time per call by the profiler (back to back, the host's
    # launches would set a CUDA-event time)
    k = dm.Products(torch.float32, dev)
    db = torch.empty(256, device=dev)
    out["db_sum"] = {}
    for rows_per_part in (64, 128):
        parts = torch.randn((-(-198_656 // rows_per_part), 256), generator=rand, device=dev)
        sums = {"one_block": lambda: k.sum_splits(parts, db)}
        if hasattr(k, "sum_rows"):
            sums["parallel"] = lambda: k.sum_rows(parts)
        nbytes = parts.numel() * 4 + 256 * 4
        r = out["db_sum"][parts.shape[0]] = {"bytes": nbytes,
                                             "bound_ms": 1e3 * nbytes / smoke.MEM_RATE}
        for name, fn in sums.items():
            r[f"{name}_ms"] = smoke.profile_calls(torch, fn)[1]
    print(f"passes db_sum: {json.dumps(out['db_sum'])}", flush=True)
    out["epilogue"] = measure_epilogue(torch, smoke, dev)
    return out


def measure_epilogue(torch, smoke, dev) -> dict:
    """NeDDF's fine pass (99,328 rows, bf16, tanhExp) from the epilogue's
    cotangents to the K=3 trunk's top-layer stacked cotangent gs: the
    three steps (the epilogue backward writing dv and dj, autograd's add of
    the colour trunk's cotangent of v_feat, the top layer's gstack) and,
    where the tree has it, the epilogue backward's top mode doing all
    three; each route's median CUDA-event ms and, by the profiler over
    three calls, its kernels with their bytes (inputs read once, outputs
    written once, in [M, 256] bf16 planes) and byte bounds."""
    from neddf_tpu_torch.kernels import dual_mlp as dm
    from neddf_tpu_torch.kernels import neddf_epilogue as epi

    rows, bf = M_NEDDF_FINE, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    v, j, z = randn(rows, 256).to(bf), randn(3, rows, 256, scale=0.3).to(bf), randn(4, rows, 256).to(bf)
    wd, wa = randn(256, scale=1 / 16), randn(256, scale=1 / 16)
    b2 = torch.tensor([0.3, -0.2], device=dev)
    scal = torch.tensor([0.001, 1.1, 2.0, 0.05, 1.0, 1.0, 1.0, 0.0], device=dev)
    g_out = randn(10, rows)
    g_t, g_col = randn(rows, 256, scale=0.1).to(bf), randn(rows, 256, scale=0.1).to(bf)
    k = dm.DualProducts(bf, dev)
    # a tree since the density activation was added passes the shipped ReLU
    dens = (("ReLU",) if "density_act" in inspect.signature(epi.neddf_epilogue_bwd).parameters
            else ())

    def composed():
        dv, dj = epi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t, *dens)[:2]
        return k.gstack(dv + g_col, dj, z, "tanhExp")

    # planes per kernel: the epilogue backward reads v, j, g_tfeat (and at
    # the top g_col and the stash's 4 planes) and writes dv, dj (gs); the
    # add reads 2 and writes 1; gstack reads gv, gj, z and writes gs; both
    # epilogue modes also read 4 f32 values of g_out per row
    routes = {"composed": (composed, {"epi_bwd_kernel": 9, "elementwise": 3,
                                      "gstack_kernel": 12})}
    if hasattr(epi, "neddf_epilogue_gstack"):
        routes["top_mode"] = (lambda: epi.neddf_epilogue_gstack(
            v, j, wd, wa, b2, scal, g_out, g_t, g_col, z, "tanhExp", *dens),
            {"epi_bwd_kernel": 14})
    plane = rows * 256 * 2
    out = {}
    for name, (fn, planes) in routes.items():
        kernels, device_ms = smoke.profile_calls(torch, fn, calls=3)
        total = 0.0
        for key, r in kernels.items():
            n = next((count for part, count in planes.items() if part in key), None)
            if n is None:
                continue
            r["bytes"] = n * plane + (16 * rows if key == "epi_bwd_kernel" else 0)
            r["bound_ms"] = 1e3 * r["bytes"] / smoke.MEM_RATE
            total += r["bound_ms"]
        out[name] = {"rows": rows, "ms": smoke.time_pair(torch, fn, fn, reps=3)[0],
                     "device_ms": device_ms, "bound_ms": total, "kernels": kernels}
        print(f"passes epilogue {name}: {json.dumps(out[name])}", flush=True)
    return out


def device_ops(torch, fn, calls: int) -> float:
    """Device operations (kernels, copies, sets) per call of ``fn``, by
    ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0) / calls


def logger_ms_per_record(log_dir: Path, records: int = 200):
    """Host ms of one step's record through the tree's ``NeRFTBLogger``
    (a default NeDDF step's scalars), or None where the tree has none."""
    try:
        from neddf_tpu_torch.training.logger import NeRFTBLogger
    except ImportError:
        return None
    logger = NeRFTBLogger(str(log_dir))
    losses = {"color": 0.01, "mask": 0.02, "fields_penalty": 0.03}
    start = time.perf_counter()
    for i in range(records):
        logger.write(0.06 + i, 20.0, losses, rays_per_sec=1e4, duration=0.02)
        logger.next()
    logger.flush()
    ms = 1e3 * (time.perf_counter() - start) / records
    logger.close()
    return ms


def measure_train(torch, smoke, family: str, tree: str) -> dict:
    extra = [*smoke.FAMILY_OVERRIDES.get(family, []), "trainer.epoch_max=1"]
    torch.cuda.reset_peak_memory_stats()
    trainer = smoke.run_main_path(torch, smoke.OUT / f"tc_accuracy_{family}", extra)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steady = [r["seconds"] for r in trainer.history if 100 <= r["iteration"] < 200]
    name = f"tc_accuracy_profile_{family}_{tree}.txt"
    steps = 5
    prof = smoke.profile_train(torch, trainer, smoke.card_line(), name, family, "train", steps)
    # an older tree's chip_smoke.profile_train returns the busy share, a
    # newer one a dict with it
    busy_share = prof["busy_share"] if isinstance(prof, dict) else prof
    busy_s = float((smoke.OUT / name).read_text().splitlines()[1].split("device busy")[1]
                   .split()[0])
    out = {"family": family, "steps": len(trainer.history),
           "ms_per_step": 1e3 * smoke.mean(steady),
           "rays_per_s": trainer.batch_size / smoke.mean(steady), "peak_memory_gib": peak_gib,
           "device_ms_per_step": 1e3 * busy_s / steps, "busy_share_traced": busy_share,
           "device_ops_per_step": device_ops(torch, lambda: trainer.run_train_step(0), steps),
           "camera_pose_device_ops": device_ops(torch, lambda: trainer.camera_pose(0), 20),
           "logger_ms_per_record": logger_ms_per_record(smoke.OUT / f"tc_accuracy_log_{tree}")}
    print(f"train {family}: {json.dumps(out)}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def measure_neus_run(torch, smoke, mode: str, seed) -> dict:
    extra = [*smoke.FAMILY_OVERRIDES["neus"]] + (["network.fused=off"] if mode == "plain" else [])
    if seed is not None:
        extra.append(f"trainer.seed={seed}")
    trainer = smoke.run_main_path(torch, smoke.OUT / f"tc_accuracy_neus_{mode}", extra)
    hist = trainer.history
    psnr = [r["psnr"] for r in hist]
    return {"mode": mode, "seed": trainer.seed, "steps": len(hist), "psnr_first50": smoke.mean(psnr[:50]),
            "psnr_last50": smoke.mean(psnr[-50:]),
            "every_20": [(r["iteration"], r["loss"], r["psnr"]) for r in hist[::20]]}


LLFF_EPOCHS = 600  # tools/llff_experiment.py's default
LLFF_CONFIGS = ("neddf_ndc", "nerf_ndc", "neddf")


def measure_llff(torch, smoke, configs) -> dict:
    from neddf_tpu_torch.data.llff import generate_forward_facing_dataset
    from neddf_tpu_torch.scripts.run_eval import evaluate
    from neddf_tpu_torch.training.metrics import peak_signal_noise_ratio, structural_similarity
    from neddf_tpu_torch.utils.png import read_png

    capture = generate_forward_facing_dataset(smoke.OUT / "llff_quality_scene",
                                              **smoke.LLFF_CAPTURE)
    hooks = [f"trainer.epoch_max={LLFF_EPOCHS}",
             f"trainer.epoch_save_model={max(LLFF_EPOCHS // 2, 1)}",
             f"trainer.epoch_test_rendering={max(LLFF_EPOCHS // 3, 1)}",
             "trainer.epoch_save_fields=100000"]
    out = {"card": smoke.card_line(), "epochs": LLFF_EPOCHS, **smoke.LLFF_CAPTURE}
    for config in configs:
        if config == "neddf":
            overrides = ["dataset=llff", "dataset.factor=1", "loss=nerf_loss",
                         f"dataset.dataset_dir={capture}"]
        else:
            overrides = smoke.llff_overrides(config.split("_")[0], capture)
        run_dir = smoke.OUT / f"llff_quality_{config}"
        start = time.perf_counter()
        trainer = smoke.run_main_path(torch, run_dir, [*overrides, *hooks])
        wall = time.perf_counter() - start
        steady = [r["seconds"] for r in trainer.history if 100 <= r["iteration"] < 200]
        steady = steady or [r["seconds"] for r in trainer.history[10:]]  # a short run
        result = {"overrides": overrides, "steps": len(trainer.history), "wall_s": wall,
                  "batch": trainer.batch_size, "ms_per_step": 1e3 * smoke.mean(steady),
                  "psnr_last50": smoke.mean([r["psnr"] for r in trainer.history[-50:]])}
        del trainer
        torch.cuda.empty_cache()
        ev = evaluate(run_dir, LLFF_EPOCHS)
        views = {}
        for i in range(len(ev.dataset)):
            gt = ev.dataset[i]["rgb_images"].astype("uint8")
            rgb = read_png(run_dir / "eval" / f"{i:03}_rgb.png")[:, :, ::-1]
            views[str(i)] = {"psnr": peak_signal_noise_ratio(rgb, gt),
                             "ssim": structural_similarity(rgb, gt, channel_axis=2)}
        result["views"] = views
        print(f"llff {config}: {json.dumps(result)}", flush=True)
        out[config] = result
        del ev
        torch.cuda.empty_cache()
    return out


def measure_llff_step(torch, smoke) -> dict:
    from neddf_tpu_torch.data.llff import generate_forward_facing_dataset

    capture = generate_forward_facing_dataset(smoke.OUT / "llff400", **smoke.LLFF_CAPTURE)
    ref = smoke.llff_reference()["step"]
    out = {}
    for family in smoke.LLFF_OVERRIDES:
        for batch in (smoke.LLFF_BATCH, 256, 512):
            got = {}
            for mode in ("auto", "off"):
                trainer = smoke.llff_trainer(torch, family, capture, [
                    "network.compute_dtype=float32", f"network.fused={mode}"])
                render = trainer.neural_render
                shapes = {k: tuple(v.shape) for k, v in render.state_dict().items()}
                render.load_state_dict({k: torch.from_numpy(v) for k, v in
                                        smoke.family_params(shapes).items()})
                draws = smoke.machine_step_draws(
                    trainer.dataset.image_width, trainer.dataset.image_height,
                    render.sample_coarse + 1, render.sample_fine + 1,
                    seed=smoke.LLFF_DRAW_SEED, batch=batch)
                us, vs, u_strat, u_pdf = (torch.as_tensor(x, device=trainer.device)
                                          for x in draws)
                loss, _, _ = trainer.step_grads(smoke.LLFF_CAMERA, us.long(), vs.long(),
                                                u_strat, u_pdf)
                got[mode] = {"loss": loss.item(), **{n: p.grad.norm().item()
                                                     for n, p in render.named_parameters()}}
                del trainer, render
                torch.cuda.empty_cache()

            def worst(a, b, n=3):
                return sorted(((abs(a[k] - v) / max(abs(v), 1e-30), k) for k, v in b.items()),
                              reverse=True)[:n]

            result = {"kernels_vs_plain": worst(got["auto"], got["off"])}
            if batch == smoke.LLFF_BATCH:
                want = {"loss": ref[family]["loss"], **ref[family]["grad_norms"]}
                result["kernels_vs_jax"] = worst(got["auto"], want)
                result["plain_vs_jax"] = worst(got["off"], want)
            print(f"llff step {family} {batch} rays: {json.dumps(result)}", flush=True)
            out[f"{family}/{batch}"] = result
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", type=Path, default=REPO)
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--batches", type=int, nargs="+", default=[64])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--params", nargs="+", default=["checkpoint"],
                        help="'checkpoint' and/or seeds of chip_smoke.family_params")
    parser.add_argument("--f32", action="store_true", help="only the f32 routes")
    parser.add_argument("--passes", action="store_true",
                        help="only the elementwise passes and products of the backwards")
    parser.add_argument("--train", nargs="+", choices=["neddf", "nerf", "neus"], default=None,
                        help="only a 200-step run of each configuration, with its profile")
    parser.add_argument("--neus-run", choices=["kernels", "plain"], default=None,
                        help="only the NeuS 300-step run, through the kernels or the plain versions")
    parser.add_argument("--llff", nargs="*", choices=LLFF_CONFIGS, default=None,
                        help="only the forward-facing path's held-out quality after 600 "
                        "epochs (default: all three configurations)")
    parser.add_argument("--llff-step", action="store_true",
                        help="only phase 19b's f32 steps, kernels vs plain versions vs JAX")
    parser.add_argument("--seed", type=int, default=None,
                        help="the trainer's seed for --neus-run (default: the config's)")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    sys.path.insert(1, str(REPO))
    import torch

    import chip_smoke as smoke
    from neddf_tpu_torch.kernels import _build
    from neddf_tpu_torch.training.checkpoint import load_msgpack_params, params_from_jax

    if not torch.cuda.is_available():
        print("tc_accuracy.py: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    sd = params_from_jax(load_msgpack_params(smoke.RUN / "models" / f"model_{smoke.EPOCH:05}.ckpt"))
    result = {"tree": str(args.tree), "card": smoke.card_line(),
              "build": str(_build.build_dir())}
    if args.passes or args.train:
        if args.passes:
            result["passes"] = measure_passes(torch, smoke, dev)
        if args.train:
            result["train"] = [measure_train(torch, smoke, family, args.tree.resolve().name)
                               for family in args.train]
    elif args.llff_step:
        result["llff_step"] = measure_llff_step(torch, smoke)
    elif args.llff is not None:
        result["llff"] = measure_llff(torch, smoke, args.llff or LLFF_CONFIGS)
    elif args.neus_run:
        result["neus_run"] = measure_neus_run(torch, smoke, args.neus_run, args.seed)
    elif args.f32:
        result["f32"] = measure_f32(torch, smoke, dev)
    else:
        result["step"] = {p: measure_step(torch, smoke, p, args.batches, args.seeds)
                          for p in args.params}
        result["layers"], result["trunk"], trunk_fn = measure_trunk(torch, smoke, sd, dev)
        result["products"], product_fns = measure_products(torch, smoke, dev)
        result["ms"] = {"trunk_fwd_stash": smoke.time_pair(torch, trunk_fn, trunk_fn,
                                                           reps=3)[0]}
        for name, fn in product_fns.items():
            result["ms"][f"product_{name}"] = smoke.time_pair(torch, fn, fn, reps=3,
                                                              inner=10)[0]
    text = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
