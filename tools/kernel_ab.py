"""Time the width-256 kernel routes of one tree's ``neddf_tpu_torch`` at the
main paths' shapes, by CUDA events and by profiler device ms; prints one
JSON line.

Run from the root of a checkout on a machine with one CUDA card, with
the tree to time (this checkout, or an unpacked ``git archive`` of
another commit in a git-ignored directory) as the argument:

    python3 tools/kernel_ab.py outputs/parent
    python3 tools/kernel_ab.py .

Runs of two trees in one call, in the order parent, change, change,
parent, compare them on one card.
"""
import inspect
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))  # chip_smoke
import chip_smoke as smoke  # noqa: E402
from neddf_tpu_torch.kernels import _build  # noqa: E402
from neddf_tpu_torch.kernels import dual_mlp as dm  # noqa: E402
from neddf_tpu_torch.kernels import mlp  # noqa: E402
from neddf_tpu_torch.kernels import neddf_epilogue as epi  # noqa: E402
from neddf_tpu_torch.kernels import sdf_mlp as sk  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
print("csrc", _build.CSRC, file=sys.stderr)
_build.library()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)
dens = ("ReLU",) if "density_act" in inspect.signature(epi.neddf_epilogue).parameters else ()


def rnd(*shape, scale=1.0, dt=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dt).contiguous()


def layers(fans, width, dt):
    return ([rnd(f, width, scale=1.5 * f ** -0.5, dt=dt) for f in fans],
            [rnd(width, scale=0.1) for _ in fans])


def ms(fn, reps=7, inner=3):
    fn()
    out = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / inner)
    return statistics.median(out)


res, dev_ms = {}, {}


def both(name, fn, reps=7, inner=3, calls=10):
    res[name] = ms(fn, reps, inner)
    dev_ms[name] = smoke.profile_calls(torch, fn, calls=calls)[1]


bf = torch.bfloat16
lay = tuple(li == 5 for li in range(8))
w, b = layers([60] + [316 if s else 256 for s in lay[1:]], 256, bf)
m = 99_328
v0, j0 = rnd(m, 60, dt=bf), rnd(3, m, 60, dt=bf)
both("1_dual_mlp_trunk_stash", lambda: dm.dual_mlp_trunk(v0, j0, w, b, lay, "tanhExp", stash=True))
v, j, pres = dm.dual_mlp_trunk(v0, j0, w, b, lay, "tanhExp", stash=True)
wd, wa = rnd(256, scale=0.1), rnd(256, scale=0.1)
b2 = torch.tensor([0.3, -0.2], device=dev)
scal = torch.tensor([0.001, 0.8, 1.5, 0.5, 1, 1, 1, 0.], device=dev)
both("5_neddf_epilogue", lambda: epi.neddf_epilogue(v, j, wd, wa, b2, scal, *dens))
g_out, g_t, g_c = rnd(10, m), rnd(m, 256, scale=0.1, dt=bf), rnd(m, 256, scale=0.1, dt=bf)
targs = (v, j, wd, wa, b2, scal, g_out, g_t, g_c, pres[-1], "tanhExp", *dens)
both("6_neddf_epilogue_gstack", lambda: epi.neddf_epilogue_gstack(*targs))
both("6_neddf_epilogue_bwd", lambda: epi.neddf_epilogue_bwd(v, j, wd, wa, b2, scal, g_out, g_t,
                                                            *dens))
top = epi.neddf_epilogue_gstack(*targs)
both("2_dual_mlp_seg_bwd_trunk", lambda: dm.dual_mlp_seg_bwd(
    [v0], [j0], w, lay, "tanhExp", (True,), pres, None, None, top=(top[0], top[4])))
cw, cb = layers([343, 256, 256, 256], 256, bf)
segs = [rnd(m, s, dt=bf) for s in (60, 24, 3, 256)]
cj = [rnd(1, m, 60, dt=bf), rnd(1, m, 256, dt=bf)]
hj = (True, False, False, True)
both("1p_dual_mlp_seg_k1", lambda: dm.dual_mlp_seg(segs, cj, cw, cb, (False,) * 4, "tanhExp", hj,
                                                  1, stash=True))
_, _, cpres = dm.dual_mlp_seg(segs, cj, cw, cb, (False,) * 4, "tanhExp", hj, 1, stash=True)
gv, gj = rnd(m, 256, scale=0.1, dt=bf), rnd(1, m, 256, scale=0.1, dt=bf)
both("2_dual_mlp_seg_bwd_color", lambda: dm.dual_mlp_seg_bwd(segs, cj, cw, (False,) * 4,
                                                            "tanhExp", hj, cpres, gv, gj))
mn = 198_656
nw, nb = layers([60] + [316 if s else 256 for s in lay[1:]], 256, bf)
nv = [rnd(mn, 60, dt=bf)]
both("3_mlp_seg_nerf_stash", lambda: mlp.mlp_seg(nv, nw, nb, lay, "ReLU", stash=True))
ms_ = 265_216
sw, sb = layers([36] + [292 if s else 256 for s in lay[1:]], 256, torch.float32)
e = rnd(ms_, 36)
both("7_sdf_mlp", lambda: sk.sdf_mlp(e, sw, sb, lay, "ReLU", stash=True), reps=5, inner=2, calls=3)
_, _, sp = sk.sdf_mlp(e, sw, sb, lay, "ReLU", stash=True)
ch, cg = rnd(ms_, 256, scale=0.1), rnd(ms_, 36, scale=0.1)
both("8_sdf_mlp_bwd", lambda: sk.sdf_mlp_bwd(e, sw, lay, "ReLU", sp, ch, cg), reps=5, inner=2,
     calls=3)
print(json.dumps({"tree": sys.argv[1], "card": smoke.card_line(), "event_ms": res,
                  "device_ms": dev_ms}))
