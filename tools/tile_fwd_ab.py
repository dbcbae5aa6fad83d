"""Time one tree's fused row-tile forward (the trunk wrappers of
``neddf_tpu_torch/kernels/{dual_mlp,mlp,sdf_mlp}.py`` over the tile
kernel) at the shapes of PERF.md's rows #1, #1', #3, #3', #3'' and #7;
prints one JSON line.

Per row: CUDA-event ms of one call alone (the host's time before the
kernels start included) and the mean of three calls back to back,
medians of 7 readings; the profiler's device ms per call (every kernel
the call launches: the tile forward, f32's W^T pre-pass, #7's sweep) and
the kernels by name; the host ms per call (20 calls issued back to back
after a sync, before the card catches up).

With ``--steps [NAME ...]``, instead: the shipped NeDDF, NeRF and NeuS
steps (``chip_smoke.py``'s phases 8 and 11, at their rays) train 100
steps each through the tree's ``scripts/run.py``: ms/step over steps
50-99, then five traced steps (``chip_smoke.profile_train``): device ms
per step and the device's busy share of their wall.

Run from the root of a checkout on a machine with one CUDA card, with
the tree to time (this checkout, or an unpacked ``git archive`` of
another commit in a git-ignored directory, with ``config`` and ``data``
linked into it for ``--steps``) as the argument:

    python3 tools/tile_fwd_ab.py outputs/parent [--steps [NAME ...]]
    python3 tools/tile_fwd_ab.py . [--steps [NAME ...]]

Runs of two trees in one call, in the order parent, change, change,
parent, compare them on one card.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, sys.argv[1])
import importlib.util  # noqa: E402

import torch  # noqa: E402

# this checkout's chip_smoke.py (a tree under test holds its own, older one)
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
from neddf_tpu_torch.kernels import _build  # noqa: E402
from neddf_tpu_torch.kernels import dual_mlp as dm  # noqa: E402
from neddf_tpu_torch.kernels import mlp  # noqa: E402
from neddf_tpu_torch.kernels import sdf_mlp as sk  # noqa: E402

TRUNK = tuple(li == 5 for li in range(8))  # [seg0, h] / [h, seg0] at layer 5 of 8
# (row, dtype, points, segments (with tangents), layers, last width,
# activation, stash, wrapper): the shipped trunks at width 256
ROWS = [("#1", "bfloat16", 99_328, ((60, True),), TRUNK, 256, "tanhExp", True, "trunk"),
        ("#1'", "bfloat16", 99_328, ((60, True), (24, False), (3, False), (256, True)),
         (False,) * 4, 256, "tanhExp", True, "seg"),
        ("#3", "bfloat16", 198_656, ((60, False), (24, False), (3, False), (256, False)),
         (False,) * 4, 256, "tanhExp", False, "mlp"),
        ("#3'", "bfloat16", 198_656, ((60, False),), TRUNK, 256, "ReLU", True, "mlp"),
        ("#3''", "float32", 265_216, ((3, False), (24, False), (3, False), (256, False)),
         (False,) * 9, 3, "ReLU", True, "mlp"),
        ("#7 trunk", "float32", 265_216, ((36, False),), TRUNK, 256, "ReLU", True, "mlp"),
        ("#7", "float32", 265_216, ((36, False),), TRUNK, 256, "ReLU", True, "sdf")]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEPS = {"neddf": [], "nerf": smoke.FAMILY_OVERRIDES["nerf"],
         "neus": smoke.FAMILY_OVERRIDES["neus"]}
WIDTH = 256

torch.backends.cuda.matmul.allow_tf32 = False
print("csrc", _build.CSRC, file=sys.stderr)
_build.library()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)


def reading(fn, inner):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(inner):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / inner


def one_and_three(fn, reps=7):
    """Median ms of one call alone and of three back to back, in turns."""
    fn()
    one, three = [], []
    for _ in range(reps):
        one.append(reading(fn, 1))
        three.append(reading(fn, 3))
    return statistics.median(one), statistics.median(three)


def host_ms(fn, calls=20):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = 1000.0 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host


def rnd(*shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype).contiguous()


def call(row, dtype, m, segs, lay, last, act, stash, wrapper):
    """The row's call of the tree's wrapper, on seeded operands."""
    k = {"trunk": 3, "seg": 1}.get(wrapper, 0)
    widths = [w for w, _ in segs]
    vs = [rnd(m, w, dtype=dtype) for w in widths]
    js = [rnd(k, m, w, dtype=dtype, scale=0.5) for w, hj in segs if hj]
    fans = [sum(widths)] + [WIDTH + widths[0] * s for s in lay[1:]]
    outs = [WIDTH] * (len(lay) - 1) + [last]
    ws = [rnd(f, o, dtype=dtype, scale=1.5 * f ** -0.5) for f, o in zip(fans, outs)]
    bs = [rnd(o, dtype=torch.float32, scale=0.1) for o in outs]
    if wrapper == "trunk":
        return lambda: dm.dual_mlp_trunk(vs[0], js[0], ws, bs, lay, act, stash=stash)
    if wrapper == "seg":
        has_j = tuple(hj for _, hj in segs)
        return lambda: dm.dual_mlp_seg(vs, js, ws, bs, lay, act, has_j, k, stash=stash)
    if wrapper == "sdf":
        return lambda: sk.sdf_mlp(vs[0], ws, bs, lay, act, stash=stash)
    return lambda: mlp.mlp_seg(vs, ws, bs, lay, act, stash=stash)


def rows(tree: str) -> None:
    out = {"tree": tree, "card": smoke.card_line(), "rows": []}
    for row, dtype_name, m, segs, lay, last, act, stash, wrapper in ROWS:
        fn = call(row, DTYPES[dtype_name], m, segs, lay, last, act, stash, wrapper)
        one, three = one_and_three(fn)
        per_call, device = smoke.profile_calls(torch, fn, calls=10)
        r = {"row": row, "dtype": dtype_name, "points": m, "act": act, "stash": stash,
             "ms_one_call": one, "ms_three_calls": three, "device_ms": device,
             "kernels": per_call, "host_ms_per_call": host_ms(fn)}
        out["rows"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "kernels"}), file=sys.stderr)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps(out))


def steps(tree: str, names) -> None:
    """--steps: each configuration's 100 steps and five traced ones; one
    JSON line."""
    import shutil

    smoke.cache_datasets()
    smoke.OUT.mkdir(parents=True, exist_ok=True)  # profile_train's table
    card = smoke.card_line()
    out = {"tree": tree, "card": card, "steps": {}}
    for name in names:
        run_dir = smoke.REPO / "outputs" / "ab_steps" / name
        trainer = smoke.run_main_path(torch, run_dir, [*STEPS[name], "trainer.epoch_max=0"])
        ms = 1000.0 * statistics.mean(r["seconds"] for r in trainer.history[50:])
        prof = smoke.profile_train(torch, trainer, card, name=f"tile_ab_{name}.txt", tag="ab")
        r = {"ms_per_step": ms, "device_ms_per_step": prof["device_ms_per_step"],
             "busy_share": prof["busy_share"]}
        out["steps"][name] = r
        print(json.dumps({"config": name, **r}), file=sys.stderr)
        del trainer
        shutil.rmtree(run_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if sys.argv[2:3] == ["--steps"]:
    steps(sys.argv[1], sys.argv[3:] or tuple(STEPS))
else:
    rows(sys.argv[1])
