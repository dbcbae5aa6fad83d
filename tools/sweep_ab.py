"""Time one tree's NeuS sweep and shallow nt product at the shapes of
PERF.md's rows #7, 7s and P; prints one JSON line.

Rows:
* #7: ``sdf_mlp`` (the f32 trunk and the sweep) at a NeuS step's 265,216
  rows, width 256, E = 36, [h, e] at layer 5, ReLU; its trunk alone (the
  same f32 row-tile launch through ``mlp_seg``); and 7s, the sweep alone,
  read from the profiler as the device ms of the kernel named
  ``sdf_sweep_kernel`` per ``sdf_mlp`` call (either tree's);
* P: ``Products.nt`` of a depth of 3 (a 3-wide layer's dx) at 198,656 x
  256 bf16, 265,216 x 256 f32 and NeuS-1024's 66,304 x 1024 f32, beside
  ``torch.matmul`` of the same operands (the yardstick; TF32 off).
Per row: CUDA-event ms, the mean of three calls back to back, median of 7
readings; the profiler's device ms per call and the kernels by name.

With ``--steps``, instead: the shipped NeuS step (``chip_smoke.py``'s
phase 11, 1024 rays) trains 100 steps through the tree's
``scripts/run.py``: ms/step over steps 50-99, then five traced steps
(``chip_smoke.profile_train``): device ms per step, the busy share and
the sweep's share.

Run from the root of a checkout on a machine with one CUDA card, with
the tree to time (this checkout, or an unpacked ``git archive`` of
another commit in a git-ignored directory, with ``config`` and ``data``
linked into it for ``--steps``) as the argument:

    python3 tools/sweep_ab.py outputs/parent [--steps]
    python3 tools/sweep_ab.py . [--steps]

Runs of two trees in one call, in the order parent, change, change,
parent, compare them on one card.
"""
import json
import statistics
import sys
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

M_NEUS = 1024 * (65 + 194)
M_NEUS_1024 = 256 * (65 + 194)
LAYOUT = tuple(li == 5 for li in range(8))
E_DIM, WIDTH = 36, 256

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


def three(fn, reps=7):
    """Median ms of three calls back to back."""
    fn()
    return statistics.median(reading(fn, 3) for _ in range(reps))


def rnd(*shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype).contiguous()


def rows(tree: str) -> None:
    out = {"tree": tree, "card": smoke.card_line(), "rows": []}
    e = rnd(M_NEUS, E_DIM)
    fans = [E_DIM] + [WIDTH + E_DIM * s for s in LAYOUT[1:]]
    ws = [rnd(f, WIDTH, scale=1.5 * f ** -0.5) for f in fans]
    bs = [rnd(WIDTH, scale=0.1) for _ in fans]
    calls = {"#7": lambda: sk.sdf_mlp(e, ws, bs, LAYOUT, "ReLU", stash=True),
             "#7 trunk": lambda: mlp.mlp_seg([e], ws, bs, LAYOUT, "ReLU", stash=True)}
    for row, fn in calls.items():
        per_call, device = smoke.profile_calls(torch, fn, calls=10)
        r = {"row": row, "ms_three_calls": three(fn), "device_ms": device, "kernels": per_call}
        if row == "#7":
            r["7s_device_ms"] = sum(v["ms"] for k, v in per_call.items()
                                    if "sdf_sweep_kernel" in k)
        out["rows"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "kernels"}), file=sys.stderr)
    del e, ws, bs, calls
    torch.cuda.empty_cache()
    for name, dtype, m, n in (("P bf16", torch.bfloat16, 2 * 99_328, WIDTH),
                              ("P f32", torch.float32, M_NEUS, WIDTH),
                              ("P f32 NeuS-1024", torch.float32, M_NEUS_1024, 1024)):
        a, b = rnd(m, 3, dtype=dtype), rnd(n, 3, dtype=dtype)
        prod = dm.Products(dtype, dev)

        def kernel():
            return prod.nt(a, b)

        def library():
            return torch.matmul(a, b.T)

        per_call, device = smoke.profile_calls(torch, kernel, calls=10)
        r = {"row": name, "m": m, "n": n, "k": 3, "ms_three_calls": three(kernel),
             "device_ms": device, "kernels": per_call, "library_ms": three(library),
             "bound_ms": 1e3 * (4 * m * n + a.element_size() * 3 * (m + n)) / smoke.MEM_RATE}
        out["rows"].append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "kernels"}), file=sys.stderr)
    print(json.dumps(out))


def steps(tree: str) -> None:
    """--steps: the NeuS step's 100 steps and five traced ones; one JSON
    line."""
    import shutil

    smoke.cache_datasets()
    smoke.OUT.mkdir(parents=True, exist_ok=True)  # profile_train's table
    card = smoke.card_line()
    run_dir = smoke.REPO / "outputs" / "ab_steps" / "neus"
    trainer = smoke.run_main_path(torch, run_dir,
                                  [*smoke.FAMILY_OVERRIDES["neus"], "trainer.epoch_max=0"])
    ms = 1000.0 * statistics.mean(r["seconds"] for r in trainer.history[50:])
    prof = smoke.profile_train(torch, trainer, card, name="sweep_ab_neus.txt", tag="ab")
    r = {"ms_per_step": ms, "device_ms_per_step": prof["device_ms_per_step"],
         "busy_share": prof["busy_share"]}
    print(json.dumps(r), file=sys.stderr)
    del trainer
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "card": card, "steps": {"neus": r}}))


if sys.argv[2:3] == ["--steps"]:
    steps(sys.argv[1])
else:
    rows(sys.argv[1])
