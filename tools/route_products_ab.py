"""Time one tree's per-layer route backward products (``Products.nt`` /
``.tn`` of ``neddf_tpu_torch/kernels/dual_mlp.py``) at PERF.md's shapes
of rows P and P32 at width 1024, a tensor-parallel shard of 512 and layer
0's narrow sides, beside ``torch.matmul`` on the same operands, and the
walks that run them (rows 2r, 4r and 8r); prints one JSON line.

Per product: CUDA-event ms of three calls back to back (medians of 5,
taken in turns with ``torch.matmul``), the profiler's device ms per call
(every kernel the call launches: the product, a padding copy, tn's split
sum), the host ms per call (20 calls issued back to back after a sync,
before the card catches up). Per walk: CUDA-event ms of one call (median
of 3), the profiler's device ms and the kernels by name. ``torch.matmul``
runs f32 with TF32 off.

With ``--steps``, instead: each configuration whose step runs these
products (the shipped NeDDF, NeRF and NeuS steps of phases 8 and 11 and
the per-layer route's NeDDF-, NeRF- and NeuS-1024 and -deep of phases
24b, 25b and 26b, at their rays) trains 100 steps through the tree's
``scripts/run.py``; its ms/step is the mean over steps 50-99.

Run from the root of a checkout on a machine with one CUDA card, with
the tree to time (this checkout, or an unpacked ``git archive`` of
another commit in a git-ignored directory, with ``config`` and ``data``
linked into it for ``--steps``) as the argument:

    python3 tools/route_products_ab.py outputs/parent [--steps]
    python3 tools/route_products_ab.py . [--steps]

Runs of two trees in one call, in the order parent, change, change,
parent, compare them on one card.
"""
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))  # chip_smoke
import chip_smoke as smoke  # noqa: E402
from neddf_tpu_torch.kernels import _build  # noqa: E402
from neddf_tpu_torch.kernels import dual_mlp as dm  # noqa: E402
from neddf_tpu_torch.kernels import mlp  # noqa: E402
from neddf_tpu_torch.kernels import sdf_mlp as sk  # noqa: E402

R_BF16, R_F32 = 4 * 99_328, 265_216  # the K=3 trunk's rows; NeuS's rows
# (row, dtype, layout, rows, depth or fan-in, out columns): nt G [rows,
# width] W [fan, width]^T; tn X [rows, fan]^T G [rows, width]
PRODUCTS = [("P nt", "bfloat16", "nt", R_BF16, 1024, 1024),
            ("P tn", "bfloat16", "tn", R_BF16, 1024, 1024),
            ("P32 nt", "float32", "nt", R_F32, 1024, 1024),
            ("P32 tn", "float32", "tn", R_F32, 1024, 1024),
            ("shard nt", "bfloat16", "nt", R_BF16, 512, 1024),
            ("shard tn", "bfloat16", "tn", R_BF16, 512, 1024),
            ("fan 60 nt", "bfloat16", "nt", R_BF16, 1024, 60),
            ("fan 60 tn", "bfloat16", "tn", R_BF16, 1024, 60),
            ("fan 36 tn", "float32", "tn", R_F32, 1024, 36)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WALK_POINTS = {"2r": 99_328, "4r": 65_536, "8r": 65_536}
TRUNK_LAYOUT = tuple(li == 5 for li in range(7))  # NeDDF's K=3 trunk
MLP_LAYOUT = tuple(li == 5 for li in range(8))  # NeRF's and NeuS's trunks

# the configurations of --steps: chip_smoke.py's overrides, at their rays
STEPS = {"neddf": [], "nerf": smoke.FAMILY_OVERRIDES["nerf"],
         "neus": smoke.FAMILY_OVERRIDES["neus"], "neddf_1024": smoke.TP_OVERRIDES["neddf_1024"],
         **{name: [*smoke.TP_FAMILY_OVERRIDES[name], f"trainer.batch_size={spec['rays']}"]
            for name, spec in smoke.TPF_RUNS.items()},
         **smoke.DEEP_OVERRIDES}

torch.backends.cuda.matmul.allow_tf32 = False
print("csrc", _build.CSRC, file=sys.stderr)
_build.library()
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)


def steps(tree: str) -> None:
    """--steps: each configuration's 100 steps; one JSON line."""
    import shutil

    smoke.cache_datasets()
    out = {"tree": tree, "card": smoke.card_line(), "steps": {}}
    for name, overrides in STEPS.items():
        run_dir = smoke.REPO / "outputs" / "ab_steps" / name
        trainer = smoke.run_main_path(torch, run_dir, [*overrides, "trainer.epoch_max=0"])
        ms = 1000.0 * statistics.mean(r["seconds"] for r in trainer.history[50:])
        out["steps"][name] = ms
        print(json.dumps({"config": name, "ms_per_step": ms}), file=sys.stderr)
        del trainer
        shutil.rmtree(run_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    print(json.dumps(out))


if sys.argv[2:] == ["--steps"]:
    steps(sys.argv[1])
    sys.exit(0)


def reading(fn, inner):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    for _ in range(inner):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / inner


def in_turns(fn, other, inner=3, reps=5):
    """Median ms of fn and of other, three calls a reading, in turns."""
    fn()
    other()
    a, b = [], []
    for _ in range(reps):
        a.append(reading(fn, inner))
        b.append(reading(other, inner))
    return statistics.median(a), statistics.median(b)


def host_ms(fn, calls=20):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = 1000.0 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host


def rnd(*shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


out = {"tree": sys.argv[1], "card": smoke.card_line(), "products": [], "walks": []}
for row, dtype_name, layout, rows, width, fan in PRODUCTS:
    dtype = DTYPES[dtype_name]
    k = dm.Products(dtype, dev)
    if layout == "nt":
        a, b = rnd(rows, width, dtype=dtype), rnd(fan, width, dtype=dtype, scale=0.03)
        lib = lambda: torch.matmul(a, b.T)  # noqa: E731
    else:
        a, b = rnd(rows, fan, dtype=dtype), rnd(rows, width, dtype=dtype, scale=0.1)
        lib = lambda: torch.matmul(a.T, b)  # noqa: E731

    def fn():
        return getattr(k, layout)(a, b)

    ms, lib_ms = in_turns(fn, lib)
    per_call, device = smoke.profile_calls(torch, fn, calls=10)
    r = {"row": row, "dtype": dtype_name, "layout": layout, "rows": rows, "width": width,
         "fan": fan, "ms": ms, "device_ms": device, "kernels": per_call,
         "host_ms_per_call": host_ms(fn), "matmul_ms": lib_ms,
         "tflops": 2.0 * rows * width * fan / ms / 1e9}
    out["products"].append(r)
    print(json.dumps(r), file=sys.stderr)
    del a, b
    torch.cuda.empty_cache()


def walk_2r(dtype):
    m, n = WALK_POINTS["2r"], 1024
    k = dm.DualProducts(dtype, dev)
    ws = [rnd(60 if li == 0 else n + 60 * s, n, dtype=dtype,
              scale=1.5 * (60 if li == 0 else n) ** -0.5) for li, s in enumerate(TRUNK_LAYOUT)]
    bs = [torch.randn(n, generator=g, device=dev) * 0.1 for _ in ws]
    _, ins, pres = dm.dual_mlp_layers_walk([rnd(m, 60, dtype=dtype)], [rnd(3, m, 60, dtype=dtype)],
                                           ws, bs, TRUNK_LAYOUT, "tanhExp", (True,), 3, k,
                                           stash=True)
    gtop = torch.randn((4, m, n), generator=g, device=dev)
    return lambda: dm.dual_mlp_layers_bwd(ins, ws, TRUNK_LAYOUT, "tanhExp", [60], (True,), pres,
                                          gtop, k)


def walk_4r(dtype):
    m, n = WALK_POINTS["4r"], 1024
    k = mlp.MLPProducts(dtype, dev)
    fans = [60] + [n + 60 * s for s in MLP_LAYOUT[1:]]
    ws = [rnd(f, n, dtype=dtype, scale=1.5 * f ** -0.5) for f in fans]
    bs = [torch.randn(n, generator=g, device=dev) * 0.1 for _ in fans]
    _, ins, pres = dm.dual_mlp_layers_walk([rnd(m, 60, dtype=dtype)], [], ws, bs, MLP_LAYOUT,
                                           "ReLU", (False,), 0, k, stash=True,
                                           hidden_first=True)
    gtop = torch.randn((1, m, n), generator=g, device=dev)
    return lambda: dm.dual_mlp_layers_bwd(ins, ws, MLP_LAYOUT, "ReLU", [60], (False,), pres,
                                          gtop, k, hidden_first=True)


def walk_8r(dtype):
    m, n = WALK_POINTS["8r"], 1024
    k = sk.SDFProducts(dtype, dev)
    fans = [36] + [n + 36 * s for s in MLP_LAYOUT[1:]]
    ws = [rnd(f, n, dtype=dtype, scale=1.5 * f ** -0.5) for f in fans]
    bs = [torch.randn(n, generator=g, device=dev) * 0.1 for _ in fans]
    _, _, ins, pres = sk.sdf_layers_walk(rnd(m, 36, dtype=dtype), ws, bs, MLP_LAYOUT, "ReLU", k)
    ch = torch.randn((m, n), generator=g, device=dev)
    cg = torch.randn((m, 36), generator=g, device=dev)
    return lambda: sk.sdf_layers_bwd(ins, ws, MLP_LAYOUT, "ReLU", pres, ch, cg, k)


for row, dtype_name, make in (("2r", "bfloat16", walk_2r), ("2r", "float32", walk_2r),
                              ("4r", "bfloat16", walk_4r), ("4r", "float32", walk_4r),
                              ("8r", "float32", walk_8r)):
    fn = make(DTYPES[dtype_name])
    ms = statistics.median([reading(fn, 1) for _ in range(4)][1:])
    per_call, device = smoke.profile_calls(torch, fn, calls=3)
    r = {"row": row, "dtype": dtype_name, "points": WALK_POINTS[row], "ms": ms,
         "device_ms": device, "kernels": per_call}
    out["walks"].append(r)
    print(json.dumps({k_: v for k_, v in r.items() if k_ != "kernels"}), file=sys.stderr)
    del fn
    torch.cuda.empty_cache()
print(json.dumps(out))
