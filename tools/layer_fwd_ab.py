"""Time one tree's per-layer route layer forward (``Products.layer_fwd`` of
``neddf_tpu_torch/kernels/dual_mlp.py``) at the shapes of PERF.md's rows
1r, 1'r, 3r, 3'r, 7r fwd and 3''r, three ways, beside ``torch.addmm`` on
the same operands; prints one JSON line.

Per row: CUDA-event ms of one launch alone (the host's time before the
kernel starts included) and the mean of three launches back to back,
measured in turns, medians of 7; the profiler's device ms per call (every
kernel the call launches); the host ms per call (20 calls issued back to
back after a sync, before the card catches up); ``torch.addmm`` by the
first two readings.

Run from the root of a checkout on a machine with one CUDA card, with
the tree to time (this checkout, or an unpacked ``git archive`` of
another commit in a git-ignored directory) as the argument:

    python3 tools/layer_fwd_ab.py outputs/parent
    python3 tools/layer_fwd_ab.py .

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

# (row, dtype, streams, points, K segments, N, activation, stash)
ROWS = [("1r", "bfloat16", 4, 99_328, (1024,), 1024, "tanhExp", True),
        ("1r", "float32", 4, 99_328, (1024,), 1024, "tanhExp", True),
        ("1r post-skip", "bfloat16", 4, 99_328, (60, 1024), 1024, "tanhExp", True),
        ("1'r", "bfloat16", 2, 99_328, (87, 1024), 1024, "tanhExp", True),
        ("1'r", "float32", 2, 99_328, (87, 1024), 1024, "tanhExp", True),
        ("3r", "bfloat16", 1, 99_328, (87, 1024), 1024, "tanhExp", False),
        ("3r", "float32", 1, 99_328, (87, 1024), 1024, "tanhExp", False),
        ("3'r", "bfloat16", 1, 198_656, (1024, 60), 1024, "ReLU", True),
        ("3'r", "float32", 1, 198_656, (1024, 60), 1024, "ReLU", True),
        ("7r fwd", "float32", 1, 265_216, (1024, 36), 1024, "ReLU", True),
        ("7r fwd", "bfloat16", 1, 265_216, (1024, 36), 1024, "ReLU", True),
        ("3''r", "float32", 1, 265_216, (1024,), 3, "ReLU", True),
        ("3''r", "bfloat16", 1, 265_216, (1024,), 3, "ReLU", True)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

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
    """Median ms of one launch alone and of three back to back, in turns."""
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


out = {"tree": sys.argv[1], "card": smoke.card_line(), "rows": []}
for row, dtype_name, s, m, ks, n, act, stash in ROWS:
    dtype = DTYPES[dtype_name]
    k = dm.Products(dtype, dev)
    xs = [torch.randn((s, m, kk), generator=g, device=dev).to(dtype) for kk in ks]
    w = (torch.randn((sum(ks), n), generator=g, device=dev) * sum(ks) ** -0.5).to(dtype)
    b = torch.randn(n, generator=g, device=dev) * 0.1

    def fn():
        return k.layer_fwd(xs, w, b, act, stash)

    one, three = one_and_three(fn)
    device = smoke.profile_calls(torch, fn, calls=10)[1]
    host = host_ms(fn)
    x2d, bt = torch.cat(xs, dim=-1).view(s * m, sum(ks)), b.to(dtype)
    lib_one, lib_three = one_and_three(lambda: torch.addmm(bt, x2d, w))
    r = {"row": row, "dtype": dtype_name, "streams": s, "points": m, "segments": list(ks),
         "n": n, "act": act, "ms_one_launch": one, "ms_three_launches": three,
         "device_ms": device, "host_ms_per_call": host, "addmm_ms_one_launch": lib_one,
         "addmm_ms_three_launches": lib_three}
    out["rows"].append(r)
    print(json.dumps(r), file=sys.stderr)
    del xs, w, x2d
    torch.cuda.empty_cache()
print(json.dumps(out))
