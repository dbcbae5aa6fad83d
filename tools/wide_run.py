#!/usr/bin/env python3
"""NeDDF with both trunks ``--width`` wide on one card (the per-layer route
of the kernels past 512): the default run (300 steps of 512 rays, bf16,
``chip_smoke.py``'s ``run_main_path``) with every count at 0 before it,
then five traced steps.

    python3 tools/wide_run.py [--width 2048]

Prints one JSON line: ms/step over steps 100-199, peak device memory,
the train PSNR of the first and last 50 steps, the route's launches (and
no plain call, or it fails), the device's busy share and device ms per
step; the trace into ``chiprun_out/chip_smoke/profile_train_neddf_<W>.txt``.
Needs a CUDA card.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--width", type=int, default=2048)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        raise SystemExit("tools/wide_run.py: no CUDA card")
    c.cache_datasets()
    from neddf_tpu_torch.kernels import _build

    _build.library()
    card = c.card_line()
    w = args.width
    c.reset_path_counts()
    torch.cuda.reset_peak_memory_stats()
    t = c.run_main_path(torch, c.OUT / f"train_neddf_{w}",
                        [f"network.ddf_layer_width={w}", f"network.col_layer_width={w}",
                         f"trainer.epoch_save_model={c.TRAIN_EPOCHS}"])
    counts = c.tp_route_counts(f"[{w}] run", c.TP_RUN_KERNELS)
    hist = t.history
    steady = [r["seconds"] for r in hist if 100 <= r["iteration"] < 200]
    out = {"card": card, "width": w, "ms_per_step": 1000 * c.mean(steady),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "psnr_first50": c.mean([r["psnr"] for r in hist[:50]]),
           "psnr_last50": c.mean([r["psnr"] for r in hist[-50:]]),
           "launches": counts["launches"], "layer_forward": counts["layer_forward"],
           "plain_calls": counts["plain_calls"]}
    prof = c.profile_train(torch, t, card, f"profile_train_neddf_{w}.txt",
                           f"512 rays, bf16, width {w}", str(w))
    out["busy_share"] = prof["busy_share"]
    out["device_ms_per_step"] = prof["device_ms_per_step"]
    c.drop_large_outputs()
    print(json.dumps(out))
