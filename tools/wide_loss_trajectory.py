#!/usr/bin/env python3
"""NeDDF's loss over the first steps at a wide width on one card, through
the kernels and through their plain versions, in bf16 and f32: whether a
rising loss comes from the kernels or from the configuration.

    python3 tools/wide_loss_trajectory.py [--width 4096] [--rays 128] [--steps 20]
        [--compare-width 2048]

Each run builds the default trainer (``chip_smoke.py::family_trainer``,
the same seeded initialisation and camera order) with both trunks
``--width`` wide and ``--rays`` rays, then takes ``--steps`` steps: bf16
through the kernels, bf16 through the plain versions (``fused=off``), f32
through the kernels, and bf16 through the kernels at ``--compare-width``.
Prints each run's wall seconds, the card, and every step's loss and loss
dict. Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--width", type=int, default=4096)
    parser.add_argument("--rays", type=int, default=128)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--compare-width", type=int, default=2048)
    args = parser.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        raise SystemExit("tools/wide_loss_trajectory.py: no CUDA card")
    c.cache_datasets()
    card = c.card_line()
    runs = (("bf16 kernels", args.width, [], "auto"), ("bf16 plain", args.width, [], "off"),
            ("f32 kernels", args.width, ["network.compute_dtype=float32"], "auto"),
            ("bf16 kernels", args.compare_width, [], "auto"))
    for label, width, extra, fused in runs:
        torch.manual_seed(0)
        trainer = c.family_trainer(torch, "neddf", [*c.tp_width_overrides(width), *extra,
                                                    f"trainer.batch_size={args.rays}"])
        trainer.neural_render.network_fine.fused = fused
        start = time.perf_counter()
        for it in range(args.steps):
            trainer.run_train_step(it % 2)
        trainer.flush_logs()
        torch.cuda.synchronize()
        print(f"{label}, width {width}: {time.perf_counter() - start:.1f} s | card: {card}",
              flush=True)
        for r in trainer.history:
            print(f"  {r['iteration']} {r['loss']:.5f} "
                  f"{json.dumps({k: round(v, 5) for k, v in r['losses'].items()})}", flush=True)
        del trainer
        torch.cuda.empty_cache()
