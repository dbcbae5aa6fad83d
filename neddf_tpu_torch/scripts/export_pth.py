"""Export a run's checkpoint as a reference-layout ``.pth``.

Usage:
    python -m neddf_tpu_torch.scripts.export_pth <run_dir> [--epoch N]
        [--device cuda]

Counterpart of ``neddf_tpu/scripts/export_pth.py``: builds the renderer
of ``<run_dir>/.hydra`` (its ``network`` and ``render`` configs; no
dataset is read), loads ``models/model_{N:05}.ckpt`` (the newest one
without ``--epoch``) into it and writes ``models/model_{N:05}.pth``
beside it in the PyTorch reference's ``state_dict`` layout
(``training/checkpoint.py::export_pth``), which the reference's own tools
and ``load_pretrained_model`` read. The snapshot's device (``tpu`` in
this repo's snapshots) maps to CUDA; ``--device cpu`` converts on the
CPU.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.training.checkpoint import export_pth
from neddf_tpu_torch.training.trainer import (
    build_renderer,
    load_renderer_weights,
    resolve_device,
)


def main(argv: Optional[List[str]] = None) -> Path:
    parser = ArgumentParser()
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--epoch", type=int, default=None,
                        help="checkpoint epoch (default: the newest)")
    parser.add_argument("--device", type=str, default=None,
                        help="override trainer device (cpu, cuda, cuda:N)")
    args = parser.parse_args(argv)
    run_dir = args.output_dir.resolve()
    if args.epoch is None:
        ckpts = sorted((run_dir / "models").glob("model_*.ckpt"))
        if not ckpts:
            raise SystemExit(f"no model_*.ckpt under {run_dir / 'models'}")
        epoch = int(ckpts[-1].stem.split("_")[1])
    else:
        epoch = args.epoch
    cfg = config_lib.load_snapshot(run_dir)
    device = resolve_device(args.device or cfg["trainer"].get("device", "cuda:0"))
    renderer = build_renderer(cfg, int(cfg["trainer"].get("seed", 0)), device)
    load_renderer_weights(renderer, run_dir / "models" / f"model_{epoch:05}.ckpt")
    out = run_dir / "models" / f"model_{epoch:05}.pth"
    export_pth(renderer, out)
    print(f"wrote {out} (from the renderer on {device})")
    return out


if __name__ == "__main__":
    main()
