"""Training entry point of the PyTorch port.

Usage:
    python -m neddf_tpu_torch.scripts.run [group=name ...] [a.b.c=value ...]
        [hydra.run.dir=<dir>]

Composes ``config/config.yaml`` with Hydra-style overrides (the same
surface as ``neddf_tpu/scripts/run.py``), re-roots a relative dataset
directory against the repository root, creates the run directory
(``outputs/{date}/{time}`` unless ``hydra.run.dir`` names one), writes
``.hydra/`` there for ``run_eval``, changes into it and trains. The
configs' device ``tpu`` maps to the CUDA card; ``trainer.device=cpu``
runs the plain versions of the kernels on the CPU. ``--resume`` and
``--watchdog`` are not ported.
"""
from __future__ import annotations

import datetime
import os
import sys
from pathlib import Path
from typing import List, Optional

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.training.trainer import NeRFTrainer

_REPO = Path(__file__).resolve().parents[2]


def prepare_run(argv: List[str]) -> "tuple[dict, Path]":
    """Compose the config and create the run directory with its snapshot."""
    run_dir: Optional[Path] = None
    overrides = []
    for ov in argv:
        if ov.startswith("hydra.run.dir="):
            run_dir = Path(ov.split("=", 1)[1])
        elif ov.startswith("--"):
            raise SystemExit(f"{ov}: not supported by the PyTorch port")
        else:
            overrides.append(ov)
    cfg = config_lib.compose(_REPO / "config", overrides=overrides)
    ds_dir = Path(cfg["dataset"]["dataset_dir"])
    if not ds_dir.is_absolute():
        cfg["dataset"]["dataset_dir"] = str(_REPO / ds_dir)
    if run_dir is None:
        now = datetime.datetime.now()
        run_dir = _REPO / "outputs" / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")
    run_dir = run_dir.resolve()
    run_dir.mkdir(parents=True, exist_ok=True)
    config_lib.save_snapshot(cfg, overrides, run_dir)
    return cfg, run_dir


def main(argv: Optional[List[str]] = None) -> NeRFTrainer:
    cfg, run_dir = prepare_run(list(sys.argv[1:] if argv is None else argv))
    os.chdir(run_dir)
    print(f"run dir: {run_dir}")
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.run_train()
    return trainer


if __name__ == "__main__":
    main()
