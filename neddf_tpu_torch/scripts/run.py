"""Training entry point of the PyTorch port.

Usage:
    python -m neddf_tpu_torch.scripts.run [group=name ...] [a.b.c=value ...]
        [hydra.run.dir=<dir>]
    python -m neddf_tpu_torch.scripts.run --resume <run_dir>
    python -m neddf_tpu_torch.scripts.run --watchdog [secs] [overrides ... | --resume <run_dir>]

Composes ``config/config.yaml`` with Hydra-style overrides (the same
surface as ``neddf_tpu/scripts/run.py``), re-roots a relative dataset
directory against the repository root (or the working directory, where
only that holds it), creates the run directory
(``outputs/{date}/{time}`` unless ``hydra.run.dir`` names one), writes
``.hydra/`` there for ``run_eval`` and ``--resume``, changes into it and
trains. The configs' device ``tpu`` maps to the CUDA card;
``trainer.device=cpu`` runs the plain versions of the kernels on the CPU.

``--resume <run_dir>`` recomposes the snapshot in ``<run_dir>/.hydra``,
loads the newest ``models/model_*.ckpt`` (the full training state:
parameters, both optimizers' state, iteration, camera deltas and the
generator's state) and continues training in that directory.

``--watchdog [secs]`` (default 600) runs training in a child process
and restarts it with ``--resume`` when the run directory sees no writes
for ``secs`` while the child lives, or when the child fails
(``training/watchdog.py``; the child is killed by pid). It combines with
``--resume``.
"""
from __future__ import annotations

import datetime
import os
import sys
from pathlib import Path
from typing import List, Optional

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.training.trainer import NeRFTrainer, device_type

_REPO = Path(__file__).resolve().parents[2]
_MODULE = "neddf_tpu_torch.scripts.run"
# the watchdog's device probe: start CUDA and finish a kernel
_CUDA_PROBE = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"


def _default_run_dir() -> Path:
    now = datetime.datetime.now()
    return _REPO / "outputs" / now.strftime("%Y-%m-%d") / now.strftime("%H-%M-%S")


def dataset_path(dataset_dir: str) -> Path:
    """The absolute dataset directory of a config: a relative one is taken
    against the repository root (the configs' ``data/...``) or, where it
    exists only there, against the working directory."""
    ds_dir = Path(dataset_dir)
    if ds_dir.is_absolute():
        return ds_dir
    if not (_REPO / ds_dir).exists() and ds_dir.exists():
        return ds_dir.resolve()
    return _REPO / ds_dir


def prepare_run(argv: List[str]) -> "tuple[dict, Path]":
    """Compose the config and create the run directory with its snapshot."""
    run_dir: Optional[Path] = None
    overrides = []
    for ov in argv:
        if ov.startswith("hydra.run.dir="):
            run_dir = Path(ov.split("=", 1)[1])
        elif ov.startswith("--"):
            raise SystemExit(f"{ov}: unknown flag (flags: --resume <run_dir>, "
                             "--watchdog [secs])")
        else:
            overrides.append(ov)
    cfg = config_lib.compose(_REPO / "config", overrides=overrides)
    cfg["dataset"]["dataset_dir"] = str(dataset_path(cfg["dataset"]["dataset_dir"]))
    run_dir = (run_dir or _default_run_dir()).resolve()
    run_dir.mkdir(parents=True, exist_ok=True)
    config_lib.save_snapshot(cfg, overrides, run_dir)
    return cfg, run_dir


def newest_checkpoint(run_dir: Path) -> Path:
    ckpts = sorted((run_dir / "models").glob("model_*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no model_*.ckpt under {run_dir / 'models'}")
    return ckpts[-1]


def resume(run_dir: Path) -> NeRFTrainer:
    """``--resume``: the snapshot's trainer from the newest checkpoint,
    trained on in ``run_dir``."""
    run_dir = run_dir.resolve()
    cfg = config_lib.load_snapshot(run_dir)
    os.chdir(run_dir)
    print(f"run dir: {run_dir}")
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    latest = newest_checkpoint(run_dir)
    trainer.load_checkpoint(latest)
    print(f"resumed from {latest} at iteration {trainer.iteration}")
    trainer.run_train()
    return trainer


def supervised(argv: List[str], stale_seconds: float) -> None:
    """``--watchdog``: training as a supervised child with auto-resume."""
    from neddf_tpu_torch.training import watchdog

    if argv and argv[0] == "--resume":
        run_dir = Path(argv[1]).resolve()
        cfg = config_lib.load_snapshot(run_dir)
        first_cmd = [sys.executable, "-m", _MODULE, "--resume", str(run_dir)]
    else:
        # the composed config gives the device; the pinned run dir is
        # shared by every incarnation
        cfg, run_dir = prepare_run(argv)
        rest = [ov for ov in argv if not ov.startswith("hydra.run.dir=")]
        first_cmd = [sys.executable, "-m", _MODULE, f"hydra.run.dir={run_dir}", *rest]

    def build_cmd(resume_run: bool) -> List[str]:
        if resume_run:
            return [sys.executable, "-m", _MODULE, "--resume", str(run_dir)]
        return first_cmd

    device = str(cfg["trainer"].get("device", "cuda:0"))
    probe = "import torch" if device_type(device) == "cpu" else _CUDA_PROBE
    raise SystemExit(watchdog.supervise(build_cmd, run_dir, stale_seconds,
                                        probe_cmd=[sys.executable, "-c", probe]))


def main(argv: Optional[List[str]] = None) -> NeRFTrainer:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--watchdog":
        argv = argv[1:]
        stale = 600.0
        if argv and argv[0].replace(".", "", 1).isdigit():
            stale = float(argv[0])
            argv = argv[1:]
        supervised(argv, stale)
    if argv and argv[0] == "--resume":
        if len(argv) != 2:
            raise SystemExit("usage: --resume <run_dir>")
        return resume(Path(argv[1]))
    cfg, run_dir = prepare_run(argv)
    os.chdir(run_dir)
    print(f"run dir: {run_dir}")
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.run_train()
    return trainer


if __name__ == "__main__":
    main()
