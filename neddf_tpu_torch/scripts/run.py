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

Data parallelism (``trainer.mesh.data=N``, or ``data: auto`` on a host
with N > 1 cards; ``parallel/mesh.py``): the world is resolved before the
run directory is made (more ranks than cards raise there), then this
process builds the kernels and starts N ranks (``torch.multiprocessing``,
spawn), rank r on ``cuda:r`` (``trainer.device=cpu``: gloo ranks on the
CPU); a rank that fails ends the others and the run exits non-zero. The
ranks stay in this process's process group, so the watchdog's kill ends
them all. ``--resume`` resolves the snapshot's mesh again: the same world
on the same host. Under torchrun (``RANK`` and ``WORLD_SIZE`` set) each
process joins the group torchrun made (``env://``) instead, on the card
of its ``LOCAL_RANK`` (only this host's ranks, ``LOCAL_WORLD_SIZE``,
need cards here), and rank 0 makes the run directory; across hosts it
must be on a file system that every host mounts.

Tensor parallelism (``trainer.mesh.model=M``; NeDDF, NeRF and NeuS):
``data x M`` ranks,
``data: auto`` the cards divided by M (1 on the CPU), each holding its
column shards of the trunks (``parallel/mesh.py``); the checkpoints hold
the gathered parameters, so ``--resume`` may change M
(``--resume <run_dir> trainer.mesh.model=1``; the snapshot keeps its
mesh).
"""
from __future__ import annotations

import datetime
import os
import sys
from pathlib import Path
from typing import List, Optional

import torch.distributed as dist

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.parallel.mesh import (
    launcher_world,
    run_world,
)
from neddf_tpu_torch.training.trainer import NeRFTrainer, device_type, launch_world

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


def compose_run(argv: List[str]) -> "tuple[dict, List[str], Path]":
    """The composed config, its overrides and the run directory's path."""
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
    return cfg, overrides, (run_dir or _default_run_dir()).resolve()


def make_run_dir(cfg: dict, overrides: List[str], run_dir: Path) -> None:
    """Create the run directory with its ``.hydra`` snapshot."""
    run_dir.mkdir(parents=True, exist_ok=True)
    config_lib.save_snapshot(cfg, overrides, run_dir)


def newest_checkpoint(run_dir: Path) -> Path:
    ckpts = sorted((run_dir / "models").glob("model_*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no model_*.ckpt under {run_dir / 'models'}")
    return ckpts[-1]


def train(cfg: dict, run_dir: Path, resumed: bool = False) -> NeRFTrainer:
    """Build the trainer in ``run_dir`` (from its newest checkpoint when
    ``resumed``) and train; in every rank of a data-parallel run."""
    if dist.is_initialized():
        # every rank trains in rank 0's directory (a launcher's ranks each
        # named a default one)
        shared = [str(run_dir)]
        dist.broadcast_object_list(shared, src=0)
        run_dir = Path(shared[0])
    os.chdir(run_dir)
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.print_rank0(f"run dir: {run_dir}")
    if resumed:
        latest = newest_checkpoint(run_dir)
        trainer.load_checkpoint(latest)
        trainer.print_rank0(f"resumed from {latest} at iteration {trainer.iteration}")
    trainer.run_train()
    return trainer


def start(cfg: dict, overrides: List[str], run_dir: Path,
          resumed: bool = False) -> Optional[NeRFTrainer]:
    """Train in this process, over the ranks it starts, or as one rank of
    a launcher's (torchrun's) process group (``parallel/mesh.py::
    run_world``); returns the trainer of a single-process run. The world
    is resolved before a new run's directory is made (by rank 0 under a
    launcher)."""
    device = str(cfg["trainer"].get("device", "cuda:0"))
    mesh = cfg["trainer"].get("mesh")
    world = launch_world(mesh, device)
    launched = launcher_world()
    if not resumed and (launched is None or launched.rank == 0):
        make_run_dir(cfg, overrides, run_dir)
    return run_world(train, (cfg, run_dir, resumed), world, device_type(device), run_dir)


def resume(run_dir: Path, mesh_overrides: Optional[List[str]] = None) -> Optional[NeRFTrainer]:
    """``--resume``: the snapshot's trainer from the newest checkpoint,
    trained on in ``run_dir`` (over the snapshot's world, or the mesh that
    ``trainer.mesh.*`` overrides give: the checkpoints hold whole
    parameters, so a run may resume under another ``model``)."""
    run_dir = run_dir.resolve()
    cfg = config_lib.load_snapshot(run_dir)
    for ov in mesh_overrides or []:
        key, _, val = ov.partition("=")
        if not key.startswith("trainer.mesh.") or not val:
            raise SystemExit(f"{ov}: --resume takes trainer.mesh.* overrides only")
        config_lib.compose_override(cfg, key, val)
    return start(cfg, [], run_dir, resumed=True)


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
        cfg, overrides, run_dir = compose_run(argv)
        make_run_dir(cfg, overrides, run_dir)
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


def main(argv: Optional[List[str]] = None) -> Optional[NeRFTrainer]:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--watchdog":
        argv = argv[1:]
        stale = 600.0
        if argv and argv[0].replace(".", "", 1).isdigit():
            stale = float(argv[0])
            argv = argv[1:]
        supervised(argv, stale)
    if argv and argv[0] == "--resume":
        if len(argv) < 2:
            raise SystemExit("usage: --resume <run_dir> [trainer.mesh.*=...]")
        return resume(Path(argv[1]), argv[2:])
    return start(*compose_run(argv))


if __name__ == "__main__":
    main()
