"""Evaluation entry point of the PyTorch port.

Usage:
    python -m neddf_tpu_torch.scripts.run_eval <run_dir> [--epoch 2000]
        [--device cuda] [--cameras 0 12] [--downsampling 1] [--ray-cull]

Recomposes ``<run_dir>/.hydra`` with ``dataset.data_split=test``, loads
``models/model_{epoch:05}.ckpt`` (or, without it, the reference's
``.pth``), renders the test views to
``<run_dir>/eval`` and prints PSNR/SSIM per view at full resolution
(the flags of ``neddf_tpu/scripts/run_eval.py``). ``--ray-cull`` builds
an occupancy grid from the loaded field and skips the rays that cross
no occupied cell (``trainer.enable_ray_cull``); culled pixels get the
empty composite. The snapshot's device (``tpu`` in this repo's
snapshots) maps to CUDA; ``--device cpu`` runs the plain versions of the
kernels on the CPU. A snapshot whose ``trainer.mesh`` resolves to more
than one rank here (``data: auto`` on a host with several cards, or an
explicit ``data``) renders over that many ranks, as ``scripts/run.py``
trains (``parallel/mesh.py``): each chunk split over them and the tiles
all-gathered; rank 0 writes and prints.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Iterable, List, Optional

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.parallel.mesh import run_world
from neddf_tpu_torch.render.renderer import Draws
from neddf_tpu_torch.training.trainer import NeRFTrainer, device_type, launch_world

_REPO = Path(__file__).resolve().parents[2]


def eval_config(run_dir: Path, device: Optional[str] = None) -> dict:
    """The snapshot's config for eval: the test split, on ``device``."""
    cfg = config_lib.load_snapshot(Path(run_dir).resolve())
    cfg["dataset"]["data_split"] = "test"
    if device:
        cfg["trainer"]["device"] = device
    return cfg


def load_trainer(
    run_dir: Path, epoch: int, device: Optional[str] = None, chunk: Optional[int] = None,
    one_process: bool = False,
) -> NeRFTrainer:
    """Build the trainer from a run snapshot and load its checkpoint; in
    one process whatever the snapshot's mesh when ``one_process`` (the
    field visualizer's), else as one rank of the snapshot's world."""
    run_dir = Path(run_dir).resolve()
    cfg = eval_config(run_dir, device)
    if one_process:
        cfg["trainer"]["mesh"] = None
    if chunk:
        cfg["trainer"]["chunk"] = chunk
    # snapshot dataset dirs are relative to the repository root
    ds_dir = Path(cfg["dataset"]["dataset_dir"])
    if not ds_dir.is_absolute() and not ds_dir.exists() and (_REPO / ds_dir).exists():
        cfg["dataset"]["dataset_dir"] = str(_REPO / ds_dir)
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    model = run_dir / "models" / f"model_{epoch:05}.ckpt"
    if not model.exists() and model.with_suffix(".pth").exists():
        model = model.with_suffix(".pth")  # the reference's checkpoint
    trainer.load_pretrained_model(model)
    return trainer


def evaluate(
    run_dir: Path,
    epoch: int,
    device: Optional[str] = None,
    cameras: Optional[Iterable[int]] = None,
    downsampling: int = 1,
    draws: Optional[Draws] = None,
    ray_cull: bool = False,
) -> NeRFTrainer:
    """The run_eval path: load, then render into ``<run_dir>/eval``."""
    trainer = load_trainer(run_dir, epoch, device)
    if ray_cull:
        trainer.enable_ray_cull()
    save_dir = Path(run_dir).resolve() / "eval"
    ids = range(len(trainer.dataset)) if cameras is None else cameras
    for camera_id in ids:
        trainer.print_rank0(f"rendering from camera {camera_id}")
        trainer.render_test(save_dir, camera_id, downsampling, draws=draws)
    return trainer


def main(argv: Optional[List[str]] = None) -> None:
    parser = ArgumentParser()
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--epoch", type=int, default=2000)
    parser.add_argument("--device", type=str, default=None,
                        help="override trainer device (cpu, cuda, cuda:N)")
    parser.add_argument("--cameras", type=int, nargs="*", default=None,
                        help="test camera ids to render (default: all)")
    parser.add_argument("--downsampling", type=int, default=1,
                        help="render at 1/N resolution (PSNR/SSIM only at 1)")
    parser.add_argument("--ray-cull", action="store_true",
                        help="skip background rays via an occupancy grid built from the "
                        "loaded field (trainer.enable_ray_cull)")
    args = parser.parse_args(argv)
    run_dir = args.output_dir.resolve()
    cfg = eval_config(run_dir, args.device)
    trainer_cfg = cfg["trainer"]
    device = str(trainer_cfg.get("device", "cuda:0"))
    run_world(evaluate, (run_dir, args.epoch, args.device, args.cameras, args.downsampling,
                         None, args.ray_cull),
              launch_world(trainer_cfg.get("mesh"), device), device_type(device), run_dir)


if __name__ == "__main__":
    main()
