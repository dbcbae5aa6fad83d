"""Evaluation entry point of the PyTorch port.

Usage:
    python -m neddf_tpu_torch.scripts.run_eval <run_dir> [--epoch 2000]
        [--device cuda] [--cameras 0 12] [--downsampling 1]

Recomposes ``<run_dir>/.hydra`` with ``dataset.data_split=test``, loads
``models/model_{epoch:05}.ckpt``, renders the test views to
``<run_dir>/eval`` and prints PSNR/SSIM per view at full resolution
(same flags as ``neddf_tpu/scripts/run_eval.py`` except ``--ray-cull``,
which is not ported). The snapshot's device (``tpu`` in this repo's
snapshots) maps to CUDA; ``--device cpu`` runs the plain versions of the
kernels on the CPU.
"""
from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import Iterable, List, Optional

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.render.renderer import Draws
from neddf_tpu_torch.training.trainer import NeRFTrainer

_REPO = Path(__file__).resolve().parents[2]


def load_trainer(
    run_dir: Path, epoch: int, device: Optional[str] = None, chunk: Optional[int] = None
) -> NeRFTrainer:
    """Build the trainer from a run snapshot and load its checkpoint."""
    run_dir = Path(run_dir).resolve()
    cfg = config_lib.load_snapshot(run_dir)
    cfg["dataset"]["data_split"] = "test"
    if device:
        cfg["trainer"]["device"] = device
    if chunk:
        cfg["trainer"]["chunk"] = chunk
    # snapshot dataset dirs are relative to the repository root
    ds_dir = Path(cfg["dataset"]["dataset_dir"])
    if not ds_dir.is_absolute() and not ds_dir.exists() and (_REPO / ds_dir).exists():
        cfg["dataset"]["dataset_dir"] = str(_REPO / ds_dir)
    trainer = config_lib.instantiate(cfg["trainer"], global_config=cfg)
    trainer.load_pretrained_model(run_dir / "models" / f"model_{epoch:05}.ckpt")
    return trainer


def evaluate(
    run_dir: Path,
    epoch: int,
    device: Optional[str] = None,
    cameras: Optional[Iterable[int]] = None,
    downsampling: int = 1,
    draws: Optional[Draws] = None,
) -> NeRFTrainer:
    """The run_eval path: load, then render into ``<run_dir>/eval``."""
    trainer = load_trainer(run_dir, epoch, device)
    save_dir = Path(run_dir).resolve() / "eval"
    save_dir.mkdir(exist_ok=True)
    ids = range(len(trainer.dataset)) if cameras is None else cameras
    for camera_id in ids:
        print(f"rendering from camera {camera_id}")
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
    args = parser.parse_args(argv)
    evaluate(args.output_dir, args.epoch, args.device, args.cameras, args.downsampling)


if __name__ == "__main__":
    main()
