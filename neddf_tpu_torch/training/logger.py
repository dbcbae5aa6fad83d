"""Training loggers: TensorBoard scalars, or JSON lines without it.

Counterpart of ``neddf_tpu/training/logger.py`` (the reference's
``neddf/logger/{base_logger,nerf_tb_logger}.py``): one record per step
under the reference's scalar names "loss", "PSNR", "objective/<key>",
"iteration duration", "total duration" and "rays per sec", into
``log_dir`` ("log" in the run directory). TensorBoard event files when
``torch.utils.tensorboard`` imports; otherwise ``log_dir/train_log.jsonl``
(the records with ``"iter"``).
"""
from __future__ import annotations

import json
from pathlib import Path
from time import time
from typing import Dict, Optional


class BaseLogger:
    def __init__(self) -> None:
        self.loss = 0.0
        self.psnr = 0.0
        self.loss_dict: Dict[str, float] = {}
        self.rays_per_sec = 0.0
        self.duration: Optional[float] = None
        self.loggerstart = time()
        self.batchstart = self.loggerstart
        self.batchend = self.loggerstart
        self.niter = 0

    def write(
        self,
        loss: float,
        psnr: float,
        loss_dict: Dict[str, float],
        rays_per_sec: float = 0.0,
        duration: Optional[float] = None,
    ) -> None:
        self.loss = float(loss)
        self.psnr = float(psnr)
        self.loss_dict = {k: float(v) for k, v in loss_dict.items()}
        self.rays_per_sec = float(rays_per_sec)
        # a step's own duration (records flushed together each get theirs;
        # the batchstart/batchend pair covers the last step only)
        self.duration = duration

    def write_batchstart(self) -> None:
        self.batchstart = time()

    def write_batchend(self) -> None:
        self.batchend = time()

    def next(self) -> None:
        duration = self.duration
        if duration is None:
            duration = self.batchend - self.batchstart
        log_dict: Dict[str, float] = {
            "loss": self.loss,
            "PSNR": self.psnr,
            "iteration duration": duration,
            "total duration": self.batchend - self.loggerstart,
        }
        if self.rays_per_sec:
            log_dict["rays per sec"] = self.rays_per_sec
        for key, val in self.loss_dict.items():
            log_dict[f"objective/{key}"] = val
        self._next_impl(log_dict)
        self.niter += 1

    def _next_impl(self, log_dict: Dict[str, float]) -> None:
        raise NotImplementedError()

    def close(self) -> None:
        pass


class NeRFTBLogger(BaseLogger):
    """TensorBoard scalars in ``log_dir``; JSON lines there when
    TensorBoard does not import."""

    def __init__(self, log_dir: str = "log") -> None:
        super().__init__()
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(log_dir) / "train_log.jsonl", "a")
        else:
            self._writer = SummaryWriter(log_dir=log_dir)

    def _next_impl(self, log_dict: Dict[str, float]) -> None:
        if self._writer is not None:
            for key, val in log_dict.items():
                self._writer.add_scalar(key, val, self.niter)
        else:
            self._jsonl.write(json.dumps({"iter": self.niter, **log_dict}) + "\n")
            self._jsonl.flush()

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
