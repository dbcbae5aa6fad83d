"""Step timing, a device trace of chosen steps, and the NaN sanitizer.

Counterpart of ``neddf_tpu/utils/profiling.py``:

* ``StepProfiler``: rays/s and mean step ms over a sliding window of
  steps, and a ``torch.profiler`` trace of the steps [trace_start,
  trace_start + trace_steps) written under ``trace_dir``: a Chrome trace
  (``trace_{first}-{last}.json``, for Perfetto or chrome://tracing) and
  the device time by kernel (``kernels_{first}-{last}.txt``,
  ``device_time_table``);
* ``device_time_table``: the kernels of a profile by device time, the
  table that ``chip_smoke.py`` writes into its ``profile*.txt`` too;
* ``enable_nan_debugging``: torch's anomaly mode with NaN checks, the
  reference's own sanitizer (``set_detect_anomaly(True)`` in its
  ``run.py``); ``raise_if_nonfinite`` names the first tensor of a list
  that is not finite (one device sync for the whole list).
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import torch

Tensor = torch.Tensor


def enable_nan_debugging(enable: bool = True):
    """Turn torch's anomaly mode with NaN checks on or off. The returned
    object is also a context manager that restores the previous mode."""
    return torch.autograd.set_detect_anomaly(enable, check_nan=True)


def raise_if_nonfinite(named: Iterable[Tuple[str, Optional[Tensor]]]) -> None:
    """Raise FloatingPointError naming the first tensor with a NaN or an
    infinity (``None`` entries are skipped)."""
    named = [(name, t) for name, t in named if t is not None]
    if not named:
        return
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    for (name, _), ok in zip(named, finite.tolist()):
        if not ok:
            raise FloatingPointError(f"debug_nans: {name} is not finite")


def device_time_table(prof, limit: int = 40) -> Tuple[float, List[str]]:
    """(device seconds in all, one line per kernel: seconds, share,
    launches, name), the kernels of ``prof`` (a finished
    ``torch.profiler.profile``) by their own device time, longest first."""
    kernels = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    lines = []
    for e in kernels[:limit]:
        t = e.self_device_time_total / 1e6
        lines.append(f"{t:9.4f} s {100 * t / max(busy, 1e-30):6.2f}% n={e.count:6d}  "
                     f"{e.key[:110]}")
    return busy, lines


class StepProfiler:
    """Rays/s over a sliding window of steps, and a device trace of the
    steps [trace_start, trace_start + trace_steps) when ``trace_dir`` is
    set.

    Usage:
        prof = StepProfiler(rays_per_step=512, trace_dir="log/profile",
                            trace_start=100, trace_steps=5)
        for step in ...:
            prof.step_begin()
            ... run the step, synchronising where its metrics are read ...
            prof.step_end()      # returns rays/s over the window
    """

    def __init__(
        self,
        rays_per_step: int,
        window: int = 50,
        trace_dir: Optional[str] = None,
        trace_start: int = -1,
        trace_steps: int = 5,
    ) -> None:
        self.rays_per_step = rays_per_step
        self.window = window
        self.trace_dir = trace_dir
        self.trace_start = trace_start
        self.trace_steps = trace_steps
        self._times: list = []
        self._step = 0
        self._prof = None
        self._t0 = 0.0

    def step_begin(self) -> None:
        if self.trace_dir is not None and self._step == self.trace_start and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        self._t0 = time.perf_counter()

    def step_end(self) -> float:
        dt = time.perf_counter() - self._t0
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        self._step += 1
        if self._prof is not None and self._step >= self.trace_start + self.trace_steps:
            self.close()
        return self.rays_per_sec()

    def rays_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return self.rays_per_step * len(self._times) / sum(self._times)

    def mean_step_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1e3 * sum(self._times) / len(self._times)

    def close(self) -> None:
        """End a trace in progress and write it."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.stop()
        out = Path(self.trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        steps = f"{self.trace_start}-{self._step - 1}"
        prof.export_chrome_trace(str(out / f"trace_{steps}.json"))
        busy, lines = device_time_table(prof)
        header = [f"steps {steps}: device busy {busy:.6f} s"]
        (out / f"kernels_{steps}.txt").write_text("\n".join(header + lines) + "\n")
