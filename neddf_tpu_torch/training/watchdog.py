"""Run-directory stall watchdog and auto-resume supervisor.

Counterpart of ``neddf_tpu/training/watchdog.py``, without JAX:

    python -m neddf_tpu_torch.scripts.run --watchdog 600 trainer=...

runs training as a supervised subprocess. The supervisor polls the run
directory's newest write time (logger files under log/, checkpoints
under models/, train_log.jsonl); if nothing has been written for
``stale_seconds`` while the child is still alive, the child's process
group is killed BY PID (never by name or pattern) and training restarts
with ``--resume <run_dir>``, which reloads the newest full-state
checkpoint (params, both optimizers' state, iteration, camera deltas,
the generator's state). Bounded by ``max_restarts``. Before every
relaunch a probe subprocess (``_wait_for_backend``; ``scripts/run.py``
passes a CUDA one, or ``import torch`` alone when the run's config says
``cpu``) tells a dead device apart from a hung child.
Checkpoint writes are atomic (a temporary file, then a rename), so a
kill leaves the previous checkpoint whole.
"""
from __future__ import annotations

import os
import signal
import subprocess
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence


def newest_write_mtime(run_dir: Path) -> float:
    """Newest mtime over the run dir's progress artifacts.

    Scans log/ (TensorBoard event files are appended every
    log_interval steps) and models/ (checkpoints), plus top-level
    files. Returns 0.0 if nothing exists yet.
    """
    run_dir = Path(run_dir)
    latest = 0.0
    for sub in ("log", "models"):
        d = run_dir / sub
        if d.is_dir():
            for p in d.rglob("*"):
                try:
                    latest = max(latest, p.stat().st_mtime)
                except OSError:
                    pass
    if run_dir.is_dir():
        for p in run_dir.iterdir():
            try:
                latest = max(latest, p.stat().st_mtime)
            except OSError:
                pass
    return latest


def _kill_child(child: "subprocess.Popen") -> None:
    """SIGKILL the child's process group (it was started in its own
    session) and reap it. Kills strictly by pid — never by pattern."""
    try:
        os.killpg(child.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            child.kill()
        except ProcessLookupError:
            pass
    try:
        child.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def has_checkpoint(run_dir: Path) -> bool:
    """True when models/ holds a checkpoint (``model_*.ckpt``)."""
    models = Path(run_dir) / "models"
    return models.is_dir() and any(models.glob("model_*.ckpt"))


def _wait_for_backend(
    probe_cmd: Sequence[str],
    probe_timeout: float,
    probe_backoff: float,
    max_probe_waits: int,
) -> None:
    """Block until ``probe_cmd`` exits 0 within ``probe_timeout``.

    Guards relaunches against a dead device or driver, where every new
    process would block or fail at start-up and each resume incarnation
    would burn a full startup grace. A probe subprocess that initialises
    the device and exits distinguishes device-down from child-hung
    cheaply; while it fails, the supervisor sleeps ``probe_backoff``
    between attempts instead of launching doomed children."""
    for attempt in range(max_probe_waits):
        try:
            rc = subprocess.run(
                list(probe_cmd),
                timeout=probe_timeout,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            ).returncode
        except subprocess.TimeoutExpired:
            rc = -1
        if rc == 0:
            if attempt:
                print("[watchdog] backend probe OK", flush=True)
            return
        print(
            f"[watchdog] backend probe failed (attempt {attempt + 1}/"
            f"{max_probe_waits}); backend down? retrying in "
            f"{probe_backoff:.0f}s",
            flush=True,
        )
        time.sleep(probe_backoff)
    raise RuntimeError(
        f"[watchdog] backend unreachable after {max_probe_waits} probes"
    )


def supervise(
    build_cmd: Callable[[bool], Sequence[str]],
    run_dir: Path,
    stale_seconds: float = 600.0,
    poll_seconds: float = 10.0,
    max_restarts: int = 10,
    grace_seconds: float = 5.0,
    startup_grace_seconds: Optional[float] = None,
    probe_cmd: Optional[Sequence[str]] = None,
    probe_timeout: float = 300.0,
    probe_backoff: float = 300.0,
    max_probe_waits: int = 24,
) -> int:
    """Run ``build_cmd(resume)`` under stall supervision.

    Args:
        build_cmd: returns the child argv; called with resume=False for
            the first launch and resume=True for every relaunch.
        run_dir: directory whose write activity signals liveness.
        stale_seconds: kill the child after this long with no run-dir
            writes (keep comfortably above one epoch; TB events are
            appended every log_interval steps once training runs).
        poll_seconds: staleness check interval.
        max_restarts: give up (re-raising failure) after this many
            kills/crashes.
        grace_seconds: pause after a kill so the device is released
            before the resume process starts.
        startup_grace_seconds: staleness threshold used while THIS
            incarnation has produced no writes yet: the dataset decode,
            the kernels' first build and the first epoch on a loaded host
            can exceed stale_seconds without being hung. Default 3x
            stale_seconds.
        probe_cmd: optional backend-health command run before every
            RELAUNCH (see _wait_for_backend); a relaunch waits with
            backoff while it fails instead of counting restarts.
        probe_timeout / probe_backoff / max_probe_waits: probe limits.

    A kill/crash only restarts with resume once a checkpoint actually
    exists in the run dir; earlier incarnations restart fresh (resuming
    an empty models/ is a guaranteed crash loop).

    Returns the child's exit code (0) on clean completion.
    """
    run_dir = Path(run_dir)
    if startup_grace_seconds is None:
        startup_grace_seconds = 3.0 * stale_seconds
    restarts = 0
    first = True
    while True:
        if not first and probe_cmd is not None:
            _wait_for_backend(
                probe_cmd, probe_timeout, probe_backoff, max_probe_waits
            )
        first = False
        resume = has_checkpoint(run_dir)
        cmd: List[str] = list(build_cmd(resume))
        start = time.time()
        child = subprocess.Popen(cmd, start_new_session=True)
        stalled = False
        try:
            while True:
                try:
                    rc: Optional[int] = child.wait(timeout=poll_seconds)
                    break
                except subprocess.TimeoutExpired:
                    pass
                last = newest_write_mtime(run_dir)
                if last <= start:
                    # nothing written by this incarnation yet: it is
                    # loading or building; use the generous threshold
                    age = time.time() - start
                    limit = startup_grace_seconds
                else:
                    age = time.time() - last
                    limit = stale_seconds
                if age > limit:
                    print(
                        f"[watchdog] no run-dir writes for {age:.0f}s "
                        f"(> {limit:.0f}s); killing pid {child.pid}",
                        flush=True,
                    )
                    _kill_child(child)
                    stalled = True
                    rc = None
                    break
        finally:
            if child.poll() is None:
                _kill_child(child)
        if not stalled and rc == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"[watchdog] giving up after {max_restarts} restarts "
                f"(last: {'stall' if stalled else f'exit {rc}'})"
            )
        reason = "stall" if stalled else f"exit code {rc}"
        nxt = "--resume" if has_checkpoint(run_dir) else "a fresh start"
        print(
            f"[watchdog] {reason}; restarting with {nxt} "
            f"({restarts}/{max_restarts})",
            flush=True,
        )
        time.sleep(grace_seconds)
