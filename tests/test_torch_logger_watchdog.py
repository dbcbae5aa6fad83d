"""The port's logger, profiler, NaN sanitizer and watchdog, on the CPU.

* ``BaseLogger.next()`` writes the JAX package's records (the
  reference's scalar names) for the same inputs; the JSON-lines fallback
  when TensorBoard does not import; a run directory's ``log/``.
* ``StepProfiler``: rays/s over its window, and a trace of the chosen
  steps under ``log/profile`` from a trainer's ``profile_trace_start``.
* ``debug_nans``: a NaN parameter raises FloatingPointError naming the
  loss, a NaN gradient names its parameter; the anomaly mode is off again
  after the step.
* ``--watchdog`` builds the supervised and the ``--resume`` commands of
  ``neddf_tpu_torch.scripts.run`` with the device probe of the composed
  config: CUDA for the default ``tpu``, ``import torch`` alone for a
  ``cpu`` trainer (``trainer=test`` or ``trainer.device=cpu``), as
  ``tests/training/test_run_watchdog_cli.py`` holds the JAX package's;
  ``supervise`` kills a stalled child by pid and resumes it
  (``tests/training/test_watchdog.py``'s child).
"""
import builtins
import json
import sys
import time

import pytest
import torch

from neddf_tpu.training.logger import BaseLogger as JaxBaseLogger
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.training import watchdog as twatchdog
from neddf_tpu_torch.training.logger import BaseLogger, NeRFTBLogger
from neddf_tpu_torch.utils.profiling import StepProfiler
from tests.test_torch_train_step import scene, tiny_config  # noqa: F401
from tests.training.test_watchdog import _child_cmd
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


def _capture(base):
    class Capture(base):
        def __init__(self):
            super().__init__()
            self.records = []

        def _next_impl(self, log_dict):
            self.records.append(dict(log_dict))

    return Capture()


@pytest.mark.parametrize("rays_per_sec", [0.0, 123.0])
def test_logger_records_equal_the_jax_packages(rays_per_sec):
    loggers = [_capture(JaxBaseLogger), _capture(BaseLogger)]
    for lg in loggers:
        lg.write_batchstart()
        lg.write_batchend()
        lg.write(0.5, 21.0, {"color": 0.4, "fields_penalty": 0.1},
                 rays_per_sec=rays_per_sec, duration=0.25)
        lg.next()
    want, got = loggers[0].records[0], loggers[1].records[0]
    assert set(got) == set(want)
    assert {"loss", "PSNR", "iteration duration", "total duration",
            "objective/color", "objective/fields_penalty"} <= set(got)
    for k in ("loss", "PSNR", "iteration duration", "objective/color"):
        assert got[k] == want[k]
    assert loggers[1].niter == 1


def test_logger_falls_back_to_json_lines(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    lg = NeRFTBLogger(log_dir=str(tmp_path))
    monkeypatch.setattr(builtins, "__import__", real_import)
    lg.write(1.0, 30.0, {"color": 1.0})
    lg.next()
    lg.close()
    rec = json.loads((tmp_path / "train_log.jsonl").read_text().splitlines()[0])
    assert rec["iter"] == 0 and rec["loss"] == 1.0 and rec["objective/color"] == 1.0


def test_step_profiler_rate_and_trace(tmp_path):
    prof = StepProfiler(rays_per_step=100, window=4)
    for _ in range(6):
        prof.step_begin()
        time.sleep(0.01)
        rate = prof.step_end()
    assert 1_000 < rate < 100_000  # ~100 rays / 0.01 s, bounded for CI jitter
    assert len(prof._times) == 4
    assert 10.0 <= prof.mean_step_ms() < 1000.0

    traced = StepProfiler(rays_per_step=10, trace_dir=str(tmp_path / "prof"), trace_start=1,
                          trace_steps=2)
    for _ in range(5):
        traced.step_begin()
        torch.square(torch.arange(8.0)).sum()
        traced.step_end()
    assert (tmp_path / "prof" / "trace_1-2.json").exists()
    assert (tmp_path / "prof" / "kernels_1-2.txt").read_text().startswith("steps 1-2")


def test_trainer_logs_and_traces_under_log(scene, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = tiny_config(scene, epoch_max=1, profile_trace_start=1, profile_trace_steps=2)
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    trainer.render_test = lambda *a, **k: None
    trainer.run_train()
    assert trainer.iteration == 4
    assert sorted(p.name for p in (tmp_path / "log" / "profile").iterdir()) == [
        "kernels_1-2.txt", "trace_1-2.json"]
    assert any(p.name.startswith("events.out.tfevents") for p in (tmp_path / "log").iterdir())


def test_debug_nans_names_the_first_tensor_that_is_not_finite(scene):
    cfg = tiny_config(scene, debug_nans=True)
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    trainer.run_train_step(0)  # finite: no error, and the mode is off again
    assert not torch.is_anomaly_enabled()
    with torch.no_grad():
        trainer.neural_render.network_fine.layers_ddf[1].w[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="loss is not finite"):
        trainer.run_train_step(0)
    assert not torch.is_anomaly_enabled()

    # a gradient that is not finite where the loss is: its parameter is named
    trainer = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    layer = trainer.neural_render.network_fine.layer_col_out
    layer.b.register_hook(lambda g: torch.full_like(g, float("inf")))
    with pytest.raises(FloatingPointError, match="layer_col_out.b is not finite"):
        trainer.run_train_step(0)


def _watchdog_capture(monkeypatch, argv):
    captured = {}

    def fake_supervise(build_cmd, run_dir, stale_seconds, **kw):
        captured.update(run_dir=run_dir, stale=stale_seconds, fresh=build_cmd(False),
                        resume=build_cmd(True), probe=kw.get("probe_cmd"))
        return 0

    monkeypatch.setattr(twatchdog, "supervise", fake_supervise)
    with pytest.raises(SystemExit) as e:
        trun.main(argv)
    assert e.value.code == 0
    return captured


def test_watchdog_flag_builds_supervised_commands(monkeypatch, tmp_path):
    got = _watchdog_capture(monkeypatch, ["--watchdog", "120", f"hydra.run.dir={tmp_path}/run",
                                          "trainer=test"])
    assert got["stale"] == 120.0
    assert str(got["run_dir"]).endswith("/run")
    fresh = got["fresh"]
    assert fresh[:3] == [sys.executable, "-m", "neddf_tpu_torch.scripts.run"]
    assert f"hydra.run.dir={tmp_path}/run" in fresh and "trainer=test" in fresh
    assert "--watchdog" not in fresh  # the child must not supervise again
    assert got["resume"][-2:] == ["--resume", str(got["run_dir"])]
    assert got["resume"][:3] == [sys.executable, "-m", "neddf_tpu_torch.scripts.run"]
    # config/trainer/test.yaml says device: cpu, so the probe needs no card
    assert got["probe"] == [sys.executable, "-c", "import torch"]

    card = _watchdog_capture(monkeypatch, ["--watchdog", f"hydra.run.dir={tmp_path}/card"])
    assert card["stale"] == 600.0
    assert card["probe"][0] == sys.executable and "torch.cuda.synchronize()" in card["probe"][-1]
    cpu = _watchdog_capture(monkeypatch, ["--watchdog", "trainer.device=cpu",
                                          f"hydra.run.dir={tmp_path}/cpu"])
    assert cpu["probe"][-1] == "import torch"


def test_watchdog_resume_mode(monkeypatch, scene, tmp_path):
    run_dir = tmp_path / "old_run"
    cfg = tiny_config(scene)
    tconfig.save_snapshot(cfg, [], run_dir)  # a snapshot of a cpu run
    got = _watchdog_capture(monkeypatch, ["--watchdog", "--resume", str(run_dir)])
    assert got["stale"] == 600.0
    assert got["fresh"][-2:] == ["--resume", str(run_dir)]
    assert got["probe"][-1] == "import torch"


def test_supervise_kills_a_stalled_child_and_resumes_it(tmp_path):
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    start = time.time()
    rc = twatchdog.supervise(_child_cmd(tmp_path, run_dir), run_dir, stale_seconds=15.0,
                             poll_seconds=0.5, max_restarts=2, grace_seconds=0.1)
    assert rc == 0
    assert time.time() - start < 120  # well before the child's hour-long hang
    assert (run_dir / "incarnations.txt").read_text().split() == ["fresh", "resume"]
    assert twatchdog.has_checkpoint(run_dir)
    assert twatchdog.newest_write_mtime(run_dir) >= start
