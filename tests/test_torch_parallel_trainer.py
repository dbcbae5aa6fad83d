"""The port's trainer and CLIs over 2 gloo ranks on the CPU
(``trainer.mesh.data=2 trainer.device=cpu``), against one process.

* ``NeRFTrainer(mesh={"data": 2})`` in each rank of a gloo group against
  the single-process trainer: three steps' losses within 1e-5 relative
  (f32: the two half-batch means are summed in another order) and the
  parameters within the JAX mesh test's ``assert_params_close`` bounds
  (``tests/parallel/test_mesh_trainer.py:71``, rtol 2e-3, atol 4e-3:
  Adam's first steps are +-lr per element, so a reduction-order sign
  flip of a near-zero gradient moves a weight by ~2 lr).
* ``python -m neddf_tpu_torch.scripts.run trainer.mesh.data=2`` exits 0
  with one writer: ``train_log.jsonl`` holds each step once, one
  checkpoint per epoch, the epoch-0 test render; its checkpoint loads in
  the JAX package's trainer and in the single-process port trainer;
  ``run_eval`` of that run dir renders over the snapshot's 2 ranks
  (within one 8-bit level of the single-process render of the same
  checkpoint); ``fields_visualizer`` reads it in one process; N +
  ``--resume`` + M at 2 ranks equals N + M bitwise.
* A rank that raises ends the launch with a non-zero exit, not a hang.
* ``resolve_world``: ``data: auto``, explicit worlds, a launcher's world
  (across hosts too: only this host's ranks need its cards), too many
  ranks for the cards, and ``model > 1``; ``launch_world`` reads the
  launcher's environment; a trainer's world is its process group's
  (``group_world``), whatever the cards.
"""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from neddf_tpu import config as jconfig
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.parallel.mesh import group_world, launcher_world, resolve_world
from neddf_tpu_torch.scripts import fields_visualizer
from neddf_tpu_torch.training.trainer import launch_world
from neddf_tpu_torch.utils.png import read_png
from tests.test_torch_parallel import (  # noqa: F401  (scene is a fixture)
    FAMILIES,
    MESH2,
    RANKS_TIMEOUT,
    REPO,
    Ranks,
    family_config,
    run_ranks,
    scene,
)
from tests.test_torch_train_field import _flat_grads


# ----------------------------------------------------------- the trainer
def test_trainer_over_two_ranks_tracks_the_single_process_trainer(scene, tmp_path):
    cfg = family_config(scene, "neddf")
    cfg["network"]["fused"] = "auto"  # the port's own path (plain versions on the CPU)
    cameras = [0, 1, 0]
    single = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    for camera_id in cameras:
        single.run_train_step(camera_id)
    single.flush_logs()
    cfg["trainer"]["mesh"] = MESH2
    ranks = run_ranks("steps", {"cfg": cfg, "cameras": cameras}, tmp_path)
    for rank, got in enumerate(ranks):
        assert [r["iteration"] for r in got["history"]] == [0, 1, 2]
        for mine, want in zip(got["history"], single.history):
            np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5, err_msg=rank)
        for name, p in single.neural_render.named_parameters():
            np.testing.assert_allclose(got["params"][name], p.detach().numpy(), rtol=2e-3,
                                       atol=4e-3, err_msg=name)
            np.testing.assert_array_equal(got["params"][name], ranks[0]["params"][name])


def test_trainer_needs_the_ranks_and_refuses_width_sharding(scene):
    """A mesh needs its ranks; since tensor parallelism a mesh of ``model =
    2`` needs 2 ranks too, for every family: NeRF's and NeuS's width
    sharding is no longer refused (their slice), so their trainers at
    ``model = 2`` ask for the process group as NeDDF's does."""
    cfg = family_config(scene, "neddf", mesh=MESH2)
    with pytest.raises(RuntimeError, match="process group of 2"):
        tconfig.instantiate(cfg["trainer"], global_config=cfg)
    cfg["trainer"]["mesh"] = {"data": 1, "model": 2}
    with pytest.raises(RuntimeError, match="process group of 2"):
        tconfig.instantiate(cfg["trainer"], global_config=cfg)
    for family in ("nerf", "neus"):
        cfg = family_config(scene, family, mesh={"data": 1, "model": 2})
        with pytest.raises(RuntimeError, match="process group of 2"):
            tconfig.instantiate(cfg["trainer"], global_config=cfg)


# ------------------------------------------------------ scripts/run.py over 2 ranks
def _overrides(scene, run_dir) -> list:
    _, network = FAMILIES["neddf"]
    return ["dataset=test", "trainer=test", f"dataset.dataset_dir={scene}",
            "trainer.device=cpu", "trainer.mesh.data=2", "trainer.epoch_max=1",
            "trainer.epoch_save_model=1", "trainer.batch_size=16", "trainer.chunk=64",
            "render.sample_coarse=4", "render.sample_fine=4",
            *[f"network.{k}={v}" for k, v in network.items() if k != "skips"],
            "network.skips=[1]", f"hydra.run.dir={run_dir}"]


def _cli(module: str, *args) -> Ranks:
    return Ranks([sys.executable, "-m", f"neddf_tpu_torch.scripts.{module}", *args])


@pytest.fixture(scope="module", autouse=True)
def dp_runs(scene, tmp_path_factory):
    """A 2-rank run (2 epochs of 2 steps), started before this file's first
    test; once it ends, the same run cut after epoch 0 and continued with
    ``--resume``, and ``run_eval`` of the run, both in the background."""
    root = tmp_path_factory.mktemp("dp_run")
    run, cut = root / "run", root / "cut"
    runs = {"run": _cli("run", *_overrides(scene, run))}

    def after_run() -> dict:
        if "resume" not in runs:
            proc = runs["run"].wait()
            assert proc.returncode == 0, proc.stderr[-4000:]
            shutil.copytree(run / ".hydra", cut / ".hydra")
            (cut / "models").mkdir()
            shutil.copy(run / "models" / "model_00000.ckpt", cut / "models")
            log = (run / "train_log.jsonl").read_text().splitlines()
            (cut / "train_log.jsonl").write_text("".join(x + "\n" for x in log[:2]))
            runs["resume"] = _cli("run", "--resume", str(cut))
            runs["eval"] = _cli("run_eval", str(run), "--epoch", "1", "--cameras", "0",
                                "--downsampling", "2", "--device", "cpu")
        return runs

    yield {"run": run, "cut": cut, "after_run": after_run}
    for ranks in runs.values():
        ranks.stop()


@pytest.fixture()
def dp_run(dp_runs):
    """(run dir, cut-and-resumed run dir, the run's output) once the run ended."""
    runs = dp_runs["after_run"]()
    return dp_runs["run"], dp_runs["cut"], runs["run"].wait().stdout


def test_run_script_over_two_ranks_has_one_writer(dp_run):
    run, _, stdout = dp_run
    records = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in records] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert sorted(p.name for p in (run / "models").iterdir()) == [
        "model_00000.ckpt", "model_00001.ckpt"]
    assert (run / "render" / "0000").is_dir() and (run / ".hydra" / "config.yaml").exists()
    assert stdout.count("epoch:  0") == 1 and stdout.count("epoch:  1") == 1
    assert not list(run.glob(".rendezvous-*"))


def test_its_checkpoint_loads_in_the_jax_and_the_single_process_trainers(dp_run):
    run, _, _ = dp_run
    ckpt = run / "models" / "model_00001.ckpt"
    cfg = tconfig.load_snapshot(run)
    assert cfg["trainer"]["mesh"]["data"] == 2
    cfg["trainer"]["mesh"] = None
    single = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    single.load_checkpoint(ckpt)
    assert single.iteration == 4
    want = {k: v.detach().numpy() for k, v in single.neural_render.state_dict().items()}
    jcfg = jconfig.load_snapshot(run)  # the snapshot's mesh: data=2 on the virtual devices
    jtr = jconfig.instantiate(jcfg["trainer"], global_config=jcfg)
    jtr.load_pretrained_model(ckpt)
    for name, value in _flat_grads(jtr.params).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)


def test_run_eval_renders_over_the_snapshots_ranks(dp_run, dp_runs, tmp_path):
    run, _, _ = dp_run
    proc = dp_runs["after_run"]()["eval"].wait()
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("rendering from camera 0") == 1
    cfg = tconfig.load_snapshot(run)
    cfg["dataset"]["data_split"] = "test"
    cfg["trainer"]["mesh"] = None
    single = tconfig.instantiate(cfg["trainer"], global_config=cfg)
    single.load_pretrained_model(run / "models" / "model_00001.ckpt")
    want = single.render_test(tmp_path, 0, 2)
    got = read_png(run / "eval" / "000_rgb.png")[:, :, ::-1]
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_fields_visualizer_reads_a_two_rank_run_in_one_process(dp_run):
    run, _, _ = dp_run
    fields_visualizer.main([str(run), "--epoch", "1", "--resolution", "8", "--slices", "1",
                            "--device", "cpu"])
    assert np.isfinite(np.load(run / "mesh" / "voxel_8.npy")).all()


def test_resume_over_two_ranks_equals_the_uninterrupted_run(dp_run, dp_runs):
    run, cut, _ = dp_run
    proc = dp_runs["after_run"]()["resume"].wait()
    assert proc.returncode == 0, proc.stderr[-4000:]
    name = "models/model_00001.ckpt"
    assert (cut / name).read_bytes() == (run / name).read_bytes()
    assert (cut / "train_log.jsonl").read_text().splitlines() == [
        x for x in (run / "train_log.jsonl").read_text().splitlines()
        if json.loads(x)["iteration"] < 2] + [
        x for x in (cut / "train_log.jsonl").read_text().splitlines()
        if json.loads(x)["iteration"] >= 2]
    losses = {json.loads(x)["iteration"]: json.loads(x)["loss"]
              for x in (run / "train_log.jsonl").read_text().splitlines()}
    for x in (cut / "train_log.jsonl").read_text().splitlines():
        assert json.loads(x)["loss"] == losses[json.loads(x)["iteration"]]


# ----------------------------------------------------------------- failures
def test_a_rank_that_raises_ends_the_launch_nonzero(tmp_path):
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the
    launch raises (the first rank to fail, which may be rank 0 once gloo
    sees rank 1 gone) and ends the other, well within the time limit."""
    torch.save({}, tmp_path / "fail.in")
    proc = subprocess.run(
        [sys.executable, "-m", "tests.torch_parallel_ranks", "fail", str(tmp_path / "fail.in"),
         str(tmp_path / "fail.out"), "2"], cwd=REPO, capture_output=True, text=True,
        timeout=RANKS_TIMEOUT)
    assert proc.returncode != 0
    assert "ProcessRaisedException" in proc.stderr


# ---------------------------------------------------------------- the world
@pytest.mark.parametrize("mesh,device,cards,launched,want", [
    (None, "cuda", 4, None, None),
    ({"data": "auto", "model": 1}, "cuda", 4, None, 4),
    ({"data": "auto", "model": 1}, "cuda", 1, None, None),
    ({"data": -1}, "cuda", 2, None, 2),
    ({"data": "auto", "model": 1}, "cpu", 0, None, None),
    ({"data": "auto", "model": 1}, "cuda", 4, 2, 2),
    ({"data": 2, "model": 1}, "cpu", 0, None, 2),
    ({"data": 1, "model": 1}, "cuda", 1, None, None),
    (None, "cpu", 0, 2, 2),
], ids=["no_mesh", "auto_4_cards", "auto_1_card", "minus_1", "auto_cpu", "launcher", "cpu_2",
        "one", "launcher_no_mesh"])
def test_resolve_world(mesh, device, cards, launched, want):
    assert resolve_world(mesh, device, cards, launched) == want


def test_resolve_world_refuses_more_ranks_than_cards_and_width_sharding():
    """More ranks than cards raise, width-sharded meshes too (``model``
    ranks per data row since tensor parallelism, which made ``model > 1``
    a world of ``data x model`` ranks instead of NotImplementedError)."""
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices; platform 'cuda' has 1"):
        resolve_world({"data": 2, "model": 1}, "cuda", 1)
    with pytest.raises(ValueError, match="the launcher started 4 ranks"):
        resolve_world({"data": 2, "model": 1}, "cuda", 4, 4)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices; platform 'cuda' has 2"):
        resolve_world({"data": 2, "model": 2}, "cuda", 2)
    assert resolve_world({"data": 1, "model": 2}, "cuda", 4) == 2
    assert resolve_world({"data": "auto", "model": 2}, "cuda", 4) == 4
    assert resolve_world({"data": "auto", "model": 2}, "cpu", 0) == 2
    with pytest.raises(ValueError, match="not a multiple of mesh model=2"):
        resolve_world({"data": "auto", "model": 2}, "cuda", 4, 3)


def test_resolve_world_across_hosts_checks_only_this_hosts_ranks():
    assert resolve_world({"data": "auto", "model": 1}, "cuda", 4, 8, 4) == 8
    assert resolve_world({"data": 8, "model": 1}, "cuda", 4, 8, 4) == 8
    with pytest.raises(ValueError, match="mesh 8x1 needs 8 devices on this host"):
        resolve_world({"data": 8, "model": 1}, "cuda", 4, 8, 8)


def test_launch_world_reads_the_launchers_ranks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert launcher_world() is None
    assert launch_world({"data": "auto", "model": 1}, "tpu") == 4
    assert launch_world({"data": "auto", "model": 1}, "cpu") is None
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("WORLD_SIZE", "8")
    assert launcher_world() == (5, 8, 5, 8)
    with pytest.raises(ValueError, match="needs 8 devices"):
        launch_world({"data": "auto", "model": 1}, "cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert launcher_world() == (5, 8, 1, 4)
    assert launch_world({"data": "auto", "model": 1}, "cuda") == 8


def test_a_trainers_world_is_its_process_groups_whatever_the_cards(monkeypatch):
    """Out of any process group a trainer is one process, even where
    ``data: auto`` would start a rank per card; an explicit ``data`` needs
    a group of that size."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for mesh in (None, {"data": "auto", "model": 1}, {"data": 1, "model": 1}):
        assert group_world(mesh) is None
    with pytest.raises(RuntimeError, match="process group of 2.*a group of 1"):
        group_world({"data": 2, "model": 1})
    with pytest.raises(RuntimeError, match="process group of a multiple of 2.*a group of 1"):
        group_world({"data": "auto", "model": 2})
