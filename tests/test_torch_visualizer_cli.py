"""The port's geometry and culled-eval CLIs on the CPU at test size:
``fields_visualizer`` and ``dataset_visualizer`` against the JAX
package's on the same run dir / scene, and ``run_eval --ray-cull``
against the port's dense ``run_eval``.

The run dir holds a narrow f32 NeDDF on a generated sphere scene, its
snapshot's device ``tpu`` (the card): every CPU run passes ``--device
cpu``, and without it the CLIs raise here (no card) instead of running
on the CPU. Tolerances: voxel volumes within 1e-5 of their largest
magnitude (f32 sums in another order), the meshes' vertex and triangle
counts equal, slice PNGs within one level; the dataset visualizer's
files byte for byte; the culled render's active pixels equal to the
dense render's, its culled pixels the empty composite.
"""
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from neddf_tpu.data.synthetic import generate_sphere_dataset
from neddf_tpu.scripts import dataset_visualizer as jdataset_viz
from neddf_tpu.scripts import fields_visualizer as jfields_viz
from neddf_tpu_torch import config as tconfig
from neddf_tpu_torch.ops.occupancy import coarsen_grid
from neddf_tpu_torch.scripts import dataset_visualizer, fields_visualizer, run_eval
from neddf_tpu_torch.training.checkpoint import params_to_jax
from neddf_tpu_torch.training.trainer import build_renderer
from neddf_tpu_torch.utils.msgpack import save_msgpack
from neddf_tpu_torch.utils.png import read_png
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
NETWORK = {
    "_target_": "neddf_tpu.fields.NeDDF", "embed_pos_rank": 6, "embed_dir_rank": 2,
    "ddf_layer_count": 4, "ddf_layer_width": 16, "col_layer_count": 3,
    "col_layer_width": 16, "d_near": 0.001, "skips": [1], "compute_dtype": "float32",
}
RENDER = {
    "_target_": "neddf_tpu.render.NeRFRender", "sample_coarse": 8, "sample_fine": 16,
    "dist_near": 2.0, "dist_far": 6.0, "max_dist": 6.0, "use_coarse_network": False,
    "sampling_type": "cone",
}
OPEN3D_MESSAGE = "open3d is not installed; headless artifacts were written instead"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_sphere_dataset(tmp_path_factory.mktemp("scene"), n_train=3, n_test=2,
                                   image_size=24)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, scene):
    loss = yaml.safe_load((REPO / "config" / "loss" / "neddf_loss.yaml").read_text())
    cfg = {
        "dataset": {"_target_": "neddf_tpu.data.NeRFSyntheticDataset",
                    "dataset_dir": str(scene), "data_split": "train",
                    "use_depth": False, "use_mask": True},
        "render": RENDER, "network": NETWORK,
        "trainer": {"_target_": "neddf_tpu.training.NeRFTrainer", "device": "tpu",
                    "batch_size": 32, "chunk": 64, "epoch_max": 1, "mesh": None},
        "loss": loss,
    }
    run = tmp_path_factory.mktemp("run")
    (run / ".hydra").mkdir()
    (run / ".hydra" / "config.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    renderer = build_renderer(tconfig.load_snapshot(run), 5, torch.device("cpu"))
    (run / "models").mkdir()
    save_msgpack(run / "models" / "model_00001.ckpt",
                 {"params": params_to_jax(renderer.state_dict())})
    return run


@pytest.fixture()
def no_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)


def test_fields_visualizer_matches_jax(run_dir, tmp_path, capsys, monkeypatch, no_open3d):
    port_run = tmp_path / "port"
    shutil.copytree(run_dir, port_run)
    args = [str(port_run), "--epoch", "1", "--resolution", "16", "--slices", "1",
            "--device", "cpu"]
    fields_visualizer.main(args + ["--gui"])
    assert OPEN3D_MESSAGE in capsys.readouterr().out
    voxel = np.load(port_run / "mesh" / "voxel_16.npy")
    assert voxel.shape == (16, 16, 16) and (port_run / "mesh" / "mesh_16_threshold0.0275.obj"
                                           ).exists()
    # again at a level the random field crosses: the cached volume is read
    level = float(np.median(voxel))
    vertices, triangles = fields_visualizer.main(args + ["--threshold", str(level)])
    assert triangles.shape[0] > 0

    jax_run = tmp_path / "jax"
    shutil.copytree(run_dir, jax_run)
    monkeypatch.setattr(sys, "argv", ["fields_visualizer", str(jax_run), "--epoch", "1",
                                      "--resolution", "16", "--slices", "1", "--device", "cpu",
                                      "--threshold", str(level), "--gui"])
    jfields_viz.main()
    assert OPEN3D_MESSAGE in capsys.readouterr().out
    want = np.load(jax_run / "mesh" / "voxel_16.npy")
    assert np.abs(voxel - want).max() <= 1e-5 * np.abs(want).max()
    obj = f"mesh_16_threshold{level}.obj"
    for path in (port_run / "mesh" / obj, jax_run / "mesh" / obj):
        assert path.with_suffix(".dae").exists()
    port_lines = (port_run / "mesh" / obj).read_text().splitlines()
    jax_lines = (jax_run / "mesh" / obj).read_text().splitlines()
    assert [x[0] for x in port_lines] == [x[0] for x in jax_lines]
    assert len(port_lines) == vertices.shape[0] + triangles.shape[0]
    slices = sorted(p.name for p in (port_run / "fields").glob("slice_*.png"))
    assert slices == sorted(p.name for p in (jax_run / "fields").glob("slice_*.png"))
    assert {"slice_distance_z00.png", "slice_density_z00.png"} <= set(slices)
    for name in slices:
        got = read_png(port_run / "fields" / name).astype(int)
        assert np.abs(got - read_png(jax_run / "fields" / name).astype(int)).max() <= 1, name


def test_visualizer_and_eval_run_on_the_card_by_default(run_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        fields_visualizer.main([str(run_dir), "--epoch", "1", "--resolution", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval.main([str(run_dir), "--epoch", "1", "--ray-cull", "--device", "cuda"])


def test_dataset_visualizer_matches_jax(scene, tmp_path, capsys, monkeypatch, no_open3d):
    overrides = ["dataset=test", f"dataset.dataset_dir={scene}"]
    monkeypatch.chdir(tmp_path)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    dataset_visualizer.main(overrides + ["--gui"])
    assert OPEN3D_MESSAGE in capsys.readouterr().out
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["dataset_visualizer", *overrides, "--gui"])
    jdataset_viz.main()
    for name in ("cameras.obj", "summary.txt"):
        got = (tmp_path / "port" / "dataset_viz" / name).read_bytes()
        assert got == (tmp_path / "jax" / "dataset_viz" / name).read_bytes(), name
    assert b"frames: 3" in (tmp_path / "port" / "dataset_viz" / "summary.txt").read_bytes()


def test_run_eval_ray_cull_matches_the_dense_render(run_dir, tmp_path):
    shutil.copytree(run_dir, tmp_path / "run")
    run = tmp_path / "run"
    args = [str(run), "--epoch", "1", "--cameras", "0", "--downsampling", "2", "--device",
            "cpu"]
    run_eval.main(args)
    dense = {k: read_png(run / "eval" / f"000_{k}.png") for k in ("rgb", "depth")}
    shutil.rmtree(run / "eval")
    run_eval.main(args + ["--ray-cull"])
    culled = {k: read_png(run / "eval" / f"000_{k}.png") for k in ("rgb", "depth")}

    trainer = run_eval.evaluate(run, 1, device="cpu", cameras=[], ray_cull=True)
    grid = trainer.eval_ray_cull
    assert grid.resolution == 64 and grid.threshold == 0.01
    h, w = dense["rgb"].shape[:2]
    uv = np.stack([np.tile(np.arange(w), h) * 2, np.repeat(np.arange(h), w) * 2], 1)
    with torch.no_grad():
        r, t = trainer.camera_pose(0)
    active = trainer.neural_render.rays_active(
        coarsen_grid(grid, 4), trainer.calib, r, t, torch.from_numpy(uv), 128
    ).numpy().reshape(h, w)
    assert 0 < active.sum() < active.size
    for k in ("rgb", "depth"):
        np.testing.assert_array_equal(culled[k][active], dense[k][active], err_msg=k)
    assert np.all(culled["rgb"][~active] == 0)
    assert np.all(culled["depth"][~active] == int((6.0 - 2.0) / 4.0 * 50000 / 256))


def test_fields_visualizer_reads_a_pth_run_dir(run_dir, tmp_path):
    """As in the JAX package, a run dir with the reference's ``.pth`` and
    no ``.ckpt`` loads (``run_eval.load_trainer``)."""
    from neddf_tpu_torch.scripts import export_pth

    run = tmp_path / "run"
    shutil.copytree(run_dir, run)
    export_pth.main([str(run), "--epoch", "1", "--device", "cpu"])
    args = ["--epoch", "1", "--resolution", "8", "--slices", "0", "--device", "cpu"]
    fields_visualizer.main([str(run)] + args)
    want = np.load(run / "mesh" / "voxel_8.npy")
    shutil.rmtree(run / "mesh")
    (run / "models" / "model_00001.ckpt").unlink()
    fields_visualizer.main([str(run)] + args)
    np.testing.assert_array_equal(np.load(run / "mesh" / "voxel_8.npy"), want)
