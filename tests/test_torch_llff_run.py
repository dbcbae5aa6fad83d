"""The forward-facing path through the port's entry points on the CPU, at
test size on a capture the JAX generator writes: ``scripts/run.py`` with
``dataset=llff`` trains NeDDF without NDC, NeDDF-NDC and NeRF-NDC (the
loss falls; the capture named by a path relative to the working
directory), ``run_eval`` renders the held-out views of each run dir,
``fields_visualizer`` writes the NDC run's slices, ``run_eval
--ray-cull`` refuses the NDC run, and a capture whose frames are not
square trains and renders at their size, as in the JAX package.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from neddf_tpu.data.llff import generate_forward_facing_dataset
from neddf_tpu_torch.scripts import fields_visualizer, run_eval
from neddf_tpu_torch.scripts import run as trun
from neddf_tpu_torch.utils.png import read_png, write_png
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NDC = ["dataset.recenter=true", "render.ndc=true", "render.ndc_near=2.0",
       "render.sampling_type=point"]
NEDDF = ["network.ddf_layer_width=16", "network.col_layer_width=16"]
RUNS = {
    "neddf": NEDDF,
    "neddf_ndc": [*NEDDF, *NDC],
    "nerf_ndc": ["network=nerf", "render=nerf_render", "network.layer_width=16", *NDC],
}
# 21 steps of 16-wide networks: at the configs' lr of 5e-4 NeRF's loss has
# not moved yet, so the runs take 10 times that
SMALL = ["dataset=llff", "dataset.factor=1", "loss=nerf_loss", "trainer=test",
         "render.sample_coarse=8", "render.sample_fine=8", "trainer.batch_size=32",
         "trainer.chunk=256", "trainer.epoch_max=2", "trainer.epoch_save_model=2",
         "trainer.optimizer_lr=0.005"]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return generate_forward_facing_dataset(tmp_path_factory.mktemp("llff") / "scene",
                                           n_images=9, image_size=24)


def _train(capture, tmp_path, monkeypatch, overrides, name="run"):
    monkeypatch.chdir(tmp_path)
    if not (tmp_path / "capture").exists():
        shutil.copytree(capture, tmp_path / "capture")
    run = tmp_path / name
    trainer = trun.main([*SMALL, "dataset.dataset_dir=capture", *overrides,
                         f"hydra.run.dir={run}"])
    return trainer, run


@pytest.mark.parametrize("config", list(RUNS))
def test_run_and_run_eval_on_an_llff_capture(capture, tmp_path, monkeypatch, config):
    trainer, run = _train(capture, tmp_path, monkeypatch, RUNS[config])
    assert trainer.dataset.dataset_dir == tmp_path / "capture"  # taken from the working dir
    assert trainer.neural_render.ndc == config.endswith("_ndc")
    log = [json.loads(x) for x in (run / "train_log.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in log]
    assert len(losses) == 3 * 7 and np.isfinite(losses).all()
    assert np.mean(losses[-7:]) < np.mean(losses[:7])

    evaluated = run_eval.evaluate(run, 2, device="cpu")
    assert len(evaluated.dataset) == 2  # ids 0 and 8 held out
    for i in range(2):
        assert read_png(run / "eval" / f"{i:03}_rgb.png").shape == (24, 24, 3)
    if config.endswith("_ndc"):
        with pytest.raises(ValueError, match="ray culling .*does not support ndc=true"):
            run_eval.main([str(run), "--epoch", "2", "--device", "cpu", "--ray-cull"])
    if config == "neddf_ndc":
        fields_visualizer.main([str(run), "--epoch", "2", "--device", "cpu",
                                "--resolution", "12", "--slices", "2"])
        slices = {p.name for p in (run / "fields").glob("*.png")}
        assert {"slice_distance_z00.png", "slice_color_z01.png"} <= slices
        assert np.isfinite(np.load(run / "mesh" / "voxel_12.npy")).all()


def test_a_capture_of_frames_that_are_not_square(capture, tmp_path, monkeypatch):
    scene = tmp_path / "capture"
    shutil.copytree(capture, scene)
    for p in (scene / "images").iterdir():
        write_png(p, read_png(p)[3:21])  # 24 x 18, the principal point kept at the centre
    trainer, run = _train(capture, tmp_path, monkeypatch, [*RUNS["neddf_ndc"],
                                                           "trainer.epoch_max=0"])
    assert (trainer.dataset.image_width, trainer.dataset.image_height) == (24, 18)
    np.testing.assert_allclose(trainer.dataset.camera_calib_params[2:], [12.0, 9.0])
    (test_render,) = (run / "render" / "0000").glob("*_rgb.png")  # at downsampling 3
    assert read_png(test_render).shape == (6, 8, 3)
    evaluated = run_eval.evaluate(run, 0, device="cpu", cameras=[1])
    assert read_png(run / "eval" / "001_rgb.png").shape == (18, 24, 3)
    assert read_png(run / "eval" / "001_depth.png").shape == (18, 24)
    assert len(evaluated.dataset) == 2
