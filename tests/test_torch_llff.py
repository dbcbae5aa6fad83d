"""The port's ``LLFFDataset`` against the JAX package's on the CPU, on
captures the JAX generator writes: cameras, intrinsics, bounds, splits and
images for ``recenter`` false and true, the ``images_{factor}`` directory,
frames of another size (the port's box mean against OpenCV's
``INTER_AREA``), JPEG frames (through OpenCV where it imports, a clear
ImportError where it does not), the refusal of degenerate poses under
``recenter``, and ``dataset_visualizer`` on a capture.

Tolerances: the same numpy arithmetic in the same order, so everything
is equal but the rotation vectors, within 1e-6 (scipy on both sides).
"""
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from neddf_tpu.data import LLFFDataset as JLLFF
from neddf_tpu.data.llff import generate_forward_facing_dataset
from neddf_tpu_torch.data import LLFFDataset
from neddf_tpu_torch.data.llff import area_downsample, read_bgr
from neddf_tpu_torch.scripts import dataset_visualizer
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return generate_forward_facing_dataset(tmp_path_factory.mktemp("llff") / "scene",
                                           n_images=9, image_size=32)


def _same(got, want):
    np.testing.assert_allclose(got.camera_params, want.camera_params, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.camera_calib_params, want.camera_calib_params)
    np.testing.assert_array_equal(got.rgb_images, want.rgb_images)
    np.testing.assert_array_equal(got.mask_images, want.mask_images)
    assert (got.near, got.far) == (want.near, want.far)
    assert got.rgb_images.dtype == np.float32 and got.camera_params.dtype == np.float32


@pytest.mark.parametrize("recenter", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_dataset_matches_jax(capture, split, recenter):
    kw = dict(factor=1, recenter=recenter)
    got = LLFFDataset(str(capture), split, **kw)
    _same(got, JLLFF(str(capture), split, **kw))
    assert len(got) == (2 if split == "test" else 7)  # ids 0 and 8 held out
    assert (got.mask_images == 255).all() and 0 < got.near < 4.0 < got.far


def test_recenter_gives_the_average_camera_frame(capture):
    from scipy.spatial.transform import Rotation

    cams = np.concatenate([LLFFDataset(str(capture), s, factor=1, recenter=True).camera_params
                           for s in ("train", "test")])
    backs = Rotation.from_rotvec(cams[:, :3]).as_matrix()[:, :, 2]
    np.testing.assert_allclose(backs.mean(0) / np.linalg.norm(backs.mean(0)), [0, 0, 1],
                               atol=1e-5)
    assert np.abs(cams[:, 3:].mean(0)).max() < 1e-5


def test_factor_directory_and_hold_every(capture, tmp_path):
    scene = tmp_path / "scene"
    shutil.copytree(capture, scene)
    (scene / "images_2").mkdir()
    for p in sorted((scene / "images").iterdir()):
        img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(scene / "images_2" / p.name), cv2.resize(img, (16, 16),
                                                                 interpolation=cv2.INTER_AREA))
    kw = dict(factor=2, hold_every=3, recenter=True)
    got = LLFFDataset(str(scene), "test", **kw)
    _same(got, JLLFF(str(scene), "test", **kw))
    assert got.rgb_images.shape == (3, 16, 16, 3)
    # the focal follows the frames' width: hwf holds the capture's 32 px
    np.testing.assert_allclose(got.camera_calib_params, [19.2, 19.2, 8.0, 8.0])
    # a factor without its directory falls back to images/
    assert LLFFDataset(str(scene), "test", factor=8).image_width == 32


@pytest.mark.parametrize("fy,fx", [(2, 2), (3, 3), (4, 4), (2, 3), (1, 2), (7, 2), (5, 6)])
def test_area_downsample_rounds_as_opencv(fy, fx):
    rng = np.random.default_rng(fy * 10 + fx)
    img = rng.integers(0, 256, size=(13 * fy, 11 * fx, 4), dtype=np.uint8)
    np.testing.assert_array_equal(area_downsample(img, 11, 13),
                                  cv2.resize(img, (11, 13), interpolation=cv2.INTER_AREA))


def test_frames_of_another_size_are_resized_as_jax_resizes_them(capture, tmp_path):
    scene = tmp_path / "scene"
    shutil.copytree(capture, scene)
    for name, scale in (("img_001.png", 2), ("img_004.png", 3)):
        img = cv2.imread(str(scene / "images" / name), cv2.IMREAD_UNCHANGED)
        img = np.repeat(np.repeat(img, scale, 0), scale, 1)
        img[::2, ::3] = 255 - img[::2, ::3]  # blocks that do not average to a level
        cv2.imwrite(str(scene / "images" / name), img)
    for split in ("train", "test"):
        _same(LLFFDataset(str(scene), split, factor=1), JLLFF(str(scene), split, factor=1))
    img = cv2.imread(str(scene / "images" / "img_002.png"), cv2.IMREAD_UNCHANGED)
    cv2.imwrite(str(scene / "images" / "img_002.png"), img[:, :-5])
    with pytest.raises(ValueError, match="integer ratio"):
        LLFFDataset(str(scene), "train", factor=1)


def test_jpeg_frames_need_opencv(capture, tmp_path, monkeypatch):
    scene = tmp_path / "scene"
    shutil.copytree(capture, scene)
    for p in sorted((scene / "images").iterdir())[4:]:
        img = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(p.with_suffix(".jpg")), img[:, :, :3])
        p.unlink()
    for split in ("train", "test"):
        _same(LLFFDataset(str(scene), split, factor=1), JLLFF(str(scene), split, factor=1))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"img_004\.jpg: reading a JPEG frame needs OpenCV"):
        LLFFDataset(str(scene), "train", factor=1)
    # the PNG frames alone still read without it
    assert read_bgr(scene / "images" / "img_000.png").shape == (32, 32, 4)


def test_recenter_refuses_degenerate_poses(capture, tmp_path):
    """Eight cameras in pairs that face opposite ways: the mean view
    direction vanishes, and the average camera's frame with it."""
    scene = tmp_path / "scene"
    shutil.copytree(capture, scene)
    (scene / "images" / "img_008.png").unlink()
    arr = np.load(scene / "poses_bounds.npy")[:8]
    poses = arr[:, :15].reshape(-1, 3, 5)
    # turned half-way about its down axis: right and back columns negated
    poses[1::2, :, :3] = poses[0::2, :, :3] * np.array([1.0, -1.0, -1.0])
    arr[:, :15] = poses.reshape(-1, 15)
    np.save(scene / "poses_bounds.npy", arr)
    assert len(LLFFDataset(str(scene), "train", factor=1)) == 7  # without recenter it loads
    with pytest.raises(ValueError, match="recenter=true needs cameras that face one way"):
        LLFFDataset(str(scene), "train", factor=1, recenter=True)


def test_dataset_visualizer_draws_a_capture(capture, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rel = Path("capture")
    shutil.copytree(capture, tmp_path / rel)
    out = dataset_visualizer.main(["dataset=llff", f"dataset.dataset_dir={rel}",
                                   "dataset.factor=1", "dataset.recenter=true"])
    summary = (out / "summary.txt").read_text()
    assert "frames: 7" in summary and "image size: 32 x 32" in summary
    lines = (out / "cameras.obj").read_text().splitlines()
    assert sum(x.startswith("v ") for x in lines) == 7 * 5 + 8
    assert sum(x.startswith("l ") for x in lines) == 7 * 8 + 12


def test_the_port_imports_without_opencv_and_maps_the_llff_target():
    """No module of the port imports OpenCV (the JPEG reader does, when it
    reads one), and ``config/dataset/llff.yaml``'s target is the port's."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('cv2', 'jax', 'neddf_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import neddf_tpu_torch\n"
        "for m in pkgutil.walk_packages(neddf_tpu_torch.__path__, 'neddf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from neddf_tpu_torch import config\n"
        "cls = config.resolve_target('neddf_tpu.data.LLFFDataset')\n"
        "assert cls.__module__ == 'neddf_tpu_torch.data.llff', cls\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
