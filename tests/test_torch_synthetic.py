"""The port's scene generators (``neddf_tpu_torch/data/synthetic.py`` and
``data/llff.py::generate_forward_facing_dataset``) against the JAX
package's on the CPU, at small sizes: the same files, decoded to the same
pixels (the JAX package writes with OpenCV, which takes BGR[A] arrays;
the port writes the same arrays through its own PNG writer after the
channel swap), the same ``transforms_*.json`` and ``poses_bounds.npy``,
byte for byte; and the port's CLI, with OpenCV blocked from importing.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from neddf_tpu.data import llff as jllff
from neddf_tpu.data import synthetic as jsynthetic
from neddf_tpu_torch.data import llff, synthetic
from neddf_tpu_torch.utils.png import read_png
from tests.torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = Path(__file__).resolve().parents[1]
GENERATORS = {
    "sphere": ("generate_sphere_dataset", 16),
    "machine": ("generate_machine_dataset", 24),
    "drums": ("generate_drums_dataset", 32),
}


def _same_scene(got: Path, want: Path) -> int:
    """Assert two scene directories hold the same files; returns the
    number of images compared."""
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    images = 0
    for rel in files:
        if rel.suffix == ".png":
            a, b = read_png(got / rel), read_png(want / rel)
            assert a.dtype == b.dtype and a.shape == b.shape, rel
            np.testing.assert_array_equal(a, b, err_msg=str(rel))
            images += 1
        else:
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel
    return images


@pytest.mark.parametrize("scene", list(GENERATORS))
def test_generators_match_jax(scene, tmp_path):
    name, size = GENERATORS[scene]
    kw = dict(n_train=2, n_test=1, image_size=size, seed=4)
    getattr(synthetic, name)(tmp_path / "port", **kw)
    getattr(jsynthetic, name)(tmp_path / "jax", **kw)
    assert _same_scene(tmp_path / "port", tmp_path / "jax") == 3
    img = read_png(tmp_path / "port" / "train" / "r_0.png")
    assert img.shape == (size, size, 4)
    assert 0 < (img[:, :, 3] == 255).mean() < 1  # the object and the background
    meta = json.loads((tmp_path / "port" / "transforms_test.json").read_text())
    assert len(meta["frames"]) == 1 and meta["frames"][0]["file_path"] == "./test/r_0"


def test_write_bgra_swaps_to_the_png_order(tmp_path):
    img = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    synthetic.write_bgra(tmp_path / "a.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img[:, :, [2, 1, 0, 3]])
    synthetic.write_bgra(tmp_path / "b.png", img[:, :, :3])
    np.testing.assert_array_equal(read_png(tmp_path / "b.png"), img[:, :, 2::-1])


def test_forward_facing_generator_matches_jax(tmp_path):
    kw = dict(n_images=5, image_size=32, seed=1)
    llff.generate_forward_facing_dataset(tmp_path / "port", **kw)
    jllff.generate_forward_facing_dataset(tmp_path / "jax", **kw)
    assert _same_scene(tmp_path / "port", tmp_path / "jax") == 5
    # a regeneration with fewer frames leaves none of the old ones
    llff.generate_forward_facing_dataset(tmp_path / "port", n_images=3, image_size=32)
    assert len(list((tmp_path / "port" / "images").iterdir())) == 3
    assert np.load(tmp_path / "port" / "poses_bounds.npy").shape == (3, 17)


def test_cli_writes_the_jax_scene_without_opencv(tmp_path):
    code = ("import runpy, sys; sys.modules['cv2'] = None; "
            "sys.argv = ['synthetic', '--scene', 'drums', '--out', sys.argv[1], "
            "'--train', '2', '--test', '1', '--size', '20', '--seed', '3']; "
            "runpy.run_module('neddf_tpu_torch.data.synthetic', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "port")], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert "wrote drums scene to" in out.stdout
    assert "cv2" not in out.stderr
    jsynthetic.generate_drums_dataset(tmp_path / "jax", n_train=2, n_test=1, image_size=20,
                                      seed=3)
    assert _same_scene(tmp_path / "port", tmp_path / "jax") == 3
