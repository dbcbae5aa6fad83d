"""The PyTorch port's own PNG, msgpack and YAML readers against the
libraries they stand in for (OpenCV, flax/msgpack, PyYAML). All three
must agree exactly: they decode, nothing is approximated."""
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml
from flax import serialization

from neddf_tpu_torch.utils import yaml_subset
from neddf_tpu_torch.utils.msgpack import load_msgpack, unpackb
from neddf_tpu_torch.utils.png import read_png, write_png

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "pretrained" / "machine_neddf" / "models" / "model_01000.ckpt"


@pytest.mark.parametrize(
    "frame",
    [
        "machine/test/r_0.png",
        "machine/test/r_12.png",
        "machine/train/r_7.png",
        # bunny frames use all five scanline filters, not only Sub
        "bunny_smoke/test/r_0.png",
    ],
)
def test_png_decoder_matches_cv2_bgr(frame):
    path = REPO / "data" / frame
    ours = read_png(path)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)  # BGRA
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours[:, :, [2, 1, 0, 3]], ref)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_roundtrips_through_cv2(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(23, 17, channels), dtype=np.uint8)
    img = img[:, :, 0] if channels == 1 else img
    write_png(tmp_path / "x.png", img)
    back = cv2.imread(str(tmp_path / "x.png"), cv2.IMREAD_UNCHANGED)
    expect = img if channels == 1 else img[:, :, [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(back, expect)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), img)


def _assert_same_tree(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_msgpack_reader_matches_flax_on_checkpoint():
    ref = serialization.msgpack_restore(CKPT.read_bytes())
    _assert_same_tree(ref, load_msgpack(CKPT))


def test_msgpack_reader_scalars_lists_and_dtypes():
    tree = {
        "params": {"layers": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
                              {"w": np.ones((1,), np.float16)}]},
        "iteration": 1234567,
        "neg": -70000,
        "scale": np.float32(0.5),
        "big": np.zeros((300,), np.int64),
        "name": "x" * 40,
    }
    ref = serialization.msgpack_restore(serialization.to_bytes(tree))
    ours = unpackb(serialization.to_bytes(tree))
    assert ours["iteration"] == ref["iteration"] == 1234567
    assert ours["neg"] == -70000 and ours["name"] == "x" * 40
    assert float(ours["scale"]) == 0.5
    _assert_same_tree(ref["params"], ours["params"])
    np.testing.assert_array_equal(ours["big"], ref["big"])


YAML_FILES = sorted(
    str(p.relative_to(REPO))
    for p in list((REPO / "config").rglob("*.yaml"))
    + list((REPO / "pretrained").glob("*/.hydra/*.yaml"))
)


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_subset_matches_pyyaml(rel):
    path = REPO / rel
    assert yaml_subset.load(path) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize(
    "text",
    ["1e-3", "1.0e-3", "-2", "+3", ".5", "true", "on", "Off", "null", "~",
     "'quoted'", '"dq \\" x"', "[1, 2.5, a]", "{a: 1, b: [x, 'y']}", "plain text"],
)
def test_yaml_scalar_resolution_matches_pyyaml(text):
    assert yaml_subset.parse_scalar(text) == yaml.safe_load(text)
