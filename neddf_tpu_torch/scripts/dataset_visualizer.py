"""Dataset visualizer of the PyTorch port: camera frusta of a dataset.

Usage:
    python -m neddf_tpu_torch.scripts.dataset_visualizer [overrides...] [--gui]

The flags and files of ``neddf_tpu/scripts/dataset_visualizer.py``. The
dataset comes from the repository's ``config/`` with the same overrides
as training (``dataset=bunny_smoke dataset.dataset_dir=data/bunny_smoke``,
or an LLFF capture: ``dataset=llff dataset.dataset_dir=<capture>
dataset.factor=1``; a relative directory as ``scripts/run.py`` takes it)
and ``./dataset_viz/`` gets:

* ``cameras.obj``: a wireframe with one five-point camera pyramid per
  frame and the [-1.1, 1.1]^3 visible-range box;
* ``summary.txt``: frame count, image size, intrinsics and the cameras'
  centre and radius.

``--gui`` opens the Open3D viewer (``viz/gui.py``) where open3d imports;
otherwise it says so, and the headless files above stand.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from neddf_tpu_torch import config as config_lib
from neddf_tpu_torch.scripts.run import dataset_path

_REPO = Path(__file__).resolve().parents[2]


def camera_frustum_lines(
    rotvec: np.ndarray,
    translation: np.ndarray,
    calib: np.ndarray,
    width: int,
    height: int,
    depth: float = 0.3,
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """Five-point camera pyramid (apex and the 4 image corners at
    ``depth``) in world space, in the RUB camera convention."""
    fx, fy, cx, cy = calib[:4]
    corners_px = np.array([[0, 0], [width, 0], [width, height], [0, height]],
                          dtype=np.float64)
    # unproject: RDF pixel frame -> RUB camera frame
    x = (corners_px[:, 0] - cx) / fx
    y = -(corners_px[:, 1] - cy) / fy
    z = -np.ones(4)
    corners = np.stack([x, y, z], axis=1) * depth
    pts_local = np.concatenate([np.zeros((1, 3)), corners], axis=0)
    rot = Rotation.from_rotvec(rotvec).as_matrix()
    pts = pts_local @ rot.T + translation[None, :]
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return pts, edges


def export_wireframe_obj(path: Path, points: np.ndarray, lines: List[Tuple[int, int]]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for p in points:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for a, b in lines:
            f.write(f"l {a + 1} {b + 1}\n")


def main(argv: Optional[List[str]] = None) -> Path:
    argv = sys.argv[1:] if argv is None else list(argv)
    gui = "--gui" in argv
    overrides = [a for a in argv if a != "--gui"]

    cfg = config_lib.compose(_REPO / "config", overrides=overrides)
    cfg["dataset"]["dataset_dir"] = str(dataset_path(cfg["dataset"]["dataset_dir"]))
    dataset = config_lib.instantiate(cfg["dataset"])

    out_dir = Path("dataset_viz")
    out_dir.mkdir(parents=True, exist_ok=True)
    calib = dataset.camera_calib_params
    poses = dataset.camera_params
    w, h = dataset.image_width, dataset.image_height

    all_pts: List[np.ndarray] = []
    all_lines: List[Tuple[int, int]] = []
    for i in range(len(dataset)):
        pts, edges = camera_frustum_lines(poses[i, :3], poses[i, 3:6], calib, w, h)
        base = len(all_pts) * 5
        all_pts.append(pts)
        all_lines.extend((base + a, base + b) for a, b in edges)

    # the visible-range box: the [-1.1, 1.1]^3 scene bounds
    r = 1.1
    base = len(all_pts) * 5
    all_pts.append(np.array(
        [[sx * r, sy * r, sz * r] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]))
    box_edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
                 (0, 4), (1, 5), (2, 6), (3, 7)]
    all_lines.extend((base + a, base + b) for a, b in box_edges)
    export_wireframe_obj(out_dir / "cameras.obj", np.concatenate(all_pts, axis=0), all_lines)

    center = poses[:, 3:6].mean(axis=0)
    radius = np.linalg.norm(poses[:, 3:6] - center[None], axis=1)
    summary = "\n".join([
        f"frames: {len(dataset)}",
        f"image size: {w} x {h}",
        f"calib fx,fy,cx,cy: {np.round(calib[:4], 3).tolist()}",
        f"camera center mean: {np.round(center, 4).tolist()}",
        f"camera radius min/mean/max: "
        f"{radius.min():.4f} / {radius.mean():.4f} / {radius.max():.4f}",
    ])
    (out_dir / "summary.txt").write_text(summary + "\n")
    print(summary)
    print(f"wireframe -> {out_dir / 'cameras.obj'}")

    if gui:
        try:
            import open3d  # noqa: F401
        except ImportError:
            print("open3d is not installed; headless artifacts were written instead")
            return out_dir
        from neddf_tpu_torch.viz.gui import DatasetVisualizerGUI, run_app

        run_app(lambda: DatasetVisualizerGUI(dataset))
    return out_dir


if __name__ == "__main__":
    main()
