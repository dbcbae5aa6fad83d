"""Pure-numpy geometry builders for the visualizer GUIs.

Counterpart of ``neddf_tpu/viz/geoms.py``: everything open3d-independent
of the reference's GUI drawing code as testable functions returning plain
arrays: vertices/edges/colors for line sets, vertices/faces/uvs for
textured panels. The open3d shells in ``viz/gui.py`` consume these, so
the GUI surface minus the widget toolkit runs headless.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from numpy import ndarray
from scipy.spatial.transform import Rotation


def camera_transform(camera_param: ndarray) -> ndarray:
    """[6] rotvec+translation -> 4x4 camera-to-world."""
    transform = np.eye(4)
    transform[:3, :3] = Rotation.from_rotvec(camera_param[:3]).as_matrix()
    transform[:3, 3] = camera_param[3:6]
    return transform


def coordinate_grid(grid_range: int = 3) -> Tuple[ndarray, ndarray, ndarray]:
    """XY ground grid (reference draw_coordinate_grid, :258-282)."""
    x_line_vtx = [
        [[-float(grid_range), float(i), 0.0], [float(grid_range), float(i), 0.0]]
        for i in range(-grid_range, grid_range + 1)
    ]
    y_line_vtx = [
        [[float(i), -float(grid_range), 0.0], [float(i), float(grid_range), 0.0]]
        for i in range(-grid_range, grid_range + 1)
    ]
    vtx = np.array(x_line_vtx + y_line_vtx).reshape(-1, 3)
    n = vtx.shape[0] // 2
    edges = np.array([[i * 2, i * 2 + 1] for i in range(n)])
    colors = np.ones((n, 3), np.float32) * 0.5
    return vtx, edges, colors


def bounding_box_lines(
    bb: ndarray,
) -> Tuple[ndarray, ndarray, ndarray]:
    """12-edge wireframe box from [3, 2] axis ranges (reference
    draw_bounding_box, :284-318); amber color."""
    vtx = np.array(
        [
            [bb[0, 0], bb[1, 0], bb[2, 0]],
            [bb[0, 0], bb[1, 0], bb[2, 1]],
            [bb[0, 0], bb[1, 1], bb[2, 1]],
            [bb[0, 0], bb[1, 1], bb[2, 0]],
            [bb[0, 1], bb[1, 0], bb[2, 0]],
            [bb[0, 1], bb[1, 0], bb[2, 1]],
            [bb[0, 1], bb[1, 1], bb[2, 1]],
            [bb[0, 1], bb[1, 1], bb[2, 0]],
        ]
    )
    edges = np.array(
        [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
         [0, 4], [1, 5], [2, 6], [3, 7]]
    )
    colors = np.ones((12, 3), np.float32) * np.array([0.8, 0.6, 0.2])
    return vtx, edges, colors


def camera_pyramid(
    calib: ndarray, width: int, height: int, camera_param: ndarray,
    f: float = 0.5,
) -> Tuple[ndarray, ndarray, ndarray]:
    """Frustum wireframe in WORLD space (reference draw_camera_pyramid,
    :424-469): apex + image plane at depth f, blue-green lines."""
    tx = f * 0.5 * width / calib[0]
    ty = f * 0.5 * height / calib[1]
    vtx = np.array(
        [[0.0, 0.0, 0.0], [-tx, ty, -f], [tx, ty, -f], [tx, -ty, -f],
         [-tx, -ty, -f]]
    )
    edges = np.array(
        [[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]]
    )
    colors = np.zeros((8, 3), np.float32)
    colors[:, 1] = 0.5
    colors[:, 2] = 0.9
    m = camera_transform(camera_param)
    vtx = vtx @ m[:3, :3].T + m[:3, 3]
    return vtx, edges, colors


def image_panel(
    calib: ndarray, width: int, height: int, camera_param: ndarray,
    rgb_bgr: ndarray, f: float = 0.5,
) -> Tuple[ndarray, ndarray, ndarray, ndarray]:
    """Textured dataset-image plane at depth f in WORLD space (reference
    draw_camera_img, :362-408). Returns (vertices, faces, uvs, rgb) with
    rgb flipped to RGB row-up as the reference does."""
    tx = f * 0.5 * width / calib[0]
    ty = f * 0.5 * height / calib[1]
    vtx = np.array(
        [[-tx, ty, -f], [tx, ty, -f], [tx, -ty, -f], [-tx, -ty, -f]]
    )
    faces = np.array([[2, 1, 0], [0, 3, 2]])
    uvs = np.array(
        [[1.0, 1.0], [1.0, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 1.0],
         [1.0, 1.0]]
    )
    rgb = np.flip(np.flipud(rgb_bgr.astype(np.uint8)), axis=2).copy()
    m = camera_transform(camera_param)
    vtx = vtx @ m[:3, :3].T + m[:3, 3]
    return vtx, faces, uvs, rgb


def slice_panel(
    slice_t: float, slice_bgr: ndarray, slice_size: float = 1.1
) -> Tuple[ndarray, ndarray, ndarray, ndarray]:
    """Movable z-plane textured with a field-slice render (reference
    draw_field_slice, :320-360)."""
    vtx = np.array(
        [
            [-slice_size, slice_size, slice_t],
            [slice_size, slice_size, slice_t],
            [slice_size, -slice_size, slice_t],
            [-slice_size, -slice_size, slice_t],
        ]
    )
    faces = np.array([[2, 1, 0], [0, 3, 2]])
    uvs = np.array(
        [[0.0, 1.0], [0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [1.0, 1.0],
         [0.0, 1.0]]
    )
    rgb = np.flip(slice_bgr, axis=2).copy()
    return vtx, faces, uvs, rgb


def visible_range_frustum(
    calib: ndarray, width: int, height: int, camera_param: ndarray,
    d_near: float, d_far: float,
) -> Tuple[ndarray, ndarray, ndarray]:
    """Near/far visible-range frustum wireframe in WORLD space
    (reference draw_visible_range, :471-520)."""
    tx_n = d_near * 0.5 * width / calib[0]
    ty_n = d_near * 0.5 * height / calib[1]
    tx_f = d_far * 0.5 * width / calib[0]
    ty_f = d_far * 0.5 * height / calib[1]
    vtx = np.array(
        [
            [-tx_n, ty_n, -d_near], [tx_n, ty_n, -d_near],
            [tx_n, -ty_n, -d_near], [-tx_n, -ty_n, -d_near],
            [-tx_f, ty_f, -d_far], [tx_f, ty_f, -d_far],
            [tx_f, -ty_f, -d_far], [-tx_f, -ty_f, -d_far],
        ]
    )
    edges = np.array(
        [[0, 1], [1, 2], [2, 3], [3, 0], [4, 5], [5, 6], [6, 7], [7, 4],
         [0, 4], [1, 5], [2, 6], [3, 7]]
    )
    colors = np.zeros((12, 3), np.float32)
    colors[:, 0] = 0.9
    colors[:, 1] = 0.4
    m = camera_transform(camera_param)
    vtx = vtx @ m[:3, :3].T + m[:3, 3]
    return vtx, edges, colors


def dataset_scene_geoms(
    dataset: "object", show_images: bool = True, show_ranges: bool = False,
    d_near: float = 4.0, d_far: float = 6.0,
) -> Dict[str, List]:
    """All per-camera geometry for the dataset view: pyramids, image
    planes, visible ranges (the dataset_visualizer.py scene content)."""
    out: Dict[str, List] = {"pyramids": [], "images": [], "ranges": []}
    w, h = dataset.image_width, dataset.image_height
    for idx in range(len(dataset)):
        data = dataset[idx]
        calib = data["camera_calib_params"]
        cam = data["camera_params"]
        out["pyramids"].append(camera_pyramid(calib, w, h, cam))
        if show_images:
            out["images"].append(
                image_panel(calib, w, h, cam, data["rgb_images"])
            )
        if show_ranges:
            out["ranges"].append(
                visible_range_frustum(calib, w, h, cam, d_near, d_far)
            )
    return out
