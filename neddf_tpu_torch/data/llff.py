"""LLFF forward-facing captures (``poses_bounds.npy`` + ``images/``).

Counterpart of ``neddf_tpu/data/llff.py``. A capture is

    <dir>/poses_bounds.npy   [N, 17] = 3x5 pose with [h, w, focal] + [near, far]
    <dir>/images/            (or images_{factor}/, pre-downsampled)

and becomes this package's cameras ([fx, fy, cx, cy] intrinsics,
[rotvec, translation] RUB camera-to-world poses):

* LLFF's pose columns are [down, right, back]; RUB is [right, up, back]:
  the columns [r, -d, b];
* ``recenter`` moves the world rigidly into the average camera's frame
  (mean position at the origin, mean view direction along -z), which the
  NDC warp (``geometry/camera.py::ndc_rays``) assumes; poses whose mean
  view direction or mean up vector vanishes, or are parallel, raise;
* translations and bounds are scaled so that the mean bound lands at
  ``target_depth``; the scaled bounds are ``near`` / ``far``;
* every ``hold_every``-th image is a test view, the rest train.

Images are BGR like the other datasets (the PNG reader returns RGB; the
channels are flipped here). JPEG frames go through OpenCV, imported when
the first one is read; where it does not import, the load raises. A
frame whose size differs from the first's is box-averaged down to it
(OpenCV's ``INTER_AREA`` at integer ratios, with its rounding); other
ratios raise. There are no masks: ``mask_images`` is all 255.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
from numpy import ndarray
from scipy.spatial.transform import Rotation

from neddf_tpu_torch.data.base import BaseDataset
from neddf_tpu_torch.utils.png import read_png

_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")


def read_bgr(path: Path) -> ndarray:
    """A frame as uint8 BGR[A] (OpenCV's ``IMREAD_UNCHANGED`` order)."""
    if path.suffix.lower() == ".png":
        img = read_png(path)
        if img.ndim != 3 or img.shape[2] < 3:
            raise ValueError(f"{path}: expected an RGB or RGBA image, got shape {img.shape}")
        return img[:, :, [2, 1, 0, *range(3, img.shape[2])]]
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"{path}: reading a JPEG frame needs OpenCV (cv2), which does "
                          "not import here; convert the capture to PNG") from exc
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None or img.ndim != 3 or img.shape[2] < 3:
        raise ValueError(f"{path}: not a readable colour image")
    return img


def area_downsample(img: ndarray, width: int, height: int) -> ndarray:
    """Box mean of uint8 ``img [H, W, C]`` down to ``[height, width, C]``
    where H / height and W / width are integers, rounded as OpenCV's
    ``resize(..., INTER_AREA)`` rounds: 2x2 blocks as (sum + 2) >> 2, other
    blocks as the sum times the f32 reciprocal of their area, to nearest
    even."""
    h, w = img.shape[:2]
    if h % height or w % width or h < height or w < width:
        raise ValueError(f"image of {w}x{h} does not scale to {width}x{height} by an integer "
                         "ratio (only integer downscaling is supported)")
    fy, fx = h // height, w // width
    sums = img.reshape(height, fy, width, fx, -1).astype(np.int64).sum(axis=(1, 3))
    if (fy, fx) == (2, 2):
        return ((sums + 2) >> 2).astype(np.uint8)
    mean = sums.astype(np.float32) * np.float32(1.0 / (fx * fy))
    return np.clip(np.rint(mean), 0, 255).astype(np.uint8)


class LLFFDataset(BaseDataset):
    def __init__(
        self,
        dataset_dir: str,
        data_split: str,
        use_depth: bool = False,
        use_mask: bool = False,
        factor: int = 4,
        hold_every: int = 8,
        target_depth: float = 4.0,
        recenter: bool = False,
    ) -> None:
        self.factor = int(factor)
        self.hold_every = int(hold_every)
        self.target_depth = float(target_depth)
        self.recenter = bool(recenter)
        self.near: float = 0.0
        self.far: float = 0.0
        super().__init__(dataset_dir, data_split, use_depth, use_mask)

    def _image_paths(self) -> List[Path]:
        for name in (f"images_{self.factor}", "images"):
            d = self.dataset_dir / name
            if d.is_dir():
                paths = sorted(p for p in d.iterdir() if p.suffix.lower() in _IMAGE_SUFFIXES)
                if paths:
                    return paths
        raise FileNotFoundError(f"no images/ or images_{self.factor}/ under {self.dataset_dir}")

    def load_data(self) -> None:
        arr = np.load(self.dataset_dir / "poses_bounds.npy")  # [N, 17]
        poses = arr[:, :15].reshape(-1, 3, 5)
        bounds = arr[:, 15:17]  # [N, 2] near, far
        n = poses.shape[0]

        paths = self._image_paths()
        if len(paths) != n:
            raise ValueError(f"{len(paths)} images vs {n} poses in {self.dataset_dir}")

        img0 = read_bgr(paths[0])
        h, w = img0.shape[:2]
        # hwf is stored at the capture's resolution: scale the focal to this one
        _, cap_w, cap_f = poses[0, :, 4]
        focal = float(cap_f) * w / float(cap_w)

        # LLFF [down, right, back] -> RUB [right, up, back]
        r = poses[:, :, 1]
        u = -poses[:, :, 0]
        b = poses[:, :, 2]
        t = poses[:, :, 3]

        if self.recenter:
            r, u, b, t = recenter_poses(r, u, b, t)

        # scene scale: the mean bound at target_depth
        mid = float(np.mean(bounds))
        scale = self.target_depth / max(mid, 1e-8)
        t = t * scale
        bounds = bounds * scale
        self.near = float(bounds.min())
        self.far = float(bounds.max())

        camera_params = np.zeros((n, 6), np.float32)
        for i in range(n):
            rot = np.stack([r[i], u[i], b[i]], axis=1)  # columns
            # re-orthonormalise against capture noise
            uu, _, vv = np.linalg.svd(rot)
            camera_params[i, :3] = Rotation.from_matrix(uu @ vv).as_rotvec()
            camera_params[i, 3:] = t[i]

        test_mask = (np.arange(n) % self.hold_every) == 0
        keep = test_mask if self.data_split == "test" else ~test_mask

        def load_image(path: Path) -> ndarray:
            img = img0 if path == paths[0] else read_bgr(path)
            if img.shape[:2] != (h, w):
                img = area_downsample(img, w, h)
            return img[:, :, :3].astype(np.float32)

        rgb = [load_image(p) for p, k in zip(paths, keep) if k]
        self.camera_calib_params = np.array([focal, focal, 0.5 * w, 0.5 * h], np.float64)
        self.camera_params = camera_params[keep]
        self.rgb_images = np.stack(rgb, 0)
        self.mask_images = 255 * np.ones(self.rgb_images.shape[:3], np.uint8)


def recenter_poses(r: ndarray, u: ndarray, b: ndarray, t: ndarray, eps: float = 1e-6):
    """The RUB columns ``r, u, b`` and positions ``t`` ([N, 3] each) in
    the average camera's frame: orthonormal [right, up, back] from the
    mean back and up columns (right-handed: r = u x b), the mean position
    at the origin."""
    b_mean, u_mean = b.mean(0), u.mean(0)
    r_avg = np.cross(u_mean, b_mean)
    if (np.linalg.norm(b_mean) < eps or np.linalg.norm(u_mean) < eps
            or np.linalg.norm(r_avg) < eps * np.linalg.norm(u_mean) * np.linalg.norm(b_mean)):
        raise ValueError(
            "recenter=true needs cameras that face one way: the mean view direction "
            f"{np.round(-b_mean, 6).tolist()} and the mean up vector "
            f"{np.round(u_mean, 6).tolist()} must be non-zero and not parallel "
            "(this capture is not forward-facing; use recenter=false)")
    b_avg = b_mean / np.linalg.norm(b_mean)
    r_avg = np.cross(u_mean, b_avg)
    r_avg = r_avg / np.linalg.norm(r_avg)
    u_avg = np.cross(b_avg, r_avg)
    rot_avg = np.stack([r_avg, u_avg, b_avg], axis=1)  # columns
    center = t.mean(0)
    return r @ rot_avg, u @ rot_avg, b @ rot_avg, (t - center[None]) @ rot_avg


def generate_forward_facing_dataset(
    out_dir: "str | Path",
    n_images: int = 12,
    image_size: int = 128,
    camera_distance: float = 4.0,
    seed: int = 0,
) -> Path:
    """A synthetic LLFF capture of the machine scene: cameras on a small
    grid facing it from one side, in the raw LLFF convention
    (``poses_bounds.npy`` with [down, right, back] columns and hwf, an
    ``images/`` directory)."""
    from neddf_tpu_torch.data.synthetic import (
        _look_at,
        _machine_scene,
        _render_machine,
        write_bgra,
    )

    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    for stale in (out_dir / "images").glob("img_*.png"):
        stale.unlink()  # a capture regenerated with fewer frames keeps none of the old
    rng = np.random.default_rng(seed)
    focal = 1.2 * image_size
    prims, light = _machine_scene()

    rows = []
    for i in range(n_images):
        # viewpoint jitter around a frontal, elevated base position
        off = rng.uniform(-0.6, 0.6, 2)
        eye = np.array([camera_distance * 0.9, off[0], 1.2 + 0.4 * off[1]], np.float64)
        c2w = _look_at(eye)
        img = _render_machine(prims, light, c2w, image_size, focal)
        write_bgra(out_dir / "images" / f"img_{i:03}.png", img)

        right, up, back = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2]
        llff_rot = np.stack([-up, right, back], axis=1)  # [down, right, back]
        hwf = np.array([image_size, image_size, focal])
        pose = np.concatenate([llff_rot, c2w[:3, 3:4], hwf[:, None]], axis=1)  # [3, 5]
        dist = np.linalg.norm(eye)
        rows.append(np.concatenate([pose.reshape(-1), [dist - 1.4, dist + 1.4]]))

    np.save(out_dir / "poses_bounds.npy", np.stack(rows, 0))
    return out_dir
