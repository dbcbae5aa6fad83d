"""NeRF-synthetic (blender ``transforms_*.json``) dataset.

Counterpart of ``neddf_tpu/data/nerf_synthetic.py``:

* focal = 0.5 * w / tan(0.5 * camera_angle_x); cx, cy = w/2, h/2;
* pose = [rotvec of the 3x3 block, translation] (scipy ``Rotation``);
* images in OpenCV's BGR order (the PNG reader returns RGB, so the
  channels are flipped here), premultiplied as ``alpha/256 * rgb`` with
  the raw alpha as the mask when ``use_mask``.
"""
from __future__ import annotations

import json

import numpy as np
from scipy.spatial.transform import Rotation

from neddf_tpu_torch.data.base import BaseDataset
from neddf_tpu_torch.utils.png import read_png


class NeRFSyntheticDataset(BaseDataset):
    def load_data(self) -> None:
        with open(self.dataset_dir / f"transforms_{self.data_split}.json") as f:
            transform_data = json.load(f)
        frames = transform_data["frames"]

        rgb_images, mask_images, camera_params = [], [], []
        for frame in frames:
            img = read_png(self.dataset_dir / (frame["file_path"] + ".png"))
            channels = (4,) if self.use_mask else (3, 4)
            if img.ndim != 3 or img.shape[2] not in channels:
                raise ValueError(f"{frame['file_path']}: unexpected shape {img.shape}")
            bgr = img[:, :, 2::-1].astype(np.float32)
            if self.use_mask:
                alpha = img[:, :, 3]
                rgb_images.append((1.0 / 256) * alpha[:, :, None].astype(np.float32) * bgr)
                mask_images.append(alpha)
            else:
                rgb_images.append(bgr)
                mask_images.append(np.full(img.shape[:2], 255, np.uint8))
            transform = np.array(frame["transform_matrix"])
            param = np.zeros(6, np.float32)
            param[:3] = Rotation.from_matrix(transform[:3, :3]).as_rotvec()
            param[3:] = transform[:3, 3]
            camera_params.append(param)

        h, w = rgb_images[0].shape[:2]
        focal = 0.5 * w / np.tan(0.5 * float(transform_data["camera_angle_x"]))
        self.camera_calib_params = np.array([focal, focal, 0.5 * w, 0.5 * h])
        self.camera_params = np.stack(camera_params, 0)
        self.rgb_images = np.stack(rgb_images, 0)
        self.mask_images = np.stack(mask_images, 0)
