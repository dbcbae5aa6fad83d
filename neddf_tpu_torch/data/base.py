"""Dataset base class (host-side numpy).

Counterpart of ``neddf_tpu/data/base.py``.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Dict

import numpy as np
from numpy import ndarray


class BaseDataset(ABC):
    """Posed multi-view image dataset.

    Attributes:
        camera_calib_params: [4] intrinsics [fx, fy, cx, cy].
        camera_params: [N, 6] poses [rotvec(3), translation(3)].
        rgb_images: [N, H, W, 3] float32, BGR, alpha-premultiplied, 0..255.
        mask_images: [N, H, W] uint8.
    """

    def __init__(
        self,
        dataset_dir: str,
        data_split: str,
        use_depth: bool = False,
        use_mask: bool = False,
    ) -> None:
        self.dataset_dir = Path(dataset_dir)
        self.data_split = data_split
        self.use_depth = use_depth
        self.use_mask = use_mask
        self.camera_calib_params: ndarray = np.zeros(4)
        self.camera_params: ndarray = np.zeros((1, 6))
        self.rgb_images: ndarray = np.zeros(0)
        self.mask_images: ndarray = np.zeros(0)
        self.load_data()

    @abstractmethod
    def load_data(self) -> None:
        raise NotImplementedError()

    def __getitem__(self, item: int) -> Dict[str, ndarray]:
        return {
            "camera_calib_params": self.camera_calib_params,
            "camera_params": self.camera_params[item, :],
            "rgb_images": self.rgb_images[item],
            "mask_images": self.mask_images[item],
        }

    def __len__(self) -> int:
        return self.rgb_images.shape[0]

    @property
    def image_width(self) -> int:
        return self.rgb_images.shape[2]

    @property
    def image_height(self) -> int:
        return self.rgb_images.shape[1]
