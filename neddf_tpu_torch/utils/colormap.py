"""The JET colour map as a numpy lookup table (no OpenCV needed).

Equal to OpenCV's ``cv2.applyColorMap(img, cv2.COLORMAP_JET)``, which the
JAX package uses for its field slices (``render_field_slice``): each
BGR channel is a clipped tent of slope 4 per grey level. OpenCV's table
has one value off its tent, blue 1 (not 2) at level 159, from the
rounding of its float interpolation; it is kept so the images match.
"""
from __future__ import annotations

import numpy as np


def _jet_table() -> np.ndarray:
    i = np.arange(256)
    # (rise offset, fall offset) of blue, green, red: min(4i + a, b - 4i)
    ramps = ((128, 638), (-128, 892), (-382, 1148))
    table = np.stack([np.clip(np.minimum(4 * i + a, b - 4 * i), 0, 255) for a, b in ramps],
                     axis=1)
    table[159, 0] = 1
    return table.astype(np.uint8)


JET_BGR = _jet_table()


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] -> uint8 BGR [H, W, 3] through the JET table."""
    if gray.dtype != np.uint8:
        raise ValueError(f"apply_jet needs uint8, got {gray.dtype}")
    return JET_BGR[gray]
