"""Image quality metrics: PSNR and SSIM (numpy + scipy).

A copy of ``neddf_tpu/training/metrics.py``, which this package may not
import. Both reimplement
``skimage.metrics.peak_signal_noise_ratio`` and
``skimage.metrics.structural_similarity`` defaults (uniform 7x7 window,
K1=0.01, K2=0.03, sample covariance, border crop) so printed numbers are
directly comparable with the reference's eval output
(neddf/trainer/base_trainer.py:170-174).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def peak_signal_noise_ratio(
    image_true: np.ndarray, image_test: np.ndarray, data_range: float = 255.0
) -> float:
    a = image_true.astype(np.float64)
    b = image_test.astype(np.float64)
    mse = np.mean(np.square(a - b))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))


def _ssim_single(
    x: np.ndarray, y: np.ndarray, data_range: float, win_size: int
) -> float:
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    ndim = x.ndim
    NP = win_size ** ndim
    cov_norm = NP / (NP - 1)  # sample covariance like skimage

    filt = lambda im: uniform_filter(im, size=win_size)
    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    crop = tuple(slice(pad, dim - pad) for dim in s.shape)
    return float(s[crop].mean())


def structural_similarity(
    im1: np.ndarray,
    im2: np.ndarray,
    channel_axis: int | None = None,
    data_range: float = 255.0,
    win_size: int = 7,
) -> float:
    if channel_axis is not None:
        vals = [
            _ssim_single(
                np.take(im1, c, axis=channel_axis),
                np.take(im2, c, axis=channel_axis),
                data_range,
                win_size,
            )
            for c in range(im1.shape[channel_axis])
        ]
        return float(np.mean(vals))
    return _ssim_single(im1, im2, data_range, win_size)
