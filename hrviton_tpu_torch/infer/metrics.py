"""Offline evaluation metrics: the port's copy of ``hrviton_tpu/infer/metrics.py``
(reference evaluate.py:28-112), host numpy and scipy.

  * ``ssim_gray``: grayscale structural similarity, gaussian_weights=True,
    use_sample_covariance=False, data_range=255 (skimage's semantics, on
    scipy);
  * ``mse``: mean squared error on [0, 1] images;
  * ``inception_score``: from an (N, C) softmax matrix; the classifier is the
    caller's (``models/inception.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

__all__ = ["ssim_gray", "mse", "inception_score"]


def ssim_gray(a: np.ndarray, b: np.ndarray, data_range: float = 255.0,
              sigma: float = 1.5, truncate: float = 3.5) -> float:
    """skimage.structural_similarity(gaussian_weights=True,
    use_sample_covariance=False) on 2-D grayscale arrays."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    filt = lambda x: gaussian_filter(x, sigma, truncate=truncate)

    ux, uy = filt(a), filt(b)
    uxx, uyy, uxy = filt(a * a), filt(b * b), filt(a * b)
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    s = num / den

    r = int(truncate * sigma + 0.5)  # the gaussian's radius: crop the border
    return float(s[r:-r, r:-r].mean())


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """MSE on [0, 1]-scaled images (evaluate.py:78-80 uses ToTensor scaling)."""
    a = a.astype(np.float64) / 255.0
    b = b.astype(np.float64) / 255.0
    return float(np.mean((a - b) ** 2))


def inception_score(preds: np.ndarray, splits: int = 1) -> Tuple[float, float]:
    """IS from (N, C) softmax predictions (evaluate.py:96-106)."""
    n = preds.shape[0]
    scores = []
    for k in range(splits):
        part = preds[k * (n // splits):(k + 1) * (n // splits)]
        py = part.mean(axis=0)
        kl = [float(np.sum(p * (np.log(p + 1e-12) - np.log(py + 1e-12))))
              for p in part]
        scores.append(float(np.exp(np.mean(kl))))
    return float(np.mean(scores)), float(np.std(scores))
