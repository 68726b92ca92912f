"""Separable Gaussian blur with torchgeometry parity.

Counterpart of ``hrviton_tpu/ops/blur.py``: a normalized 1-D kernel
exp(-x^2 / 2 sigma^2), zero padding, applied per channel along H then W.
Always computed in float32 with TF32 off: the blur feeds the argmax that
makes the parse labels, and lower precision flips labels at region edges.
The two 1-D kernels are copied to a device once (``core/graphs.constant``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs

__all__ = ["gaussian_kernel1d", "gaussian_blur"]


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    if ksize % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, ksize=(15, 15), sigma=(3.0, 3.0)):
    """Depthwise Gaussian blur of an NHWC tensor; returns x's dtype."""
    n, h, w, c = x.shape
    kh, kw = ksize
    sig_y = float(sigma[1] if len(sigma) > 1 else sigma[0])
    sig_x = float(sigma[0])
    ky = graphs.constant(gaussian_kernel1d(kh, sig_y), x.device)
    kx = graphs.constant(gaussian_kernel1d(kw, sig_x), x.device)
    y = x.permute(0, 3, 1, 2).float()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        y = F.conv2d(y, ky.view(1, 1, kh, 1).expand(c, 1, kh, 1),
                     padding=(kh // 2, 0), groups=c)
        y = F.conv2d(y, kx.view(1, 1, 1, kw).expand(c, 1, 1, kw),
                     padding=(0, kw // 2), groups=c)
    return y.permute(0, 2, 3, 1).to(x.dtype)
