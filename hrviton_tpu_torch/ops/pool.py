"""Pooling with torch semantics: the counterpart of ``hrviton_tpu/ops/pool.py``.

The multiscale discriminators downsample with
``AvgPool2d(3, stride=2, padding=1, count_include_pad=False)`` (reference
networks.py:320, network_generator.py:301-302).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["avg_pool2d_nopad"]


def avg_pool2d_nopad(x: torch.Tensor, ksize: int = 3, stride: int = 2,
                     padding: int = 1) -> torch.Tensor:
    """NHWC average pool, zero-padded, count_include_pad=False, f32 math."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), ksize, stride, padding,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
