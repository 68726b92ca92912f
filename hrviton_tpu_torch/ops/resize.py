"""Image resize with ``torch.nn.functional.interpolate`` semantics.

Counterpart of ``hrviton_tpu/ops/resize.py``: 'bilinear' with align_corners
False or True, and 'nearest' with torch's legacy floor rule
(src = floor(dst * in/out)). The output size is always resolved first and
passed as ``size``, so ``scale_factor`` follows the JAX package's contract
(out = floor(in * factor), sampled at in/out).

Public functions take and return NHWC; the ``*_nchw`` forms are what the
models call on their (channels_last) NCHW tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["interpolate", "resize_flow", "interpolate_nchw"]


def _out_size(h: int, w: int, size=None, scale_factor=None):
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size / scale_factor is required")
        if isinstance(scale_factor, (int, float)):
            scale_factor = (scale_factor, scale_factor)
        size = (int(h * scale_factor[0]), int(w * scale_factor[1]))
    return int(size[0]), int(size[1])


def interpolate_nchw(x: torch.Tensor, size=None, scale_factor=None,
                     mode: str = "bilinear",
                     align_corners: bool = False) -> torch.Tensor:
    """(N, C, H, W) resize; the channels_last memory format is kept."""
    oh, ow = _out_size(x.shape[2], x.shape[3], size, scale_factor)
    if (oh, ow) == tuple(x.shape[2:]):
        return x
    if mode == "nearest":
        if x.shape[2] % oh == 0 and x.shape[3] % ow == 0:
            # integer-ratio downscale: floor(dst * k) is a stride-k slice
            return x[:, :, ::x.shape[2] // oh, ::x.shape[3] // ow]
        return F.interpolate(x, size=(oh, ow), mode="nearest")
    if mode != "bilinear":
        raise ValueError(f"unsupported mode {mode!r}")
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=align_corners)


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """NHWC resize with torch ``F.interpolate`` semantics (see module)."""
    y = interpolate_nchw(x.permute(0, 3, 1, 2), size, scale_factor, mode,
                         align_corners)
    return y.permute(0, 2, 3, 1)


def resize_flow(flow: torch.Tensor, size, mode: str = "bilinear"):
    """Resize a (N, H, W, 2) appearance-flow field."""
    return interpolate(flow, size=size, mode=mode, align_corners=False)
