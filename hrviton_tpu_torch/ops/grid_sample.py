"""Bilinear grid sampling (appearance-flow warping), torch semantics.

Counterpart of ``hrviton_tpu/ops/grid_sample.py``: 'border' and 'zeros'
padding, computed in float32 and returned in the input's dtype. The
identity grid is an inclusive linspace (``make_grid``), while sampling uses
``align_corners=False``: the combination the reference computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["grid_sample", "make_grid", "flow_warp"]


def grid_sample(x: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "border",
                align_corners: bool = False) -> torch.Tensor:
    """x: (N, H, W, C); grid: (N, Ho, Wo, 2) normalized (x, y) in [-1, 1].
    Returns (N, Ho, Wo, C) in x's dtype."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    y = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid.float(),
                      mode="bilinear", padding_mode=padding_mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def make_grid(n: int, h: int, w: int, device="cpu") -> torch.Tensor:
    """Identity sampling grid (N, H, W, 2), linspace endpoints inclusive."""
    gx = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=device)
    gy = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=device)
    return torch.stack([gx[None, None, :].expand(n, h, w),
                        gy[None, :, None].expand(n, h, w)], dim=-1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, norm_w: float,
              norm_h: float, padding_mode: str = "border") -> torch.Tensor:
    """Warp x by a pixel-unit flow (N, H, W, 2) normalized by (norm_w, norm_h)."""
    n, h, w, _ = x.shape
    fn = torch.stack([flow[..., 0] / norm_w, flow[..., 1] / norm_h], dim=-1)
    return grid_sample(x, fn + make_grid(n, h, w, x.device),
                       padding_mode=padding_mode)
