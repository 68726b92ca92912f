"""Total-variation losses on appearance-flow fields
(``hrviton_tpu/losses/tv.py``, reference train_condition.py:187-232): plain
TV over each flow level (mean |dy| + mean |dx|), the last-level-only
variant, and the edge-aware variants that weigh TV down across cloth-mask
edges by exp(-150 |d mask|). Flows are (N, H, W, 2) NHWC."""

from __future__ import annotations

from typing import Sequence

import torch

from hrviton_tpu_torch.ops.resize import interpolate

__all__ = ["tv_loss", "edge_aware_tv_loss", "flow_tv_suite"]


def tv_loss(flow):
    y_tv = torch.mean((flow[:, 1:] - flow[:, :-1]).abs())
    x_tv = torch.mean((flow[:, :, 1:] - flow[:, :, :-1]).abs())
    return y_tv + x_tv


def edge_aware_tv_loss(flow, warped_clothmask):
    """Edge-aware TV at one flow level (train_condition.py:201-226): the
    (N, H, W, 1) cloth mask at the condition resolution is resized
    bilinearly to the flow's and used as the edge map."""
    m = interpolate(warped_clothmask, size=flow.shape[1:3], mode="bilinear")
    y_tv = (flow[:, 1:] - flow[:, :-1]).abs()
    x_tv = (flow[:, :, 1:] - flow[:, :, :-1]).abs()
    mask_y = torch.exp(-150.0 * (m[:, 1:] - m[:, :-1]).abs())
    mask_x = torch.exp(-150.0 * (m[:, :, 1:] - m[:, :, :-1]).abs())
    return torch.mean(y_tv * mask_y) + torch.mean(x_tv * mask_x)


def flow_tv_suite(flow_list: Sequence, warped_clothmask=None,
                  edgeawaretv: str = "no_edge", lasttvonly: bool = False,
                  add_lasttv: bool = False):
    """The TV term of the condition stage (train_condition.py:187-232)."""
    loss = 0.0
    if edgeawaretv == "no_edge":
        flows = flow_list[-1:] if lasttvonly else flow_list
        for f in flows:
            loss = loss + tv_loss(f)
    elif edgeawaretv == "last_only":
        loss = loss + edge_aware_tv_loss(flow_list[-1], warped_clothmask)
    elif edgeawaretv == "weighted":
        for i, f in enumerate(flow_list):
            loss = loss + edge_aware_tv_loss(f, warped_clothmask) / (2 ** (4 - i))
    else:
        raise ValueError(edgeawaretv)
    if edgeawaretv != "no_edge" and add_lasttv:
        loss = loss + tv_loss(flow_list[-1])
    return loss
