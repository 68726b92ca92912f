"""Segmentation losses and metrics (``hrviton_tpu/losses/seg.py``):

  * ``cross_entropy2d`` with ignore_index 250 (reference utils.py:29-42);
  * ``iou_metric`` over the thresholded softmax (train_condition.py:18-36);
  * ``cal_miou`` over the argmax one-hot, classes 1..8 (utils.py:80-91).
"""

from __future__ import annotations

import torch

from hrviton_tpu_torch.ops.resize import interpolate

__all__ = ["cross_entropy2d", "iou_metric", "cal_miou"]


def cross_entropy2d(logits, target, ignore_index: int = 250):
    """NHWC logits (N, H, W, C), int target (N, Ht, Wt): the mean CE over
    the pixels not ignored, f32. A size mismatch is resized bilinearly with
    align_corners=True (utils.py:34-35)."""
    h, w = logits.shape[1:3]
    th, tw = target.shape[1:3]
    if (h, w) != (th, tw):
        logits = interpolate(logits, size=(th, tw), mode="bilinear",
                             align_corners=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = target != ignore_index
    tsafe = torch.where(valid, target, torch.zeros_like(target)).long()
    nll = -torch.gather(logp, -1, tsafe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def iou_metric(y_pred, y_true, eps: float = 1e-7):
    """The batch mean of the IoU of (pred > 0.5) against binary targets,
    over all channels (train_condition.py:18-36)."""
    pred = (y_pred > 0.5).float()
    true = y_true.float()
    axes = tuple(range(1, pred.dim()))
    inter = (pred * true).sum(dim=axes)
    union = pred.sum(dim=axes) + true.sum(dim=axes)
    return torch.mean((inter + eps) / (union - inter + eps))


def cal_miou(prediction, target, classes=tuple(range(1, 9))):
    """One IoU over the batch and classes 1..8 of the argmax one-hot
    predictions (utils.py:80-91)."""
    label = prediction.argmax(dim=-1)
    onehot = label[..., None] == torch.arange(prediction.shape[-1],
                                              device=prediction.device)
    cls = list(classes)
    p = onehot[..., cls]
    t = target[..., cls] > 0.5
    inter = (p & t).sum()
    union = (p | t).sum()
    return inter / union.clamp(min=1)
