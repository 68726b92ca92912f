"""Legacy helpers (``hrviton_tpu/utils/legacy.py``, reference
utils.py:9-47,72-91), kept for the reference's API; the port's modern
equivalents are in ``ops/parse.py`` and ``losses/seg.py``."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_clothes_mask", "changearm", "gen_noise", "ndim_tensor2im",
           "pred_to_onehot"]


def get_clothes_mask(label):
    """(..., H, W) int label map -> float mask of the cloth class (3)."""
    return (torch.as_tensor(label) == 3).float()


def changearm(label):
    """Relabel the arm classes (5, 6) to cloth (3) (utils.py:13-19)."""
    label = torch.as_tensor(label)
    arm = (label == 5) | (label == 6)
    return torch.where(arm, torch.full_like(label, 3), label)


def gen_noise(shape, seed: int = 0):
    """Quantized noise as the reference makes it (utils.py:21-27): uint8
    gaussian noise scaled down and floored, from numpy's generator."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 255, shape).clip(0, 255).astype(np.uint8)
    return torch.from_numpy((noise / 255).astype(np.uint8).astype(np.float32))


def ndim_tensor2im(seg_nhwc, batch: int = 0):
    """(N, H, W, C) channel map -> (H, W) argmax uint8 labels (utils.py:44-47)."""
    return torch.as_tensor(seg_nhwc[batch]).argmax(dim=-1).cpu().numpy() \
        .astype(np.uint8)


def pred_to_onehot(prediction):
    """(N, H, W, C) logits -> the one-hot of the argmax (utils.py:72-78)."""
    prediction = torch.as_tensor(prediction)
    c = prediction.shape[-1]
    am = prediction.argmax(dim=-1)
    return (am[..., None] == torch.arange(c, device=am.device)).float()
