"""Discriminator feature-matching loss (``hrviton_tpu/losses/matching.py``,
reference train_generator.py:300-309): for each scale i and each
intermediate map j (the logits excluded), L1(fake, detached real) *
lambda_feat / num_D, in f32."""

from __future__ import annotations

import torch

__all__ = ["feature_matching_loss"]


def feature_matching_loss(pred_fake, pred_real, lambda_feat: float = 10.0):
    num_d = len(pred_fake)
    loss = 0.0
    for i in range(num_d):
        for j in range(len(pred_fake[i]) - 1):
            diff = (pred_fake[i][j].float() - pred_real[i][j].detach().float()).abs()
            loss = loss + torch.mean(diff) * lambda_feat / num_d
    return loss
