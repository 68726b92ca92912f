"""GAN objectives, both reference flavours (``hrviton_tpu/losses/gan.py``).

  * ``lsgan_loss``: the condition stage's LSGAN / MSE criterion (reference
    networks.py:258-299), summed over the multiscale output list.
  * ``gan_loss``: the SPADE stage's criterion, modes 'ls' | 'original' |
    'hinge' | 'w' (reference network_generator.py:318-398), averaged over
    the multiscale list.

Both take the discriminators' list-of-lists output (the logits are the last
map of each scale's list) and compute in f32.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["lsgan_loss", "gan_loss"]


def _final_logits(pred):
    """[[...feats..., logits], ...] -> the per-scale logit maps."""
    return [p[-1] if isinstance(p, (list, tuple)) else p for p in pred]


def lsgan_loss(pred: Sequence, target_is_real: bool):
    """Sum over scales of the MSE against a 0 / 1 target (networks.py:289-299)."""
    target = 1.0 if target_is_real else 0.0
    loss = 0.0
    for logits in _final_logits(pred):
        loss = loss + torch.mean((logits.float() - target) ** 2)
    return loss


def gan_loss(pred: Sequence, target_is_real: bool, mode: str = "hinge",
             for_discriminator: bool = True):
    """The multiscale-averaged GAN loss (network_generator.py:357-398)."""
    def one(logits):
        x = logits.float()
        if mode == "original":                      # BCE with logits
            t = 1.0 if target_is_real else 0.0
            return torch.mean(torch.clamp(x, min=0) - x * t
                              + torch.log1p(torch.exp(-x.abs())))
        if mode == "ls":
            t = 1.0 if target_is_real else 0.0
            return torch.mean((x - t) ** 2)
        if mode == "hinge":
            if for_discriminator:
                if target_is_real:
                    return -torch.mean(torch.clamp(x - 1.0, max=0.0))
                return -torch.mean(torch.clamp(-x - 1.0, max=0.0))
            assert target_is_real, "generator hinge loss aims for real"
            return -torch.mean(x)
        if mode == "w":
            return -torch.mean(x) if target_is_real else torch.mean(x)
        raise ValueError(mode)

    logits_list = _final_logits(pred)
    total = 0.0
    for logits in logits_list:
        total = total + one(logits)
    return total / len(logits_list)
