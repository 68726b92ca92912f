"""Discriminator rejection: the offline norm constant and per-sample scores.

Counterpart of ``hrviton_tpu/infer/rejection.py`` (reference
get_norm_const.py:60-132 and test_condition.py:118-127):

  * ``d_logit``: the mean of each scale's final logit map / 2, summed over
    the scales;
  * the norm constant M: the largest odds l / (1 - l) over the train set,
    real and fake segmaps alike;
  * the rejection score of a test sample: (s / (1 - s)) / M.

``d_logit`` runs on the discriminator's device; the rest is f32 numpy on
the host, as the JAX package computes it.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

__all__ = ["d_logit", "odds", "norm_const_from_logits", "rejection_scores"]


def d_logit(pred) -> torch.Tensor:
    """Multiscale D output -> (N,) f32 score (get_norm_const.py:60-64)."""
    score = 0.0
    for scale in pred:
        final = scale[-1] if isinstance(scale, (list, tuple)) else scale
        score = score + final.float().mean(dim=(1, 2, 3)) / 2.0
    return score


def odds(logit):
    return logit / (1.0 - logit)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def norm_const_from_logits(real_logits: Iterable, fake_logits: Iterable) -> float:
    """M = max odds over all real and fake samples (get_norm_const.py:119-132)."""
    vals: List[float] = []
    for arr in list(real_logits) + list(fake_logits):
        vals.extend(odds(_f32(arr)).reshape(-1).tolist())
    return float(sorted(vals)[-1])


def rejection_scores(logits, norm_const: float) -> np.ndarray:
    """(s / (1 - s)) / M per sample, f32 (test_condition.py:123)."""
    return odds(_f32(logits)) / norm_const
