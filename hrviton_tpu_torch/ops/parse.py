"""Parse-label regrouping: the 13 -> 7 SPADE conditioning groups.

Counterpart of the inference half of ``hrviton_tpu/ops/parse.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["LABELS_13_TO_7", "group_index_of_label13", "lut_lookup", "onehot"]

# 7-way SPADE conditioning groups over the 13 labels (test_generator.py:188-196).
LABELS_13_TO_7 = {
    0: [0],                      # background
    1: [2, 4, 7, 8, 9, 10, 11],  # paste
    2: [3],                      # upper
    3: [1],                      # hair
    4: [5],                      # left_arm
    5: [6],                      # right_arm
    6: [12],                     # noise
}


@functools.lru_cache(maxsize=None)
def group_index_of_label13() -> np.ndarray:
    """Lookup table: 13-label id -> 7-group id."""
    table = np.zeros((13,), dtype=np.int32)
    for dst, srcs in LABELS_13_TO_7.items():
        for s in srcs:
            table[s] = dst
    return table


def lut_lookup(labels: torch.Tensor, table) -> torch.Tensor:
    """``table[labels]`` as int32."""
    t = torch.as_tensor(np.asarray(table), dtype=torch.int32,
                        device=labels.device)
    return t[labels.long()]


def onehot(labels: torch.Tensor, num_classes: int,
           dtype=torch.float32) -> torch.Tensor:
    """(N, H, W) int labels -> (N, H, W, num_classes) one-hot."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None].long() == classes).to(dtype)
