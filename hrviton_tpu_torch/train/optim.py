"""Optimizers and learning-rate schedules with the reference's
hyperparameters (``hrviton_tpu/train/optim.py``).

  * Stage 1: Adam(0.5, 0.999), constant 2e-4 for G and D (reference
    train_condition.py:99-100,129-130).
  * Stage 2: Adam(0, 0.9) with TTUR (G 1e-4 / D 4e-4) and a LambdaLR linear
    decay stepped once per 1000 updates (train_generator.py:154-159,596-598).

``adam`` is ``torch.optim.Adam`` with eps 1e-8 outside the square root, as
optax's is: update = -lr * m_hat / (sqrt(v_hat) + eps). With a schedule
the learning rate of update t (counted from 0) is lr * schedule(t), as
``optax.scale_by_schedule`` counts.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

__all__ = ["Adam", "adam", "lambda_decay_schedule"]


class Adam:
    """``torch.optim.Adam`` that sets its learning rate from ``schedule``
    before each update; ``count`` is the number of updates taken."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float,
                 b2: float, schedule: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        self.lr, self.schedule = lr, schedule
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(b1, b2),
                                    eps=1e-8)
        self.count = 0

    def step(self) -> None:
        if self.schedule is not None:
            for group in self.opt.param_groups:
                group["lr"] = self.lr * float(self.schedule(self.count))
        self.opt.step()
        self.count += 1



def adam(params, lr: float, b1: float, b2: float, schedule=None) -> Adam:
    return Adam(params, lr, b1, b2, schedule)


def lambda_decay_schedule(keep_step: int, decay_step: int, load_step: int = 0):
    """The multiplier of update ``count``: LambdaLR(lambda s: 1 - max(0, s *
    1000 + load - keep) / (decay + 1)) stepped once per 1000 updates."""
    def mult(count: int) -> float:
        s = (count // 1000) * 1000
        frac = (s + load_step - keep_step) / float(decay_step + 1)
        return 1.0 - max(frac, 0.0)
    return mult
