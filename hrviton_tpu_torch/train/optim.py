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

A training step is recorded as a CUDA graph on the card (``core/graphs.py``),
so the update is split in three: ``prepare`` writes the learning rate of
update ``count`` before the recorded body, ``update`` is the body's part
(``torch.optim.Adam.step``), ``advance`` counts the update after it. On the
card the optimizer is ``capturable`` (its step counts on the device) and its
learning rate a 0-d device tensor that ``prepare`` fills, so a replay reads
the new rate; on the CPU it is the plain optimizer with a float rate. The
two sum the same terms in another order (the capturable update divides by
-lr / (1 - b1^t) on the device): equal within f32 rounding, not bit for bit.
The moments and step counts exist from construction, so a recording finds
every tensor it writes.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

__all__ = ["Adam", "adam", "lambda_decay_schedule"]


class Adam:
    """``torch.optim.Adam`` that sets its learning rate from ``schedule``
    before each update; ``count`` is the number of updates taken."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, b1: float,
                 b2: float, schedule: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        self.lr, self.schedule = lr, schedule
        dev = self.params[0].device
        self.capturable = dev.type == "cuda"
        rate = (torch.tensor(lr, dtype=torch.float32, device=dev)
                if self.capturable else lr)
        self.opt = torch.optim.Adam(self.params, lr=rate, betas=(b1, b2),
                                    eps=1e-8, capturable=self.capturable)
        # eager steps of a capturable optimizer are the checks' reference
        self.opt._warned_capturable_if_run_uncaptured = True
        for p in self.params:
            self.opt.state[p] = {
                "step": (torch.zeros((), dtype=torch.float32, device=dev)
                         if self.capturable else torch.tensor(0.0)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        self.count = 0

    def state_tensors(self) -> List[torch.Tensor]:
        """What an update writes besides the parameters: the moments and
        the step counts. (The learning rate is read, not written: a new
        rate needs no new recording.)"""
        return [t for p in self.params for t in self.opt.state[p].values()]

    def set_lr(self, value: float) -> None:
        """The learning rate of the next updates (outside a recorded body)."""
        for group in self.opt.param_groups:
            if self.capturable:
                group["lr"].fill_(value)
            else:
                group["lr"] = value

    def prepare(self) -> None:
        if self.schedule is not None:
            self.set_lr(self.lr * float(self.schedule(self.count)))

    def update(self) -> None:
        self.opt.step()

    def advance(self) -> None:
        self.count += 1

    def step(self) -> None:
        self.prepare()
        self.update()
        self.advance()


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
