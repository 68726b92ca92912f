"""LPIPS lin-head training: the counterpart of
``hrviton_tpu/losses/lpips_train.py`` (the reference DistModel's training
path, eval_models/dist_model.py:115-210 and networks_basic.py:114-141):

  * ``Dist2LogitLayer``: 1x1 convs 5 -> 32 -> 32 -> 1 with LeakyReLU(0.2)
    and a sigmoid, fed (d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps))
    (networks_basic.py:114-129);
  * ``bce_ranking_loss``: BCE of that logit against the human preference
    fraction, each log term clamped at -100 as torch's BCELoss clamps it
    (networks_basic.py:131-141, dist_model.py:158-163);
  * ``LPIPSHeadTrainer``: one step is the two LPIPS forwards (ref, p0) and
    (ref, p1) with the heads' dropout on (independent masks from the
    trainer's ``torch.Generator``), Adam(lr, (0.5, 0.999), eps 1e-8) over
    the lin heads and the rank net (the backbone too only with
    ``pnet_tune``; otherwise it has no gradient and no optimizer state),
    then every lin-head kernel clamped at >= 0 (dist_model.py:121-131);
    the accuracy d1_lt_d0 * judge + (1 - d1_lt_d0) * (1 - judge)
    (dist_model.py:169-172) and the linear learning-rate decay
    (dist_model.py:200-208).

Inputs are NHWC in [-1, 1]; judge is the preference fraction in [0, 1] (0:
p0 preferred). The step runs in f32 with TF32 off. On the card it replays a
CUDA graph recorded once per batch signature (``core/graphs.py``; the JAX
step's jit with its state donated): the graph advances the heads, the rank
net, Adam's state and the dropout generator in place, once a call; the
inputs' copies to the card and the two numbers read back are outside it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from hrviton_tpu_torch.convert import export_jax_variables, load_jax_variables
from hrviton_tpu_torch.core import graphs, precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.losses.lpips import LPIPSModel
from hrviton_tpu_torch.nn.layers import Conv2d, activation, init_weights
from hrviton_tpu_torch.train.optim import adam

__all__ = ["Dist2LogitLayer", "bce_ranking_loss", "LPIPSHeadTrainer"]


class Dist2LogitLayer(nn.Module):
    """networks_basic.py:114-129: two distances (N,) -> the predicted
    human judgement (N,). Submodules ``fc0``..``fc2`` as in the JAX tree."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.use_sigmoid = use_sigmoid
        kw = dict(device=dev, dtype=dtype)
        self.fc0 = Conv2d(5, chn_mid, 1, **kw)
        self.fc1 = Conv2d(chn_mid, chn_mid, 1, **kw)
        self.fc2 = Conv2d(chn_mid, 1, 1, **kw)

    def forward(self, d0, d1, eps: float = 0.1):
        d0 = d0.float().reshape(-1, 1, 1, 1)
        d1 = d1.float().reshape(-1, 1, 1, 1)
        x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)],
                      dim=1)
        x = activation(self.fc0(x), "leaky0.2")
        x = activation(self.fc1(x), "leaky0.2")
        x = self.fc2(x)
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x[:, 0, 0, 0]


def bce_ranking_loss(logit, per, eps: float = 1e-12):
    """torch.nn.BCELoss of the rank logit against the preference fraction
    ``per``, each log term clamped at -100 (networks_basic.py:136-141)."""
    logl = torch.clamp(torch.log(logit + eps), min=-100.0)
    log1 = torch.clamp(torch.log(1.0 - logit + eps), min=-100.0)
    return -torch.mean(per * logl + (1.0 - per) * log1)


def _train_step(trainer: "LPIPSHeadTrainer", ref, p0, p1, judge):
    """The recorded step: (loss, acc) as 0-d tensors."""
    with precision.no_tf32():
        d0 = trainer.model(ref, p0, train=True, generator=trainer.dropout)
        d1 = trainer.model(ref, p1, train=True, generator=trainer.dropout)
        loss = bce_ranking_loss(trainer.rank(d0, d1), judge)
        grads = torch.autograd.grad(loss, trainer.params)
        for p, gr in zip(trainer.params, grads):
            p.grad = gr
        trainer.opt.update()
    with torch.no_grad():
        # clamp_weights (dist_model.py:127-131): the lin heads' 1x1
        # kernels, not the rank net's, floor at 0
        for h in trainer.heads:
            h.weight.clamp_(min=0.0)
        d1_lt_d0 = (d1 < d0).float()
        acc = torch.mean(d1_lt_d0 * judge + (1.0 - d1_lt_d0) * (1.0 - judge))
    return loss.detach(), acc


_step = graphs.captured(
    _train_step,
    donated=lambda trainer, *_: graphs.module_tensors(trainer.model, trainer.rank)
    + trainer.opt.state_tensors() + [trainer.dropout])


class LPIPSHeadTrainer:
    """Trains the net-lin calibration on 2AFC triplets (ref, p0, p1,
    judge). ``variables``: an LPIPS variable tree (the JAX layout) to start
    from, else random weights from ``seed``; the dropout masks come from a
    generator seeded with ``seed + 1``."""

    def __init__(self, net: str = "alex", lr: float = 1e-4,
                 beta1: float = 0.5, pnet_tune: bool = False,
                 variables: Optional[Mapping] = None, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = LPIPSModel(net, lpips=True, device=self.device)
        self.rank = Dist2LogitLayer(device=self.device)
        g = torch.Generator().manual_seed(seed)
        init_weights(self.model, g)
        init_weights(self.rank, g)
        if variables is not None:
            load_jax_variables(self.model, variables)
        self.heads = [getattr(self.model, f"lin{i}")
                      for i in range(self.model.n_taps)]
        self.model._backbone().requires_grad_(pnet_tune)
        trainable = (list(self.model.parameters()) if pnet_tune else
                     [h.weight for h in self.heads])
        self.params = trainable + list(self.rank.parameters())
        self.lr = self.old_lr = lr
        self.opt = adam(self.params, lr, beta1, 0.999)
        self.dropout = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _as_tensor(self, a) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32))
        return t.to(self.device, torch.float32)

    def train_step(self, ref, p0, p1, judge) -> Tuple[float, float]:
        """One optimize_parameters() step; returns (loss, acc)."""
        args = map(self._as_tensor, (ref, p0, p1, judge))
        self.opt.prepare()
        loss, acc = _step(self, *args)
        self.opt.advance()
        return float(loss), float(acc)

    def update_learning_rate(self, nepoch_decay: int) -> float:
        """dist_model.py:200-208: the linear decay old_lr - lr / nepoch_decay."""
        self.old_lr = self.old_lr - self.lr / nepoch_decay
        self.opt.set_lr(self.old_lr)
        return self.old_lr

    def trained_variables(self) -> Dict:
        """The LPIPS variable tree with the trained heads (the JAX layout),
        ready for ``LPIPSModel`` / ``make_lpips`` scoring."""
        return export_jax_variables(self.model)
