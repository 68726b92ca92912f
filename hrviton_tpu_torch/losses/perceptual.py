"""VGG19 perceptual loss (``hrviton_tpu/losses/perceptual.py``, reference
networks.py:234-251): the L1 distance between VGG19 slice activations of x
and of the detached target y, slice weights [1/32, 1/16, 1/8, 1/4, 1]. The
reference feeds [-1, 1] images directly (no ImageNet renormalization); so
does the port. The backbone is ``models/backbones.py:Vgg19Features``,
frozen; it computes in its input's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hrviton_tpu_torch.models.backbones import Vgg19Features
from hrviton_tpu_torch.nn.layers import init_weights

__all__ = ["VGGLossFn", "make_vgg_loss", "vgg_perceptual_loss", "vgg_features"]

_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def vgg_features(vgg: Vgg19Features, y):
    """The detached VGG19 slice activations of a target image, for
    ``vgg_perceptual_loss(..., y_feats=...)``: one target tower shared by
    several terms."""
    with torch.no_grad():
        return [f.detach() for f in vgg(y.detach())]


def vgg_perceptual_loss(vgg: Vgg19Features, x, y=None,
                        layids: Optional[Sequence[int]] = None,
                        y_feats=None):
    """The loss of x against the target ``y`` (its tower computed here) or
    ``y_feats`` (``vgg_features(vgg, y)``): the same numbers either way."""
    fx = vgg(x)
    fy = vgg_features(vgg, y) if y_feats is None else y_feats
    ids = layids if layids is not None else range(len(fx))
    loss = 0.0
    for i in ids:
        loss = loss + _WEIGHTS[i] * torch.mean(
            (fx[i].float() - fy[i].detach().float()).abs())
    return loss


class VGGLossFn:
    """The VGG perceptual loss closed over a frozen backbone."""

    def __init__(self, vgg: Vgg19Features,
                 layids: Optional[Sequence[int]] = None):
        self.vgg = vgg
        self._layids = layids

    def __call__(self, x, y):
        return vgg_perceptual_loss(self.vgg, x, y, self._layids)


def make_vgg_loss(vgg_variables=None, seed: int = 0, device="cuda") -> VGGLossFn:
    """A VGG loss on ``device``: the backbone from ``vgg_variables`` (a
    variable tree, ``convert.load_jax_variables``), else random from
    ``seed``. Its parameters need no gradient."""
    vgg = Vgg19Features(device=device)
    if vgg_variables is None:
        init_weights(vgg, torch.Generator().manual_seed(seed))
    else:
        from hrviton_tpu_torch.convert import load_jax_variables
        load_jax_variables(vgg, vgg_variables)
    vgg.requires_grad_(False)
    return VGGLossFn(vgg)
