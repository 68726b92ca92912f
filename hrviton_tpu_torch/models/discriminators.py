"""The condition stage's multiscale PatchGAN discriminator, eval mode.

Counterpart of ``CondNLayerDiscriminator`` and
``CondMultiscaleDiscriminator`` in ``hrviton_tpu/models/discriminators.py``
(reference networks.py:302-408, define_D at :445-453): pix2pixHD-style, it
judges (input1, input2, segmap) for the condition stage and serves the
discriminator rejection (``infer/rejection.py``). Submodule names follow the
JAX parameter tree (``discriminator_{i}`` / ``layer{n}_conv`` /
``layer{n}_norm``), so ``convert.load_jax_variables`` maps one onto the
other.

Only the forward of the eval mode is ported: BatchNorm uses its running
statistics, the spectral norm its stored u/v, dropout is the identity. The
leaky ReLUs multiply by 0.2 in the tensor's dtype
(``ops/conv3x3.py:activation``), as the JAX package does. The SPADE
discriminator waits for the training slice.

Forward contract: x (N, H, W, input_nc) NHWC; each sub-discriminator gives
a list of NHWC maps, the last its logits (the list holds only them unless
``get_interm_feat``); the multiscale one gives the list of those lists.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from hrviton_tpu_torch.config import CondDiscriminatorConfig
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, InstanceNorm2d,
                                         SpectralNorm2d, activation)
from hrviton_tpu_torch.ops.pool import avg_pool2d_nopad

__all__ = ["CondNLayerDiscriminator", "CondMultiscaleDiscriminator"]

_PADW = 2  # int(ceil((4 - 1) / 2)): torch kw=4 padding (networks.py:358-359)
_CL = torch.channels_last


class CondNLayerDiscriminator(nn.Module):
    """NLayerDiscriminator (reference networks.py:351-408)."""

    def __init__(self, cfg: CondDiscriminatorConfig = CondDiscriminatorConfig(),
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(init="normal", device=dev, dtype=dtype)

        def norm(nc):
            if cfg.norm == "instance":
                return InstanceNorm2d()
            return BatchNorm2d(nc, device=dev, dtype=dtype)

        conv = SpectralNorm2d if cfg.spectral else Conv2d
        self.layer0_conv = Conv2d(cfg.input_nc, cfg.ndf, 4, stride=2,
                                  padding=_PADW, **kw)
        nf = cfg.ndf
        for n in range(1, cfg.n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer{n}_conv", conv(nf_prev, nf, 4, stride=2,
                                                   padding=_PADW, **kw))
            self.add_module(f"layer{n}_norm", norm(nf))
        nf_prev, nf = nf, min(nf * 2, 512)
        n = cfg.n_layers
        self.add_module(f"layer{n}_conv", Conv2d(nf_prev, nf, 4, stride=1,
                                                 padding=_PADW, **kw))
        self.add_module(f"layer{n}_norm", norm(nf))
        self.add_module(f"layer{n + 1}_conv", Conv2d(nf, 1, 4, stride=1,
                                                     padding=_PADW, **kw))

    def forward(self, x) -> List[torch.Tensor]:
        cfg = self.cfg
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=_CL)
        h = activation(self.layer0_conv(h), "leaky0.2")
        feats = [h]
        for n in range(1, cfg.n_layers + 1):
            h = getattr(self, f"layer{n}_conv")(h)
            h = activation(getattr(self, f"layer{n}_norm")(h), "leaky0.2")
            feats.append(h)                    # eval: dropout is the identity
        h = getattr(self, f"layer{cfg.n_layers + 1}_conv")(h)
        if cfg.use_sigmoid:
            h = torch.sigmoid(h)
        feats.append(h)
        return [nhwc(t) for t in feats] if cfg.get_interm_feat else [nhwc(h)]


class CondMultiscaleDiscriminator(nn.Module):
    """MultiscaleDiscriminator (reference networks.py:302-349). Scale
    ordering as the reference's: sub-discriminator ``num_d - 1 - i`` judges
    the input downsampled i times (networks.py:339-348)."""

    def __init__(self, cfg: CondDiscriminatorConfig = CondDiscriminatorConfig(),
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_d):
            self.add_module(f"discriminator_{i}",
                            CondNLayerDiscriminator(cfg, device, dtype))

    def forward(self, x) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        h = avg_pool2d_nopad(x) if cfg.ddownx2 else x
        result = []
        for i in range(cfg.num_d):
            result.append(getattr(self, f"discriminator_{cfg.num_d - 1 - i}")(h))
            if i != cfg.num_d - 1:
                h = avg_pool2d_nopad(h)
        return result
