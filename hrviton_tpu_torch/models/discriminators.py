"""The two multiscale PatchGAN discriminators of HR-VITON.

Counterparts of ``hrviton_tpu/models/discriminators.py``:

  * ``CondNLayerDiscriminator`` / ``CondMultiscaleDiscriminator``
    (reference networks.py:302-408, define_D at :445-453): pix2pixHD-style,
    it judges (input1, input2, segmap) for the condition stage and serves
    the discriminator rejection (``infer/rejection.py``);
  * ``SPADENLayerDiscriminator`` / ``SPADEMultiscaleDiscriminator``
    (reference network_generator.py:250-316): it judges (parse, image) for
    the image stage, its intermediate features exposed for feature
    matching. Its middle convs are spectral and bias-free, its instance
    norm affine-free.

Submodule names follow the JAX parameter tree (``discriminator_{i}`` /
``layer{n}_conv`` / ``layer{n}_norm``), so ``convert.load_jax_variables``
maps one onto the other. ``forward(x)`` is the eval mode: BatchNorm uses
its running statistics, the spectral norm its stored u/v, dropout is the
identity. ``train=True`` takes the batch's statistics in BatchNorm (staged,
``nn/layers.commit_state``) and, with ``ddropout``, drops half the features
with a mask drawn from the ``generator`` given (at the global batch's shape
inside ``core/mesh.sharded``, the rank's rows kept); ``update_sn=True`` runs one
power iteration in each spectral conv (staged). The leaky ReLUs multiply by
0.2 in the tensor's dtype (``ops/conv3x3.py:activation``), as the JAX
package does.

Forward contract: x (N, H, W, input_nc) NHWC; each sub-discriminator gives
a list of NHWC maps, the last its logits (the condition one's list holds
only them unless ``get_interm_feat``); the multiscale one gives the list of
those lists.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                      SPADEDiscriminatorConfig)
from hrviton_tpu_torch.core.mesh import draw_rows
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import (BatchNorm2d, Conv2d, InstanceNorm2d,
                                         SpectralNorm2d, activation)
from hrviton_tpu_torch.ops.pool import avg_pool2d_nopad

__all__ = ["CondNLayerDiscriminator", "CondMultiscaleDiscriminator",
           "SPADENLayerDiscriminator", "SPADEMultiscaleDiscriminator"]

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

    def forward(self, x, train: bool = False, update_sn: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        cfg = self.cfg
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=_CL)
        h = activation(self.layer0_conv(h), "leaky0.2")
        feats = [h]
        for n in range(1, cfg.n_layers + 1):
            conv = getattr(self, f"layer{n}_conv")
            h = (conv(h, update=update_sn) if isinstance(conv, SpectralNorm2d)
                 else conv(h))
            norm = getattr(self, f"layer{n}_norm")
            h = norm(h, train=train) if isinstance(norm, BatchNorm2d) else norm(h)
            h = activation(h, "leaky0.2")
            if cfg.ddropout and train and n < cfg.n_layers:
                # at the global batch's shape under a data-parallel mesh
                keep = draw_rows(lambda s, d=h.device: torch.bernoulli(
                    torch.full(s, 0.5, device=d), generator=generator), h.shape)
                h = h * (keep * 2.0).to(h.dtype)
            feats.append(h)
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

    def forward(self, x, train: bool = False, update_sn: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        h = avg_pool2d_nopad(x) if cfg.ddownx2 else x
        result = []
        for i in range(cfg.num_d):
            result.append(getattr(self, f"discriminator_{cfg.num_d - 1 - i}")(
                h, train, update_sn, generator))
            if i != cfg.num_d - 1:
                h = avg_pool2d_nopad(h)
        return result


class SPADENLayerDiscriminator(nn.Module):
    """NLayerDiscriminator (reference network_generator.py:250-288): a
    leaky first conv, ``n_layers_d - 1`` spectral bias-free stride-2 convs
    each with an affine-free instance norm and a leaky ReLU, and a 1-channel
    conv; every map is returned (only the logits with
    ``no_gan_feat_loss``)."""

    def __init__(self, cfg: SPADEDiscriminatorConfig = SPADEDiscriminatorConfig(),
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(init="xavier", device=dev, dtype=dtype)
        self.layer0_conv = Conv2d(cfg.input_nc, cfg.ndf, 4, stride=2,
                                  padding=_PADW, **kw)
        nf = cfg.ndf
        for n in range(1, cfg.n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            self.add_module(f"layer{n}_conv", SpectralNorm2d(
                nf_prev, nf, 4, stride=2, padding=_PADW, bias=False, **kw))
            self.add_module(f"layer{n}_norm", InstanceNorm2d())
        self.add_module(f"layer{cfg.n_layers_d}_conv", Conv2d(
            nf, 1, 4, stride=1, padding=_PADW, **kw))

    def forward(self, x, update_sn: bool = False):
        cfg = self.cfg
        h = x.permute(0, 3, 1, 2).contiguous(memory_format=_CL)
        h = activation(self.layer0_conv(h), "leaky0.2")
        results = [h]
        for n in range(1, cfg.n_layers_d):
            h = getattr(self, f"layer{n}_conv")(h, update=update_sn)
            h = activation(getattr(self, f"layer{n}_norm")(h), "leaky0.2")
            results.append(h)
        results.append(getattr(self, f"layer{cfg.n_layers_d}_conv")(h))
        results = [t.permute(0, 2, 3, 1) for t in results]
        return results[-1] if cfg.no_gan_feat_loss else results


class SPADEMultiscaleDiscriminator(nn.Module):
    """MultiscaleDiscriminator (reference network_generator.py:291-316):
    ``discriminator_0`` judges the full resolution, each next one a further
    average-pool downsample. Returns one list of maps per scale."""

    def __init__(self, cfg: SPADEDiscriminatorConfig = SPADEDiscriminatorConfig(),
                 device="cuda", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_d):
            self.add_module(f"discriminator_{i}",
                            SPADENLayerDiscriminator(cfg, device, dtype))

    def forward(self, x, update_sn: bool = False) -> List[List[torch.Tensor]]:
        cfg = self.cfg
        result, h = [], x
        for i in range(cfg.num_d):
            out = getattr(self, f"discriminator_{i}")(h, update_sn)
            result.append([out] if cfg.no_gan_feat_loss else out)
            if i != cfg.num_d - 1:
                h = avg_pool2d_nopad(h)
        return result
