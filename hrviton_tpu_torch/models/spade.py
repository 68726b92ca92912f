"""SPADE (ALIAS) image generator: stage 2 of HR-VITON, eval mode.

Counterpart of ``hrviton_tpu/models/spade.py`` (reference
network_generator.py:75-245). Submodule names follow the JAX parameter
tree. Per-norm noise is injected in eval as well; it comes from a noise
source (see ``noise_source``) drawn in the JAX package's order: block by
block, and within a block norm_s, norm_0, norm_1.

At eligible scales (``ops/spade_block.fused_spade_conv_eligible``: the
up_3 and up_4 blocks on a CUDA device) each {SPADENorm -> act -> conv} pair
runs as one fused CUDA unit; elsewhere the plain modules run.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn as nn

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import Conv2d, SpectralNorm2d, instance_norm
from hrviton_tpu_torch.ops.parse import onehot
from hrviton_tpu_torch.ops.resize import interpolate_nchw
from hrviton_tpu_torch.ops.spade_block import (fused_spade_conv_eligible,
                                               spade_conv_unit)

__all__ = ["SPADENorm", "SPADEResBlock", "SPADEGenerator", "noise_source"]

_NHIDDEN = 128
_CL = torch.channels_last

NoiseArg = Union[torch.Generator, Callable, Sequence[torch.Tensor]]


def noise_source(noise: NoiseArg, device) -> Callable:
    """A callable ``draw(shape) -> float32 tensor`` for (B, H, W, 1) fields.

    ``noise`` is a ``torch.Generator`` (standard normals drawn on
    ``device``), a callable taking the shape, or a sequence of tensors
    consumed in order (e.g. another implementation's draws)."""
    if isinstance(noise, torch.Generator):
        return lambda shape: torch.randn(shape, generator=noise,
                                         device=device, dtype=torch.float32)
    if callable(noise):
        return noise
    it = iter(noise)

    def draw(shape):
        t = torch.as_tensor(next(it), dtype=torch.float32, device=device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise of shape {tuple(t.shape)}, expected {shape}")
        return t
    return draw


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1).contiguous()


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class SPADENorm(nn.Module):
    """SPADENorm 'aliasinstance' (reference network_generator.py:75-122)."""

    _jax_names = {"noise_scale": "noise_scale"}

    def __init__(self, norm_nc: int, label_nc: int,
                 norm_type: str = "aliasinstance", device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if norm_type != "aliasinstance":
            raise NotImplementedError(f"SPADENorm {norm_type!r} is not ported yet")
        dev = resolve_device(device)
        kw = dict(init="xavier", device=dev, dtype=dtype)
        self.noise_scale = nn.Parameter(torch.zeros(norm_nc, device=dev,
                                                    dtype=dtype))
        self.conv_shared = Conv2d(label_nc, _NHIDDEN, 3, padding=1, **kw)
        self.conv_gamma = Conv2d(_NHIDDEN, norm_nc, 3, padding=1, **kw)
        self.conv_beta = Conv2d(_NHIDDEN, norm_nc, 3, padding=1, **kw)

    def forward(self, x, seg, draw):
        b, _, h, w = x.shape
        noise = _nchw(draw((b, h, w, 1)))
        xn = x + (noise * self.noise_scale.view(1, -1, 1, 1)).to(x.dtype)
        normalized = instance_norm(xn)
        actv = self.conv_shared(seg)
        gamma = self.conv_gamma(actv, pre_act="relu")
        beta = self.conv_beta(actv, pre_act="relu")
        return normalized * (1.0 + gamma) + beta


def _conv_weight(conv, dtype):
    if isinstance(conv, SpectralNorm2d):
        return conv.normalized_weight(dtype)
    return conv.weight.to(dtype)


class SPADEResBlock(nn.Module):
    """SPADEResBlock (reference network_generator.py:125-173)."""

    def __init__(self, input_nc: int, output_nc: int,
                 norm_g: str = "spectralaliasinstance", gen_semantic_nc: int = 7,
                 fused: bool = False, device="cuda", dtype=torch.float32):
        super().__init__()
        self.learned_shortcut = input_nc != output_nc
        self.fused = fused
        middle_nc = min(input_nc, output_nc)
        spectral = norm_g.startswith("spectral")
        subnorm = norm_g[len("spectral"):] if spectral else norm_g
        conv = SpectralNorm2d if spectral else Conv2d
        kw = dict(device=device, dtype=dtype)

        def norm(nc):
            return SPADENorm(nc, gen_semantic_nc, subnorm, **kw)

        if self.learned_shortcut:
            self.norm_s = norm(input_nc)
            self.conv_s = conv(input_nc, output_nc, 1, bias=False,
                               init="xavier", **kw)
        self.norm_0 = norm(input_nc)
        self.conv_0 = conv(input_nc, middle_nc, 3, padding=1, init="xavier",
                           **kw)
        self.norm_1 = norm(middle_nc)
        self.conv_1 = conv(middle_nc, output_nc, 3, padding=1, init="xavier",
                           **kw)

    def _unit(self, norm, conv, xin, seg, draw, pre_act, residual=None):
        """One fused {SPADENorm, conv} pair (ops/spade_block.py)."""
        b, _, h, w = xin.shape
        noise = draw((b, h, w, 1))
        actv = norm.conv_shared(seg)                       # pre-relu
        out = spade_conv_unit(
            pre_act, _nhwc(xin), noise, norm.noise_scale, _nhwc(actv),
            norm.conv_gamma.weight, norm.conv_gamma.bias,
            norm.conv_beta.weight, norm.conv_beta.bias,
            _conv_weight(conv, xin.dtype), conv.bias,
            None if residual is None else _nhwc(residual))
        return _nchw(out)

    def forward(self, x, seg, draw):
        """x: (B, C, H, W); seg: (B, label_nc, h, w) float; draw: noise source."""
        seg = interpolate_nchw(seg, size=x.shape[2:], mode="nearest")
        if self.fused and fused_spade_conv_eligible(
                x.shape[2], x.shape[3], _NHIDDEN, x.dtype, x.device):
            xs = (self._unit(self.norm_s, self.conv_s, x, seg, draw, None)
                  if self.learned_shortcut else x)
            dx = self._unit(self.norm_0, self.conv_0, x, seg, draw, "leaky0.2")
            return self._unit(self.norm_1, self.conv_1, dx, seg, draw,
                              "leaky0.2", residual=xs)
        if self.learned_shortcut:
            xs = self.conv_s(self.norm_s(x, seg, draw))
        else:
            xs = x
        dx = self.conv_0(self.norm_0(x, seg, draw), pre_act="leaky0.2")
        dx = self.conv_1(self.norm_1(dx, seg, draw), pre_act="leaky0.2")
        return xs + dx


class SPADEGenerator(nn.Module):
    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig(), device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.num_upsampling_layers not in ("more", "most"):
            raise ValueError(
                "num_upsampling_layers must be 'more' or 'most' ('normal' is "
                "unreachable in the reference)")
        for knob in ("s2d_tail", "fast_conv", "fast_spade", "merge_gamma_beta"):
            if getattr(cfg, knob):
                raise NotImplementedError(f"SPADEGenConfig.{knob} is not ported yet")
        dev = resolve_device(device)
        self.cfg = cfg
        nf = cfg.ngf
        kw = dict(device=dev, dtype=dtype)
        for i in range(8):
            self.add_module(f"conv_{i}", Conv2d(
                cfg.input_nc, nf * 16 if i == 0 else 16, 3, padding=1,
                init="xavier", **kw))
        chans = [("head_0", nf * 16, nf * 16),
                 ("G_middle_0", nf * 16 + 16, nf * 16),
                 ("G_middle_1", nf * 16 + 16, nf * 16),
                 ("up_0", nf * 16 + 16, nf * 8),
                 ("up_1", nf * 8 + 16, nf * 4),
                 ("up_2", nf * 4 + 16, nf * 2),
                 ("up_3", nf * 2 + 16, nf)]
        if cfg.num_upsampling_layers == "most":
            chans.append(("up_4", nf + 16, nf // 2))
        self.block_names = [name for name, _, _ in chans]
        for name, cin, cout in chans:
            self.add_module(name, SPADEResBlock(
                cin, cout, norm_g=cfg.norm_g,
                gen_semantic_nc=cfg.gen_semantic_nc, fused=cfg.fused_block,
                **kw))
        self.conv_img = Conv2d(chans[-1][2], 3, 3, padding=1, init="xavier",
                               **kw)

    def set_fused(self, on: bool) -> None:
        """Route eligible blocks through the fused unit (on) or not."""
        for name in self.block_names:
            getattr(self, name).fused = bool(on)

    def forward(self, x, seg, noise: NoiseArg):
        """x: (N, H, W, input_nc) NHWC; seg: (N, H, W, 7) float one-hot or
        (N, H, W) int labels in [0, 7); noise: see ``noise_source``.
        Returns (N, H, W, 3) in [-1, 1]."""
        cfg = self.cfg
        draw = noise_source(noise, x.device)
        sh, sw = cfg.latent_hw
        xc = _nchw(x)
        labels = seg if seg.dim() == 3 else None

        def seg_for(ref):
            th, tw = ref.shape[2], ref.shape[3]
            if labels is None:
                return interpolate_nchw(_nchw(seg), size=(th, tw),
                                        mode="nearest")
            lh, lw = labels.shape[1], labels.shape[2]
            if lh % th or lw % tw:
                lab = interpolate_nchw(labels[:, None].float(), size=(th, tw),
                                       mode="nearest")[:, 0].long()
            else:
                lab = labels[:, ::lh // th, ::lw // tw]
            return _nchw(onehot(lab, cfg.gen_semantic_nc, dtype=x.dtype))

        # one feature map per block ('more' never reads conv_7's scale)
        features = []
        for i in range(len(self.block_names)):
            sample = interpolate_nchw(xc, size=(sh * 2 ** i, sw * 2 ** i),
                                      mode="nearest")
            features.append(getattr(self, f"conv_{i}")(
                sample.contiguous(memory_format=_CL)))

        def up(t):
            return interpolate_nchw(t, scale_factor=2, mode="nearest")

        h = self.head_0(features[0], seg_for(features[0]), draw)
        for i, name in enumerate(self.block_names[1:], start=1):
            h = up(h)
            h = torch.cat([h, features[i]], dim=1).contiguous(memory_format=_CL)
            h = getattr(self, name)(h, seg_for(features[i]), draw)
        h = self.conv_img(h, pre_act="leaky0.2")
        return torch.tanh(h).permute(0, 2, 3, 1)
