"""SPADE (ALIAS) image generator: stage 2 of HR-VITON, eval mode.

Counterpart of ``hrviton_tpu/models/spade.py`` (reference
network_generator.py:75-245). Submodule names follow the JAX parameter
tree. Per-norm noise is injected in eval as well; it comes from a noise
source (see ``noise_source``) drawn in the JAX package's order: block by
block, and within a block norm_s, norm_0, norm_1.

Dispatch inside a block follows the JAX package. With ``fused_block``, at
eligible scales (``ops/spade_block.fused_spade_conv_eligible``: the up_3 and
up_4 blocks on a CUDA device, in bf16) each {SPADENorm -> act -> conv} pair
runs as one fused CUDA unit. Otherwise a block in the space-to-depth domain
(``s2d_tail``) runs the ``ops/s2d.py`` formulation; a norm that
``fast_spade`` admits (``ops/spade_fused.fused_spade_eligible``) runs the
fused modulation kernel; and everything else runs the plain modules, whose
3x3 convs go to the ``ops/conv3x3.py`` kernels where ``fast_conv`` or the
small-channel switch admits them. ``SPADEGenerator.forward`` enters
``fast_conv``, ``fast_spade`` and ``merge_gamma_beta`` from its config for the
length of the call and restores them after, so a knob of one generator never
reaches another model.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Union

import torch
import torch.nn as nn

from hrviton_tpu_torch.config import SPADEGenConfig
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import (Conv2d, SpectralNorm2d, conv_forward,
                                         instance_norm)
from hrviton_tpu_torch.ops.conv3x3 import fast_conv
from hrviton_tpu_torch.ops.parse import onehot
from hrviton_tpu_torch.ops.resize import interpolate_nchw
from hrviton_tpu_torch.ops.s2d import (concat_s2d, from_s2d, instance_norm_s2d,
                                       to_s2d, upsample2x_s2d)
from hrviton_tpu_torch.ops.spade_block import (fused_spade_conv_eligible,
                                               spade_conv_unit)
from hrviton_tpu_torch.ops.spade_fused import (fast_spade,
                                               fused_spade_eligible,
                                               fused_spade_modulate)

__all__ = ["SPADENorm", "SPADEResBlock", "SPADEGenerator", "noise_source",
           "enable_merge_gamma_beta", "merge_gamma_beta"]

_NHIDDEN = 128
_CL = torch.channels_last

# Merged gamma+beta modulation conv: one 3x3 conv with the two kernels
# concatenated on the output axis, split after. Exactly equivalent (each
# output channel sees the same taps) and the same parameters either way. Off
# by default (SPADEGenConfig.merge_gamma_beta, or this switch).
_MERGE_GB = False


def enable_merge_gamma_beta(on: bool = True) -> None:
    global _MERGE_GB
    _MERGE_GB = bool(on)


@contextlib.contextmanager
def merge_gamma_beta(on: bool = True):
    global _MERGE_GB
    prev = _MERGE_GB
    _MERGE_GB = bool(on)
    try:
        yield
    finally:
        _MERGE_GB = prev

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


def _nhwc_view(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


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

    def forward(self, x, seg, draw, s2d: bool = False):
        b, c, h, w = x.shape
        if s2d:
            # x and seg are space-to-depth tensors (ops/s2d.py): the same
            # math and parameters. The noise field is drawn at the plain
            # full-res shape, so its values match the plain path's.
            nc = c // 4
            noise2 = to_s2d(draw((b, 2 * h, 2 * w, 1)))
            noise = noise2.repeat_interleave(nc, dim=-1) * self.noise_scale.repeat(4)
            xn = x + _nchw(noise).to(x.dtype)
            normalized = _nchw(instance_norm_s2d(_nhwc_view(xn), nc))
            actv = self.conv_shared(seg, s2d=True)
            gamma = self.conv_gamma(actv, pre_act="relu", s2d=True)
            beta = self.conv_beta(actv, pre_act="relu", s2d=True)
            return normalized * (1.0 + gamma) + beta

        noise = draw((b, h, w, 1))
        if fused_spade_eligible((b, h, w, c), _NHIDDEN, x.dtype, x.device):
            # the fused modulation kernel (ops/spade_fused.py): same math
            # and parameters; conv_shared's output stays pre-relu
            actv = self.conv_shared(seg)
            return _nchw(fused_spade_modulate(
                _nhwc(x), noise, self.noise_scale, _nhwc(actv),
                self.conv_gamma.weight, self.conv_gamma.bias,
                self.conv_beta.weight, self.conv_beta.bias))

        xn = x + (_nchw(noise) * self.noise_scale.view(1, -1, 1, 1)).to(x.dtype)
        normalized = instance_norm(xn)
        actv = self.conv_shared(seg)
        if _MERGE_GB:
            gb = conv_forward(
                actv,
                torch.cat([self.conv_gamma.weight, self.conv_beta.weight]).to(x.dtype),
                torch.cat([self.conv_gamma.bias, self.conv_beta.bias]),
                1, 1, pre_act="relu")
            gamma, beta = gb[:, :c], gb[:, c:]
        else:
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

    def forward(self, x, seg, draw, s2d: bool = False):
        """x: (B, C, H, W); seg: (B, label_nc, h, w) float; draw: noise
        source. With ``s2d`` both arrive as space-to-depth tensors on one
        grid (the caller resizes seg)."""
        if not s2d:
            seg = interpolate_nchw(seg, size=x.shape[2:], mode="nearest")
        if self.fused and not s2d and fused_spade_conv_eligible(
                x.shape[2], x.shape[3], _NHIDDEN, x.dtype, x.device):
            xs = (self._unit(self.norm_s, self.conv_s, x, seg, draw, None)
                  if self.learned_shortcut else x)
            dx = self._unit(self.norm_0, self.conv_0, x, seg, draw, "leaky0.2")
            return self._unit(self.norm_1, self.conv_1, dx, seg, draw,
                              "leaky0.2", residual=xs)
        if self.learned_shortcut:
            xs = self.conv_s(self.norm_s(x, seg, draw, s2d), s2d=s2d)
        else:
            xs = x
        dx = self.conv_0(self.norm_0(x, seg, draw, s2d), pre_act="leaky0.2",
                         s2d=s2d)
        dx = self.conv_1(self.norm_1(dx, seg, draw, s2d), pre_act="leaky0.2",
                         s2d=s2d)
        return xs + dx


class SPADEGenerator(nn.Module):
    def __init__(self, cfg: SPADEGenConfig = SPADEGenConfig(), device="cuda",
                 dtype=torch.float32):
        super().__init__()
        if cfg.num_upsampling_layers not in ("more", "most"):
            raise ValueError(
                "num_upsampling_layers must be 'more' or 'most' ('normal' is "
                "unreachable in the reference)")
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
        # the config's dispatch knobs hold for this call and are restored
        # after it (the ops-level switches stay available to experiments)
        with contextlib.ExitStack() as stack:
            if self.cfg.fast_conv:
                stack.enter_context(fast_conv(True))
            if self.cfg.fast_spade:
                stack.enter_context(fast_spade(True))
            if self.cfg.merge_gamma_beta:
                stack.enter_context(merge_gamma_beta(True))
            return self._forward(x, seg, noise)

    def _forward(self, x, seg, noise: NoiseArg):
        cfg = self.cfg
        nf = cfg.ngf
        draw = noise_source(noise, x.device)
        sh, sw = cfg.latent_hw
        xc = _nchw(x)
        labels = seg if seg.dim() == 3 else None

        def seg_at(th, tw):
            """seg at (th, tw), NCHW one-hot."""
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

        # s2d tail (ops/s2d.py): the two full-res blocks and conv_img of
        # 'most' run in the space-to-depth domain; same parameters
        use_s2d = cfg.s2d_tail and cfg.num_upsampling_layers == "most"
        n_plain = 6 if use_s2d else len(self.block_names)

        # one feature map per block ('more' never reads conv_7's scale)
        features = []
        for i in range(n_plain):
            sample = interpolate_nchw(xc, size=(sh * 2 ** i, sw * 2 ** i),
                                      mode="nearest")
            features.append(getattr(self, f"conv_{i}")(
                sample.contiguous(memory_format=_CL)))

        def up(t):
            return interpolate_nchw(t, scale_factor=2, mode="nearest")

        h = self.head_0(features[0], seg_at(*features[0].shape[2:]), draw)
        for i, name in enumerate(self.block_names[1:n_plain], start=1):
            h = up(h)
            h = torch.cat([h, features[i]], dim=1).contiguous(memory_format=_CL)
            h = getattr(self, name)(h, seg_at(*features[i].shape[2:]), draw)

        if use_s2d:
            # the nearest downscales of the input pyramid are stride-2 slices,
            # the nearest x2 upsample is a channel tile (upsample2x_s2d), and
            # the seg pyramid maps the same way
            fh, fw = x.shape[1], x.shape[2]
            feat6 = self.conv_6(_nchw(to_s2d(x[:, ::2, ::2, :])), s2d=True)
            feat7 = self.conv_7(_nchw(to_s2d(x)), s2d=True)
            seg6 = _nchw(to_s2d(_nhwc_view(seg_at(fh // 2, fw // 2))))
            seg7 = _nchw(to_s2d(_nhwc_view(seg_at(fh, fw))))
            h = upsample2x_s2d(_nhwc_view(h))                 # up to 512x384
            h = concat_s2d([h, _nhwc_view(feat6)], [nf * 2, 16])
            h = self.up_3(_nchw(h), seg6, draw, s2d=True)
            h = upsample2x_s2d(from_s2d(_nhwc_view(h), nf))   # up to 1024x768
            h = concat_s2d([h, _nhwc_view(feat7)], [nf, 16])
            h = self.up_4(_nchw(h), seg7, draw, s2d=True)
            h = self.conv_img(h, pre_act="leaky0.2", s2d=True)
            return torch.tanh(from_s2d(_nhwc_view(h), 3))

        h = self.conv_img(h, pre_act="leaky0.2")
        return torch.tanh(h).permute(0, 2, 3, 1)
