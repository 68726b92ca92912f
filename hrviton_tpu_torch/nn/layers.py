"""Layer library with the JAX package's semantics (``hrviton_tpu/nn/layers.py``).

Modules run on (channels_last) NCHW tensors and hold torch-layout (OIHW)
weights. Only the eval-mode forward is ported: BatchNorm uses its running
statistics, and SpectralNorm divides by sigma = u . (W v) from its stored
u/v without a power iteration (training waits for the training slice).

Every module takes ``device`` (default 'cuda', which raises without a card)
and ``dtype``. Weights are drawn by ``init_weights`` from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops import conv3x3 as c3
from hrviton_tpu_torch.ops import s2d
from hrviton_tpu_torch.ops.conv3x3 import activation

__all__ = ["Conv2d", "BatchNorm2d", "InstanceNorm2d", "SpectralNorm2d",
           "instance_norm", "activation", "conv_forward", "init_weights"]


def conv_forward(x, weight, bias, stride: int = 1, padding: int = 0,
                 pre_act: Optional[str] = None, s2d_domain: bool = False):
    """pre_act -> conv -> bias on an NCHW (channels_last) tensor, ``weight``
    OIHW and already in x's dtype.

    A 3x3 stride-1 pad-1 conv goes to the hand-written kernel whose gate
    admits it (``ops/conv3x3.kernel_for``), with the pre-activation fused;
    every other conv, and every conv no gate admits, is the library's. With
    ``s2d_domain`` x is a space-to-depth tensor (4 * Cin channels,
    ``ops/s2d.py``) while ``weight`` keeps the plain Cin: the same parameters
    serve both domains."""
    ksize = tuple(weight.shape[-2:])
    is_3x3 = ksize == (3, 3) and stride == 1 and padding == 1
    if s2d_domain:
        xs = activation(x, pre_act).permute(0, 2, 3, 1)
        if is_3x3:
            y = s2d.conv3x3_s2d(xs, weight, bias, x.dtype)
        elif ksize == (1, 1) and stride == 1 and padding == 0:
            y = s2d.conv1x1_s2d(xs, weight, bias, x.dtype)
        else:
            raise NotImplementedError(
                f"s2d conv only for 3x3/s1/p1 and 1x1: {ksize}")
        return y.permute(0, 3, 1, 2)
    if is_3x3:
        xs = x.permute(0, 2, 3, 1)
        run = c3.kernel_for(xs.shape, weight.shape, (1, 1), (1, 1), x.dtype,
                            x.device)
        if run is not None:
            # the kernels read contiguous NHWC: a channels_last tensor is
            # that already, anything else is copied; the result goes back as
            # a channels_last view, so the next library conv does not copy
            return run(xs.contiguous(), weight, bias, pre_act).permute(0, 3, 1, 2)
    b = None if bias is None else bias.to(x.dtype)
    return F.conv2d(activation(x, pre_act), weight, b, stride, padding)


def _std(init: str, weight: torch.Tensor) -> float:
    if init == "normal":                       # N(0, 0.02)
        return 0.02
    if init == "xavier":                       # xavier_normal_(gain=0.02)
        o, i, kh, kw = weight.shape
        return 0.02 * (2.0 / ((i + o) * kh * kw)) ** 0.5
    raise ValueError(init)


class Conv2d(nn.Module):
    """Conv with torch padding/stride semantics and an optional pre-activation
    ('relu' | 'leaky0.2') applied to the input; ``s2d=True`` takes a
    space-to-depth tensor (see ``conv_forward``)."""

    _jax_names = {"kernel": "weight", "bias": "bias"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 init: str = "normal", device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.stride, self.padding, self.init = stride, padding, init
        self.weight = nn.Parameter(torch.zeros(
            out_ch, in_ch, kernel_size, kernel_size, device=dev, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=dev, dtype=dtype))
                     if bias else None)

    def forward(self, x, pre_act: Optional[str] = None, s2d: bool = False):
        return conv_forward(x, self.weight.to(x.dtype), self.bias, self.stride,
                            self.padding, pre_act, s2d)


class BatchNorm2d(nn.Module):
    """torch BatchNorm2d in eval mode: running statistics, f32 math."""

    _jax_names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}

    def __init__(self, features: int, eps: float = 1e-5, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, device=dev, dtype=dtype))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=dev, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(features, device=dev, dtype=dtype))

    def forward(self, x):
        v = lambda t: t.float().view(1, -1, 1, 1)
        y = (x.float() - v(self.running_mean)) * torch.rsqrt(
            v(self.running_var) + self.eps)
        return (y * v(self.weight) + v(self.bias)).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per-sample, per-channel f32 stats."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class InstanceNorm2d(nn.Module):
    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return instance_norm(x, self.eps)


class SpectralNorm2d(nn.Module):
    """Spectrally normalized conv, eval mode: W / sigma, sigma = u . (W v)
    with W reshaped to (O, I*kh*kw) and u/v the stored vectors."""

    _jax_names = {"kernel": "weight", "bias": "bias", "u": "u", "v": "v"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 init: str = "xavier", eps: float = 1e-12, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.stride, self.padding, self.init, self.eps = stride, padding, init, eps
        self.weight = nn.Parameter(torch.zeros(
            out_ch, in_ch, kernel_size, kernel_size, device=dev, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=dev, dtype=dtype))
                     if bias else None)
        self.register_buffer("u", torch.zeros(out_ch, device=dev, dtype=dtype))
        self.register_buffer("v", torch.zeros(
            in_ch * kernel_size * kernel_size, device=dev, dtype=dtype))

    def normalized_weight(self, dtype) -> torch.Tensor:
        w = self.weight
        sigma = torch.dot(self.u.float(),
                          w.float().reshape(w.shape[0], -1) @ self.v.float())
        return (w / sigma.to(w.dtype)).to(dtype)

    def forward(self, x, pre_act: Optional[str] = None, s2d: bool = False):
        return conv_forward(x, self.normalized_weight(x.dtype), self.bias,
                            self.stride, self.padding, pre_act, s2d)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation with the JAX package's distributions, drawn on
    the CPU from ``generator`` (so a seed gives the same weights on every
    device): conv kernels N(0, 0.02) or xavier-normal(0.02), biases 0,
    BatchNorm scale 1 / shift 0 / running stats (0, 1), spectral u ~ N(0, 1)
    normalized and v = normalize(u W)."""
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for m in module.modules():
        if isinstance(m, (Conv2d, SpectralNorm2d)):
            m.weight.copy_(normal(m.weight.shape, _std(m.init, m.weight)))
            if m.bias is not None:
                m.bias.zero_()
        if isinstance(m, SpectralNorm2d):
            w = m.weight.float().cpu().reshape(m.weight.shape[0], -1)
            u = normal(m.u.shape, 1.0)
            u = u / (u.norm() + m.eps)
            v = u @ w
            m.u.copy_(u)
            m.v.copy_(v / (v.norm() + m.eps))
        if isinstance(m, BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
