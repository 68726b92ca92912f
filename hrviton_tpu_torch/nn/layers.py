"""Layer library with the JAX package's semantics (``hrviton_tpu/nn/layers.py``).

Modules run on (channels_last) NCHW tensors and hold torch-layout (OIHW)
weights. A module computes in its input's dtype and reads each parameter
through ``core/precision.policy`` where it uses it: under the training
loops' bf16 policy (``precision.param_dtype``) an f32 module computes what
the JAX package computes on a bf16 cast of its variables, and its
gradients come back in f32 through the cast. Statistics stay f32.

Training modes, as in the JAX package:

  * ``BatchNorm2d(x, train=True)`` normalizes with the batch's biased
    two-pass variance and stages the running mean and the *unbiased*
    variance, momentum 0.1; inside ``core/mesh.sharded`` the batch is the
    global one, across the ranks;
  * ``SpectralNorm2d(x, update=True)`` runs one power iteration from the
    stored u in f32 (v <- l2(W^T u), u <- l2(W v), sigma = u . W v) and
    stages the new u and v. The gradient flows through u and v, as in the
    JAX package (``torch.nn.utils.spectral_norm`` computes them without
    gradient).

A staged update is not written into the module's buffers by the forward:
``commit_state(module)`` writes it, ``drop_state(module)`` forgets it. So a
forward that runs again (a block recomputed by ``torch.utils.checkpoint``,
or the second of two discriminator calls that must start from the same u)
reads the same stored state and stages the same values.

Every module takes ``device`` (default 'cuda', which raises without a card)
and ``dtype``. Weights are drawn by ``init_weights`` from an explicit
``torch.Generator``. Every library conv and matmul of an f32 forward runs
with TF32 off (``core/precision.exact``); the training loops run their whole
step (backward included) under ``precision.no_tf32``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.ops import conv3x3 as c3
from hrviton_tpu_torch.ops import s2d
from hrviton_tpu_torch.ops.conv3x3 import activation

__all__ = ["Conv2d", "Dense", "BatchNorm2d", "InstanceNorm2d", "SpectralNorm2d",
           "instance_norm", "activation", "conv_forward", "init_weights",
           "commit_state", "drop_state"]


def conv_forward(x, weight, bias, stride: int = 1, padding: int = 0,
                 pre_act: Optional[str] = None, s2d_domain: bool = False):
    """pre_act -> conv -> bias on an NCHW (channels_last) tensor, ``weight``
    OIHW and already in x's dtype.

    A 3x3 stride-1 pad-1 conv goes to the hand-written kernel whose gate
    admits it (``ops/conv3x3.kernel_for``), with the pre-activation fused;
    every other conv, and every conv no gate admits, is the library's, issued
    with TF32 off when x is float32 (``core/precision.exact``). With
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
    if is_3x3 and c3.taps_wgrad_enabled() and torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad):
        # the same forward, with the im2col-free weight gradient
        return c3.conv3x3_taps(x, weight, b, pre_act)
    with precision.exact(x.dtype):
        return F.conv2d(activation(x, pre_act), weight, b, stride, padding)


def _std(init: str, weight: torch.Tensor) -> float:
    if init == "normal":                       # N(0, 0.02)
        return 0.02
    if init == "xavier":                       # xavier_normal_(gain=0.02)
        o, i, kh, kw = weight.shape
        return 0.02 * (2.0 / ((i + o) * kh * kw)) ** 0.5
    if init == "kaiming":                      # kaiming_normal_(fan_in)
        return (2.0 / weight[0].numel()) ** 0.5
    raise ValueError(init)


class Conv2d(nn.Module):
    """Conv with torch padding/stride semantics and an optional pre-activation
    ('relu' | 'leaky0.2') applied to the input; ``s2d=True`` takes a
    space-to-depth tensor (see ``conv_forward``). ``kernel_size`` and
    ``padding`` are an int or an (h, w) pair."""

    _jax_names = {"kernel": "weight", "bias": "bias"}

    def __init__(self, in_ch: int, out_ch: int, kernel_size,
                 stride: int = 1, padding=0, bias: bool = True,
                 init: str = "normal", device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.stride, self.padding, self.init = stride, padding, init
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else kernel_size)
        self.weight = nn.Parameter(torch.zeros(
            out_ch, in_ch, kh, kw, device=dev, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=dev, dtype=dtype))
                     if bias else None)

    def forward(self, x, pre_act: Optional[str] = None, s2d: bool = False):
        b = None if self.bias is None else precision.policy(self.bias)
        return conv_forward(x, precision.policy(self.weight).to(x.dtype), b,
                            self.stride, self.padding, pre_act, s2d)


class Dense(nn.Module):
    """A fully connected layer (flax ``nn.Dense``): x @ W^T + b on the last
    axis, W held (out, in) as torch holds it."""

    _jax_names = {"kernel": "weight", "bias": "bias"}

    def __init__(self, in_features: int, out_features: int, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.weight = nn.Parameter(torch.zeros(out_features, in_features,
                                               device=dev, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev,
                                             dtype=dtype))

    def forward(self, x):
        with precision.exact(x.dtype):
            return F.linear(x, precision.policy(self.weight).to(x.dtype),
                            precision.policy(self.bias).to(x.dtype))


class BatchNorm2d(nn.Module):
    """torch BatchNorm2d, f32 math. Eval (``train=False``): the running
    statistics. Training: the batch's mean and biased two-pass variance
    normalize; the running mean and unbiased variance are staged with
    momentum 0.1 (``commit_state`` writes them). Inside
    ``core/mesh.sharded`` with several ranks the batch is the global one:
    the sums are all-reduced (gradients flow through the reduction) and
    ``n`` counts every rank's rows. ``affine=False`` has no ``weight`` or
    ``bias`` (the JAX ``affine``)."""

    _jax_names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}

    _MOMENTUM = 0.1

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(features, device=dev,
                                                  dtype=dtype))
            self.bias = nn.Parameter(torch.zeros(features, device=dev,
                                                 dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean",
                             torch.zeros(features, device=dev, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(features, device=dev, dtype=dtype))
        self._pending = None

    @staticmethod
    def _batch_moments(xf):
        """(mean, biased variance, n) over (N, H, W), global across the
        ranks of an active mesh."""
        mesh = mesh_lib.active_mesh()
        if mesh is None:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            return mean, var, xf.shape[0] * xf.shape[2] * xf.shape[3]
        from torch.distributed.nn.functional import all_reduce
        n = xf.shape[0] * xf.shape[2] * xf.shape[3] * mesh.world_size
        mean = all_reduce(xf.sum(dim=(0, 2, 3)), group=mesh.group) / n
        dev2 = (xf - mean.view(1, -1, 1, 1)).square().sum(dim=(0, 2, 3))
        return mean, all_reduce(dev2, group=mesh.group) / n, n

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            mean, var, n = self._batch_moments(xf)
            with torch.no_grad():
                m = self._MOMENTUM
                self._pending = (
                    (1 - m) * self.running_mean.float() + m * mean,
                    (1 - m) * self.running_var.float()
                    + m * var * (n / max(n - 1, 1)))
            y = (xf - mean.view(1, -1, 1, 1)) * torch.rsqrt(
                var.view(1, -1, 1, 1) + self.eps)
        else:
            s = lambda t: t.float().view(1, -1, 1, 1)
            y = (xf - s(self.running_mean)) * torch.rsqrt(
                s(self.running_var) + self.eps)
        if self.weight is not None:
            v = lambda t: precision.policy(t).float().view(1, -1, 1, 1)
            y = y * v(self.weight) + v(self.bias)
        return y.to(x.dtype)

    def _commit(self, pending):
        self.running_mean.copy_(pending[0])
        self.running_var.copy_(pending[1])


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
    """Spectrally normalized conv: W / sigma in the dtype the precision
    policy holds W in, W reshaped to (O, I*kh*kw). Eval: sigma = u . (W v)
    from the stored u/v. ``update=True``: one power iteration from the
    stored u, in f32 (v <- l2(W^T u), u <- l2(W v), sigma = u . W v, the
    gradient flowing through u and v), the new u/v staged for
    ``commit_state``."""

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
        self._pending = None

    def _l2(self, t):
        return t / (torch.linalg.vector_norm(t) + self.eps)

    def normalized_weight(self, dtype, update: bool = False) -> torch.Tensor:
        w = precision.policy(self.weight)
        wm = w.float().reshape(w.shape[0], -1)
        with precision.no_tf32():                # sigma is f32 math always
            if update:
                v = self._l2(self.u.float() @ wm)
                u = self._l2(wm @ v)
                self._pending = (u.detach(), v.detach())
            else:
                u, v = self.u.float(), self.v.float()
            sigma = torch.dot(u, wm @ v)
        return (w / sigma.to(w.dtype)).to(dtype)

    def forward(self, x, pre_act: Optional[str] = None, s2d: bool = False,
                update: bool = False):
        b = None if self.bias is None else precision.policy(self.bias)
        return conv_forward(x, self.normalized_weight(x.dtype, update),
                            b, self.stride, self.padding, pre_act, s2d)

    def _commit(self, pending):
        self.u.copy_(pending[0])
        self.v.copy_(pending[1])


@torch.no_grad()
def commit_state(module: nn.Module) -> None:
    """Write every update staged in ``module`` (BatchNorm running
    statistics, spectral u/v) into its buffers and clear it."""
    for m in module.modules():
        pending = getattr(m, "_pending", None)
        if pending is not None:
            m._commit(pending)
            m._pending = None


def drop_state(module: nn.Module) -> None:
    """Forget every update staged in ``module``."""
    for m in module.modules():
        if getattr(m, "_pending", None) is not None:
            m._pending = None


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation with the JAX package's distributions, drawn on
    the CPU from ``generator`` (so a seed gives the same weights on every
    device): conv kernels N(0, 0.02), xavier-normal(0.02) or kaiming-normal,
    dense kernels lecun-normal, biases 0, BatchNorm scale 1 / shift 0 /
    running stats (0, 1), spectral u ~ N(0, 1) normalized and v =
    normalize(u W)."""
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
        if isinstance(m, Dense):               # lecun normal, bias 0
            m.weight.copy_(normal(m.weight.shape, m.weight.shape[1] ** -0.5))
            m.bias.zero_()
        if isinstance(m, BatchNorm2d):
            if m.weight is not None:
                m.weight.fill_(1.0)
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
