"""Pretrained-CNN feature backbones of the perceptual metrics, eval mode.

Counterpart of ``hrviton_tpu/models/backbones.py``:

  * ``Vgg19Features``: the 5-slice VGG19 extractor of VGGLoss (reference
    networks.py:201-231): relu1_1, relu2_1, relu3_1, relu4_1, relu5_1;
  * ``Vgg16Features``, ``SqueezeNetFeatures`` (SqueezeNet 1.1) and
    ``AlexNetFeatures``: the LPIPS slicings (reference
    eval_models/pretrained_networks.py).

Submodule names follow the JAX parameter tree; weights come from the
torchvision checkpoints through ``train/checkpoint.py``'s converters and
``convert.load_jax_variables``, or are random (``init_weights``, kaiming
normal) in tests. Inputs and taps are NHWC; the convs run on channels_last
NCHW inside, in f32 without TF32 (``nn/layers.py:conv_forward``). Max pools
are unpadded, in floor mode, as ``flax.linen.max_pool`` gives them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import Conv2d

__all__ = ["Vgg19Features", "Vgg16Features", "SqueezeNetFeatures",
           "AlexNetFeatures", "to_nchw", "to_nhwc"]

_CL = torch.channels_last


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> a channels_last NCHW tensor (a view when x is contiguous)."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=_CL)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _maxpool(x, k=2, s=2):
    return F.max_pool2d(x, k, s)


def _maxpool3(x):
    return F.max_pool2d(x, 3, 2)


class _Features(nn.Module):
    """A stack of named convs; ``_convs`` lists (name, cin, cout, k, stride,
    padding) in order."""

    _convs = ()

    def __init__(self, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        for name, cin, cout, k, s, p in self._convs:
            self.add_module(name, Conv2d(cin, cout, k, stride=s, padding=p,
                                         init="kaiming", device=dev,
                                         dtype=dtype))

    def _relu(self, name, h):
        return F.relu(getattr(self, name)(h))


def _vgg_convs(stages):
    out, cin = [], 3
    for i, (cout, n) in enumerate(stages, start=1):
        for j in range(1, n + 1):
            out.append((f"conv{i}_{j}", cin, cout, 3, 1, 1))
            cin = cout
    return tuple(out)


class Vgg19Features(_Features):
    """VGG19 through conv5_1; returns [relu1_1, relu2_1, relu3_1, relu4_1,
    relu5_1]."""

    _convs = _vgg_convs([(64, 2), (128, 2), (256, 4), (512, 4), (512, 1)])

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        h = to_nchw(x)
        for stage, n in ((1, 2), (2, 2), (3, 4), (4, 4), (5, 1)):
            if stage > 1:
                h = _maxpool(h)
            h = self._relu(f"conv{stage}_1", h)
            taps.append(h)
            for j in range(2, n + 1):
                h = self._relu(f"conv{stage}_{j}", h)
        return [to_nhwc(t) for t in taps]


class Vgg16Features(_Features):
    """VGG16 with the LPIPS slicing (pretrained_networks.py:139-180): taps
    relu1_2, relu2_2, relu3_3, relu4_3, relu5_3."""

    _convs = _vgg_convs([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)])

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        h = to_nchw(x)
        for stage, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3)):
            if stage > 1:
                h = _maxpool(h)
            for j in range(1, n + 1):
                h = self._relu(f"conv{stage}_{j}", h)
            taps.append(h)
        return [to_nhwc(t) for t in taps]


class _Fire(nn.Module):
    def __init__(self, cin, squeeze, expand1, expand3, device, dtype):
        super().__init__()
        kw = dict(init="kaiming", device=device, dtype=dtype)
        self.squeeze = Conv2d(cin, squeeze, 1, **kw)
        self.expand1x1 = Conv2d(squeeze, expand1, 1, **kw)
        self.expand3x3 = Conv2d(squeeze, expand3, 3, padding=1, **kw)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], dim=1)


_FIRES = (("fire2", 16, 64), ("fire3", 16, 64), ("fire4", 32, 128),
          ("fire5", 32, 128), ("fire6", 48, 192), ("fire7", 48, 192),
          ("fire8", 64, 256), ("fire9", 64, 256))


class SqueezeNetFeatures(nn.Module):
    """SqueezeNet 1.1 with the LPIPS 7-tap slicing (pretrained_networks.py:
    6-55)."""

    def __init__(self, device="cuda", dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.conv1 = Conv2d(3, 64, 3, stride=2, init="kaiming", device=dev,
                            dtype=dtype)
        cin = 64
        for name, sq, ex in _FIRES:
            self.add_module(name, _Fire(cin, sq, ex, ex, dev, dtype))
            cin = 2 * ex

    def forward(self, x) -> List[torch.Tensor]:
        h = F.relu(self.conv1(to_nchw(x)))
        taps = [h]
        h = _maxpool3(h)
        h = self.fire3(self.fire2(h))
        taps.append(h)
        h = _maxpool3(h)
        h = self.fire5(self.fire4(h))
        taps.append(h)
        h = _maxpool3(h)
        for name in ("fire6", "fire7", "fire8", "fire9"):
            h = getattr(self, name)(h)
            taps.append(h)
        return [to_nhwc(t) for t in taps]


class AlexNetFeatures(_Features):
    """AlexNet features; returns [relu1..relu5] per the LPIPS slicing
    (pretrained_networks.py:18-33)."""

    _convs = (("conv1", 3, 64, 11, 4, 2), ("conv2", 64, 192, 5, 1, 2),
              ("conv3", 192, 384, 3, 1, 1), ("conv4", 384, 256, 3, 1, 1),
              ("conv5", 256, 256, 3, 1, 1))

    def forward(self, x) -> List[torch.Tensor]:
        h = self._relu("conv1", to_nchw(x))
        taps = [h]
        h = self._relu("conv2", _maxpool3(h))
        taps.append(h)
        h = self._relu("conv3", _maxpool3(h))
        taps.append(h)
        for name in ("conv4", "conv5"):
            h = self._relu(name, h)
            taps.append(h)
        return [to_nhwc(t) for t in taps]
