"""InceptionV3 classifier of the Inception Score, eval mode.

Counterpart of ``hrviton_tpu/models/inception.py``. The reference computes IS
with ``torchvision.models.inception_v3(pretrained=True,
transform_input=False)`` at 299x299 (reference evaluate.py:43, 75-76); no
torchvision here, so users supply its ``.pth`` and ``convert_inception_v3``
ports it. Module names mirror torchvision's state_dict and the JAX
parameter tree: BasicConv2d = conv (no bias) + BatchNorm (eps 1e-3) + relu;
the auxiliary classifier is left out (unused at eval). Input NHWC in [-1, 1];
output the logits. Every conv and the classifier run in f32 without TF32.
``inception_probs`` is the Inception Score's forward and softmax; on the card
it replays a CUDA graph recorded once per batch signature (``core/graphs.py``),
as the JAX evaluate jits it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.backbones import to_nchw
from hrviton_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Dense

__all__ = ["InceptionV3", "inception_probs", "convert_inception_v3"]


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, *, dev,
                 dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel_size, stride=stride,
                           padding=padding, bias=False, init="kaiming",
                           device=dev, dtype=dtype)
        self.bn = BatchNorm2d(cout, eps=1e-3, device=dev, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3s1(x):
    # torch F.avg_pool2d(x, 3, stride=1, padding=1) counts the pad zeros
    return F.avg_pool2d(x.float(), 3, 1, 1).to(x.dtype)


class _Block(nn.Module):
    """Branches of BasicConv2d: ``convs`` lists (name, cin, cout, kernel,
    stride, padding)."""

    def __init__(self, convs, dev, dtype):
        super().__init__()
        for name, cin, cout, k, s, p in convs:
            self.add_module(name, BasicConv2d(cin, cout, k, s, p, dev=dev,
                                              dtype=dtype))

    def _run(self, x, *names):
        for name in names:
            x = getattr(self, name)(x)
        return x


class InceptionA(_Block):
    def __init__(self, cin, pool_features, dev, dtype):
        super().__init__([
            ("branch1x1", cin, 64, 1, 1, 0),
            ("branch5x5_1", cin, 48, 1, 1, 0),
            ("branch5x5_2", 48, 64, 5, 1, 2),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 1, 1),
            ("branch_pool", cin, pool_features, 1, 1, 0)], dev, dtype)

    def forward(self, x):
        return torch.cat([
            self._run(x, "branch1x1"),
            self._run(x, "branch5x5_1", "branch5x5_2"),
            self._run(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            self._run(_avgpool3s1(x), "branch_pool")], dim=1)


class InceptionB(_Block):
    def __init__(self, cin, dev, dtype):
        super().__init__([
            ("branch3x3", cin, 384, 3, 2, 0),
            ("branch3x3dbl_1", cin, 64, 1, 1, 0),
            ("branch3x3dbl_2", 64, 96, 3, 1, 1),
            ("branch3x3dbl_3", 96, 96, 3, 2, 0)], dev, dtype)

    def forward(self, x):
        return torch.cat([
            self._run(x, "branch3x3"),
            self._run(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            _maxpool3s2(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, cin, c7, dev, dtype):
        super().__init__([
            ("branch1x1", cin, 192, 1, 1, 0),
            ("branch7x7_1", cin, c7, 1, 1, 0),
            ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_1", cin, c7, 1, 1, 0),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
            ("branch_pool", cin, 192, 1, 1, 0)], dev, dtype)

    def forward(self, x):
        return torch.cat([
            self._run(x, "branch1x1"),
            self._run(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
            self._run(x, *(f"branch7x7dbl_{i}" for i in range(1, 6))),
            self._run(_avgpool3s1(x), "branch_pool")], dim=1)


class InceptionD(_Block):
    def __init__(self, cin, dev, dtype):
        super().__init__([
            ("branch3x3_1", cin, 192, 1, 1, 0),
            ("branch3x3_2", 192, 320, 3, 2, 0),
            ("branch7x7x3_1", cin, 192, 1, 1, 0),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
            ("branch7x7x3_4", 192, 192, 3, 2, 0)], dev, dtype)

    def forward(self, x):
        return torch.cat([
            self._run(x, "branch3x3_1", "branch3x3_2"),
            self._run(x, *(f"branch7x7x3_{i}" for i in range(1, 5))),
            _maxpool3s2(x)], dim=1)


class InceptionE(_Block):
    def __init__(self, cin, dev, dtype):
        super().__init__([
            ("branch1x1", cin, 320, 1, 1, 0),
            ("branch3x3_1", cin, 384, 1, 1, 0),
            ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch3x3dbl_1", cin, 448, 1, 1, 0),
            ("branch3x3dbl_2", 448, 384, 3, 1, 1),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
            ("branch_pool", cin, 192, 1, 1, 0)], dev, dtype)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self._run(x, "branch3x3dbl_1", "branch3x3dbl_2")
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avgpool3s1(x))], dim=1)


class InceptionV3(nn.Module):
    """Eval-mode inception_v3 (transform_input=False): NHWC images in
    [-1, 1] (the reference feeds Normalize(0.5, 0.5) tensors) -> logits
    (N, num_classes)."""

    def __init__(self, num_classes: int = 1000, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(dev=dev, dtype=dtype)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2, **kw)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, **kw)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1, **kw)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, **kw)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, **kw)
        self.Mixed_5b = InceptionA(192, 32, dev, dtype)
        self.Mixed_5c = InceptionA(256, 64, dev, dtype)
        self.Mixed_5d = InceptionA(288, 64, dev, dtype)
        self.Mixed_6a = InceptionB(288, dev, dtype)
        self.Mixed_6b = InceptionC(768, 128, dev, dtype)
        self.Mixed_6c = InceptionC(768, 160, dev, dtype)
        self.Mixed_6d = InceptionC(768, 160, dev, dtype)
        self.Mixed_6e = InceptionC(768, 192, dev, dtype)
        self.Mixed_7a = InceptionD(768, dev, dtype)
        self.Mixed_7b = InceptionE(1280, dev, dtype)
        self.Mixed_7c = InceptionE(2048, dev, dtype)
        self.fc = Dense(2048, num_classes, device=dev, dtype=dtype)

    def forward(self, x):
        x = to_nchw(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return self.fc(x.float().mean(dim=(2, 3)).to(x.dtype))


@graphs.captured(weights=lambda model, *_: graphs.module_tensors(model))
def _probs(model, x):
    return torch.softmax(model(x), dim=-1)


@torch.inference_mode()
def inception_probs(model: InceptionV3, x: torch.Tensor) -> torch.Tensor:
    """softmax(model(x)): the class probabilities (N, num_classes) of NHWC
    images in [-1, 1]; replayed on the card (module docstring)."""
    return _probs(model, x)


def convert_inception_v3(sd: Dict[str, np.ndarray]) -> Dict:
    """torchvision inception_v3 state_dict -> the InceptionV3 variable tree
    (the JAX layout, for ``convert.load_jax_variables``)."""
    params: Dict = {}
    stats: Dict = {}

    def setp(root, path, v):
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(v)

    prefixes = sorted({k.rsplit(".conv.weight", 1)[0]
                       for k in sd if k.endswith(".conv.weight")})
    for pre in prefixes:
        if pre.startswith("AuxLogits"):
            continue
        path = tuple(pre.split("."))
        setp(params, (*path, "conv", "conv", "kernel"),
             sd[pre + ".conv.weight"].transpose(2, 3, 1, 0))
        setp(params, (*path, "bn", "scale"), sd[pre + ".bn.weight"])
        setp(params, (*path, "bn", "bias"), sd[pre + ".bn.bias"])
        setp(stats, (*path, "bn", "mean"), sd[pre + ".bn.running_mean"])
        setp(stats, (*path, "bn", "var"), sd[pre + ".bn.running_var"])

    setp(params, ("fc", "kernel"), sd["fc.weight"].T)
    setp(params, ("fc", "bias"), sd["fc.bias"])
    return {"params": params, "batch_stats": stats}
