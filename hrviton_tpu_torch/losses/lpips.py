"""LPIPS perceptual distance, eval mode: the counterpart of
``hrviton_tpu/losses/lpips.py`` (the vendored LPIPS v0.1, reference
eval_models/):

  * net-lin distance with 'alex' | 'vgg16' | 'squeeze' backbones and learned
    1x1 linear heads (networks_basic.py:27-92); 'net' mode (lpips=False)
    averages the normalized feature distances uniformly instead;
  * the L2 and DSSIM "fake nets" (networks_basic.py:123-187);
  * the 2AFC and JND dataset scores (dist_model.py:212-284), host numpy.

Inputs are NHWC in [-1, 1]. Weights load from the JAX variable tree
(``make_lpips`` / ``LPIPSFn``, or ``convert.load_jax_variables``) or from the
published ``.pth`` files through ``train/checkpoint.convert_lpips_alex``;
random weights (``init_weights``) in tests. Every conv runs in f32 without
TF32. Training the heads (``train=True``) waits for the training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.backbones import (AlexNetFeatures,
                                                SqueezeNetFeatures,
                                                Vgg16Features, to_nchw,
                                                to_nhwc)
from hrviton_tpu_torch.nn.layers import Conv2d, init_weights
from hrviton_tpu_torch.ops.resize import interpolate

__all__ = ["LPIPSModel", "LPIPSAlex", "LPIPSFn", "make_lpips",
           "l2_distance", "dssim_distance", "score_2afc", "score_jnd"]

# networks_basic.py:94-102 ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# backbone class and the channels of its taps
_BACKBONES = {
    "alex": (AlexNetFeatures, (64, 192, 384, 256, 256)),
    "vgg16": (Vgg16Features, (64, 128, 256, 512, 512)),
    "squeeze": (SqueezeNetFeatures, (64, 128, 256, 384, 384, 512, 512)),
}


def _normalize_tensor(x, eps: float = 1e-10):
    norm = torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True))
    return x / (norm + eps)


def _scaled(v: torch.Tensor) -> torch.Tensor:
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=v.device)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=v.device)
    return (v.float() - shift) / scale


class LPIPSModel(nn.Module):
    """net-lin (lpips=True) or net (lpips=False) distance: (x, y) NHWC ->
    (N,), or (N, H, W) maps with ``spatial``. The backbone is the attribute
    named ``net`` (or ``backbone_name``), the heads ``lin{i}``, as in the
    JAX parameter tree."""

    def __init__(self, net: str = "alex", lpips: bool = True,
                 spatial: bool = False, device="cuda", dtype=torch.float32,
                 backbone_name: Optional[str] = None):
        super().__init__()
        dev = resolve_device(device)
        backbone_cls, chans = _BACKBONES[net]
        self.backbone_name = backbone_name or net
        self.lpips, self.spatial = lpips, spatial
        self.n_taps = len(chans)
        self.add_module(self.backbone_name, backbone_cls(dev, dtype))
        if lpips:
            for i, c in enumerate(chans):
                self.add_module(f"lin{i}", Conv2d(c, 1, 1, bias=False,
                                                  init="kaiming", device=dev,
                                                  dtype=dtype))

    def _backbone(self) -> nn.Module:
        return getattr(self, self.backbone_name)

    def forward(self, x, y, train: bool = False):
        if train:
            raise NotImplementedError(
                "training the LPIPS heads (dropout) waits for the training "
                "slice")
        fx = self._backbone()(_scaled(x))
        fy = self._backbone()(_scaled(y))
        total = 0.0
        for i in range(self.n_taps):
            diff = (_normalize_tensor(fx[i].float())
                    - _normalize_tensor(fy[i].float())) ** 2
            if self.lpips:
                d = to_nhwc(getattr(self, f"lin{i}")(to_nchw(diff)))
            else:
                d = torch.sum(diff, dim=-1, keepdim=True)
            if self.spatial:
                total = total + interpolate(d, size=tuple(x.shape[1:3]),
                                            mode="bilinear")
            else:
                total = total + d.mean(dim=(1, 2))
        return total[..., 0]


class LPIPSAlex(LPIPSModel):
    """net-lin alex, the configuration the reference uses everywhere
    (train_generator.py:651, evaluate.py:41); its backbone is named
    ``alexnet``, as in the JAX parameter tree."""

    def __init__(self, device="cuda", dtype=torch.float32):
        super().__init__("alex", device=device, dtype=dtype,
                         backbone_name="alexnet")


class LPIPSFn:
    """LPIPS as a callable over frozen weights: ``variables`` (a JAX
    variable tree of numpy arrays) loaded into ``model`` (an ``LPIPSAlex``
    on ``device`` by default); None keeps the model's own weights."""

    def __init__(self, variables: Optional[Mapping], model=None,
                 device="cuda"):
        self.model = (model if model is not None
                      else LPIPSAlex(device=device)).eval()
        if variables is not None:
            load_jax_variables(self.model, variables)

    @torch.inference_mode()
    def __call__(self, x, y):
        return self.model(x, y)


def make_lpips(variables: Optional[Mapping] = None, seed: int = 0,
               device="cuda") -> LPIPSFn:
    """LPIPS alex from ``variables``, or random (kaiming normal from
    ``seed``) without them."""
    model = LPIPSAlex(device=device)
    if variables is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return LPIPSFn(variables, model)


# ------------------------------------------------------- fake-net distances

def l2_distance(x, y):
    """Mean squared difference on [-1,1] images scaled to [0,1]
    (networks_basic.py L2 semantics: mean over CHW of ((a-b)/2)^2)."""
    d = ((x.float() - y.float()) / 2.0) ** 2
    return d.mean(dim=tuple(range(1, d.dim())))


def dssim_distance(x, y):
    """(1 - SSIM) / 2, skimage-default-exact (networks_basic.py:167-174 ->
    eval_models/__init__.py:52-53: compare_ssim(multichannel=True,
    data_range=255) on tensor2im uint8 images).

    skimage defaults: a 7x7 uniform window, sample covariance (N/(N-1)), a
    border crop of (win-1)/2, which makes an unpadded conv exact. Inputs
    are [-1,1] NHWC images; tensor2im's uint8 cast truncates toward zero."""
    a = torch.clamp(torch.floor((x.float() + 1.0) * 127.5), 0.0, 255.0)
    b = torch.clamp(torch.floor((y.float() + 1.0) * 127.5), 0.0, 255.0)
    k = 7
    c = a.shape[-1]
    win = torch.full((c, 1, k, k), 1.0 / (k * k), dtype=torch.float32,
                     device=a.device)

    def filt(v):
        with precision.exact(torch.float32):
            return F.conv2d(v.permute(0, 3, 1, 2), win, groups=c)

    cov_norm = (k * k) / (k * k - 1.0)  # use_sample_covariance=True
    mu_a, mu_b = filt(a), filt(b)
    var_a = cov_norm * (filt(a * a) - mu_a ** 2)
    var_b = cov_norm * (filt(b * b) - mu_b ** 2)
    cov = cov_norm * (filt(a * b) - mu_a * mu_b)
    data_range = 255.0
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / \
        ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    # per-channel mean then channel average == mean over the map
    ssim = ssim_map.mean(dim=tuple(range(1, ssim_map.dim())))
    return (1.0 - ssim) / 2.0


# --------------------------------------------------------- dataset scoring

def score_2afc(d0s: np.ndarray, d1s: np.ndarray, gts: np.ndarray) -> float:
    """Two-alternative forced choice score (dist_model.py:212-244): the
    share of human judgements that agree with the metric's ordering."""
    d0s, d1s, gts = map(np.asarray, (d0s, d1s, gts))
    scores = (d0s < d1s) * (1.0 - gts) + (d1s < d0s) * gts + (d1s == d0s) * 0.5
    return float(np.mean(scores))


def score_jnd(ds: np.ndarray, sames: np.ndarray) -> float:
    """JND score: the area under the precision-recall curve of 'same'
    detection sorted by distance (dist_model.py:247-284 semantics)."""
    ds, sames = np.asarray(ds), np.asarray(sames)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = np.sum(sames_sorted) - tps
    precision_ = tps / np.maximum(tps + fps, 1e-12)
    recall = tps / np.maximum(tps + fns, 1e-12)
    # trapezoid AUC over recall
    rec = np.concatenate([[0.0], recall])
    prec = np.concatenate([[1.0], precision_])
    return float(np.sum((rec[1:] - rec[:-1]) * prec[1:]))
