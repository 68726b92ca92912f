"""Try-On Condition Generator (tocg): joint appearance flow + segmentation.

Counterpart of ``hrviton_tpu/models/condition.py`` (reference
networks.py:13-159), eval mode. Submodule names follow the JAX parameter
tree, so ``convert.load_jax_variables`` maps one onto the other.

Forward contract (NHWC in and out, like the JAX package):
  input1 (N, H, W, 4) cloth + mask, input2 (N, H, W, 16) parse-agnostic +
  densepose -> (flow_list[5], seg (N, H, W, 13), warped_c (N, H, W, 3),
  warped_cm (N, H, W, 1)); flow_list[i] is (N, H/32*2^i, W/32*2^i, 2) in
  pixel units of its level.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hrviton_tpu_torch.config import TOCGConfig
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.nn.layers import BatchNorm2d, Conv2d, InstanceNorm2d
from hrviton_tpu_torch.ops.grid_sample import make_grid
from hrviton_tpu_torch.ops.resize import interpolate_nchw

__all__ = ["ResBlock", "ConditionGenerator"]

_CL = torch.channels_last


def _sample(x, grid):
    """Border-padded bilinear warp of NCHW x at an NHWC grid, f32 math."""
    y = F.grid_sample(x.float(), grid.float(), mode="bilinear",
                      padding_mode="border", align_corners=False)
    return y.to(x.dtype)


def _flow_grid(flow_nchw, h, w, norm_w, norm_h):
    """Identity grid + flow normalized by (norm_w, norm_h), as (N, H, W, 2)."""
    fl = flow_nchw.float()
    fn = torch.stack([fl[:, 0] / norm_w, fl[:, 1] / norm_h], dim=-1)
    return make_grid(fl.shape[0], h, w, fl.device) + fn


class ResBlock(nn.Module):
    """ResBlock (reference networks.py:171-198): scale conv + 2x(conv-norm)."""

    def __init__(self, in_nc: int, out_nc: int, scale: str = "down",
                 norm: str = "batch", device="cuda", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        use_bias = norm == "instance"
        self.scale = scale
        if scale in ("same", "up"):
            self.scale_conv = Conv2d(in_nc, out_nc, 1, bias=True, **kw)
        elif scale == "down":
            self.scale_conv = Conv2d(in_nc, out_nc, 3, stride=2, padding=1,
                                     bias=use_bias, **kw)
        else:
            raise ValueError(f"bad scale {scale!r}")
        self.conv1 = Conv2d(out_nc, out_nc, 3, padding=1, bias=use_bias, **kw)
        self.conv2 = Conv2d(out_nc, out_nc, 3, padding=1, bias=use_bias, **kw)
        if norm == "batch":
            self.norm1 = BatchNorm2d(out_nc, **kw)
            self.norm2 = BatchNorm2d(out_nc, **kw)
        elif norm == "instance":
            self.norm1, self.norm2 = InstanceNorm2d(), InstanceNorm2d()
        else:
            raise ValueError(norm)

    def forward(self, x):
        if self.scale == "up":
            x = interpolate_nchw(x, scale_factor=2, mode="bilinear")
        residual = self.scale_conv(x)
        y = F.relu(self.norm1(self.conv1(residual)))
        y = self.norm2(self.conv2(y))
        return F.relu(residual + y)


class ConditionGenerator(nn.Module):
    def __init__(self, cfg: TOCGConfig = TOCGConfig(), device="cuda",
                 dtype=torch.float32):
        super().__init__()
        resolve_device(device)
        if cfg.warp_feature not in ("T1", "encoder"):
            raise ValueError(cfg.warp_feature)
        if cfg.out_layer not in ("relu", "conv"):
            raise ValueError(cfg.out_layer)
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        ngf = cfg.ngf
        enc = [ngf, ngf * 2, ngf * 4, ngf * 4, ngf * 4]
        seg = [ngf * 4, ngf * 4, ngf * 2, ngf, ngf]
        for name, cin in (("ClothEncoder", cfg.input1_nc),
                          ("PoseEncoder", cfg.input2_nc)):
            for i, d in enumerate(enc):
                self.add_module(f"{name}_{i}", ResBlock(
                    cin if i == 0 else enc[i - 1], d, "down", cfg.norm, **kw))
        self.flow_conv_0 = Conv2d(ngf * 8, 2, 3, padding=1, **kw)
        self.conv = ResBlock(ngf * 4, ngf * 8, "same", cfg.norm, **kw)
        self.SegDecoder_0 = ResBlock(ngf * 8, seg[0], "up", cfg.norm, **kw)
        for i in range(1, 5):
            j = 4 - i
            self.add_module(f"conv1_{j}", Conv2d(enc[j], ngf * 4, 1, **kw))
            self.add_module(f"conv2_{j}", Conv2d(enc[j], ngf * 4, 1, **kw))
            self.add_module(f"bottleneck_{i - 1}",
                            Conv2d(seg[i - 1], ngf * 4, 3, padding=1, **kw))
            self.add_module(f"flow_conv_{i}",
                            Conv2d(ngf * 8, 2, 3, padding=1, **kw))
            warped = ngf * 4 if cfg.warp_feature == "T1" else enc[j]
            self.add_module(f"SegDecoder_{i}", ResBlock(
                seg[i - 1] + enc[j] + warped, seg[i], "up", cfg.norm, **kw))
        head_in = seg[4] + cfg.input2_nc + cfg.input1_nc
        if cfg.out_layer == "relu":
            self.out_layer = ResBlock(head_in, cfg.output_nc, "same", cfg.norm,
                                      **kw)
        else:
            self.out_layer_res = ResBlock(head_in, ngf, "same", cfg.norm, **kw)
            self.out_layer_conv = Conv2d(ngf, cfg.output_nc, 1, **kw)

    def forward(self, input1, input2):
        """NHWC in, NHWC out (see module docstring)."""
        cfg = self.cfg
        up = cfg.upsample
        i1 = input1.permute(0, 3, 1, 2).contiguous(memory_format=_CL)
        i2 = input2.permute(0, 3, 1, 2).contiguous(memory_format=_CL)
        e1, e2 = [], []
        h1, h2 = i1, i2
        for i in range(5):
            h1 = getattr(self, f"ClothEncoder_{i}")(h1)
            h2 = getattr(self, f"PoseEncoder_{i}")(h2)
            e1.append(h1)
            e2.append(h2)

        flows = []
        for i in range(5):
            feat1, feat2 = e1[4 - i], e2[4 - i]
            ih, iw = feat1.shape[2:]
            if i == 0:
                t1, t2 = feat1, feat2
                flow = self.flow_conv_0(torch.cat([t1, t2], dim=1))
                x = self.SegDecoder_0(self.conv(t2))
            else:
                t1 = interpolate_nchw(t1, scale_factor=2, mode=up) + \
                    getattr(self, f"conv1_{4 - i}")(feat1)
                t2 = interpolate_nchw(t2, scale_factor=2, mode=up) + \
                    getattr(self, f"conv2_{4 - i}")(feat2)
                flow_up = interpolate_nchw(flow, size=(ih, iw), mode=up)
                grid = _flow_grid(flow_up, ih, iw, (iw / 2 - 1.0) / 2.0,
                                  (ih / 2 - 1.0) / 2.0)
                warped_t1 = _sample(t1, grid)
                bott = F.relu(getattr(self, f"bottleneck_{i - 1}")(x))
                delta = getattr(self, f"flow_conv_{i}")(
                    torch.cat([warped_t1, bott], dim=1))
                flow = flow_up + delta
                warped = (warped_t1 if cfg.warp_feature == "T1"
                          else _sample(feat1, grid))
                x = getattr(self, f"SegDecoder_{i}")(
                    torch.cat([x, feat2, warped], dim=1))
            flows.append(flow)

        ih, iw = i1.shape[2:]
        flow_full = interpolate_nchw(flows[-1], size=(ih, iw), mode=up)
        grid = _flow_grid(flow_full, ih, iw, (iw / 2 - 1.0) / 2.0,
                          (ih / 2 - 1.0) / 2.0)
        warped_input1 = _sample(i1, grid)
        head_in = torch.cat([x, i2, warped_input1], dim=1)
        if cfg.out_layer == "relu":
            seg = self.out_layer(head_in)
        else:
            seg = self.out_layer_conv(self.out_layer_res(head_in))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return ([nhwc(f) for f in flows], nhwc(seg),
                nhwc(warped_input1[:, :-1]), nhwc(warped_input1[:, -1:]))
