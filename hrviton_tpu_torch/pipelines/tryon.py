"""End-to-end unpaired try-on: the reference's first entry point.

Counterpart of ``hrviton_tpu/pipelines/tryon.py`` (reference
test_generator.py:90-238):

  downsample -> tocg -> cloth-mask composition -> gaussian blur + argmax ->
  13->7 regroup -> full-res flow warp -> occlusion removal -> SPADE generator

``condition_forward`` and ``tryon_forward`` keep the JAX signatures (NHWC
dicts in, NHWC tensors out). ``TryOnPipeline`` builds both models from their
configs and answers ``pipeline(batch) -> (rgb, ConditionOutputs)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from hrviton_tpu_torch.config import PipelineConfig, SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.condition import ConditionGenerator
from hrviton_tpu_torch.models.spade import NoiseArg, SPADEGenerator
from hrviton_tpu_torch.nn.layers import init_weights
from hrviton_tpu_torch.ops.blur import gaussian_blur
from hrviton_tpu_torch.ops.grid_sample import flow_warp
from hrviton_tpu_torch.ops.parse import group_index_of_label13, lut_lookup, onehot
from hrviton_tpu_torch.ops.resize import interpolate, resize_flow

__all__ = ["ConditionOutputs", "compose_clothmask", "remove_overlap",
           "condition_forward", "tryon_forward", "TryOnPipeline"]


class ConditionOutputs(NamedTuple):
    flow_list: Any
    fake_segmap: torch.Tensor        # composed 13-ch logits at condition res
    warped_cloth_lr: torch.Tensor    # tocg's own full warp at condition res
    warped_clothmask_lr: torch.Tensor
    fake_parse_gauss: torch.Tensor   # blurred 13-ch logits at fine res
    fake_parse: torch.Tensor         # argmax labels (N, H, W)
    parse7: torch.Tensor             # 7-ch SPADE conditioning map at fine res
    parse_labels: torch.Tensor       # 7-way int labels (N, H, W)
    warped_cloth: torch.Tensor       # full-res warped cloth (after occlusion if on)
    warped_clothmask: torch.Tensor


def compose_clothmask(fake_segmap, warped_clothmask, mode: str):
    """Cloth-channel composition (test_generator.py:167-176)."""
    if mode == "no_composition":
        return fake_segmap
    if mode == "detach":
        m = (warped_clothmask > 0.5).to(fake_segmap.dtype)
    elif mode == "warp_grad":
        m = warped_clothmask
    else:
        raise ValueError(mode)
    return torch.cat([fake_segmap[..., :3], fake_segmap[..., 3:4] * m,
                      fake_segmap[..., 4:]], dim=-1)


def remove_overlap(seg_softmax, warped_cm):
    """Occlusion handling (test_generator.py:19-24): subtract the probability
    mass of body parts (channels 1, 2 and 5..12) from the cloth mask."""
    body = seg_softmax[..., 1:3].sum(-1, keepdim=True) + \
        seg_softmax[..., 5:].sum(-1, keepdim=True)
    return warped_cm - body * warped_cm


def condition_forward(tocg_apply: Callable, batch: Dict[str, torch.Tensor],
                      cfg: PipelineConfig, cloth_key: str = "cloth",
                      clothmask_key: str = "cloth_mask") -> ConditionOutputs:
    """Frozen-tocg conditioning at (cond_h, cond_w), lifted to (fine_h, fine_w).

    tocg_apply: fn(input1, input2) -> (flow_list, seg, warped_c, warped_cm).
    batch: NHWC dict with 'cloth', 'cloth_mask', 'parse_agnostic' (13 ch),
    'densepose'.
    """
    ch, cw = cfg.cond_height, cfg.cond_width
    fh, fw = cfg.fine_height, cfg.fine_width

    cloth = batch[cloth_key]
    cm = (batch[clothmask_key] > 0.5).to(cloth.dtype)
    cloth_down = interpolate(cloth, size=(ch, cw), mode="bilinear")
    cm_down = interpolate(cm, size=(ch, cw), mode="nearest")
    parse_agn_down = interpolate(batch["parse_agnostic"], size=(ch, cw),
                                 mode="nearest")
    densepose_down = interpolate(batch["densepose"], size=(ch, cw),
                                 mode="bilinear")
    input1 = torch.cat([cloth_down, cm_down], dim=-1)
    input2 = torch.cat([parse_agn_down, densepose_down], dim=-1)

    flow_list, fake_segmap, warped_c_lr, warped_cm_lr = tocg_apply(input1, input2)
    fake_segmap = compose_clothmask(fake_segmap, warped_cm_lr,
                                    cfg.clothmask_composition)

    seg_full = interpolate(fake_segmap, size=(fh, fw), mode="bilinear")
    fake_parse_gauss = gaussian_blur(seg_full, (15, 15), (3.0, 3.0))
    fake_parse = torch.argmax(fake_parse_gauss, dim=-1)
    glabel = lut_lookup(fake_parse, group_index_of_label13())
    parse7 = onehot(glabel, 7, dtype=cloth.dtype)

    flow_full = resize_flow(flow_list[-1], (fh, fw), mode="bilinear")
    warped = flow_warp(torch.cat([cloth, cm], dim=-1), flow_full,
                       cfg.flow_norm_w, cfg.flow_norm_h)
    warped_cloth = warped[..., :3]
    warped_clothmask = warped[..., 3:]
    if cfg.occlusion:
        warped_clothmask = remove_overlap(
            torch.softmax(fake_parse_gauss, dim=-1), warped_clothmask)
        warped_cloth = warped_cloth * warped_clothmask + (1.0 - warped_clothmask)

    return ConditionOutputs(flow_list, fake_segmap, warped_c_lr, warped_cm_lr,
                            fake_parse_gauss, fake_parse, parse7, glabel,
                            warped_cloth, warped_clothmask)


def tryon_forward(tocg_apply: Callable, generator_apply: Callable,
                  batch: Dict[str, torch.Tensor], cfg: PipelineConfig,
                  cloth_key: str = "cloth", clothmask_key: str = "cloth_mask"):
    """Full unpaired try-on. generator_apply: fn(x9, parse_labels) -> rgb.
    Returns (rgb in [-1, 1] NHWC, ConditionOutputs)."""
    cond = condition_forward(tocg_apply, batch, cfg, cloth_key, clothmask_key)
    gen_in = torch.cat([batch["agnostic"], batch["densepose"],
                        cond.warped_cloth], dim=-1)
    return generator_apply(gen_in, cond.parse_labels), cond


class TryOnPipeline:
    """The unpaired try-on entry point: tocg + SPADE generator, eval mode.

    Built as the inference CLI and the benchmark build it: tocg ngf=96 at the
    condition resolution, SPADE ngf=64 'most' at the fine resolution with the
    fused unit on. Weights are random from ``seed`` until loaded
    (``convert.load_jax_variables`` on ``.tocg`` / ``.generator``). Each call
    draws the SPADE noise from a generator seeded with ``noise_seed``, as the
    JAX CLI uses one fixed noise key. An f32 forward is f32 in every library
    conv and matmul too, as in the JAX package: each is issued with TF32 off
    (``core/precision.exact``) and the caller's settings are restored after
    it. bf16 leaves them as they are.
    """

    def __init__(self, pipeline_cfg: Optional[PipelineConfig] = None,
                 tocg_cfg: Optional[TOCGConfig] = None,
                 gen_cfg: Optional[SPADEGenConfig] = None, device="cuda",
                 dtype=torch.float32, seed: int = 0, noise_seed: int = 1):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cfg = pipeline_cfg or PipelineConfig()
        tocg_cfg = tocg_cfg or TOCGConfig(ngf=96, upsample=self.cfg.upsample)
        gen_cfg = gen_cfg or SPADEGenConfig(
            ngf=64, num_upsampling_layers="most", fused_block=True,
            fine_height=self.cfg.fine_height, fine_width=self.cfg.fine_width)
        self.tocg = ConditionGenerator(tocg_cfg, self.device, dtype).eval()
        self.generator = SPADEGenerator(gen_cfg, self.device, dtype).eval()
        g = torch.Generator().manual_seed(seed)
        init_weights(self.tocg, g)
        init_weights(self.generator, g)
        self.noise_seed = noise_seed

    @torch.inference_mode()
    def __call__(self, batch: Dict[str, torch.Tensor],
                 noise: Optional[NoiseArg] = None):
        batch = {k: v.to(self.device, self.dtype) for k, v in batch.items()}
        if noise is None:
            noise = torch.Generator(device=self.device).manual_seed(
                self.noise_seed)
        return tryon_forward(self.tocg,
                             lambda x, seg: self.generator(x, seg, noise),
                             batch, self.cfg)
