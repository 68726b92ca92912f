"""Shared CLI plumbing: flag groups mirroring the reference argparse surfaces
(the same flags and defaults as ``hrviton_tpu/cli/common.py``), the
checkpoint loaders onto the port's modules, and the condition stage's models
as the rejection CLIs build them (``build_tocg``, ``build_cond_discriminator``,
``condition_inputs``)."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from hrviton_tpu_torch.config import (CondDiscriminatorConfig, DataConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core.mesh import Mesh, init_distributed, make_mesh
from hrviton_tpu_torch.data.device import expand_compact, to_device
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.models.condition import ConditionGenerator
from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
from hrviton_tpu_torch.nn.layers import init_weights
from hrviton_tpu_torch.train.checkpoint import (convert_cond_discriminator,
                                                convert_spade_gen,
                                                convert_tocg, load_pytree,
                                                load_torch_state_dict)

__all__ = ["add_data_flags", "add_tocg_flags", "add_spade_flags",
           "add_d_flags", "add_ignored_reference_flags",
           "load_tocg_variables", "load_gen_variables", "load_d_variables",
           "data_cfg_from_args", "check_pretrained_backbone", "build_tocg",
           "build_cond_discriminator", "condition_inputs",
           "add_multihost_flags", "start_mesh", "expandable_segments",
           "batch_to_device", "expand",
           "StepEvents"]


def check_pretrained_backbone(weights_path: str, *, what: str, flag: str,
                              allowed: bool, allow_flag: str,
                              refuse: bool = True) -> None:
    """Fail loudly when a loss/metric backbone would be RANDOMLY initialized.

    The pretrained VGG19 is part of the reference's loss definition
    (reference networks.py:234-251); running without it silently trains
    against a different objective while looking healthy. Likewise a random
    LPIPS backbone makes the in-train metric meaningless."""
    if weights_path:
        return
    msg = (f"{what} weights were not provided ({flag} is empty) — the "
           f"backbone will be RANDOMLY initialized. For the reference "
           f"objective/metric, convert pretrained weights to a .ckpt "
           f"(hrviton_tpu_torch.cli.convert_checkpoint) and pass {flag}. "
           f"To proceed anyway, pass {allow_flag}.")
    if allowed or not refuse:
        print(f"WARNING: {msg}", file=sys.stderr, flush=True)
    else:
        raise SystemExit(f"ERROR: {msg}")


def add_ignored_reference_flags(p: argparse.ArgumentParser, *names: str):
    """Register reference-CLI flags that the port does not use (apex fp16,
    GPU id lists, or flags the reference declares but never reads) so
    existing invocation scripts run unmodified. Values are parsed and
    ignored."""
    for name in names:
        p.add_argument(name, nargs="?", const=True, default=None,
                       help="accepted for reference CLI compatibility; ignored")


def add_data_flags(p: argparse.ArgumentParser, *, dataroot="./data/zalando-hd-resize",
                   datamode="train", data_list="train_pairs.txt",
                   fine_width=192, fine_height=256, batch_size=8):
    p.add_argument("--dataroot", default=dataroot)
    p.add_argument("--datamode", default=datamode)
    p.add_argument("--data_list", default=data_list)
    p.add_argument("--fine_width", type=int, default=fine_width)
    p.add_argument("--fine_height", type=int, default=fine_height)
    p.add_argument("-b", "--batch-size", dest="batch_size", type=int,
                   default=batch_size)
    p.add_argument("-j", "--workers", type=int, default=4)
    p.add_argument("--worker_processes", action="store_true",
                   help="decode samples in --workers spawned processes "
                        "instead of a thread pool — the reference's torch "
                        "DataLoader num_workers semantics "
                        "(cp_dataset.py:412)")
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--semantic_nc", type=int, default=13)
    # compact wire format (data/device.py): the loader ships uint8 and the
    # normalize/one-hot/composite math runs on the device. This flag
    # restores the full f32 host-side format.
    p.add_argument("--no_device_preprocess", action="store_true")


def add_tocg_flags(p: argparse.ArgumentParser):
    p.add_argument("--warp_feature", choices=["encoder", "T1"], default="T1")
    p.add_argument("--out_layer", choices=["relu", "conv"], default="relu")
    p.add_argument("--output_nc", type=int, default=13)
    p.add_argument("--clothmask_composition",
                   choices=["no_composition", "detach", "warp_grad"],
                   default="warp_grad")
    p.add_argument("--occlusion", action="store_true")
    p.add_argument("--upsample", choices=["nearest", "bilinear"],
                   default="bilinear")


def add_spade_flags(p: argparse.ArgumentParser):
    p.add_argument("--norm_G", default="spectralaliasinstance")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--gen_semantic_nc", type=int, default=7)
    p.add_argument("--num_upsampling_layers", choices=["normal", "more", "most"],
                   default="most")
    p.add_argument("--init_type", default="xavier")
    p.add_argument("--init_variance", type=float, default=0.02)


def add_d_flags(p: argparse.ArgumentParser):
    """The condition discriminator's flags (get_norm_const, test_condition)."""
    p.add_argument("--tocg_checkpoint", default="")
    p.add_argument("--D_checkpoint", default="")
    p.add_argument("--Ddownx2", action="store_true")
    p.add_argument("--Ddropout", action="store_true")
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--spectral", action="store_true")


def data_cfg_from_args(args, mode=None, data_list=None) -> DataConfig:
    return DataConfig(
        dataroot=args.dataroot,
        datamode=mode or args.datamode,
        data_list=data_list or args.data_list,
        fine_height=args.fine_height,
        fine_width=args.fine_width,
        semantic_nc=args.semantic_nc,
        shuffle=getattr(args, "shuffle", False),
        workers=args.workers,
    )


def _is_torch_ckpt(path: str) -> bool:
    return path.endswith((".pth", ".pt"))


def load_tocg_variables(path: str, module: nn.Module,
                        out_layer: str = "relu") -> nn.Module:
    """Load tocg weights from a JAX-package ``.ckpt`` or a reference
    ``.pth`` into the port's ConditionGenerator ``module`` (every tensor of
    it must be filled); returns ``module``."""
    if _is_torch_ckpt(path):
        tree = convert_tocg(load_torch_state_dict(path), out_layer=out_layer)
    else:
        tree = load_pytree(path)
    load_jax_variables(module, tree)
    return module


def load_gen_variables(path: str, module: nn.Module,
                       num_upsampling_layers: str = "most") -> nn.Module:
    """As ``load_tocg_variables``, for the SPADEGenerator."""
    if _is_torch_ckpt(path):
        tree = convert_spade_gen(load_torch_state_dict(path),
                                 num_upsampling_layers)
    else:
        tree = load_pytree(path)
    load_jax_variables(module, tree)
    return module


def load_d_variables(path: str, module: nn.Module,
                     num_d: int = 2) -> nn.Module:
    """As ``load_tocg_variables``, for the condition discriminator (a
    reference ``D_*.pth`` goes through ``convert_cond_discriminator``)."""
    if _is_torch_ckpt(path):
        tree = convert_cond_discriminator(load_torch_state_dict(path), num_d)
    else:
        tree = load_pytree(path)
    load_jax_variables(module, tree)
    return module


def build_tocg(opt) -> nn.Module:
    """The rejection CLIs' ConditionGenerator (ngf=96, the flags'
    warp_feature / out_layer / upsample) on ``opt.device``, eval mode:
    weights from ``--tocg_checkpoint`` where the file exists, else random
    from ``--seed``."""
    tocg = ConditionGenerator(TOCGConfig(
        ngf=96, warp_feature=opt.warp_feature, out_layer=opt.out_layer,
        upsample=opt.upsample), device=opt.device).eval()
    init_weights(tocg, torch.Generator().manual_seed(opt.seed))
    if opt.tocg_checkpoint and os.path.exists(opt.tocg_checkpoint):
        load_tocg_variables(opt.tocg_checkpoint, tocg, opt.out_layer)
    return tocg


def build_cond_discriminator(opt) -> nn.Module:
    """The condition discriminator of the rejection CLIs: input_nc = 4 +
    semantic_nc + 3 + output_nc, the flags' num_D / Ddownx2 / Ddropout /
    spectral, on ``opt.device``, eval mode, weights from ``--D_checkpoint``
    where the file exists, else random from ``--seed``."""
    cfg = CondDiscriminatorConfig(
        input_nc=4 + opt.semantic_nc + 3 + opt.output_nc, num_d=opt.num_D,
        ddownx2=opt.Ddownx2, ddropout=opt.Ddropout, spectral=opt.spectral)
    d = CondMultiscaleDiscriminator(cfg, device=opt.device).eval()
    init_weights(d, torch.Generator().manual_seed(opt.seed + 1))
    if opt.D_checkpoint and os.path.exists(opt.D_checkpoint):
        load_d_variables(opt.D_checkpoint, d, opt.num_D)
    return d


def condition_inputs(raw: Mapping, datasetting: str,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tocg's inputs from a loader batch (f32 NHWC numpy, the full
    format): input1 = cloth + (cloth mask > 0.5), input2 = parse-agnostic +
    densepose, on ``device``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cloth = t(raw["cloth"][datasetting])
    cm = (t(raw["cloth_mask"][datasetting]) > 0.5).float()
    return (torch.cat([cloth, cm], dim=-1),
            torch.cat([t(raw["parse_agnostic"]), t(raw["densepose"])], dim=-1))


def add_multihost_flags(p: argparse.ArgumentParser):
    """The training CLIs' multi-host flags: one process a device,
    ``--num_processes`` of them, each with its own ``--process_id`` and
    the same ``--coordinator`` (host:port where rank 0 listens)."""
    p.add_argument("--coordinator", default="",
                   help="coordinator address host:port for multi-process "
                        "runs (rank 0's)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def start_mesh(opt) -> Mesh:
    """The data-parallel layout of a training CLI: with ``--coordinator``,
    this process joins the group (``core/mesh.init_distributed``: NCCL on
    ``cuda:{process_id % device count}``, gloo with ``--device cpu``);
    without it one process drives ``--device``. ``--num_processes`` or
    ``--process_id`` without ``--coordinator`` raises."""
    if not opt.coordinator and (opt.num_processes is not None
                                or opt.process_id is not None):
        raise ValueError("--num_processes / --process_id need --coordinator")
    dev = init_distributed(opt.coordinator, opt.num_processes,
                           opt.process_id, opt.device)
    return make_mesh(dev if dev is not None else resolve_device(opt.device))


def expandable_segments(device) -> None:
    """On a CUDA device, the caching allocator's expandable segments for the
    rest of the process, unless ``PYTORCH_CUDA_ALLOC_CONF`` names them. A
    recorded step's private pool then holds what the step allocates at its
    peak; with fixed segments it holds the segments of the step's first
    allocations, for stage 1 half as much again (PERF.md, section 5)."""
    if torch.device(device).type != "cuda" or \
            "expandable_segments" in os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""):
        return
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


@graphs.captured
def expand(batch: Mapping, semantic_nc: int = 13) -> dict:
    """``data/device.expand_compact`` of a batch on the device: the JAX
    training CLIs' jitted ``expand``, one graph per batch signature on the
    card."""
    return expand_compact(batch, semantic_nc=semantic_nc)


def batch_to_device(batch: Mapping, device, compact: bool,
                    semantic_nc: int = 13) -> dict:
    """A loader batch without its name lists, as tensors on ``device`` (the
    host's copy, outside any graph), the compact format expanded there
    (``expand``)."""
    batch = {k: v for k, v in batch.items() if k not in ("im_name", "c_name")}
    batch = to_device(batch, device)
    return expand(batch, semantic_nc) if compact else batch


class StepEvents:
    """CUDA events around each training step on a card (nothing on the
    CPU); ``ms()`` gives the steps' times, after a synchronize."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.pairs = []

    def start(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs.append([e, None])

    def stop(self):
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.pairs[-1][1] = e

    def ms(self):
        if not self.on:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]
