"""Inference CLI: the port's counterpart of ``hrviton_tpu/cli/test_generator.py``
(reference test_generator.py).

Full unpaired try-on at 1024x768 on the card: TryOnPipeline (tocg + SPADE
generator), saves output JPEGs and 12-panel debug grids. Takes the JAX
package's ``.ckpt`` files or the reference's torch ``.pth`` files; random
weights from ``--seed`` when a checkpoint is missing. The same flags and
defaults as the JAX CLI, plus ``--device`` (default ``cuda``; ``cpu`` runs
every kernel's plain version)::

    python -m hrviton_tpu_torch.cli.test_generator --dataroot ROOT \\
        --tocg_checkpoint mtviton.pth --gen_checkpoint gen.pth [--bf16]

PIL is imported by ``main`` only: ``tryon_step`` and ``grid_panels`` serve a
caller with neither PIL nor msgpack.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Mapping, NamedTuple

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (add_data_flags,
                                          add_ignored_reference_flags,
                                          add_spade_flags, add_tocg_flags,
                                          data_cfg_from_args,
                                          load_gen_variables,
                                          load_tocg_variables)
from hrviton_tpu_torch.config import PipelineConfig, SPADEGenConfig, TOCGConfig
from hrviton_tpu_torch.core.precision import bf16_params
from hrviton_tpu_torch.data.device import expand_compact, to_device
from hrviton_tpu_torch.pipelines.tryon import ConditionOutputs, TryOnPipeline
from hrviton_tpu_torch.utils.vis import (make_image_grid, save_images,
                                         visualize_segmap)

__all__ = ["get_opt", "build_pipeline", "tryon_step", "grid_panels", "main",
           "Step"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--test_name", default="test")
    add_data_flags(p, dataroot="./data/zalando-hd-resize", datamode="test",
                   data_list="test_pairs.txt", fine_width=768,
                   fine_height=1024, batch_size=1)
    add_tocg_flags(p)
    add_ignored_reference_flags(p, "--cuda", "--fp16", "--gpu_ids", "--checkpoint_dir", "--tensorboard_dir", "--tensorboard_count")
    add_spade_flags(p)
    p.add_argument("--output_dir", default="./Output")
    p.add_argument("--datasetting", default="unpaired")
    p.add_argument("--tocg_checkpoint",
                   default="./eval_models/weights/v0.1/mtviton.pth")
    p.add_argument("--gen_checkpoint",
                   default="./eval_models/weights/v0.1/gen.pth")
    p.add_argument("--cond_height", type=int, default=256)
    p.add_argument("--cond_width", type=int, default=192)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (default f32 for strict parity)")
    p.add_argument("--no_grids", action="store_true",
                   help="skip 12-panel debug grids (faster)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the forward ('cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def build_pipeline(opt) -> TryOnPipeline:
    """The CLI's TryOnPipeline: its configurations from the flags, weights
    from the checkpoints (random from ``--seed`` where one is missing), and
    with ``--bf16`` the weights cast to bf16."""
    pcfg = PipelineConfig(fine_height=opt.fine_height, fine_width=opt.fine_width,
                          cond_height=opt.cond_height, cond_width=opt.cond_width,
                          clothmask_composition=opt.clothmask_composition,
                          occlusion=opt.occlusion, upsample=opt.upsample)
    tcfg = TOCGConfig(ngf=96, warp_feature=opt.warp_feature,
                      out_layer=opt.out_layer, upsample=opt.upsample)
    gcfg = SPADEGenConfig(
        ngf=opt.ngf, gen_semantic_nc=opt.gen_semantic_nc,
        num_upsampling_layers=opt.num_upsampling_layers, norm_g=opt.norm_G,
        fine_height=opt.fine_height, fine_width=opt.fine_width)
    pipe = TryOnPipeline(pcfg, tcfg, gcfg, device=opt.device,
                         dtype=torch.float32, seed=opt.seed,
                         noise_seed=opt.seed + 1)
    if opt.tocg_checkpoint and os.path.exists(opt.tocg_checkpoint):
        load_tocg_variables(opt.tocg_checkpoint, pipe.tocg, opt.out_layer)
    else:
        print(f"WARNING: tocg checkpoint missing ({opt.tocg_checkpoint}); "
              "random weights")
    if opt.gen_checkpoint and os.path.exists(opt.gen_checkpoint):
        load_gen_variables(opt.gen_checkpoint, pipe.generator,
                           opt.num_upsampling_layers)
    else:
        print(f"WARNING: gen checkpoint missing ({opt.gen_checkpoint}); "
              "random weights")
    if opt.bf16:
        bf16_params(pipe.tocg)
        bf16_params(pipe.generator)
        pipe.dtype = torch.bfloat16
    return pipe


class Step(NamedTuple):
    output: torch.Tensor        # (N, H, W, 3) rgb in [-1, 1], the pipeline's dtype
    cond: ConditionOutputs
    batch: Dict[str, torch.Tensor]   # the pipeline's inputs, its dtype
    full: Dict                  # the loader's arrays on the device, expanded


def tryon_step(pipe: TryOnPipeline, raw: Mapping, *,
               datasetting: str = "unpaired", compact: bool = True,
               semantic_nc: int = 13) -> Step:
    """One batch of the CLI: the loader's dict (name lists removed) to the
    device, expanded there if compact, the ``datasetting`` cloth picked, cast
    to the pipeline's dtype, and the try-on forward."""
    full = to_device(raw, pipe.device)
    if compact:
        full = expand_compact(full, semantic_nc=semantic_nc)
    batch = {"cloth": full["cloth"][datasetting],
             "cloth_mask": full["cloth_mask"][datasetting],
             "parse_agnostic": full["parse_agnostic"],
             "densepose": full["densepose"],
             "agnostic": full["agnostic"]}
    batch = {k: v.to(pipe.dtype) for k, v in batch.items()}
    output, cond = pipe(batch)
    return Step(output, cond, batch, full)


def grid_panels(step: Step, i: int) -> List[np.ndarray]:
    """The 12 panels of sample ``i``'s debug grid, (H, W, 3) float in [0, 1],
    in the JAX CLI's order."""
    f32 = lambda t: t[i].float().cpu().numpy()
    seg = lambda t: visualize_segmap(t[i:i + 1].float().cpu().numpy())
    batch, cond, full = step.batch, step.cond, step.full
    return [
        f32(batch["cloth"]) / 2 + 0.5,
        np.repeat(f32(batch["cloth_mask"]), 3, -1),
        seg(full["parse_agnostic"]),
        (f32(batch["densepose"]) + 1) / 2,
        f32(cond.warped_cloth) / 2 + 0.5,
        np.repeat(np.clip(f32(cond.warped_clothmask), 0, 1), 3, -1),
        seg(cond.fake_parse_gauss),
        f32(full["pose"]) / 2 + 0.5,
        f32(cond.warped_cloth) / 2 + 0.5,
        f32(batch["agnostic"]) / 2 + 0.5,
        f32(full["image"]) / 2 + 0.5,
        f32(step.output) / 2 + 0.5,
    ]


def main(argv=None):
    from PIL import Image

    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader

    opt = get_opt(argv)
    print(opt)
    pipe = build_pipeline(opt)

    compact = not opt.no_device_preprocess
    ds = VitonHDDataset(data_cfg_from_args(opt), mode="test_gen",
                        compact=compact)
    loader = Loader(ds, opt.batch_size, shuffle=False, drop_last=False,
                    num_workers=opt.workers,
                    worker_processes=opt.worker_processes)

    output_dir = opt.output_dir or os.path.join(
        "./output", opt.test_name, opt.datamode, opt.datasetting,
        "generator", "output")
    grid_dir = os.path.join("./output", opt.test_name, opt.datamode,
                            opt.datasetting, "generator", "grid")
    os.makedirs(output_dir, exist_ok=True)
    os.makedirs(grid_dir, exist_ok=True)

    num = 0
    t0 = time.time()
    steps = (len(ds) + opt.batch_size - 1) // opt.batch_size
    try:
        for _ in range(steps):
            raw = loader.next_batch()
            names = raw.pop("c_name")
            raw.pop("im_name")
            step = tryon_step(pipe, raw, datasetting=opt.datasetting,
                              compact=compact, semantic_nc=opt.semantic_nc)
            output = step.output.float().cpu().numpy()

            out_names = []
            for i in range(output.shape[0]):
                out_name = (names["paired"][i].split(".")[0] + "_" +
                            names[opt.datasetting][i].split(".")[0] + ".png")
                out_names.append(out_name)
                if not opt.no_grids:
                    grid = make_image_grid(grid_panels(step, i), nrow=4)
                    Image.fromarray((grid * 255).astype(np.uint8)).save(
                        os.path.join(grid_dir, out_name))
            save_images(output, out_names, output_dir)
            num += output.shape[0]
            print(num, flush=True)
    finally:
        loader.close()
    print(f"Test time {time.time() - t0}")
    print("Finished testing!")


if __name__ == "__main__":
    main()
