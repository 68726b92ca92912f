"""Condition-stage test CLI: the port's counterpart of
``hrviton_tpu/cli/test_condition.py`` (reference test_condition.py).

Runs the tocg over the test split and saves 12-panel grids; with a
discriminator checkpoint and ``--norm_const`` it also writes the
discriminator-rejection scores, sorted in descending order, to
``rejection_prob.txt`` (reference test_condition.py:118-153). The same flags
and defaults as the JAX CLI, plus ``--device`` (default ``cuda``)::

    python -m hrviton_tpu_torch.cli.test_condition --dataroot ROOT \\
        --tocg_checkpoint mtviton.pth --D_checkpoint D.pth --norm_const M

PIL is imported by ``main`` only: ``condition_step`` and ``grid_panels``
serve a caller without it.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Mapping

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (add_d_flags, add_data_flags,
                                          add_ignored_reference_flags,
                                          add_tocg_flags,
                                          build_cond_discriminator,
                                          build_tocg, condition_inputs,
                                          data_cfg_from_args)
from hrviton_tpu_torch.infer.rejection import d_logit, rejection_scores
from hrviton_tpu_torch.pipelines.tryon import compose_clothmask
from hrviton_tpu_torch.utils.vis import make_image_grid, visualize_segmap

__all__ = ["get_opt", "condition_step", "grid_panels", "main"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    add_data_flags(p, dataroot="./data/zalando-hd-resize", datamode="test",
                   data_list="test_pairs.txt", batch_size=8)
    add_tocg_flags(p)
    add_ignored_reference_flags(p, "--fp16", "--gpu_ids", "--checkpoint_dir",
                                "--tensorboard_dir", "--tensorboard_count")
    p.add_argument("--datasetting", default="paired")
    add_d_flags(p)
    p.add_argument("--norm_const", type=float, default=None)
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models ('cpu' for the host)")
    return p.parse_args(argv)


@torch.inference_mode()
def condition_step(tocg, d_model, input1, input2,
                   composition: str = "warp_grad"):
    """One batch: the tocg's composed segmap, warped cloth and mask, and,
    with a discriminator, ``d_logit`` of D(input1, input2, softmax(seg))
    (else None)."""
    _, seg, wc, wcm = tocg(input1, input2)
    seg = compose_clothmask(seg, wcm, composition)
    logits = None
    if d_model is not None:
        pred = d_model(torch.cat([input1, input2, torch.softmax(seg, dim=-1)],
                                 dim=-1))
        logits = d_logit(pred)
    return seg, wc, wcm, logits


def grid_panels(raw: Mapping, datasetting: str, seg, wc, wcm,
                i: int) -> List[np.ndarray]:
    """The 12 panels of sample ``i``'s grid, (H, W, 3) float in [0, 1], in
    the JAX CLI's order; ``raw`` is the loader's batch, seg / wc / wcm the
    step's outputs."""
    seg = seg.float().cpu().numpy()
    wc = wc.float().cpu().numpy()
    wcm_hard = wcm.float().cpu().numpy() > 0.5
    fake_cm = (seg.argmax(-1) == 3)[..., None]
    cm = (raw["cloth_mask"][datasetting] > 0.5).astype(np.float32)
    return [
        raw["cloth"][datasetting][i] / 2 + 0.5,
        np.repeat(cm[i], 3, -1),
        visualize_segmap(raw["parse_agnostic"], i),
        (raw["densepose"][i] + 1) / 2,
        raw["parse_cloth"][i] / 2 + 0.5,
        np.repeat(raw["pcm"][i], 3, -1),
        wc[i] / 2 + 0.5,
        np.repeat(wcm_hard[i].astype(np.float32), 3, -1),
        visualize_segmap(raw["parse"], i),
        visualize_segmap(seg, i),
        raw["image"][i] / 2 + 0.5,
        np.repeat(np.clip(fake_cm[i].astype(np.float32) - wcm_hard[i], 0, 1),
                  3, -1),
    ]


def main(argv=None):
    from PIL import Image

    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader

    opt = get_opt(argv)
    print(opt)
    tocg = build_tocg(opt)
    d_model = None
    if opt.D_checkpoint and os.path.exists(opt.D_checkpoint):
        if opt.norm_const is None:
            raise SystemExit("--norm_const is required with --D_checkpoint "
                             "(run get_norm_const first)")
        d_model = build_cond_discriminator(opt)

    ds = VitonHDDataset(data_cfg_from_args(opt), mode="test")
    loader = Loader(ds, opt.batch_size, shuffle=False, drop_last=False,
                    num_workers=opt.workers,
                    worker_processes=opt.worker_processes)
    ckname = (opt.tocg_checkpoint.split("/")[-2:] if opt.tocg_checkpoint
              else ["x", "y"])
    out_dir = os.path.join(opt.output_dir, *ckname, opt.datamode,
                           opt.datasetting, "multi-task")
    os.makedirs(out_dir, exist_ok=True)

    scores = []
    num = 0
    t0 = time.time()
    steps = (len(ds) + opt.batch_size - 1) // opt.batch_size
    try:
        for _ in range(steps):
            raw = loader.next_batch()
            input1, input2 = condition_inputs(raw, opt.datasetting, opt.device)
            seg, wc, wcm, logits = condition_step(
                tocg, d_model, input1, input2, opt.clothmask_composition)
            if logits is not None:
                s = rejection_scores(logits, opt.norm_const)
                for i in range(len(s)):
                    name = raw["c_name"]["paired"][i].replace(".jpg", ".png")
                    scores.append((name, float(s[i])))
            for i in range(input1.shape[0]):
                grid = make_image_grid(
                    grid_panels(raw, opt.datasetting, seg, wc, wcm, i), nrow=4)
                name = (raw["c_name"]["paired"][i].split(".")[0] + "_" +
                        raw["c_name"]["unpaired"][i].split(".")[0] + ".png")
                Image.fromarray((grid * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, name))
            num += input1.shape[0]
            print(num, flush=True)
    finally:
        loader.close()

    if scores:
        scores.sort(key=lambda x: x[1], reverse=True)
        with open(os.path.join(out_dir, "rejection_prob.txt"), "w") as f:
            for name, s in scores:
                f.write(f"{name} {s}\n")
    print(f"Test time {time.time() - t0}")
    return out_dir


if __name__ == "__main__":
    main()
