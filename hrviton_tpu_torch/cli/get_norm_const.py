"""Norm-constant CLI: the port's counterpart of
``hrviton_tpu/cli/get_norm_const.py`` (reference get_norm_const.py).

Computes M, the largest discriminator odds l / (1 - l) over the train split
on both real and predicted segmaps; feed M to ``test_condition
--norm_const``. The same flags and defaults as the JAX CLI, plus
``--device`` (default ``cuda``; ``cpu`` for a run on the host)::

    python -m hrviton_tpu_torch.cli.get_norm_const --dataroot ROOT \\
        --tocg_checkpoint mtviton.pth --D_checkpoint D.pth   # prints M: <float>
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (add_d_flags, add_data_flags,
                                          add_ignored_reference_flags,
                                          add_tocg_flags,
                                          build_cond_discriminator,
                                          build_tocg, condition_inputs,
                                          data_cfg_from_args)
from hrviton_tpu_torch.infer.rejection import d_logit, norm_const_from_logits
from hrviton_tpu_torch.pipelines.tryon import compose_clothmask

__all__ = ["get_opt", "norm_const_step", "main"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="test")
    add_data_flags(p, dataroot="./data", datamode="train",
                   data_list="train_pairs.txt", batch_size=8)
    add_tocg_flags(p)
    add_ignored_reference_flags(
        p, "--checkpoint_dir", "--display_count", "--fp16", "--gpu_ids",
        "--keep_step", "--load_step", "--save_count", "--tensorboard_count",
        "--tensorboard_dir", "--test_data_list", "--test_datasetting",
        "--test_dataroot")
    add_d_flags(p)
    p.add_argument("--max_samples", type=int, default=0,
                   help="limit train samples scanned (0 = all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models ('cpu' for the host)")
    return p.parse_args(argv)


@torch.inference_mode()
def norm_const_step(tocg, d_model, input1, input2, label,
                    composition: str = "warp_grad"):
    """The discriminator's scores (N,) of the real segmap ``label`` and of
    the tocg's composed prediction, each ``d_logit`` of D(input1, input2,
    segmap)."""
    _, seg, _, wcm = tocg(input1, input2)
    seg = compose_clothmask(seg, wcm, composition)
    real = d_model(torch.cat([input1, input2, label], dim=-1))
    fake = d_model(torch.cat([input1, input2, torch.softmax(seg, dim=-1)],
                             dim=-1))
    return d_logit(real), d_logit(fake)


def main(argv=None):
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader

    opt = get_opt(argv)
    print(opt)
    tocg = build_tocg(opt)
    d_model = build_cond_discriminator(opt)

    ds = VitonHDDataset(data_cfg_from_args(opt), mode="train")
    loader = Loader(ds, opt.batch_size, shuffle=False, drop_last=False,
                    num_workers=opt.workers,
                    worker_processes=opt.worker_processes)
    length = len(ds) if opt.max_samples == 0 else min(opt.max_samples, len(ds))

    real_logits, fake_logits = [], []
    try:
        for _ in range(max(1, length // opt.batch_size)):
            raw = loader.next_batch()
            input1, input2 = condition_inputs(raw, "paired", opt.device)
            label = torch.from_numpy(raw["parse"]).to(opt.device)
            lr, lf = norm_const_step(tocg, d_model, input1, input2, label,
                                     opt.clothmask_composition)
            lr, lf = lr.cpu().numpy(), lf.cpu().numpy()
            real_logits.append(lr)
            fake_logits.append(lf)
            print("real:", np.asarray(lr), "fake:", np.asarray(lf), flush=True)
    finally:
        loader.close()
    m = norm_const_from_logits(real_logits, fake_logits)
    print("M:", m)
    return m


if __name__ == "__main__":
    main()
