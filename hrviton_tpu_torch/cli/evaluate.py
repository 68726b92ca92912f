"""Offline evaluation CLI: the port's counterpart of
``hrviton_tpu/cli/evaluate.py`` (reference evaluate.py).

SSIM (grayscale, gaussian-weighted) and MSE on the host, LPIPS (alex at
128x128) on the card, and the Inception Score with ``--inception_weights``
(a torchvision ``inception_v3`` ``.pth``, or a converted ``.ckpt``), else
NaN, as the JAX CLI reports it; ``eval.txt`` and ``lpips.txt`` (per image,
sorted by distance) are appended in the JAX CLI's format (reference
evaluate.py:91-111). The same flags and defaults as the JAX CLI, plus
``--device`` (default ``cuda``)::

    python -m hrviton_tpu_torch.cli.evaluate --predict_dir OUT \\
        --ground_truth_dir ROOT/test/image --lpips_weights lpips.ckpt

On the card the LPIPS forward and the Inception forward with its softmax
each replay a CUDA graph recorded once per input signature
(``losses/lpips.LPIPSFn``, ``models/inception.inception_probs``), as the JAX
CLI jits them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (add_ignored_reference_flags,
                                          check_pretrained_backbone)
from hrviton_tpu_torch.infer.metrics import inception_score, mse, ssim_gray

__all__ = ["get_opt", "lpips_input", "inception_input", "main"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    add_ignored_reference_flags(p, "--evaluation")
    p.add_argument("--predict_dir", default="./result/output/")
    p.add_argument("--ground_truth_dir",
                   default="./data/zalando-hd-resize/test/image")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--lpips_weights", default="",
                   help="converted LPIPS alex weights (msgpack)")
    p.add_argument("--inception_weights", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device of LPIPS and Inception ('cpu' for the "
                        "host)")
    return p.parse_args(argv)


def _resize_for(opt, img):
    from PIL import Image
    if opt.resolution == 1024:
        return img
    if opt.resolution == 512:
        return img.resize((384, 512), Image.BILINEAR)
    if opt.resolution == 256:
        return img.resize((192, 256), Image.BILINEAR)
    raise NotImplementedError(opt.resolution)


def _unit_input(img, hw, device) -> torch.Tensor:
    from PIL import Image
    arr = np.asarray(img.convert("RGB").resize(hw, Image.BILINEAR),
                     dtype=np.float32) / 255.0
    return torch.from_numpy(arr[None] * 2.0 - 1.0).to(device)


def lpips_input(img, device) -> torch.Tensor:
    """A PIL image -> (1, 128, 128, 3) in [-1, 1], LPIPS' input."""
    return _unit_input(img, (128, 128), device)


def inception_input(img, device) -> torch.Tensor:
    """A PIL image -> (1, 299, 299, 3) in [-1, 1], Inception's input."""
    return _unit_input(img, (299, 299), device)


def _load_tree(path: str, convert):
    from hrviton_tpu_torch.train.checkpoint import (load_pytree,
                                                    load_torch_state_dict)
    if path.endswith((".pth", ".pt")):
        return convert(load_torch_state_dict(path))
    return load_pytree(path)


def main(argv=None):
    from PIL import Image

    from hrviton_tpu_torch.convert import load_jax_variables
    from hrviton_tpu_torch.losses.lpips import make_lpips
    from hrviton_tpu_torch.models.inception import (InceptionV3,
                                                    convert_inception_v3,
                                                    inception_probs)
    from hrviton_tpu_torch.train.checkpoint import load_pytree

    opt = get_opt(argv)
    pred_list = sorted(os.listdir(opt.predict_dir))
    pred_list = [p for p in pred_list if p.endswith((".png", ".jpg"))]

    check_pretrained_backbone(opt.lpips_weights, what="LPIPS (eval metric)",
                              flag="--lpips_weights", allowed=False,
                              allow_flag="--lpips_weights", refuse=False)
    lpips_vars = load_pytree(opt.lpips_weights) if opt.lpips_weights else None
    lpips = make_lpips(lpips_vars, device=opt.device)

    avg_ssim = avg_mse = avg_lpips = 0.0
    lpips_list = []
    for i, name in enumerate(pred_list):
        gt_name = name.split("_")[0] + "_00.jpg"
        gt_img = _resize_for(opt, Image.open(
            os.path.join(opt.ground_truth_dir, gt_name)))
        pred_img = Image.open(os.path.join(opt.predict_dir, name))
        assert gt_img.size == pred_img.size, f"{gt_img.size} vs {pred_img.size}"

        avg_ssim += ssim_gray(np.asarray(gt_img.convert("L")),
                              np.asarray(pred_img.convert("L")))
        avg_mse += mse(np.asarray(gt_img.convert("RGB")),
                       np.asarray(pred_img.convert("RGB")))
        d = float(lpips(lpips_input(gt_img, opt.device),
                        lpips_input(pred_img, opt.device))[0])
        lpips_list.append((name, d))
        avg_lpips += d
        print(f"step: {i + 1} evaluation... lpips:{d}", flush=True)

    n = max(len(pred_list), 1)
    avg_ssim /= n
    avg_mse /= n
    avg_lpips /= n

    is_mean, is_std = float("nan"), float("nan")
    if opt.inception_weights:
        inception = InceptionV3(device=opt.device).eval()
        load_jax_variables(inception, _load_tree(opt.inception_weights,
                                                 convert_inception_v3))
        preds = np.zeros((len(pred_list), 1000))
        for i, name in enumerate(pred_list):
            img = Image.open(os.path.join(opt.predict_dir, name))
            preds[i] = inception_probs(
                inception, inception_input(img, opt.device))[0].cpu().numpy()
        is_mean, is_std = inception_score(preds, splits=1)

    lpips_list.sort(key=lambda x: x[1], reverse=True)
    with open(os.path.join(opt.predict_dir, "lpips.txt"), "a") as f:
        for name, score in lpips_list:
            f.write(f"{name} {score}\n")
    with open(os.path.join(opt.predict_dir, "eval.txt"), "a") as f:
        f.write(f"SSIM : {avg_ssim} / MSE : {avg_mse} / LPIPS : {avg_lpips}\n")
        f.write(f"IS_mean : {is_mean} / IS_std : {is_std}\n")

    print("SSIM : %f / MSE : %f / LPIPS : %f" % (avg_ssim, avg_mse, avg_lpips))
    print("IS_mean : %f / IS_std : %f" % (is_mean, is_std))
    return avg_ssim, avg_mse, avg_lpips, is_mean, is_std


if __name__ == "__main__":
    main()
