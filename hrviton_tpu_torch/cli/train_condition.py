"""Stage-1 training CLI: the port's counterpart of
``hrviton_tpu/cli/train_condition.py`` (reference train_condition.py), the
same flags and defaults, plus ``--device`` (default ``cuda``)::

    python -m hrviton_tpu_torch.cli.train_condition --name run \\
        --dataroot ROOT --test_dataroot ROOT --vgg_weights vgg19.ckpt

Runs ``ConditionTrainer.train_step``, with in-train IoU validation every
--val_count steps, TensorBoard panels every --tensorboard_count and
checkpoints every --save_count; on the card the step, ``eval_iou``,
``visualize`` and the batches' ``expand`` replay CUDA graphs recorded once
per signature (``core/graphs.py``), as the JAX CLI jits them, and no flag
turns that off. Checkpoints are written as the JAX CLI writes them
(``tocg_*.ckpt``, ``D_*.ckpt``: the JAX variable trees in its msgpack
format, readable by both packages' test_condition).

Data parallel: start one process a device, each with the same
``--coordinator host:port`` and ``--num_processes N`` and its own
``--process_id`` (``cli/common.start_mesh``); -b stays the global batch, of
which each rank loads its rows (the validation batch too). The metrics and
the IoU printed are the ranks' averages; rank 0 alone writes the
checkpoints, the board and the panels. ``main`` returns the run's record:
the metrics of every displayed step, the IoU values, the steps' CUDA-event
times on a card and the checkpoint directory (rank 0's files), and tears
the group down.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (StepEvents, add_data_flags,
                                          add_ignored_reference_flags,
                                          add_multihost_flags, add_tocg_flags,
                                          batch_to_device,
                                          check_pretrained_backbone,
                                          data_cfg_from_args,
                                          expandable_segments,
                                          load_tocg_variables, start_mesh)
from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                      ConditionTrainConfig, TOCGConfig)
from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
from hrviton_tpu_torch.train.checkpoint import load_pytree, save_pytree
from hrviton_tpu_torch.train.condition_trainer import ConditionTrainer
from hrviton_tpu_torch.utils.logging import Board
from hrviton_tpu_torch.utils.vis import make_image_grid, visualize_segmap

__all__ = ["get_opt", "main"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", default="test")
    add_data_flags(p, dataroot="./data/", datamode="train",
                   data_list="train_pairs.txt")
    add_tocg_flags(p)
    add_ignored_reference_flags(p, "--cuda", "--gpu_ids")
    p.add_argument("--tensorboard_dir", default="tensorboard")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--tocg_checkpoint", default="")
    p.add_argument("--vgg_weights", default="",
                   help="converted VGG19 weights (msgpack); required unless "
                        "--allow_random_vgg")
    p.add_argument("--allow_random_vgg", action="store_true",
                   help="run with a randomly initialized VGG19 perceptual "
                        "backbone (changes the training objective; smoke "
                        "tests only)")
    p.add_argument("--tensorboard_count", type=int, default=100)
    p.add_argument("--display_count", type=int, default=100)
    p.add_argument("--save_count", type=int, default=10000)
    p.add_argument("--load_step", type=int, default=0)
    p.add_argument("--keep_step", type=int, default=300000)
    p.add_argument("--Ddownx2", action="store_true")
    p.add_argument("--Ddropout", action="store_true")
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--spectral", action="store_true")
    p.add_argument("--G_D_seperate", action="store_true")
    p.add_argument("--no_GAN_loss", action="store_true")
    p.add_argument("--lasttvonly", action="store_true")
    p.add_argument("--interflowloss", action="store_true")
    p.add_argument("--edgeawaretv", choices=["no_edge", "last_only", "weighted"],
                   default="no_edge")
    p.add_argument("--add_lasttv", action="store_true")
    p.add_argument("--no_test_visualize", action="store_true")
    p.add_argument("--num_test_visualize", type=int, default=3)
    p.add_argument("--test_datasetting", default="unpaired")
    p.add_argument("--test_dataroot", default="./data/")
    p.add_argument("--test_data_list", default="test_pairs.txt")
    p.add_argument("--G_lr", type=float, default=2e-4)
    p.add_argument("--D_lr", type=float, default=2e-4)
    p.add_argument("--CElamda", type=float, default=10)
    p.add_argument("--GANlambda", type=float, default=1)
    p.add_argument("--tvlambda", type=float, default=2)
    p.add_argument("--val_count", type=int, default=1000)
    p.add_argument("--val_samples", type=int, default=2000)
    p.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                   help="bf16 compute / f32 params (the reference's --fp16)")
    p.add_argument("--seed", type=int, default=0)
    add_multihost_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device of the training ('cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def _panels(vb_raw, vis, i):
    """The reference's 12 panels of test sample i (train_condition.py:377-435)."""
    cm = np.asarray(vb_raw["cloth_mask"]["paired"]) > 0.5
    f = lambda t: t.float().cpu().numpy()
    return [
        np.asarray(vb_raw["cloth"]["paired"][i]) / 2 + .5,
        np.repeat(cm[i].astype(np.float32), 3, -1),
        visualize_segmap(vb_raw["parse_agnostic"], i),
        (np.asarray(vb_raw["densepose"][i]) + 1) / 2,
        np.asarray(vb_raw["parse_cloth"][i]) / 2 + .5,
        np.repeat(np.asarray(vb_raw["pcm"][i]), 3, -1),
        f(vis["warped_cloth"][i]) / 2 + .5,
        np.repeat(f(vis["warped_cm_onehot"][i]), 3, -1),
        visualize_segmap(vb_raw["parse"], i),
        visualize_segmap(f(vis["seg_softmax"]), i),
        np.asarray(vb_raw["image"][i]) / 2 + .5,
        np.repeat(f(vis["misalign"][i]), 3, -1),
    ]


def main(argv=None):
    opt = get_opt(argv)
    print(opt)
    # fail fast, before dataset construction
    check_pretrained_backbone(opt.vgg_weights, what="VGG19 (perceptual loss)",
                              flag="--vgg_weights",
                              allowed=opt.allow_random_vgg,
                              allow_flag="--allow_random_vgg")
    mesh = start_mesh(opt)
    expandable_segments(mesh.device)
    try:
        return _train(opt, mesh)
    finally:
        if opt.coordinator:            # the group this run joined
            mesh_lib.shutdown_distributed()


def _train(opt, mesh):
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader

    dev = mesh.device
    rows = dict(process_id=mesh.rank, num_processes=mesh.world_size)

    tcfg = ConditionTrainConfig(
        batch_size=opt.batch_size, keep_step=opt.keep_step, g_lr=opt.G_lr,
        d_lr=opt.D_lr, ce_lambda=opt.CElamda, gan_lambda=opt.GANlambda,
        tv_lambda=opt.tvlambda, no_gan_loss=opt.no_GAN_loss,
        g_d_separate=opt.G_D_seperate, lasttvonly=opt.lasttvonly,
        interflowloss=opt.interflowloss, edgeawaretv=opt.edgeawaretv,
        add_lasttv=opt.add_lasttv, occlusion=opt.occlusion,
        clothmask_composition=opt.clothmask_composition,
        val_count=opt.val_count, display_count=opt.display_count,
        save_count=opt.save_count, tensorboard_count=opt.tensorboard_count,
        load_step=opt.load_step, bf16=opt.bf16)
    tocg_cfg = TOCGConfig(input2_nc=opt.semantic_nc + 3, output_nc=opt.output_nc,
                          ngf=96, warp_feature=opt.warp_feature,
                          out_layer=opt.out_layer, upsample=opt.upsample)
    d_cfg = CondDiscriminatorConfig(
        input_nc=4 + opt.semantic_nc + 3 + opt.output_nc, num_d=opt.num_D,
        ddownx2=opt.Ddownx2, ddropout=opt.Ddropout, spectral=opt.spectral)

    # data
    compact = not opt.no_device_preprocess
    train_ds = VitonHDDataset(data_cfg_from_args(opt), mode="train",
                              compact=compact)
    train_loader = Loader(train_ds, opt.batch_size, shuffle=True,
                          num_workers=opt.workers, seed=opt.seed,
                          worker_processes=opt.worker_processes, **rows)
    val_loader = test_loader = None
    if not opt.no_test_visualize:
        test_cfg = dataclasses.replace(
            data_cfg_from_args(opt, mode="test", data_list=opt.test_data_list),
            dataroot=opt.test_dataroot)
        test_ds = VitonHDDataset(test_cfg, mode="test")
        val_loader = Loader(test_ds, opt.batch_size, shuffle=False,
                            num_workers=opt.workers,
                            indices=range(min(opt.val_samples, len(test_ds))),
                            **rows)
        test_loader = Loader(test_ds, opt.num_test_visualize, shuffle=False,
                             num_workers=1)

    # models and trainer
    vgg = make_vgg_loss(load_pytree(opt.vgg_weights) if opt.vgg_weights
                        else None, device=dev).vgg
    trainer = ConditionTrainer(tocg_cfg, d_cfg, tcfg, device=dev, mesh=mesh)
    state = trainer.init(opt.seed)
    if opt.tocg_checkpoint and os.path.exists(opt.tocg_checkpoint):
        load_tocg_variables(opt.tocg_checkpoint, state.g.module, opt.out_layer)
    # every rank starts from rank 0's weights
    mesh_lib.broadcast_module(state.g.module, mesh)
    mesh_lib.broadcast_module(state.d.module, mesh)

    main_rank = mesh.is_main
    board = Board(os.path.join(opt.tensorboard_dir, opt.name) if main_rank
                  else None)
    ckpt_dir = os.path.join(opt.checkpoint_dir, opt.name)
    events = StepEvents(dev)
    record = {"metrics": [], "val_iou": [], "ckpt_dir": ckpt_dir}

    def put(raw):
        return batch_to_device(raw, dev, compact, opt.semantic_nc)

    t0 = time.time()
    try:
        for step in range(opt.load_step, opt.keep_step):
            batch = put(train_loader.next_batch())
            events.start()
            state, metrics = trainer.train_step(state, batch, vgg)
            events.stop()

            if (step + 1) % tcfg.display_count == 0:
                m = {k: float(v) for k, v in metrics.items()}
                record["metrics"].append(m)
                print(f"step {step + 1} t={time.time() - t0:.1f}s " +
                      " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())),
                      flush=True)
            if (step + 1) % tcfg.tensorboard_count == 0 and main_rank:
                board.scalars({k: float(v) for k, v in metrics.items()},
                              step + 1)
                if test_loader is not None:
                    vb_raw = test_loader.next_batch()
                    vis = trainer.visualize(
                        state, batch_to_device(vb_raw, dev, False))
                    for i in range(min(opt.num_test_visualize,
                                       vb_raw["image"].shape[0])):
                        board.image_grid(f"test_images/{i}",
                                         make_image_grid(_panels(vb_raw, vis, i),
                                                         nrow=4), step + 1)
            if val_loader is not None and (step + 1) % tcfg.val_count == 0:
                ious = [float(trainer.eval_iou(state, mesh_lib.shard_eval_batch(
                            mesh, batch_to_device(val_loader.next_batch(), dev,
                                                  False))))
                        for _ in range(max(1, opt.val_samples // opt.batch_size))]
                iou = mesh_lib.all_mean(np.mean(ious), mesh)
                board.scalar("val/iou", iou, step + 1)
                record["val_iou"].append(iou)
                print(f"val/iou {iou:.4f}", flush=True)
            if (step + 1) % tcfg.save_count == 0 and main_rank:
                save_pytree(state.g.variables(), os.path.join(
                    ckpt_dir, f"tocg_step_{step + 1:06d}.ckpt"))
                save_pytree(state.d.variables(), os.path.join(
                    ckpt_dir, f"D_step_{step + 1:06d}.ckpt"))
    finally:
        for loader in (train_loader, val_loader, test_loader):
            if loader is not None:
                loader.close()

    if main_rank:
        save_pytree(state.g.variables(), os.path.join(ckpt_dir,
                                                      "tocg_final.ckpt"))
        save_pytree(state.d.variables(), os.path.join(ckpt_dir, "D_final.ckpt"))
    board.close()
    record["step_ms"] = events.ms()
    print(f"Finished training {opt.name}!")
    return record


if __name__ == "__main__":
    main()
