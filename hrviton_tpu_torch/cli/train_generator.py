"""Stage-2 training CLI: the port's counterpart of
``hrviton_tpu/cli/train_generator.py`` (reference train_generator.py), the
same flags and defaults, plus ``--device`` (default ``cuda``)::

    python -m hrviton_tpu_torch.cli.train_generator --name run \\
        --dataroot ROOT --test_dataroot ROOT --tocg_checkpoint tocg.ckpt \\
        --vgg_weights vgg19.ckpt --lpips_weights lpips.ckpt

The frozen tocg conditions the SPADE generator, trained against its
multiscale discriminator with TTUR and the linear decay
(``GeneratorTrainer``), with in-train LPIPS validation over
--lpips_samples test images every --lpips_count steps (batches of
--lpips_batch, the port's ``losses/lpips.py``), TensorBoard grids and
checkpoints as the JAX CLI writes them (``gen_*.ckpt``, ``dis_*.ckpt``).
The training defaults hold: the fused unit off (``--fused_block`` turns it
on), remat and D remat on (``--no_remat``, ``--no_d_remat``), the taps
weight gradient on (``--no_taps_wgrad``). On the card the step, the
LPIPS validation's ``generate`` and ``lpips_resize``, the grids'
``generate_debug`` and the batches' ``expand`` replay CUDA graphs recorded
once per signature (``core/graphs.py``), as the JAX CLI jits them; no flag
turns that off. The SPADE noise of the steps,
of the LPIPS validation and of the grids comes from three generators
seeded from --seed, so the training's draws do not depend on the
validation's cadence.

``build_training(opt, mesh)`` builds what the steps need (the trainer, its
state, the frozen networks, the steps' noise, ``put``) and
``train_step(...)`` is one step of the loop: the batch to the device, then
the trainer's step, under the host root span ``train_step`` when tracing is
on (``utils/profiling``). The benchmark drives the same two functions.

Data parallel: start one process a device, each with the same
``--coordinator host:port`` and ``--num_processes N`` and its own
``--process_id`` (``cli/common.start_mesh``); -b and --lpips_batch stay
global batches, of which each rank loads its rows. The metrics and the
LPIPS printed are the ranks' averages; rank 0 alone writes the
checkpoints, the board and the grids. ``main`` returns the run's record:
the metrics of every displayed step, the LPIPS values, the steps'
CUDA-event times on a card and the checkpoint directory (rank 0's files),
and tears the group down.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from hrviton_tpu_torch.cli.common import (StepEvents, add_data_flags,
                                          add_ignored_reference_flags,
                                          add_multihost_flags,
                                          add_spade_flags, add_tocg_flags,
                                          batch_to_device,
                                          check_pretrained_backbone,
                                          data_cfg_from_args,
                                          expandable_segments,
                                          load_gen_variables,
                                          load_tocg_variables, start_mesh)
from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig, SPADEGenConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.losses.lpips import make_lpips
from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
from hrviton_tpu_torch.models.condition import ConditionGenerator
from hrviton_tpu_torch.nn.layers import init_weights
from hrviton_tpu_torch.ops.resize import interpolate
from hrviton_tpu_torch.train.checkpoint import load_pytree, save_pytree
from hrviton_tpu_torch.train.generator_trainer import GeneratorTrainer
from hrviton_tpu_torch.train.state import GANState
from hrviton_tpu_torch.utils import profiling
from hrviton_tpu_torch.utils.logging import Board
from hrviton_tpu_torch.utils.vis import make_image_grid, visualize_segmap

__all__ = ["get_opt", "main", "lpips_resize", "build_training", "train_step",
           "Training", "TrainStep"]


def get_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True)
    add_data_flags(p, dataroot="./data/", datamode="train",
                   data_list="train_pairs.txt", fine_width=768,
                   fine_height=1024, batch_size=8)
    add_tocg_flags(p)
    add_ignored_reference_flags(p, "--cuda", "--gpu_ids", "--GMM_const", "--grid_size",
                                "--lambda_l1", "--netD_subarch", "--radius")
    add_spade_flags(p)
    p.add_argument("--tensorboard_dir", default="tensorboard")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--tocg_checkpoint", default="")
    p.add_argument("--gen_checkpoint", default="")
    p.add_argument("--dis_checkpoint", default="")
    p.add_argument("--vgg_weights", default="")
    p.add_argument("--lpips_weights", default="")
    p.add_argument("--taps_wgrad", action="store_true", default=True,
                   help="3x3 conv weight gradients as nine tap products over "
                        "row chunks, no im2col buffer (ops/conv3x3.py). "
                        "Default on; --no_taps_wgrad takes the library's")
    p.add_argument("--no_taps_wgrad", dest="taps_wgrad", action="store_false")
    p.add_argument("--fused_block", action="store_true",
                   help="the fused SPADE unit kernel in the TRAINING "
                        "generator (default off, as in the JAX CLI; its "
                        "backward is autograd of the plain unit)")
    p.add_argument("--no_remat", dest="remat", action="store_false",
                   default=True,
                   help="keep the SPADE blocks' activations instead of "
                        "recomputing them in backward")
    p.add_argument("--no_d_remat", dest="d_remat", action="store_false",
                   default=True,
                   help="keep the discriminator's activations instead of "
                        "recomputing them in backward")
    p.add_argument("--allow_random_vgg", action="store_true",
                   help="run with a randomly initialized VGG19 perceptual "
                        "backbone (changes the training objective; smoke "
                        "tests only)")
    p.add_argument("--tensorboard_count", type=int, default=100)
    p.add_argument("--display_count", type=int, default=100)
    p.add_argument("--save_count", type=int, default=10000)
    p.add_argument("--load_step", type=int, default=0)
    p.add_argument("--keep_step", type=int, default=100000)
    p.add_argument("--decay_step", type=int, default=100000)
    p.add_argument("--lpips_count", type=int, default=1000)
    p.add_argument("--lpips_samples", type=int, default=500)
    p.add_argument("--lpips_batch", type=int, default=10,
                   help="batch size of the in-train LPIPS validation (the "
                        "metric is a mean of per-image distances, so "
                        "batching is exact)")
    p.add_argument("--test_datasetting", default="paired")
    p.add_argument("--test_dataroot", default="./data/")
    p.add_argument("--test_data_list", default="test_pairs.txt")
    p.add_argument("--num_test_visualize", type=int, default=3,
                   help="unpaired test_images/i grid count per tensorboard "
                        "tick (train_generator.py:110,471)")
    p.add_argument("--G_lr", type=float, default=1e-4)
    p.add_argument("--D_lr", type=float, default=4e-4)
    p.add_argument("--no_ganFeat_loss", action="store_true")
    p.add_argument("--no_vgg_loss", action="store_true")
    p.add_argument("--lambda_feat", type=float, default=10.0)
    p.add_argument("--lambda_vgg", type=float, default=10.0)
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--ndf", type=int, default=64)
    p.add_argument("--norm_D", default="spectralinstance")
    p.add_argument("--GT", action="store_true")
    p.add_argument("--cond_height", type=int, default=256)
    p.add_argument("--cond_width", type=int, default=192)
    p.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                   help="bf16 compute / f32 params (the reference's --fp16)")
    p.add_argument("--seed", type=int, default=0)
    add_multihost_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device of the training ('cpu' runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def _grid_panels(tb, out, warped, fpg, i):
    """The reference's 10 panels (train_generator.py:366-476)."""
    f = lambda t: t.float().cpu().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)
    dp = f(tb["densepose"][i])
    return [
        f(tb["cloth"][i]) / 2 + 0.5,
        np.repeat(f(tb["cloth_mask"][i]), 3, -1),
        (dp + 1) / 2,
        visualize_segmap(f(tb["parse_agnostic"]), i),
        f(warped[i]) / 2 + 0.5,
        f(tb["agnostic"][i]) / 2 + 0.5,
        dp / 2 + 0.5,
        visualize_segmap(f(fpg), i),
        f(out[i]) / 2 + 0.5,
        f(tb["image"][i]) / 2 + 0.5,
    ]


@torch.inference_mode()
def lpips_resize(lpips, a, b):
    """LPIPS of two NHWC batches resized bilinearly to 128x128 (the JAX
    CLI's jitted ``lpips_resize``); one graph per signature on the card."""
    return _lpips_resize(lpips, a, b)


@graphs.captured(weights=lambda lpips, *_: graphs.module_tensors(lpips.model))
def _lpips_resize(lpips, a, b):
    return lpips(interpolate(a.float(), (128, 128), mode="bilinear"),
                 interpolate(b.float(), (128, 128), mode="bilinear"))


def main(argv=None):
    opt = get_opt(argv)
    print(opt)
    # fail fast, before dataset construction
    if not opt.no_vgg_loss:
        check_pretrained_backbone(opt.vgg_weights,
                                  what="VGG19 (perceptual loss)",
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


class Training(NamedTuple):
    """What ``build_training`` builds for the steps."""
    trainer: GeneratorTrainer
    state: GANState
    frozen: Dict                # {'vgg': Vgg19Features, 'tocg': the tocg or None}
    noise: torch.Generator      # the steps' SPADE noise
    put: Callable               # a loader batch to the device (``put(raw)``)
    compact: bool               # the loader yields compact batches


class TrainStep(NamedTuple):
    state: GANState
    metrics: Dict[str, torch.Tensor]
    batch: Dict                 # the step's batch on the device


def build_training(opt, mesh) -> Training:
    """The CLI's trainer from its flags: the configurations, the frozen tocg
    (the checkpoint's weights, else random from seed 0) and VGG19 (the
    flag's weights, else random), the initial state (the generator's
    checkpoint loaded where there is one, every rank on rank 0's weights),
    the steps' noise generator (``--seed`` + 1) and ``put``. Building the
    networks is the host span ``trainer.init``."""
    dev = mesh.device
    tcfg = GeneratorTrainConfig(
        batch_size=opt.batch_size, keep_step=opt.keep_step,
        decay_step=opt.decay_step, g_lr=opt.G_lr, d_lr=opt.D_lr,
        lambda_feat=opt.lambda_feat, lambda_vgg=opt.lambda_vgg,
        no_gan_feat_loss=opt.no_ganFeat_loss, no_vgg_loss=opt.no_vgg_loss,
        gt_mode=opt.GT, occlusion=opt.occlusion,
        clothmask_composition=opt.clothmask_composition,
        lpips_count=opt.lpips_count, display_count=opt.display_count,
        save_count=opt.save_count, tensorboard_count=opt.tensorboard_count,
        load_step=opt.load_step, bf16=opt.bf16, taps_wgrad=opt.taps_wgrad,
        d_remat=opt.d_remat)
    pcfg = PipelineConfig(fine_height=opt.fine_height, fine_width=opt.fine_width,
                          cond_height=opt.cond_height, cond_width=opt.cond_width,
                          clothmask_composition=opt.clothmask_composition,
                          occlusion=opt.occlusion)
    gen_cfg = SPADEGenConfig(ngf=opt.ngf, gen_semantic_nc=opt.gen_semantic_nc,
                             num_upsampling_layers=opt.num_upsampling_layers,
                             norm_g=opt.norm_G, fine_height=opt.fine_height,
                             fine_width=opt.fine_width,
                             fused_block=opt.fused_block, remat=opt.remat)
    d_cfg = SPADEDiscriminatorConfig(gen_semantic_nc=opt.gen_semantic_nc,
                                     ndf=opt.ndf, n_layers_d=opt.n_layers_D,
                                     num_d=opt.num_D,
                                     no_gan_feat_loss=opt.no_ganFeat_loss)

    with profiling.span("trainer.init"):
        # the frozen tocg: the checkpoint's weights, else random from seed 0
        tocg_cfg = tocg = None
        if not opt.GT:
            tocg_cfg = TOCGConfig(ngf=96, warp_feature=opt.warp_feature,
                                  out_layer=opt.out_layer)
            tocg = ConditionGenerator(tocg_cfg, device=dev).eval()
            init_weights(tocg, torch.Generator().manual_seed(0))
            if opt.tocg_checkpoint:
                load_tocg_variables(opt.tocg_checkpoint, tocg, opt.out_layer)
            tocg.requires_grad_(False)
        vgg = make_vgg_loss(load_pytree(opt.vgg_weights) if opt.vgg_weights
                            else None, device=dev).vgg
        trainer = GeneratorTrainer(gen_cfg, d_cfg, tcfg, pcfg, tocg_cfg,
                                   device=dev, mesh=mesh)
        state = trainer.init(opt.seed)
    if opt.gen_checkpoint and os.path.exists(opt.gen_checkpoint):
        load_gen_variables(opt.gen_checkpoint, state.g.module,
                           opt.num_upsampling_layers)
    # every rank starts from rank 0's weights
    for module in (state.g.module, state.d.module, tocg):
        if module is not None:
            mesh_lib.broadcast_module(module, mesh)

    compact = not opt.no_device_preprocess

    def put(raw, cloth="paired", expand=compact):
        # flatten the cloth keys (train_generator.py:195-196)
        raw = dict(raw)
        raw["cloth"] = raw["cloth"][cloth]
        raw["cloth_mask"] = raw["cloth_mask"][cloth]
        return batch_to_device(raw, dev, expand, opt.semantic_nc)

    noise = torch.Generator(device=dev).manual_seed(opt.seed + 1)
    return Training(trainer, state, {"vgg": vgg, "tocg": tocg}, noise, put,
                    compact)


def train_step(trainer: GeneratorTrainer, state: GANState, raw, noise,
               frozen, put, events: Optional[StepEvents] = None) -> TrainStep:
    """One step of the CLI's loop: the loader's batch to the device
    (``put``), then ``GeneratorTrainer.train_step`` (``events`` around it
    alone). With tracing on it is a request's root span, ``train_step``."""
    with profiling.span("train_step"):
        batch = put(raw)
        if events is not None:
            events.start()
        state, metrics = trainer.train_step(state, batch, noise, noise, frozen)
        if events is not None:
            events.stop()
    return TrainStep(state, metrics, batch)


def _train(opt, mesh):
    from hrviton_tpu_torch.data.dataset import VitonHDDataset
    from hrviton_tpu_torch.data.loader import Loader

    dev = mesh.device
    rows = dict(process_id=mesh.rank, num_processes=mesh.world_size)
    trainer, state, frozen, noise, put, compact = build_training(opt, mesh)
    tcfg, tocg = trainer.tcfg, frozen["tocg"]
    # random LPIPS only corrupts the in-train metric, not the objective: warn
    check_pretrained_backbone(opt.lpips_weights, what="LPIPS (in-train metric)",
                              flag="--lpips_weights", allowed=False,
                              allow_flag="--lpips_weights", refuse=False)
    lpips = make_lpips(load_pytree(opt.lpips_weights) if opt.lpips_weights
                       else None, device=dev)

    # data
    train_ds = VitonHDDataset(data_cfg_from_args(opt), mode="train",
                              compact=compact)
    train_loader = Loader(train_ds, opt.batch_size, shuffle=True,
                          num_workers=opt.workers, seed=opt.seed,
                          worker_processes=opt.worker_processes, **rows)
    test_cfg = dataclasses.replace(
        data_cfg_from_args(opt, mode="test", data_list=opt.test_data_list),
        dataroot=opt.test_dataroot)
    test_ds = VitonHDDataset(test_cfg, mode="test_gen")
    # batched LPIPS validation: the mean of per-image distances is exact
    # under equal-size batches
    n_eval = min(opt.lpips_samples, len(test_ds))
    lpips_batch = max(1, min(opt.lpips_batch, n_eval))
    lpips_iters = max(1, n_eval // lpips_batch)
    if lpips_iters * lpips_batch != n_eval:
        print(f"note: lpips_batch={lpips_batch} does not divide "
              f"{n_eval} eval samples; scoring {lpips_iters * lpips_batch}")
    test_loader = Loader(test_ds, lpips_batch, shuffle=False,
                         num_workers=opt.workers,
                         indices=range(lpips_iters * lpips_batch), **rows)
    # the unpaired grids' loader (train_generator.py:618-624)
    vis_loader = Loader(test_ds, min(opt.num_test_visualize, len(test_ds)),
                        shuffle=True, num_workers=0, seed=opt.seed + 7)

    main_rank = mesh.is_main
    board = Board(os.path.join(opt.tensorboard_dir, opt.name) if main_rank
                  else None)
    ckpt_dir = os.path.join(opt.checkpoint_dir, opt.name)
    # the LPIPS validation's and the grids' noise (the steps' is the
    # training's)
    eval_noise, vis_noise = (torch.Generator(device=dev).manual_seed(opt.seed + k)
                             for k in (2, 3))
    events = StepEvents(dev)
    record = {"metrics": [], "lpips": [], "ckpt_dir": ckpt_dir}

    t0 = time.time()
    try:
        for step in range(opt.load_step, opt.keep_step + opt.decay_step):
            state, metrics, batch = train_step(
                trainer, state, train_loader.next_batch(), noise, frozen, put,
                events)

            if (step + 1) % tcfg.display_count == 0:
                m = {k: float(v) for k, v in metrics.items()}
                record["metrics"].append(m)
                print(f"step {step + 1} t={time.time() - t0:.1f}s " +
                      " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())),
                      flush=True)
            if (step + 1) % tcfg.tensorboard_count == 0 and main_rank:
                board.scalars({k: float(v) for k, v in metrics.items()},
                              step + 1)
                out, warped, fpg = trainer.generate_debug(state, batch,
                                                          vis_noise, tocg)
                board.image_grid("train_images", make_image_grid(
                    _grid_panels(batch, out, warped, fpg, 0), nrow=4), step + 1)
                # unpaired cloth for the test grids (train_generator.py:391-392)
                vb = put(vis_loader.next_batch(), "unpaired", False)
                out, warped, fpg = trainer.generate_debug(state, vb, vis_noise,
                                                          tocg)
                for i in range(out.shape[0]):
                    board.image_grid(f"test_images/{i}", make_image_grid(
                        _grid_panels(vb, out, warped, fpg, i), nrow=4), step + 1)
            if (step + 1) % tcfg.lpips_count == 0:
                dists = []
                for _ in range(lpips_iters):
                    tb = mesh_lib.shard_eval_batch(
                        mesh, put(test_loader.next_batch(), expand=False))
                    out = trainer.generate(state, tb, eval_noise, tocg)
                    dists.append(float(
                        lpips_resize(lpips, tb["image"], out).mean()))
                dist_mean = mesh_lib.all_mean(np.mean(dists), mesh)
                board.scalar("test/LPIPS", dist_mean, step + 1)
                record["lpips"].append(dist_mean)
                print(f"LPIPS {dist_mean:.4f}", flush=True)
            if (step + 1) % tcfg.save_count == 0 and main_rank:
                save_pytree(state.g.variables(), os.path.join(
                    ckpt_dir, f"gen_step_{step + 1:06d}.ckpt"))
                save_pytree(state.d.variables(), os.path.join(
                    ckpt_dir, f"dis_step_{step + 1:06d}.ckpt"))
    finally:
        for loader in (train_loader, test_loader, vis_loader):
            loader.close()

    if main_rank:
        save_pytree(state.g.variables(), os.path.join(ckpt_dir,
                                                      "gen_model_final.ckpt"))
        save_pytree(state.d.variables(), os.path.join(ckpt_dir,
                                                      "dis_model_final.ckpt"))
    board.close()
    record["step_ms"] = events.ms()
    print(f"Finished training {opt.name}!")
    return record


if __name__ == "__main__":
    main()
