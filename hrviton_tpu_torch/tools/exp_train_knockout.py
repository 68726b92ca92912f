#!/usr/bin/env python
"""Composed knockout attribution of the stage-2 training step (timing only).

PyTorch counterpart of ``tools/exp_train_knockout.py``: the stage-2 step at
``bench_train.py``'s configuration (SPADE ngf=64 'most' at 1024x768, batch 2,
bf16, taps wgrad, remat, the fused unit off as in the stage-2 CLI's
defaults, the SPADE discriminator, a frozen tocg ngf=96 at 256x192 and a
random VGG19), recorded as a CUDA graph that advances its
state once a call (``core/graphs.captured(donated=)``), timed whole, then
with one piece replaced by a stub that keeps the shapes and the state's
threading. ``step_body`` is a copy of ``GeneratorTrainer._train_step_body``
with the JAX tool's switches (``KNOCKS``; "skeleton" is all of them), so
that its full variant is the production step: ``main`` first holds one
full step against one production step from the same state, bit for bit.
"prod" is the production step itself in the same harness. Each variant is
timed in pairs with the full step, each on a state (and a frozen tocg) of
its own that every step of it advances: graphs that shared one would each
find the others' recordings written into it and record anew every call.

    python -m hrviton_tpu_torch.tools.exp_train_knockout [variant ...]

Sizes: KNOCK_TRAIN_BATCH (2), KNOCK_H, KNOCK_W, KNOCK_COND_H, KNOCK_COND_W,
KNOCK_NGF, KNOCK_TOCG_NGF, KNOCK_PAIRS (``tools/_knockout.py``);
KNOCK_TRAIN_FUSED=1 times the ``--fused_block`` step instead (the JAX
tool's TK_FUSED).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig, SPADEGenConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.losses.gan import gan_loss
from hrviton_tpu_torch.losses.matching import feature_matching_loss
from hrviton_tpu_torch.losses.perceptual import (make_vgg_loss,
                                                 vgg_perceptual_loss)
from hrviton_tpu_torch.models.condition import ConditionGenerator
from hrviton_tpu_torch.nn.layers import commit_state, drop_state, init_weights
from hrviton_tpu_torch.ops.conv3x3 import taps_wgrad
from hrviton_tpu_torch.ops.spade_block import spade_conv_unit
from hrviton_tpu_torch.tools._common import env_int
from hrviton_tpu_torch.tools._knockout import (card_name, in_pairs, knock_size,
                                               report)
from hrviton_tpu_torch.train import generator_trainer as gt
from hrviton_tpu_torch.train.condition_trainer import (apply_grads, cast_batch,
                                                       net_tensors)

__all__ = ["KNOCKS", "step_body", "build", "main"]

# the JAX tool's knocks (tools/exp_train_knockout.py:60-61)
KNOCKS = ("no_cond", "no_vgg", "no_fm", "no_d_in_g", "reuse_ng",
          "no_d_update", "no_g_bwd", "no_opt")


def _update(loss, net, knocks, backward=True):
    """``apply_grads``, or its stubs: ``no_g_bwd`` (zero gradients, the
    optimizer's update on them) and ``no_opt`` (the gradients consumed by a
    zero update of the parameters, the optimizer's state untouched)."""
    if not backward:
        grads = [torch.zeros_like(p) for p in net.opt.params]
    elif "no_opt" in knocks:
        grads = torch.autograd.grad(loss, net.opt.params, allow_unused=True)
    else:
        return apply_grads(loss, net)
    if "no_opt" in knocks:
        with torch.no_grad():
            for p, g in zip(net.opt.params, grads):
                if g is not None:
                    p.add_(g * 0)
        return
    for p, g in zip(net.opt.params, grads):
        if p.grad is None:
            p.grad = g
        else:
            graphs.hold(p.grad).copy_(g)
    net.opt.update()


def step_body(tr, g, d_net, batch, noise_g, noise_d, frozen, knocks):
    """``GeneratorTrainer._train_step_body`` with the knock switches; the
    empty set is the production body, statement for statement."""
    tcfg = tr.tcfg
    bf16 = torch.bfloat16 if tcfg.bf16 else None
    batch = cast_batch(batch, tr.dtype)
    gen, d = g.module, d_net.module
    tocg = frozen.get("tocg")
    with precision.param_dtype(bf16):
        if "no_cond" in knocks:
            # a GT-style stub of the same shapes: no frozen tocg, no warp
            with torch.no_grad():
                labels = batch["parse"][..., :7].argmax(dim=-1).int()
                parse7 = (labels[..., None] == torch.arange(
                    7, dtype=torch.int32, device=labels.device)).float()
                gen_in = torch.cat([batch["agnostic"], batch["densepose"],
                                    batch["parse_cloth"]], dim=-1)
        else:
            tocg_state = (precision.rounded_buffers(tocg, bf16)
                          if bf16 and tocg is not None
                          else contextlib.nullcontext())
            with tocg_state:
                gen_in, parse7, labels = tr.conditioning(batch, tocg)
        im = batch["image"]
        vgg = frozen.get("vgg")

        # ---- G update
        with (precision.rounded_buffers(d, bf16) if bf16
              else contextlib.nullcontext()):
            backward = "no_g_bwd" not in knocks
            with contextlib.nullcontext() if backward else torch.no_grad():
                output = gen(gen_in, labels, noise_g, train=True,
                             update_sn=True)
                if "no_d_in_g" in knocks:
                    losses = {"GAN": output.float().mean()}
                else:
                    pred_fake, pred_real = tr._d_forward(d, parse7, output, im)
                    losses = {"GAN": gan_loss(pred_fake, True, "hinge",
                                              for_discriminator=False)}
                    if not tcfg.no_gan_feat_loss and "no_fm" not in knocks:
                        losses["GAN_Feat"] = feature_matching_loss(
                            pred_fake, pred_real, tcfg.lambda_feat)
                if not tcfg.no_vgg_loss and "no_vgg" not in knocks:
                    losses["VGG"] = torch.utils.checkpoint.checkpoint(
                        vgg_perceptual_loss, vgg, output, im,
                        use_reentrant=False, preserve_rng_state=False
                    ) * tcfg.lambda_vgg
                loss_g = sum(losses.values())
            _update(loss_g, g, knocks, backward)
        commit_state(gen)

        # ---- D update on a fresh no-gradient output of the updated G
        if "no_d_update" in knocks:
            loss_d = l_fake = l_real = torch.zeros((), device=im.device)
        else:
            if "reuse_ng" in knocks:
                output_ng = output.detach()
            else:
                with torch.no_grad():
                    output_ng = gen(gen_in, labels, noise_d, train=True)
                drop_state(gen)
            pred_fake, pred_real = tr._d_forward(d, parse7, output_ng, im,
                                                 update_sn=True)
            l_fake = gan_loss(pred_fake, False, "hinge", for_discriminator=True)
            l_real = gan_loss(pred_real, True, "hinge", for_discriminator=True)
            loss_d = l_fake + l_real
            _update(loss_d, d_net, knocks)
            commit_state(d)

    metrics = {f"loss/gen/{k}": v.detach() for k, v in losses.items()}
    metrics.update({"loss/gen": loss_g.detach(), "loss/dis": loss_d.detach(),
                    "loss/dis/adv_fake": l_fake.detach(),
                    "loss/dis/adv_real": l_real.detach()})
    return metrics


def _knocked_step(tr, g, d, batch, fields_g, fields_d, frozen, knocks):
    with taps_wgrad(tr.tcfg.taps_wgrad), precision.no_tf32(), \
            mesh_lib.sharded(tr.mesh):
        return mesh_lib.mean_metrics(step_body(tr, g, d, batch, fields_g,
                                               fields_d, frozen, knocks))


# one graph per knock set (a static argument), donating the state as the
# production step does, in the production step's pool
_step = graphs.captured(
    _knocked_step,
    weights=lambda tr, g, d, batch, fg, fd, frozen, knocks:
    graphs.module_tensors(frozen.get("vgg"), frozen.get("tocg")),
    donated=lambda tr, g, d, *_: net_tensors(g, d), pool=gt._POOL)


def build(device, seed=0):
    """(trainer, batch, new_run) at the tool's size: the trainer as
    ``bench_train.py`` configures it, a batch of standard normals (the parse
    a one-hot of 13 labels), and ``new_run(knocks)`` -> (run, state): a step
    of a state of its own made from ``seed``, with a frozen tocg of its own
    (a bf16 step rounds the tocg's statistics in place and back, a write
    that would make every other graph reading it record anew) and the one
    random VGG; "prod" for the production step."""
    size = knock_size()
    b = env_int("KNOCK_TRAIN_BATCH", 2)
    fh, fw, ch, cw = size.fh, size.fw, size.ch, size.cw
    vgg = make_vgg_loss(None, seed, device=device).vgg
    tr = gt.GeneratorTrainer(
        SPADEGenConfig(ngf=size.ngf, fine_height=fh, fine_width=fw,
                       num_upsampling_layers="most",
                       fused_block=bool(env_int("KNOCK_TRAIN_FUSED", 0))),
        SPADEDiscriminatorConfig(),
        GeneratorTrainConfig(batch_size=b, bf16=True, taps_wgrad=True),
        PipelineConfig(fine_height=fh, fine_width=fw, cond_height=ch,
                       cond_width=cw), TOCGConfig(ngf=size.tocg_ngf),
        device=device)
    rng = np.random.default_rng(seed)

    def a(c):
        return torch.from_numpy(rng.standard_normal(
            (b, fh, fw, c), dtype=np.float32)).to(device)
    labels = rng.integers(0, 13, (b, fh, fw))
    batch = {"cloth": a(3),
             "cloth_mask": torch.from_numpy(rng.uniform(
                 0, 1, (b, fh, fw, 1)).astype(np.float32)).to(device),
             "parse_agnostic": a(13), "densepose": a(3), "agnostic": a(3),
             "image": a(3),
             "parse": torch.from_numpy((labels[..., None] == np.arange(13))
                                       .astype(np.float32)).to(device),
             "parse_cloth": a(3)}

    def new_run(knocks):
        tocg = ConditionGenerator(TOCGConfig(ngf=size.tocg_ngf),
                                  device=device).eval()
        init_weights(tocg, torch.Generator().manual_seed(seed))
        tocg.requires_grad_(False)
        state = tr.init(seed)
        return _runner(tr, state, batch, {"vgg": vgg, "tocg": tocg},
                       knocks), state
    return tr, batch, new_run


def _runner(tr, state, batch, frozen, knocks):
    """One step of ``state`` (the production step for "prod"), its noise
    drawn before it, the optimizers' rate set before and counted after, as
    ``train_step`` does."""
    n = batch["image"].shape[0]
    gen = state.g.module
    noise = torch.Generator(device=tr.device).manual_seed(1)

    def run():
        if knocks == "prod":
            return tr.train_step(state, batch, noise, noise, frozen)[1]
        fields_g = tr.noise_fields(gen, noise, n)
        fields_d = tr.noise_fields(gen, noise, n)
        for opt in (state.g.opt, state.d.opt):
            opt.prepare()
        metrics = _step(tr, state.g, state.d, batch, fields_g, fields_d,
                        frozen, frozenset(knocks))
        for opt in (state.g.opt, state.d.opt):
            opt.advance()
        state.step += 1
        return metrics
    return run


@contextlib.contextmanager
def _cudnn(benchmark: bool, deterministic: bool):
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = benchmark, deterministic
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def full_equals_production(new_run):
    """One full-variant step and one production step, each from a state made
    from the same seed with the same noise, cuDNN deterministic (its
    default weight gradients sum in another order from run to run): every
    tensor of the two states (parameters, buffers, Adam moments and counts)
    and every metric bit for bit. Returns the number of tensors compared;
    raises if one differs."""
    (prod, a), (full, b) = new_run("prod"), new_run(())
    with _cudnn(False, True):
        ma, mb = prod(), full()
    ta, tb = net_tensors(a.g, a.d), net_tensors(b.g, b.d)
    bad = [i for i, (x, y) in enumerate(zip(ta, tb)) if not torch.equal(x, y)]
    bad += [k for k in ma if not torch.equal(ma[k], mb[k])]
    if bad or len(ta) != len(tb) or set(ma) != set(mb):
        raise RuntimeError(f"the full variant's step is not the production "
                           f"step: {len(bad)} tensors or metrics differ")
    return len(ta)


def main(which=(), device="cuda"):
    """Hold the full variant against the production step, then time the
    named variants (default: prod, each knock, skeleton), each on a state of
    its own, in pairs with the full step, cuDNN's autotuning off as the
    training CLIs run; returns the times (``in_pairs``). With the fused
    unit off (the CLI's default) a step that launched it raises."""
    dev = resolve_device(device)
    size = knock_size()
    tr, batch, new_run = build(dev)
    fused = tr.gen_cfg.fused_block
    print(f"stage-2 step: fused unit {'on' if fused else 'off'}, taps wgrad "
          f"{'on' if tr.tcfg.taps_wgrad else 'off'}, remat "
          f"{'on' if tr.gen_cfg.remat else 'off'}, bf16 {tr.tcfg.bf16}", flush=True)
    units = spade_conv_unit.launches
    n = full_equals_production(new_run)
    print(f"stage-2 step: the full variant equals the production step bit for "
          f"bit ({n} state tensors and the metrics)", flush=True)
    names = which or ("prod", *KNOCKS, "skeleton")
    tags = {nm: "prod" if nm == "prod" else KNOCKS if nm == "skeleton" else (nm,)
            for nm in names}
    with _cudnn(False, torch.backends.cudnn.deterministic):
        times = in_pairs(new_run(())[0],
                         {nm: new_run(t)[0] for nm, t in tags.items()},
                         size.pairs, dev)
    if not fused and spade_conv_unit.launches != units:
        raise RuntimeError(f"the stage-2 step launched the fused unit "
                           f"{spade_conv_unit.launches - units} times with "
                           f"fused_block off")
    report(f"stage-2 step b{batch['image'].shape[0]} {size.fh}x{size.fw}"
           + (" --fused_block" if fused else ""), times, card_name(dev))
    return times


if __name__ == "__main__":
    main(tuple(sys.argv[1:]))
