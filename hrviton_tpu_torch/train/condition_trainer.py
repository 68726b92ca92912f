"""Stage-1 training: the try-on condition generator and its multiscale
discriminator (``hrviton_tpu/train/condition_trainer.py``, reference
train_condition.py:113-312):

  G loss = 10 L1(warped cloth mask) + VGG(warped cloth) + tv_lambda TV
           + 10 CE(segmap) + 1 LSGAN,   D loss = LSGAN(fake) + LSGAN(real).

One ``train_step`` takes the G update and then the D update, as the JAX
step does: the G gradient goes to the tocg's parameters only
(``torch.autograd.grad``; the discriminator inside the G loss keeps no
gradient), the tocg's BatchNorm statistics are written after its forward,
the D step judges the detached fake (or, with ``g_d_separate``, a fresh
forward of the updated tocg whose statistics are dropped) with one power
iteration in the fake call only. The whole step runs with TF32 off.

On the card ``train_step``, ``visualize`` and ``eval_iou`` replay CUDA
graphs recorded once per batch signature (``core/graphs.py``) into one
memory pool, the counterparts of the JAX trainer's jits; the step's graph
advances the networks, their optimizers and the dropout generator in place,
once a call (``donate_argnums=1``). The learning rates, the optimizers'
counts and ``state.step`` move on the host around it. On the CPU they are
plain calls.

Data parallel (``core/mesh.py``): with a mesh of several ranks each rank
steps on its rows of the global batch; the gradients, the BatchNorm
statistics, the ``--Ddropout`` masks (drawn at the global shape) and the
metrics are reduced across the ranks, so the step equals the one-process
step on the global batch.

bf16 (``ConditionTrainConfig.bf16``): parameters and Adam state stay f32;
the batch is cast to bf16 and every parameter is read rounded to bf16
(``core/precision.param_dtype``), the discriminator's state too in the G
step, as the JAX step casts its variable trees; gradients arrive in f32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                      ConditionTrainConfig, TOCGConfig)
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.losses.gan import lsgan_loss
from hrviton_tpu_torch.losses.perceptual import (vgg_features,
                                                 vgg_perceptual_loss)
from hrviton_tpu_torch.losses.seg import cross_entropy2d, iou_metric
from hrviton_tpu_torch.losses.tv import flow_tv_suite
from hrviton_tpu_torch.models.condition import ConditionGenerator
from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
from hrviton_tpu_torch.nn.layers import commit_state, drop_state, init_weights
from hrviton_tpu_torch.ops.grid_sample import grid_sample, make_grid
from hrviton_tpu_torch.ops.resize import resize_flow
from hrviton_tpu_torch.pipelines.tryon import compose_clothmask, remove_overlap
from hrviton_tpu_torch.train.optim import adam
from hrviton_tpu_torch.train.state import GANState, NetState

__all__ = ["ConditionTrainer", "prep_batch", "cast_batch", "apply_grads",
           "put_grads", "net_tensors"]


def cast_batch(tree, dtype):
    """Every floating tensor of a (nested) batch dict cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_batch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def prep_batch(batch) -> Dict[str, torch.Tensor]:
    """The tocg's inputs and targets (train_condition.py:135-155)."""
    cm = (batch["cloth_mask"]["paired"] > 0.5).float()
    return dict(
        input1=torch.cat([batch["cloth"]["paired"], cm], dim=-1),
        input2=torch.cat([batch["parse_agnostic"], batch["densepose"]], dim=-1),
        cm=cm,
        label_onehot=batch["parse_onehot"].long(),
        label=batch["parse"],
        pcm=batch["pcm"],
        im_c=batch["parse_cloth"],
    )


def apply_grads(loss, net: NetState):
    """``put_grads``, then the optimizer's update (``Adam.update``: the
    caller sets its learning rate before the step and counts it after)."""
    put_grads(loss, net)
    net.opt.update()


def put_grads(loss, net: NetState):
    """The gradient of ``loss`` with respect to ``net``'s parameters alone,
    averaged across the ranks of an active mesh (``core/mesh.sharded``),
    put in their ``.grad``. After the first call the gradients are copied
    into the ``.grad`` it made: a recorded step writes them outside its
    pool, which it shares with the eval calls (``graphs.Pool``)."""
    params = net.opt.params
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    mesh_lib.average_grads(grads)
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g
        else:
            graphs.hold(p.grad).copy_(g)


def net_tensors(*nets: NetState):
    """What a training step writes in place: the networks' parameters and
    buffers, their optimizers' moments and step counts."""
    return [t for net in nets for t in
            graphs.module_tensors(net.module) + net.opt.state_tensors()]


def _train_step(trainer: "ConditionTrainer", g: NetState, d: NetState, batch,
                vgg):
    with mesh_lib.sharded(trainer.mesh):
        metrics = trainer._train_step_body(g, d, batch, vgg)
        return mesh_lib.mean_metrics(metrics)


# the step's and the eval calls' graphs, one memory pool
_POOL = graphs.Pool()

# the counterpart of the JAX step's jit with its state donated
_step = graphs.captured(
    _train_step,
    weights=lambda trainer, g, d, batch, vgg: graphs.module_tensors(vgg),
    donated=lambda trainer, g, d, *_: net_tensors(g, d) + [trainer.dropout],
    pool=_POOL)


def _visualize(trainer: "ConditionTrainer", tocg, batch):
    prep = prep_batch(batch)
    with precision.no_tf32():
        _, seg, warped_c, warped_cm = tocg(prep["input1"], prep["input2"])
    warped_cm_onehot = (warped_cm > 0.5).float()
    seg = compose_clothmask(seg, warped_cm, trainer.tcfg.clothmask_composition)
    if trainer.tcfg.occlusion:
        warped_cm = remove_overlap(torch.softmax(seg, -1), warped_cm)
        warped_c = warped_c * warped_cm + (1.0 - warped_cm)
    fake_cm = (seg.argmax(dim=-1, keepdim=True) == 3).float()
    misalign = (fake_cm - warped_cm_onehot).clamp(min=0.0)
    return dict(seg_softmax=torch.softmax(seg, -1), warped_cloth=warped_c,
                warped_cm_onehot=warped_cm_onehot, misalign=misalign)


def _eval_iou(trainer: "ConditionTrainer", tocg, batch):
    prep = prep_batch(batch)
    with precision.no_tf32():
        _, seg, _, warped_cm = tocg(prep["input1"], prep["input2"])
    seg = compose_clothmask(seg, warped_cm, trainer.tcfg.clothmask_composition)
    return iou_metric(torch.softmax(seg, dim=-1), prep["label"])


_tocg_weights = lambda trainer, tocg, *_: graphs.module_tensors(tocg)
_visualize_graph = graphs.captured(_visualize, weights=_tocg_weights,
                                   pool=_POOL)
_eval_iou_graph = graphs.captured(_eval_iou, weights=_tocg_weights, pool=_POOL)


class ConditionTrainer:
    def __init__(self, tocg_cfg: TOCGConfig, d_cfg: CondDiscriminatorConfig,
                 tcfg: ConditionTrainConfig, device="cuda",
                 mesh: Optional[mesh_lib.Mesh] = None):
        """``mesh``: the data-parallel layout (``core/mesh.make_mesh``);
        each step's batch is then the rank's rows of the global batch."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tocg_cfg, self.d_cfg, self.tcfg = tocg_cfg, d_cfg, tcfg
        self.dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
        # the discriminator's dropout masks (--Ddropout)
        self.dropout = torch.Generator(device=self.device).manual_seed(0)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> GANState:
        """Both networks with random weights from ``seed`` and their Adam
        optimizers."""
        tcfg = self.tcfg
        g = torch.Generator().manual_seed(seed)
        tocg = ConditionGenerator(self.tocg_cfg, device=self.device)
        d = CondMultiscaleDiscriminator(self.d_cfg, device=self.device)
        init_weights(tocg, g)
        init_weights(d, g)
        self.dropout.manual_seed(seed + 1)
        return GANState(
            step=0,
            g=NetState(tocg, adam(tocg.parameters(), tcfg.g_lr, tcfg.beta1,
                                  tcfg.beta2)),
            d=NetState(d, adam(d.parameters(), tcfg.d_lr, tcfg.beta1,
                               tcfg.beta2)))

    def _policy(self):
        return precision.param_dtype(torch.bfloat16 if self.tcfg.bf16 else None)

    # ------------------------------------------------------------ tocg losses
    def _forward_and_losses(self, tocg, d, vgg, prep, train: bool = True):
        """The G loss (train_condition.py:157-266): (loss_g, (seg_softmax,
        losses))."""
        tcfg = self.tcfg
        flow_list, seg, warped_c, warped_cm = tocg(
            prep["input1"], prep["input2"], train=train)
        seg = compose_clothmask(seg, warped_cm, tcfg.clothmask_composition)

        if tcfg.occlusion:
            warped_cm = remove_overlap(torch.softmax(seg, dim=-1), warped_cm)
            warped_c = warped_c * warped_cm + (1.0 - warped_cm)

        loss_l1 = torch.mean((warped_cm - prep["pcm"]).abs())
        # one target tower for the main and the interflow VGG terms
        im_c_feats = vgg_features(vgg, prep["im_c"])
        loss_vgg = vgg_perceptual_loss(vgg, warped_c, y_feats=im_c_feats)
        loss_tv = flow_tv_suite(
            flow_list, warped_clothmask=warped_cm,
            edgeawaretv=tcfg.edgeawaretv, lasttvonly=tcfg.lasttvonly,
            add_lasttv=tcfg.add_lasttv)

        if tcfg.interflowloss:
            # the intermediate warps (train_condition.py:237-248), each flow
            # normalized by its own extent, upsampled with opt.upsample
            n, ih, iw, _ = prep["input1"].shape
            grid = make_grid(n, ih, iw, prep["input1"].device)
            cloth = prep["input1"][..., :3]
            cmask = prep["cm"]
            seg_softmax = torch.softmax(seg, dim=-1)
            for i, flow in enumerate(flow_list[:-1]):
                fh, fw = flow.shape[1:3]
                fl = resize_flow(flow, (ih, iw), mode=self.tocg_cfg.upsample)
                fn = torch.stack([fl[..., 0] / ((fw - 1.0) / 2.0),
                                  fl[..., 1] / ((fh - 1.0) / 2.0)], dim=-1)
                wc = grid_sample(cloth, fn + grid, padding_mode="border")
                wm = grid_sample(cmask, fn + grid, padding_mode="border")
                wm = remove_overlap(seg_softmax, wm)
                loss_l1 = loss_l1 + torch.mean((wm - prep["pcm"]).abs()) / 2 ** (4 - i)
                loss_vgg = loss_vgg + vgg_perceptual_loss(
                    vgg, wc, y_feats=im_c_feats) / 2 ** (4 - i)

        ce = cross_entropy2d(seg, prep["label_onehot"])
        losses = dict(l1_cloth=loss_l1, vgg=loss_vgg, tv=loss_tv, ce=ce)
        loss_g = (tcfg.l1_lambda * loss_l1 + loss_vgg + tcfg.tv_lambda * loss_tv
                  + ce * tcfg.ce_lambda)

        seg_softmax = torch.softmax(seg, dim=-1)
        if not tcfg.no_gan_loss:
            d_in = torch.cat([prep["input1"].detach(), prep["input2"].detach(),
                              seg_softmax], dim=-1)
            pred = d(d_in, train=True, generator=self.dropout)
            g_gan = lsgan_loss(pred, True)
            losses["gan"] = g_gan
            loss_g = loss_g + g_gan * tcfg.gan_lambda
        return loss_g, (seg_softmax, losses)

    # ------------------------------------------------------------- train step
    def train_step(self, state: GANState, batch, vgg) -> Tuple[GANState, Dict]:
        """One G update and one D update; ``vgg`` is the frozen
        ``Vgg19Features``. Returns (state, metrics of 0-d tensors, averaged
        across the mesh's ranks); the gradients of the last updates stay in
        the parameters' ``.grad``. On the card the call replays the step's
        graph (module docstring)."""
        opts = [state.g.opt] + ([] if self.tcfg.no_gan_loss else [state.d.opt])
        for opt in opts:
            opt.prepare()
        metrics = _step(self, state.g, state.d, batch, vgg)
        for opt in opts:
            opt.advance()
        state.step += 1
        return state, metrics

    def _train_step_body(self, g: NetState, d_net: NetState, batch, vgg):
        tcfg = self.tcfg
        prep = cast_batch(prep_batch(batch), self.dtype)
        tocg, d = g.module, d_net.module
        bf16 = torch.bfloat16 if tcfg.bf16 else None
        d_state = (precision.rounded_buffers(d, bf16) if bf16
                   else contextlib.nullcontext())
        with precision.no_tf32(), self._policy():
            # ---- G update
            with d_state:
                loss_g, (seg_softmax, losses) = self._forward_and_losses(
                    tocg, d, vgg, prep, train=True)
                apply_grads(loss_g, g)
            commit_state(tocg)
            metrics = {f"loss/G/{k}": v.detach() for k, v in losses.items()}
            metrics["loss/G"] = loss_g.detach()

            # ---- D update (train_condition.py:268-312)
            if not tcfg.no_gan_loss:
                if tcfg.g_d_separate:
                    # a fresh forward of the updated G, its statistics dropped
                    with torch.no_grad():
                        _, seg2, _, wcm2 = tocg(prep["input1"], prep["input2"],
                                                train=True)
                    drop_state(tocg)
                    seg2 = compose_clothmask(seg2, wcm2,
                                             tcfg.clothmask_composition)
                    fake_softmax = torch.softmax(seg2, dim=-1).detach()
                else:
                    fake_softmax = seg_softmax.detach()
                base = torch.cat([prep["input1"], prep["input2"]], dim=-1)
                pred_f = d(torch.cat([base, fake_softmax], dim=-1), train=True,
                           update_sn=True, generator=self.dropout)
                pred_r = d(torch.cat([base, prep["label"]], dim=-1),
                           train=True, generator=self.dropout)
                l_fake = lsgan_loss(pred_f, False)
                l_real = lsgan_loss(pred_r, True)
                loss_d = l_fake + l_real
                apply_grads(loss_d, d_net)
                commit_state(d)
                metrics.update({"loss/D": loss_d.detach(),
                                "loss/D/pred_fake": l_fake.detach(),
                                "loss/D/pred_real": l_real.detach()})
        return metrics

    # ----------------------------------------------------------- visualization
    @torch.no_grad()
    def visualize(self, state: GANState, batch) -> Dict[str, torch.Tensor]:
        """Eval-mode forward for the TensorBoard panels
        (train_condition.py:400-436): the composed segmap softmax, the warped
        cloth and mask and the misalignment map."""
        return _visualize_graph(self, state.g.module, batch)

    # -------------------------------------------------------------- validation
    @torch.no_grad()
    def eval_iou(self, state: GANState, batch) -> torch.Tensor:
        """Validation IoU of the composed softmax segmap
        (train_condition.py:314-360)."""
        return _eval_iou_graph(self, state.g.module, batch)
