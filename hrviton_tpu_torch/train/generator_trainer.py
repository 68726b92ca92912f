"""Stage-2 training: the SPADE image generator and its multiscale
discriminator beside a frozen tocg (``hrviton_tpu/train/generator_trainer.py``,
reference train_generator.py:184-360):

  conditioning (no gradient: the tocg at the condition size, lifted to the
  full size, train_generator.py:201-275),
  G loss = hinge + 10 feature matching + 10 VGG, then the D hinge step on a
  fresh output of the updated G, with no gradient. Both forwards of G run in
  training mode (the 'aliasbatch' norms on the batch's statistics); the G
  loss's forward writes the running statistics after the G update, the
  regeneration writes none (the JAX step applies it with its batch_stats
  immutable).

TTUR Adam(0, 0.9) with the linear decay after keep_step, stepped per 1000
updates. As in the JAX step: the G loss's forward runs one power iteration
in every spectral conv of G (written after the G update, so the D step's
regeneration reads the new u/v and updates none); the discriminator forwards
inside the G loss update nothing and keep no gradient (the G gradient is
taken with respect to G's parameters alone); the D step's forward updates
D's u/v once, and with ``split_d_batch`` its fake and real calls start from
the same stored u. The VGG loss runs under ``torch.utils.checkpoint`` (both
towers), the generator's blocks under ``SPADEGenConfig.remat`` and the
discriminator under ``d_remat``; ``taps_wgrad`` holds for the whole step
(``ops/conv3x3.taps_wgrad``). The step runs with TF32 off.

Data parallel (``core/mesh.py``): with a mesh of several ranks each rank
steps on its rows of the global batch; the G step's gradients, the batch
norms' statistics, the SPADE noise (drawn at the global shape) and the
metrics are reduced across the ranks, so the step equals the one-process
step on the global batch.

bf16 (``GeneratorTrainConfig.bf16``): f32 parameters and Adam state, the
batch cast to bf16, every parameter read rounded to bf16
(``core/precision.param_dtype``); the frozen tocg's statistics and, in the
G step, D's u/v are rounded too, as the JAX step casts those trees.

On the card ``train_step``, ``generate`` and ``generate_debug`` replay CUDA
graphs recorded once per batch signature (``core/graphs.py``) into one
memory pool, the counterparts of the JAX trainer's jits; the step's graph
advances both networks and their optimizers in place, once a call
(``donate_argnums=1``).
The SPADE noise is drawn before the graph, in the eager step's order (the G
loss's forward, then the regeneration), and handed in as fields
(``noise_fields``); the learning rates, the optimizers' counts and
``state.step`` move on the host around it. On the CPU they are plain calls.

With tracing on (``utils/profiling``) the step is seven contiguous device
spans, recorded into its graph: ``train.condition`` (the batch's cast, the
no-gradient conditioning: the tocg, the lift, the LUT), ``train.g_forward``
(G's output, D on fake and real, VGG, the losses), ``train.g_backward`` (the
G gradient, with the blocks' and VGG's recomputation), ``train.g_update``
(G's Adam update and its u/v written), ``train.regenerate`` (the second,
no-gradient G forward), ``train.d_step`` (D's forward and backward) and
``train.d_update`` (D's Adam update and its u/v written). Inside the
backward each tap-product weight gradient is a nested ``train.wgrad_taps``
(``ops/conv3x3.wgrad_taps``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig, SPADEGenConfig,
                                      TOCGConfig)
from hrviton_tpu_torch.core import graphs
from hrviton_tpu_torch.core import mesh as mesh_lib
from hrviton_tpu_torch.core import precision
from hrviton_tpu_torch.device import resolve_device
from hrviton_tpu_torch.losses.gan import gan_loss
from hrviton_tpu_torch.losses.matching import feature_matching_loss
from hrviton_tpu_torch.losses.perceptual import vgg_perceptual_loss
from hrviton_tpu_torch.models.discriminators import SPADEMultiscaleDiscriminator
from hrviton_tpu_torch.models.spade import (NoiseArg, SPADEGenerator,
                                           noise_source)
from hrviton_tpu_torch.nn.layers import commit_state, drop_state, init_weights
from hrviton_tpu_torch.ops.conv3x3 import taps_wgrad
from hrviton_tpu_torch.ops.parse import group_index_of_label13, lut_lookup
from hrviton_tpu_torch.pipelines.tryon import condition_forward
from hrviton_tpu_torch.train.condition_trainer import (cast_batch, net_tensors,
                                                       put_grads)
from hrviton_tpu_torch.train.optim import adam, lambda_decay_schedule
from hrviton_tpu_torch.train.state import GANState, NetState
from hrviton_tpu_torch.utils import profiling

__all__ = ["GeneratorTrainer"]


def _train_step(trainer: "GeneratorTrainer", g: NetState, d: NetState, batch,
                fields_g, fields_d, frozen):
    with taps_wgrad(trainer.tcfg.taps_wgrad), precision.no_tf32(), \
            mesh_lib.sharded(trainer.mesh):
        metrics = trainer._train_step_body(g, d, batch, fields_g, fields_d,
                                           frozen)
        return mesh_lib.mean_metrics(metrics)


# the step's and the eval calls' graphs, one memory pool
_POOL = graphs.Pool()

# the counterpart of the JAX step's jit with its state donated
_step = graphs.captured(
    _train_step,
    weights=lambda trainer, g, d, batch, fg, fd, frozen: graphs.module_tensors(
        frozen.get("vgg"), frozen.get("tocg")),
    donated=lambda trainer, g, d, *_: net_tensors(g, d), pool=_POOL)


def _generate(trainer: "GeneratorTrainer", gen, batch, fields, tocg):
    gen_in, _, labels = trainer.conditioning(batch, tocg)
    with precision.no_tf32(), mesh_lib.sharded(trainer.mesh):
        return gen(gen_in, labels, fields, train=False)


def _generate_debug(trainer: "GeneratorTrainer", gen, batch, fields, tocg):
    fake_parse, warped_cloth, fpg = trainer._condition(batch, tocg)
    glabel = lut_lookup(fake_parse, group_index_of_label13())
    gen_in = torch.cat([batch["agnostic"], batch["densepose"],
                        warped_cloth], dim=-1)
    with precision.no_tf32(), mesh_lib.sharded(trainer.mesh):
        out = gen(gen_in, glabel, fields, train=False)
    return out, warped_cloth, fpg


_gen_weights = lambda trainer, gen, batch, fields, tocg: graphs.module_tensors(
    gen, tocg)
_generate_graph = graphs.captured(_generate, weights=_gen_weights, pool=_POOL)
_generate_debug_graph = graphs.captured(_generate_debug, weights=_gen_weights,
                                        pool=_POOL)


class GeneratorTrainer:
    def __init__(self, gen_cfg: SPADEGenConfig, d_cfg: SPADEDiscriminatorConfig,
                 tcfg: GeneratorTrainConfig, pcfg: PipelineConfig,
                 tocg_cfg: Optional[TOCGConfig] = None, device="cuda",
                 mesh: Optional[mesh_lib.Mesh] = None):
        """tocg_cfg: the frozen condition generator's architecture; None in
        --GT mode (train_generator.py:102,253-256). Its module is passed per
        step, with the VGG's, in ``frozen``. ``mesh``: the data-parallel
        layout (``core/mesh.make_mesh``); each call's batch is then the
        rank's rows of the global batch."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.gen_cfg, self.d_cfg, self.tcfg, self.pcfg = gen_cfg, d_cfg, tcfg, pcfg
        self.tocg_cfg = tocg_cfg
        self.dtype = torch.bfloat16 if tcfg.bf16 else torch.float32
        # what the latest step wrote, for a check of that step: its
        # conditioning (the generator's input, the labels), G's output of the
        # G update (the fake) and D's logits of the D update (a scale each,
        # the fakes' then the reals'). Inside a recorded step they are the
        # graph's own tensors, which each replay rewrites: read them before
        # the next step.
        self.held: Dict[str, object] = {}
        self.schedule = lambda_decay_schedule(tcfg.keep_step, tcfg.decay_step,
                                              tcfg.load_step)

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> GANState:
        tcfg = self.tcfg
        g = torch.Generator().manual_seed(seed)
        gen = SPADEGenerator(self.gen_cfg, device=self.device)
        d = SPADEMultiscaleDiscriminator(self.d_cfg, device=self.device)
        init_weights(gen, g)
        init_weights(d, g)
        return GANState(
            step=0,
            g=NetState(gen, adam(gen.parameters(), tcfg.g_lr, tcfg.beta1,
                                 tcfg.beta2, self.schedule)),
            d=NetState(d, adam(d.parameters(), tcfg.d_lr, tcfg.beta1,
                               tcfg.beta2, self.schedule)))

    # ---------------------------------------------------------- conditioning
    @torch.no_grad()
    def _condition(self, batch, tocg):
        """(fake_parse labels, warped cloth, fake_parse_gauss)."""
        if self.tcfg.gt_mode or tocg is None:
            # the reference's GT-mode grid names an undefined
            # fake_parse_gauss; the GT parse stands in for it
            return (batch["parse"].argmax(dim=-1), batch["parse_cloth"],
                    batch["parse"])
        cond = condition_forward(lambda i1, i2: tocg(i1, i2), batch, self.pcfg)
        return cond.fake_parse, cond.warped_cloth, cond.fake_parse_gauss

    @torch.no_grad()
    def conditioning(self, batch, tocg=None):
        """No-gradient conditioning (train_generator.py:201-275): the
        9-channel generator input, the 7-channel parse (f32, for the D) and
        the 7-way int label map."""
        fake_parse, warped_cloth, _ = self._condition(batch, tocg)
        glabel = lut_lookup(fake_parse, group_index_of_label13())
        parse7 = (glabel[..., None] == torch.arange(
            7, dtype=torch.int32, device=glabel.device)).float()
        gen_in = torch.cat([batch["agnostic"], batch["densepose"],
                            warped_cloth], dim=-1)
        return gen_in, parse7, glabel

    def _d_forward(self, d, parse7, fake, real, update_sn: bool = False):
        """The concatenated-batch D forward (train_generator.py:281-295), or
        two calls with ``split_d_batch``: the instance-norm D gives the
        same per-sample maps either way, and both calls start from the same
        stored u (a staged update is written by the caller)."""
        fake_concat = torch.cat([parse7, fake], dim=-1)
        real_concat = torch.cat([parse7, real], dim=-1)

        def d_fwd(x):
            return d(x, update_sn=update_sn)

        if self.tcfg.d_remat and torch.is_grad_enabled():
            run = lambda x: torch.utils.checkpoint.checkpoint(
                d_fwd, x, use_reentrant=False, preserve_rng_state=False)
        else:
            run = d_fwd
        if self.tcfg.split_d_batch:
            return run(fake_concat), run(real_concat)
        out = run(torch.cat([fake_concat, real_concat], dim=0))
        n = fake.shape[0]
        return ([[t[:n] for t in scale] for scale in out],
                [[t[n:] for t in scale] for scale in out])

    def noise_fields(self, gen: SPADEGenerator, noise: NoiseArg, n: int):
        """The SPADE noise fields of one forward of ``gen`` on ``n`` rows,
        drawn from ``noise`` (``models/spade.noise_source``) in the
        forward's order: inside ``core/mesh.sharded`` at the global batch's
        shape, the rank's rows kept, as the forward draws them."""
        with mesh_lib.sharded(self.mesh):
            draw = noise_source(noise, self.device)
            return [draw(shape) for shape in gen.noise_shapes(n)]

    # ------------------------------------------------------------- train step
    def train_step(self, state: GANState, batch, noise_g: NoiseArg,
                   noise_d: NoiseArg, frozen: Dict) -> Tuple[GANState, Dict]:
        """One G update, then one D update on a regenerated output.
        ``frozen``: {'vgg': Vgg19Features, 'tocg': ConditionGenerator or
        None in GT mode}; ``noise_g`` / ``noise_d``: the SPADE noise of the
        G-loss forward and of the regeneration, drawn in that order before
        the step. Returns (state, metrics of 0-d tensors, averaged across the
        mesh's ranks); the last updates' gradients stay in ``.grad``. On the
        card the call replays the step's graph (module docstring)."""
        n = batch["image"].shape[0]
        gen = state.g.module
        fields_g = self.noise_fields(gen, noise_g, n)
        fields_d = self.noise_fields(gen, noise_d, n)
        for opt in (state.g.opt, state.d.opt):
            opt.prepare()
        metrics = _step(self, state.g, state.d, batch, fields_g, fields_d,
                        {"vgg": frozen.get("vgg"), "tocg": frozen.get("tocg")})
        for opt in (state.g.opt, state.d.opt):
            opt.advance()
        state.step += 1
        return state, metrics

    def _train_step_body(self, g: NetState, d_net: NetState, batch, noise_g,
                         noise_d, frozen):
        tcfg = self.tcfg
        bf16 = torch.bfloat16 if tcfg.bf16 else None
        gen, d = g.module, d_net.module
        tocg = frozen.get("tocg")
        dev = batch["image"].device
        span = lambda name: profiling.device_span(name, dev)
        with precision.param_dtype(bf16), contextlib.ExitStack() as d_state:
            with span("train.condition"):
                batch = cast_batch(batch, self.dtype)
                with (precision.rounded_buffers(tocg, bf16)
                      if bf16 and tocg is not None
                      else contextlib.nullcontext()):
                    gen_in, parse7, labels = self.conditioning(batch, tocg)
            im = batch["image"]
            vgg = frozen.get("vgg")

            # ---- G update
            with span("train.g_forward"):
                if bf16:
                    d_state.enter_context(precision.rounded_buffers(d, bf16))
                output = gen(gen_in, labels, noise_g, train=True,
                             update_sn=True)
                pred_fake, pred_real = self._d_forward(d, parse7, output, im)
                losses = {"GAN": gan_loss(pred_fake, True, "hinge",
                                          for_discriminator=False)}
                if not tcfg.no_gan_feat_loss:
                    losses["GAN_Feat"] = feature_matching_loss(
                        pred_fake, pred_real, tcfg.lambda_feat)
                if not tcfg.no_vgg_loss:
                    # both towers recomputed in backward, as the JAX step
                    losses["VGG"] = torch.utils.checkpoint.checkpoint(
                        vgg_perceptual_loss, vgg, output, im,
                        use_reentrant=False, preserve_rng_state=False
                    ) * tcfg.lambda_vgg
                loss_g = sum(losses.values())
            with span("train.g_backward"):
                put_grads(loss_g, g)
                d_state.close()            # D's own u/v back
            with span("train.g_update"):
                g.opt.update()
                commit_state(gen)

            # ---- D update on a fresh no-gradient output of the updated G
            # (train_generator.py:327-334), in training mode; the batch
            # norms' statistics it stages are not written
            with span("train.regenerate"), torch.no_grad():
                output_ng = gen(gen_in, labels, noise_d, train=True)
            drop_state(gen)
            with span("train.d_step"):
                pred_fake, pred_real = self._d_forward(d, parse7, output_ng,
                                                       im, update_sn=True)
                l_fake = gan_loss(pred_fake, False, "hinge",
                                  for_discriminator=True)
                l_real = gan_loss(pred_real, True, "hinge",
                                  for_discriminator=True)
                loss_d = l_fake + l_real
                put_grads(loss_d, d_net)
            with span("train.d_update"):
                d_net.opt.update()
                commit_state(d)

        self.held = {"gen_in": gen_in, "labels": labels,
                     "fake": output.detach(),
                     "d_logits": [s[-1].detach() for s in pred_fake + pred_real]}
        metrics = {f"loss/gen/{k}": v.detach() for k, v in losses.items()}
        metrics.update({"loss/gen": loss_g.detach(), "loss/dis": loss_d.detach(),
                        "loss/dis/adv_fake": l_fake.detach(),
                        "loss/dis/adv_real": l_real.detach()})
        return metrics

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def generate(self, state: GANState, batch, noise: NoiseArg, tocg=None):
        gen = state.g.module
        return _generate_graph(self, gen, batch, self.noise_fields(
            gen, noise, batch["agnostic"].shape[0]), tocg)

    @torch.no_grad()
    def generate_debug(self, state: GANState, batch, noise: NoiseArg,
                       tocg=None):
        """``generate`` and the conditioning's intermediates for the
        reference's TensorBoard grids (train_generator.py:366-476):
        (output, warped cloth, fake_parse_gauss 13 channels)."""
        gen = state.g.module
        return _generate_debug_graph(self, gen, batch, self.noise_fields(
            gen, noise, batch["agnostic"].shape[0]), tocg)
