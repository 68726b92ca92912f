"""Stage 2's training step: the port's GeneratorTrainer against the JAX
GeneratorTrainer on the CPU (SPADE ngf=8 'more' at 128x128, the SPADE
discriminator ndf 8, batch 2, --GT conditioning), and the step's
equivalences.

The JAX side is the G loss composed from the trainer's public parts as
generator_trainer.py:170-190 composes it (``conditioning``, the
generator's update_sn forward, ``_d_forward``, the hinge, feature-matching
and VGG losses) under the trainer's ``taps_wgrad``, and the D hinge loss on
``_d_forward(..., update_sn=True)`` of a regeneration by the port's updated
G (the same weights on both sides; Adam is held against optax on its own).
The SPADE noise fields (noise_scale is non-zero) are numpy draws fed to
both sides in the draw order, the G forward's and the regeneration's
apart. Limits as in test_torch_trainers.py: f32 gradients
per tensor within 1e-4 x max|ref| or four times the reference's own
rounding noise (the JAX side again on the batch and the noise in reverse
sample order), losses within 1e-5 relative, the spectral u/v after the
step within 1e-4 x max|ref|; bf16 losses within 4 bf16 ulps of |ref|.

The taps op's backward in the step: every g that reaches it with an input
gradient to take arrives channels_last, as its x, so the bf16 dgrad copies
none (the f32 one copies g to NCHW and its result back, two a call).

Equivalences, port only, f32: remat on / off and d_remat on / off give
the same step bit for bit (losses, gradients, u/v); split_d_batch gives
the concatenated batch's within 1e-5 x max|ref| (other conv batchings).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hrviton_tpu.config import GeneratorTrainConfig as JGenTConfig
from hrviton_tpu.config import PipelineConfig as JPipelineConfig
from hrviton_tpu.config import SPADEDiscriminatorConfig as JSpadeDConfig
from hrviton_tpu.config import SPADEGenConfig as JSPADEGenConfig
from hrviton_tpu.core.precision import cast_floating
from hrviton_tpu.losses.gan import gan_loss as jgan_loss
from hrviton_tpu.losses.matching import feature_matching_loss as jfm
from hrviton_tpu.losses.perceptual import vgg_perceptual_loss as jvgg_loss
from hrviton_tpu.models.backbones import Vgg19Features as JVgg
from hrviton_tpu.ops.conv3x3 import taps_wgrad as jtaps_wgrad
from hrviton_tpu.train import GeneratorTrainer as JGenTrainer
from hrviton_tpu_torch.config import (GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig, SPADEGenConfig)
from hrviton_tpu_torch.convert import export_jax_variables, load_jax_variables
from hrviton_tpu_torch.models.backbones import Vgg19Features
from hrviton_tpu_torch.ops import conv3x3 as tc3
from hrviton_tpu_torch.train.generator_trainer import GeneratorTrainer
from test_torch_support import (close_per_tensor, grad_tree, random_variables,
                                reverse_batch, tree_diff)
from test_torch_trainers import _losses_close, _np_tree, _torch_batch

torch.set_num_threads(2)
FH, FW = 128, 128
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _gen_batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda c: np.tanh(rng.standard_normal((n, FH, FW, c),
                                              dtype=np.float32))
    labels = rng.integers(0, 13, (n, FH, FW)).astype(np.int32)
    parse = (labels[..., None] == np.arange(13)).astype(np.float32)
    return {"cloth": f(3),
            "cloth_mask": rng.uniform(0, 1, (n, FH, FW, 1)).astype(np.float32),
            "parse_agnostic": f(13), "densepose": f(3), "agnostic": f(3),
            "image": f(3), "parse": parse, "parse_cloth": f(3)}


@contextlib.contextmanager
def _fed_noise(fields):
    """jax.random.normal of a (B, H, W, 1) field returns the next of
    ``fields`` (traced arrays), in order."""
    real, it = jax.random.normal, iter(fields)

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[-1] == 1:
            a = next(it)
            assert tuple(a.shape) == tuple(shape), (a.shape, shape)
            return a.astype(dtype)
        return real(key, shape, dtype)
    jax.random.normal = normal
    try:
        yield
    finally:
        jax.random.normal = real


def _cfgs(bf16=False, **tkw):
    g = dict(ngf=8, fine_height=FH, fine_width=FW, num_upsampling_layers="more")
    p = dict(fine_height=FH, fine_width=FW, cond_height=64, cond_width=64)
    t = dict(gt_mode=True, bf16=bf16, **tkw)
    return g, dict(ndf=8), t, p


@pytest.fixture(scope="module")
def setup():
    g, d, t, p = _cfgs()
    jt = JGenTrainer(JSPADEGenConfig(remat=False, **g), JSpadeDConfig(**d),
                     JGenTConfig(**t), JPipelineConfig(**p), None)
    gv = random_variables(jt.gen, {"params": jax.random.PRNGKey(0),
                                   "noise": jax.random.PRNGKey(1)},
                          jnp.zeros((1, FH, FW, 9)), jnp.zeros((1, FH, FW, 7)),
                          train=False, seed=1)
    dv = random_variables(jt.d, jax.random.PRNGKey(2),
                          jnp.zeros((1, FH, FW, 10)), train=False, seed=2)
    jv = random_variables(JVgg(), jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)), seed=7)
    vgg = Vgg19Features(device="cpu")
    load_jax_variables(vgg, jv)
    vgg.requires_grad_(False)
    return gv, dv, jv, vgg


def _port(setup, bf16=False, remat=True, **tkw):
    gv, dv, _, vgg = setup
    g, d, t, p = _cfgs(bf16, **tkw)
    pt = GeneratorTrainer(SPADEGenConfig(remat=remat, **g),
                          SPADEDiscriminatorConfig(**d),
                          GeneratorTrainConfig(**t), PipelineConfig(**p),
                          None, device="cpu")
    state = pt.init(0)
    load_jax_variables(state.g.module, gv)
    load_jax_variables(state.d.module, dv)
    return pt, state


def _noise_shapes(pt, state, batch):
    """The noise fields one generator forward draws, in order."""
    shapes = []

    def draw(shape):
        shapes.append(tuple(shape))
        return torch.zeros(shape)
    gen_in, _, labels = pt.conditioning(_torch_batch(batch))
    with torch.no_grad():
        state.g.module(gen_in, labels, draw)
    return shapes


def _jax_step(jt, gv, dv, jv, batch, noise_g, noise_d, g_params_new=None,
              bf16=False):
    cast = (lambda t: cast_floating(t, jnp.bfloat16)) if bf16 else (lambda t: t)
    with jtaps_wgrad(True):
        b = cast(batch)
        gen_in, parse7, labels = jt.conditioning(b, None)
        im = b["image"]
        d_vars = cast(dv)

        def g_loss_fn(p):
            with _fed_noise(noise_g):
                out, new_g = jt.gen.apply(
                    {"params": cast(p), "aux": gv["aux"]}, gen_in, labels,
                    train=True, update_sn=True,
                    rngs={"noise": jax.random.PRNGKey(5)}, mutable=["aux"])
            pf, pr, _ = jt._d_forward(d_vars, parse7, out, im)
            losses = {"GAN": jgan_loss(pf, True, "hinge",
                                       for_discriminator=False),
                      "GAN_Feat": jfm(pf, pr, 10.0),
                      "VGG": jvgg_loss(cast(jv), out, im) * 10.0}
            return sum(losses.values()), (new_g, losses)

        (loss_g, (new_g, losses)), g_grads = jax.value_and_grad(
            g_loss_fn, has_aux=True)(gv["params"])
        if g_params_new is None:
            upd, _ = jt.g_tx.update(g_grads, jt.g_tx.init(gv["params"]),
                                    gv["params"])
            g_params_new = optax.apply_updates(gv["params"], upd)
        with _fed_noise(noise_d):
            out_ng = jax.lax.stop_gradient(jt.gen.apply(
                {"params": cast(g_params_new), "aux": new_g["aux"]}, gen_in,
                labels, train=True, update_sn=False,
                rngs={"noise": jax.random.PRNGKey(6)}))

        def d_loss_fn(p):
            pf, pr, new_d = jt._d_forward({"params": cast(p), "aux": dv["aux"]},
                                          parse7, out_ng, im, update_sn=True)
            l_fake = jgan_loss(pf, False, "hinge", for_discriminator=True)
            l_real = jgan_loss(pr, True, "hinge", for_discriminator=True)
            return l_fake + l_real, (l_fake, l_real, new_d)

        (loss_d, (l_fake, l_real, new_d)), d_grads = jax.value_and_grad(
            d_loss_fn, has_aux=True)(dv["params"])
    metrics = {f"loss/gen/{k}": v for k, v in losses.items()}
    metrics.update({"loss/gen": loss_g, "loss/dis": loss_d,
                    "loss/dis/adv_fake": l_fake, "loss/dis/adv_real": l_real})
    return metrics, g_grads, new_g, d_grads, new_d


def _inputs(setup, pt, state):
    batch = _gen_batch()
    rng = np.random.default_rng(11)
    shapes = _noise_shapes(pt, state, batch)
    noise_g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    noise_d = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return batch, noise_g, noise_d


def _jax_trainer(bf16=False):
    g, d, t, p = _cfgs(bf16)
    return JGenTrainer(JSPADEGenConfig(remat=False, **g), JSpadeDConfig(**d),
                       JGenTConfig(**t), JPipelineConfig(**p), None)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_generator_step_matches_jax(setup):
    gv, dv, jv, vgg = setup
    pt, state = _port(setup)
    batch, noise_g, noise_d = _inputs(setup, pt, state)
    state, got = pt.train_step(state, _torch_batch(batch), _t(noise_g),
                               _t(noise_d), {"vgg": vgg, "tocg": None})
    # the D step judges a regeneration by the port's updated G on both
    # sides: Adam's first step is lr * sign(g), so a gradient element at
    # rounding level flips its weight's update, and the two sides' updated
    # weights are not comparable element by element (Adam itself is held
    # against optax in test_torch_losses.py)
    g_new = export_jax_variables(state.g.module)["params"]
    jt = _jax_trainer()
    step = jax.jit(lambda *a: _jax_step(jt, *a))
    metrics, g_grads, new_g, d_grads, new_d = step(gv, dv, jv, batch, noise_g,
                                                   noise_d, g_new)
    rev = lambda fields: [f[::-1].copy() for f in fields]
    _, g_rev, _, d_rev, _ = step(gv, dv, jv, reverse_batch(batch),
                                 rev(noise_g), rev(noise_d), g_new)
    _losses_close(got, metrics, 1e-5)
    g_grads, d_grads = _np_tree(g_grads), _np_tree(d_grads)
    close_per_tensor(grad_tree(state.g.module),
                     g_grads, 1e-4, tree_diff(g_grads, _np_tree(g_rev)))
    close_per_tensor(grad_tree(state.d.module),
                     d_grads, 1e-4, tree_diff(d_grads, _np_tree(d_rev)))
    close_per_tensor(export_jax_variables(state.g.module)["aux"],
                     _np_tree(new_g["aux"]), 1e-4)
    close_per_tensor(export_jax_variables(state.d.module)["aux"],
                     _np_tree(new_d["aux"]), 1e-4)
    assert abs(float(got["loss/dis"]) - 2.0) < 0.1     # hinge at init


def test_generator_step_bf16(setup):
    gv, dv, jv, vgg = setup
    pt, state = _port(setup, bf16=True)
    batch, noise_g, noise_d = _inputs(setup, pt, state)
    jt = _jax_trainer(bf16=True)
    metrics = jax.jit(lambda *a: _jax_step(jt, *a, bf16=True)[0])(
        gv, dv, jv, batch, noise_g, noise_d)
    state, got = pt.train_step(state, _torch_batch(batch), _t(noise_g),
                               _t(noise_d), {"vgg": vgg, "tocg": None})
    _losses_close(got, metrics, 4 * BF16_ULP)
    for m in (state.g.module, state.d.module):
        for p in m.parameters():
            assert p.dtype == torch.float32 and torch.isfinite(p).all()
            assert torch.isfinite(p.grad).all()


def _step_record(setup, remat=True, **tkw):
    pt, state = _port(setup, remat=remat, **tkw)
    batch, noise_g, noise_d = _inputs(setup, pt, state)
    state, got = pt.train_step(state, _torch_batch(batch), _t(noise_g),
                               _t(noise_d), {"vgg": setup[3], "tocg": None})
    grads = {f"g.{n}": p.grad for n, p in state.g.module.named_parameters()}
    grads.update({f"d.{n}": p.grad for n, p in state.d.module.named_parameters()})
    bufs = {f"g.{n}": b for n, b in state.g.module.named_buffers()}
    bufs.update({f"d.{n}": b for n, b in state.d.module.named_buffers()})
    return got, grads, bufs


@pytest.mark.parametrize("knob", ["remat", "d_remat"])
def test_remat_is_bit_exact(setup, knob):
    on = _step_record(setup, remat=True, d_remat=True)
    off = (_step_record(setup, remat=False, d_remat=True) if knob == "remat"
           else _step_record(setup, remat=True, d_remat=False))
    for a, b in zip(on, off):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_split_d_batch_equals_concat(setup):
    cat = _step_record(setup, split_d_batch=False)
    split = _step_record(setup, split_d_batch=True)
    for a, b in zip(split, cat):
        for k in b:
            lim = 1e-5 * max(float(b[k].abs().max()), 1e-30)
            assert float((a[k] - b[k]).abs().max()) <= lim, k


@pytest.mark.parametrize("bf16", [False, True])
def test_taps_backward_layout_copies_in_the_step(setup, bf16, monkeypatch):
    """Under the trainer's ``taps_wgrad`` the step's backward runs the taps
    op once for each of G's 3x3 convs with a weight gradient (the benchmark
    driver's count) and each of VGG19's 13 on G's output (an input gradient
    alone: VGG is frozen). Each call that takes an input gradient finds x
    and g channels_last, so ``conv3x3_taps.layout_copies`` adds 0 in bf16,
    and in f32 two a call (g to the NCHW dgrad, its result to x's layout).
    (The input pyramid's convs take a channel slice of a concatenation's
    gradient, which is not channels_last; they take no input gradient, so
    no dgrad copies it.)"""
    from benchmark.drivers.train_closed_loop import taps_per_step
    from test_torch_wgrad3x3 import spy_taps_backward
    pt, state = _port(setup, bf16=bf16)
    batch, noise_g, noise_d = _inputs(setup, pt, state)
    vgg = setup[3]
    counts = lambda: (tc3.conv3x3_taps.backwards.launches,
                      tc3.conv3x3_taps.layout_copies.launches)
    seen = spy_taps_backward(monkeypatch)
    before = counts()
    pt.train_step(state, _torch_batch(batch), _t(noise_g), _t(noise_d),
                  {"vgg": vgg, "tocg": None})
    vgg_convs = sum(1 for p in vgg.parameters()
                    if p.dim() == 4 and tuple(p.shape[-2:]) == (3, 3))
    assert vgg_convs == 13
    dgrads = [s for s in seen if s[0]]
    assert dgrads and all(x_cl and g_cl for _, x_cl, g_cl in dgrads)
    got = tuple(a - b for a, b in zip(counts(), before))
    assert got == (taps_per_step(state.g.module) + vgg_convs,
                   0 if bf16 else 2 * len(dgrads))
    assert len(seen) == got[0]
