"""The two training loops: one step of the port's trainers against the JAX
trainers on the CPU, at tiny shapes (tocg ngf=8 at 64x64; SPADE ngf=8
'more' at 128x128 with discriminators of ndf 8; batch 2).

Both sides start from the same random variables (tests/test_torch_support:
non-zero BatchNorm statistics and SPADE noise_scale, spectral u/v) and the
same data; the SPADE noise is injected, the G forward's draws and the D
step's regeneration's draws each handed to the port. The JAX side is
``jax.value_and_grad`` of the trainer's own loss (``ConditionTrainer.
_forward_and_losses``; for stage 2 the G loss composed from
``GeneratorTrainer.conditioning``, ``_d_forward`` and the losses, as
generator_trainer.py:170-190 composes it) and of the D loss, the updated G
for the regeneration from the trainer's own optax update. Limits, f32:
every gradient tensor within 1e-4 x its max|ref| or, where the reference's
own rounding noise is larger, within four times that noise (the JAX side
run a second time on the batch with its samples in reverse order: the same
gradient in exact arithmetic, summed in other orders; a conv bias sums its
gradient over every pixel and moves by up to ~1e-4 of its max between the
two), a gradient that is zero in exact arithmetic below 1e-5 of its
network's largest on both sides (tests/test_torch_support.close_per_tensor),
the losses within 1e-5
relative, BatchNorm statistics and spectral u/v after the step within 1e-4
x max|ref|. A bf16 step of each: its losses within 4 bf16 ulps of |ref|
and every update finite (weights are not compared in bf16: Adam's first
step is lr * sign(g)). Also: remat on equals remat off bit for bit, and so
do d_remat on / off and split_d_batch / concat, in f32 on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hrviton_tpu.config import (CondDiscriminatorConfig as JCondDConfig,
                                ConditionTrainConfig as JCondTConfig,
                                GeneratorTrainConfig as JGenTConfig,
                                PipelineConfig as JPipelineConfig,
                                SPADEDiscriminatorConfig as JSpadeDConfig,
                                SPADEGenConfig as JSPADEGenConfig,
                                TOCGConfig as JTOCGConfig)
from hrviton_tpu.core.precision import cast_floating
from hrviton_tpu.losses.gan import gan_loss as jgan_loss
from hrviton_tpu.losses.gan import lsgan_loss as jlsgan_loss
from hrviton_tpu.losses.matching import feature_matching_loss as jfm
from hrviton_tpu.losses.perceptual import vgg_perceptual_loss as jvgg_loss
from hrviton_tpu.models.backbones import Vgg19Features as JVgg
from hrviton_tpu.ops.conv3x3 import taps_wgrad as jtaps_wgrad
from hrviton_tpu.train.condition_trainer import _prep as jprep
from hrviton_tpu.train import ConditionTrainer as JCondTrainer
from hrviton_tpu.train import GeneratorTrainer as JGenTrainer
from hrviton_tpu_torch.config import (CondDiscriminatorConfig,
                                      ConditionTrainConfig,
                                      GeneratorTrainConfig, PipelineConfig,
                                      SPADEDiscriminatorConfig,
                                      SPADEGenConfig, TOCGConfig)
from hrviton_tpu_torch.convert import export_jax_variables, load_jax_variables
from hrviton_tpu_torch.models.backbones import Vgg19Features
from hrviton_tpu_torch.train.condition_trainer import ConditionTrainer
from hrviton_tpu_torch.train.generator_trainer import GeneratorTrainer
from test_torch_support import (close_per_tensor, grad_tree, injected_noise,
                                random_variables, reverse_batch, tree_diff)

torch.set_num_threads(2)
CH, CW = 64, 64
FH, FW = 128, 128
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True)
def _jax_unfused_on_cpu(monkeypatch):
    sb = importlib.import_module("hrviton_tpu.ops.spade_block")
    monkeypatch.setattr(sb, "_INTERPRET", False)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch_batch(batch):
    def t(v):
        if isinstance(v, dict):
            return {k: t(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v))
    return t(batch)


def _cond_batch(n=2, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda c: rng.standard_normal((n, CH, CW, c), dtype=np.float32)
    labels = rng.integers(0, 13, (n, CH, CW)).astype(np.int32)
    parse = (labels[..., None] == np.arange(13)).astype(np.float32)
    return {"cloth": {"paired": f(3)},
            "cloth_mask": {"paired": rng.uniform(0, 1, (n, CH, CW, 1)
                                                 ).astype(np.float32)},
            "parse_agnostic": f(13), "densepose": f(3),
            "parse_onehot": labels, "parse": parse,
            "pcm": parse[..., 3:4].copy(), "parse_cloth": f(3)}


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


@pytest.fixture(scope="module")
def vgg_pair():
    jv = random_variables(JVgg(), jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)), seed=7)
    tv = Vgg19Features(device="cpu")
    load_jax_variables(tv, jv)
    tv.requires_grad_(False)
    return jv, tv


# ----------------------------------------------------------------- stage 1

def _small_flows(tocg_vars, scale=0.05):
    """The tocg's flow convs scaled down, so that its warps stay inside the
    image as a trained tocg's do. With random full-scale weights the flows
    run far outside it, the border clamp holds almost everywhere, and the
    gradient flips between clamped and free under any f32 rounding: there
    the JAX trainer's own f32 gradients differ from its f64 ones by 0.7%
    (batch 2, 64x64), against 7e-6 with the flows scaled by 0.05."""
    for k, sub in tocg_vars["params"].items():
        if k.startswith("flow_conv"):
            sub["conv"]["kernel"] = sub["conv"]["kernel"] * np.float32(scale)
            sub["conv"]["bias"] = sub["conv"]["bias"] * np.float32(scale)
    return tocg_vars


_COND_CASES = {
    "default": {},
    "interflow_occlusion": dict(interflowloss=True, occlusion=True),
}


def _cond_setup(tkw, bf16=False, spectral=True):
    tocg_cfg = dict(ngf=8)
    d_kw = dict(input_nc=33, ndf=8, spectral=spectral)
    jt = JCondTrainer(JTOCGConfig(**tocg_cfg), JCondDConfig(**d_kw),
                      JCondTConfig(bf16=bf16, **tkw))
    gv = _small_flows(random_variables(
        jt.tocg, jax.random.PRNGKey(0), jnp.zeros((1, CH, CW, 4)),
        jnp.zeros((1, CH, CW, 16)), train=False, seed=1))
    dv = random_variables(jt.d, jax.random.PRNGKey(1),
                          jnp.zeros((1, CH, CW, 33)), train=False, seed=2)
    pt = ConditionTrainer(TOCGConfig(**tocg_cfg), CondDiscriminatorConfig(**d_kw),
                          ConditionTrainConfig(bf16=bf16, **tkw), device="cpu")
    state = pt.init(0)
    load_jax_variables(state.g.module, gv)
    load_jax_variables(state.d.module, dv)
    return jt, gv, dv, pt, state


def _jax_cond_step(jt, gv, dv, vgg_vars, batch, bf16=False):
    """The JAX trainer's G and D losses and gradients, as its train_step
    forms them (condition_trainer.py:167-262)."""
    cast = (lambda t: cast_floating(t, jnp.bfloat16)) if bf16 else (lambda t: t)
    prep = cast(jprep(jax.tree_util.tree_map(jnp.asarray, batch)))
    g_params = gv["params"]
    g_extras = {k: v for k, v in gv.items() if k != "params"}
    d_vars = cast(dv)
    rng = jax.random.PRNGKey(3)
    (loss_g, (new_g, seg_softmax, losses)), g_grads = jax.value_and_grad(
        lambda p: jt._forward_and_losses(cast(p), g_extras, d_vars,
                                         cast(vgg_vars), prep, rng),
        has_aux=True)(g_params)
    base = jnp.concatenate([prep["input1"], prep["input2"]], axis=-1)
    fake = jax.lax.stop_gradient(seg_softmax)
    d_extras = {k: v for k, v in dv.items() if k != "params"}

    def d_loss_fn(p):
        dvp = {"params": cast(p), **d_extras}
        pred_f, new_d = jt._d_apply(dvp, jnp.concatenate([base, fake], -1),
                                    rng, train=True, update_sn=True)
        pred_r = jt._d_apply(dvp, jnp.concatenate([base, prep["label"]], -1),
                             rng, train=True)
        l_fake, l_real = jlsgan_loss(pred_f, False), jlsgan_loss(pred_r, True)
        return l_fake + l_real, (l_fake, l_real, new_d)

    (loss_d, (l_fake, l_real, new_d)), d_grads = jax.value_and_grad(
        d_loss_fn, has_aux=True)(dv["params"])
    metrics = {f"loss/G/{k}": v for k, v in losses.items()}
    metrics.update({"loss/G": loss_g, "loss/D": loss_d,
                    "loss/D/pred_fake": l_fake, "loss/D/pred_real": l_real})
    return metrics, g_grads, new_g, d_grads, new_d


def _losses_close(got, want, rel):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        v = float(v)
        assert abs(float(got[k]) - v) <= rel * max(abs(v), 1e-30), (k, float(got[k]), v)


@pytest.mark.parametrize("case", sorted(_COND_CASES))
def test_condition_step_matches_jax(case, vgg_pair):
    tkw = _COND_CASES[case]
    jv, tv = vgg_pair
    jt, gv, dv, pt, state = _cond_setup(tkw)
    batch = _cond_batch()
    step = jax.jit(lambda *a: _jax_cond_step(jt, *a))
    metrics, g_grads, new_g, d_grads, new_d = step(gv, dv, jv, batch)
    _, g_rev, _, d_rev, _ = step(gv, dv, jv, reverse_batch(batch))
    state, got = pt.train_step(state, _torch_batch(batch), tv)
    _losses_close(got, metrics, 1e-5)
    g_grads, d_grads = _np_tree(g_grads), _np_tree(d_grads)
    close_per_tensor(grad_tree(state.g.module),
                     g_grads, 1e-4, tree_diff(g_grads, _np_tree(g_rev)))
    close_per_tensor(grad_tree(state.d.module),
                     d_grads, 1e-4, tree_diff(d_grads, _np_tree(d_rev)))
    close_per_tensor(export_jax_variables(state.g.module)["batch_stats"],
                     _np_tree(new_g["batch_stats"]), 1e-4)
    close_per_tensor(export_jax_variables(state.d.module)["aux"],
                     _np_tree(new_d["aux"]), 1e-4)
    assert state.step == 1


def test_condition_step_bf16(vgg_pair):
    jv, tv = vgg_pair
    jt, gv, dv, pt, state = _cond_setup({}, bf16=True)
    batch = _cond_batch()
    metrics = jax.jit(lambda *a: _jax_cond_step(jt, *a, bf16=True)[0])(
        gv, dv, jv, batch)
    before = [p.detach().clone() for p in state.g.module.parameters()]
    state, got = pt.train_step(state, _torch_batch(batch), tv)
    _losses_close(got, metrics, 4 * BF16_ULP)
    for p, b in zip(state.g.module.parameters(), before):
        assert torch.isfinite(p).all() and p.dtype == torch.float32
    assert any((p != b).any() for p, b in zip(state.g.module.parameters(), before))
    for p in state.d.module.parameters():
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all()


def test_entry_points_default_to_the_card():
    """The trainers and the VGG loss run on 'cuda' unless the caller asks
    for the CPU, and raise without a card (no fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hrviton_tpu_torch.losses.perceptual import make_vgg_loss
    with pytest.raises(RuntimeError, match="CUDA"):
        ConditionTrainer(TOCGConfig(ngf=8), CondDiscriminatorConfig(),
                         ConditionTrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneratorTrainer(SPADEGenConfig(), SPADEDiscriminatorConfig(),
                         GeneratorTrainConfig(), PipelineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_vgg_loss()
    from hrviton_tpu_torch.cli import train_condition, train_generator
    assert train_condition.get_opt([]).device == "cuda"
    assert train_generator.get_opt(["--name", "x"]).device == "cuda"


def test_export_is_a_copy_and_round_trips():
    """export_jax_variables gives arrays of their own (a later update of
    the module leaves them alone) that load back bit for bit."""
    from hrviton_tpu_torch.models.condition import ConditionGenerator
    from hrviton_tpu_torch.nn.layers import init_weights
    m = ConditionGenerator(TOCGConfig(ngf=8), device="cpu")
    init_weights(m, torch.Generator().manual_seed(0))
    tree = export_jax_variables(m)
    assert set(tree) == {"params", "batch_stats"}
    k = tree["params"]["ClothEncoder_0"]["conv1"]["conv"]["kernel"].copy()
    w0 = m.ClothEncoder_0.conv1.weight.detach().clone()
    with torch.no_grad():
        m.ClothEncoder_0.conv1.weight.add_(1.0)
    np.testing.assert_array_equal(
        tree["params"]["ClothEncoder_0"]["conv1"]["conv"]["kernel"], k)
    again = ConditionGenerator(TOCGConfig(ngf=8), device="cpu")
    load_jax_variables(again, tree)
    with torch.no_grad():
        m.ClothEncoder_0.conv1.weight.copy_(w0)
    for (n, a), b in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
