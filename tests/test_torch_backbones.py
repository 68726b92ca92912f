"""The evaluation backbones and their converters: the port against the JAX
package on the CPU, f32.

The four feature backbones at 64x64 and InceptionV3 at 75x75 (its smallest
input), on random variables shared through ``load_jax_variables``; numpy
inputs from a seed. Tolerance f32 1e-5 relative to max|ref| per tap (with
1e-6 absolute): up to sixteen convs, each summing its products in another
order on the two sides; InceptionV3's logits 2e-5 (ninety-four convs, each
with its BatchNorm).

The converters run on torch state dicts under torchvision's and LPIPS
v0.1's key names, filled with numpy draws of the shapes of the port's
modules: the port's trees equal the JAX converters' bit for bit and fill
every tensor of the port's module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.losses import lpips as jlpips
from hrviton_tpu.models import backbones as jbb
from hrviton_tpu.models import inception as jinc
from hrviton_tpu.train import checkpoint as jckpt
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.losses import lpips as tlpips
from hrviton_tpu_torch.models import backbones as tbb
from hrviton_tpu_torch.models import inception as tinc
from hrviton_tpu_torch.train import checkpoint as tckpt
from test_torch_support import random_variables

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


_BACKBONES = {"vgg19": (jbb.Vgg19Features, tbb.Vgg19Features),
              "vgg16": (jbb.Vgg16Features, tbb.Vgg16Features),
              "squeeze": (jbb.SqueezeNetFeatures, tbb.SqueezeNetFeatures),
              "alex": (jbb.AlexNetFeatures, tbb.AlexNetFeatures)}


@pytest.mark.parametrize("name", sorted(_BACKBONES))
def test_backbone_matches_jax(name):
    jcls, tcls = _BACKBONES[name]
    m = jcls()
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(m.apply)(v, x)
    port = tcls(device="cpu")
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_inception_matches_jax():
    m = jinc.InceptionV3()
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 75, 75, 3)))
    x = np.random.default_rng(1).uniform(-1, 1, (1, 75, 75, 3)).astype(
        np.float32)
    want = jax.jit(m.apply)(v, x)
    port = tinc.InceptionV3(device="cpu").eval()
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, rel=2e-5)


# ------------------------------------------------------------ converters

def _sd(rng, module, table, suffixes=("weight", "bias")):
    """A state dict with the keys of ``table`` (torch key, port module
    path) and the shapes of the port module's tensors there."""
    sd = {}
    for tkey, path in table:
        mod = module.get_submodule(path)
        for s in suffixes:
            t = getattr(mod, s, None)
            if t is not None:
                sd[f"{tkey}.{s}"] = rng.standard_normal(
                    tuple(t.shape)).astype(np.float32)
    return sd


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def _squeeze_table():
    rows = [("features.0", "conv1")]
    for idx, name in tckpt._SQUEEZE_FIRES:
        for part in ("squeeze", "expand1x1", "expand3x3"):
            rows.append((f"features.{idx}.{part}", f"{name}.{part}"))
    return rows


_CONVERTERS = {
    "vgg19": (tbb.Vgg19Features, tckpt._VGG19_CONVS, "convert_vgg19"),
    "vgg16": (tbb.Vgg16Features, tckpt._VGG16_CONVS, "convert_vgg16"),
    "alexnet": (tbb.AlexNetFeatures, tckpt._ALEX_CONVS, "convert_alexnet"),
    "squeezenet": (tbb.SqueezeNetFeatures, _squeeze_table(),
                   "convert_squeezenet"),
}


@pytest.mark.parametrize("name", sorted(_CONVERTERS))
def test_backbone_converter_matches_jax(name):
    cls, table, fn = _CONVERTERS[name]
    port = cls(device="cpu")
    sd = _sd(np.random.default_rng(3), port, table)
    tree = getattr(tckpt, fn)(sd)
    _assert_same_tree(tree, getattr(jckpt, fn)(sd))
    load_jax_variables(port, tree)                   # fills every tensor
    for tkey, path in table:
        w = port.get_submodule(path).weight
        assert np.array_equal(w.detach().numpy(), sd[tkey + ".weight"])


@pytest.mark.parametrize("lin_key", ["model.1", "model.0"])
def test_convert_lpips_alex_matches_jax(lin_key):
    port = tlpips.LPIPSAlex(device="cpu")
    rng = np.random.default_rng(4)
    alex_sd = _sd(rng, port.alexnet, tckpt._ALEX_CONVS)
    lin_sd = {f"lin{i}.{lin_key}.weight": rng.standard_normal(
        tuple(getattr(port, f"lin{i}").weight.shape)).astype(np.float32)
        for i in range(5)}
    tree = tckpt.convert_lpips_alex(lin_sd, alex_sd)
    _assert_same_tree(tree, jckpt.convert_lpips_alex(lin_sd, alex_sd))
    load_jax_variables(port, tree)


def test_convert_inception_matches_jax():
    """A state dict under torchvision's inception_v3 keys (the port's module
    is named as torchvision's, so its own state_dict gives them), with the
    BatchNorms' num_batches_tracked and an auxiliary classifier, which the
    converter skips."""
    port = tinc.InceptionV3(device="cpu")
    rng = np.random.default_rng(5)
    sd = {k: rng.standard_normal(tuple(t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k] = np.abs(sd[k]) + 0.5
        sd[k.replace("running_var", "num_batches_tracked")] = np.array(7)
    sd["AuxLogits.conv0.conv.weight"] = rng.standard_normal(
        (128, 768, 1, 1)).astype(np.float32)
    tree = tinc.convert_inception_v3(sd)
    _assert_same_tree(tree, jinc.convert_inception_v3(sd))
    load_jax_variables(port, tree)
    for k, t in port.state_dict().items():
        assert np.array_equal(t.detach().numpy(), sd[k]), k
