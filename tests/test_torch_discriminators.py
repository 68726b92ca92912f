"""The condition discriminator and the rejection math: the port against the
JAX package on the CPU, f32.

Random variables (tests/test_torch_support.py: kernels N(0, 1/fan_in),
BatchNorm running statistics, spectral u/v) go to the JAX model and,
through ``load_jax_variables``, to the port. Inputs are numpy draws from a
seed. Tolerance f32 1e-5 relative to max|ref| (with 1e-6 absolute): five
4x4 convs of up to 512 channels, each summing its products in another order
on the two sides. The pool and the rejection arithmetic are the same
elementwise f32 operations on both sides: bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hrviton_tpu.config import CondDiscriminatorConfig as JDConfig
from hrviton_tpu.infer import rejection as jrej
from hrviton_tpu.models import CondMultiscaleDiscriminator as JCondD
from hrviton_tpu.ops.pool import avg_pool2d_nopad as javg
from hrviton_tpu.train import checkpoint as jckpt
from hrviton_tpu_torch.config import CondDiscriminatorConfig
from hrviton_tpu_torch.convert import load_jax_variables
from hrviton_tpu_torch.infer import rejection as trej
from hrviton_tpu_torch.models.discriminators import CondMultiscaleDiscriminator
from hrviton_tpu_torch.ops.pool import avg_pool2d_nopad
from hrviton_tpu_torch.train import checkpoint as tckpt
from test_torch_support import random_variables

torch.set_num_threads(1)
_REL = 1e-5


def _close(got, want, rel=_REL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max()) + 1e-6
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("shape", [(2, 64, 64, 33), (1, 37, 45, 5),
                                   (1, 8, 6, 3)])
def test_avg_pool2d_nopad_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = avg_pool2d_nopad(torch.from_numpy(x))
    want = np.asarray(javg(jnp.asarray(x)))
    assert np.array_equal(got.numpy(), want)


_CONFIGS = {
    "instance": dict(),
    "spectral_ddownx2": dict(spectral=True, ddownx2=True),
    "batch_dropout_interm": dict(norm="batch", ddropout=True,
                                 get_interm_feat=True, use_sigmoid=True,
                                 num_d=3),
}


@functools.lru_cache(maxsize=None)
def _jax_d(kind):
    cfg = JDConfig(input_nc=33, **_CONFIGS[kind])
    m = JCondD(cfg)
    v = random_variables(m, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 33)),
                         train=False)
    return m, v


def _port_d(kind, v):
    d = CondMultiscaleDiscriminator(
        CondDiscriminatorConfig(input_nc=33, **_CONFIGS[kind]),
        device="cpu").eval()
    load_jax_variables(d, v)
    return d


@pytest.mark.parametrize("kind", sorted(_CONFIGS))
def test_cond_discriminator_matches_jax(kind):
    m, v = _jax_d(kind)
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 33)).astype(
        np.float32)
    want = jax.jit(lambda v_, a: m.apply(v_, a, train=False))(v, x)
    with torch.no_grad():
        got = _port_d(kind, v)(torch.from_numpy(x))
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            _close(g, w)
    _close(trej.d_logit(got), jrej.d_logit(want))


def test_rejection_math_matches_jax():
    rng = np.random.default_rng(2)
    real = [rng.uniform(-0.9, 0.45, (8,)).astype(np.float32) for _ in range(3)]
    fake = [rng.uniform(-0.9, 0.45, (5,)).astype(np.float32) for _ in range(2)]
    m = trej.norm_const_from_logits(real, fake)
    assert m == jrej.norm_const_from_logits(real, fake)
    assert m == trej.norm_const_from_logits([torch.from_numpy(a) for a in real],
                                            fake)
    got = trej.rejection_scores(torch.from_numpy(real[0]), m)
    want = jrej.rejection_scores(real[0], m)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(trej.odds(real[1]), np.asarray(jrej.odds(real[1])))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _d_state_dict(v, num_d=2, n_layers=3):
    """The reference's D_*.pth keys (layer{d}.{seq index}.weight / bias),
    built by inverting the converter's mapping over JAX variables."""
    seq = [0, 2, 5, 8, 11]
    sd = {}
    for d in range(num_d):
        node = v["params"][f"discriminator_{d}"]
        for j, si in enumerate(seq):
            conv = node[f"layer{j}_conv"]["conv"]
            sd[f"layer{d}.{si}.weight"] = np.ascontiguousarray(
                conv["kernel"].transpose(3, 2, 0, 1))
            sd[f"layer{d}.{si}.bias"] = conv["bias"]
    return sd


def test_convert_cond_discriminator_matches_jax():
    m, v = _jax_d("instance")
    sd = _d_state_dict(v)
    tree = tckpt.convert_cond_discriminator(sd)
    want = jckpt.convert_cond_discriminator(sd)
    got_l, want_l, src = _leaves(tree), _leaves(want), _leaves(v)
    assert got_l.keys() == want_l.keys() == src.keys()
    for k in want_l:
        assert np.array_equal(got_l[k], want_l[k]), k
        assert np.array_equal(got_l[k], src[k]), k
